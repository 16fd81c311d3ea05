"""Share of the traced block's device-idle time during which one of the
optimizer lane's spans (bucket hand-off, sync wait, unpack, the wrapped
optimizer's step) is open on any thread."""
from perfbench import spans


def read(art):
    return spans.idle_share_pct(art)
