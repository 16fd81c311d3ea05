"""A broadcast or alltoall while the peers are joined fails the same way on
every rank, whichever reaches the negotiation service first: the peers'
JOINs or rank 0's request.

The refusal is an error every joined rank reads from the same agreed plan.
Before it was typed as such, the first joined rank to fail published a
poison record, and a joined rank whose negotiation round lagged behind
could read that record before its own round delivered the plan, failing
with a ``PeerFailureError`` instead (``test_torch_negotiation.py::
test_join_refuses_broadcast_and_alltoall[world4]``, once under load).
Here rank 3's rounds lag on purpose (``HVD_FAULT_SPEC``), the watchdog
ticks fast, and each order is forced by delaying the other side's
submission. The rank side, :func:`_join_order_rank`, imports no JAX.
"""

import numpy as np
import pytest
import torch

from test_torch_world2 import run_world

# rank 3 reads every negotiation round late; the watchdog ticks often
_LAG = "kv.gather:delay=0.4:rank=3"
# each order: the other side's submission waits (the first submission of
# every rank is the warm-up allreduce)
_ORDERS = {
    "join_first": "svc.submit:delay=1.5:rank=0:after=1",
    "request_first": ";".join(f"svc.submit:delay=1.5:rank={r}:after=1"
                              for r in (1, 2, 3)),
}


def _raised(fn) -> str:
    try:
        fn()
    except Exception as e:  # the type and message, for the test to read
        return f"{type(e).__name__}: {e}"
    return ""


def _join_order_rank(out_path):
    import horovod_tpu_torch as hvd
    hvd.init(device="cpu")
    try:
        n = hvd.size()
        # one negotiated collective first: every service is up and in step
        hvd.allreduce(torch.ones(2), name="warm")
        if hvd.rank() == 0:
            msg = _raised(lambda: hvd.alltoall(torch.ones(n)))
        else:
            msg = _raised(hvd.join)
        np.savez(out_path, joined_peer=np.asarray(msg))
    finally:
        hvd.shutdown()


@pytest.mark.parametrize("order", sorted(_ORDERS))
def test_join_refusal_is_the_same_in_either_order(order, tmp_path):
    res = run_world("_join_order_rank", tmp_path, size=4,
                    module="test_torch_join_order", kv=True,
                    env={"HVD_FAULT_SPEC": f"{_LAG};{_ORDERS[order]}",
                         "HVD_HEALTH_INTERVAL": "0.1",
                         "HVD_PENDING_CYCLE_TIME": "10"})
    first = str(res[0]["joined_peer"])
    assert first.startswith("HorovodCollectiveError") and "ALLTOALL" in first
    for got in res[1:]:
        msg = str(got["joined_peer"])
        assert msg.startswith("HorovodCollectiveError") and "join" in msg, msg
