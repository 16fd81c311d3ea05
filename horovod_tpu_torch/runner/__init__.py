"""Launcher-side services of the port (``horovod_tpu/runner``): the KV
store that the negotiation service talks through."""
