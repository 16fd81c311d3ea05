"""The hierarchical negotiation control plane and the coordinator
ResponseCache (port of ``horovod_tpu/negotiation/``).

Ranks are partitioned into leader groups (:mod:`.layout`); past one group a
negotiation round runs member -> leader -> cross-leader -> fan-down
(:mod:`.hierarchy`); and each service's :class:`.ResponseCache` serves
steady-state requests locally once the protocol's AND-ed cache bit vector
has proven that every rank holds their response (:mod:`.response_cache`).
"""

from .hierarchy import HierarchicalTransport
from .layout import GroupLayout
from .response_cache import ResponseCache

__all__ = ["GroupLayout", "ResponseCache", "HierarchicalTransport"]
