"""Ray integration (port of ``horovod_tpu/ray``): the ranks of a job as Ray
actors, static (:class:`RayExecutor`) or elastic
(:class:`ElasticRayExecutor`, with :class:`RayHostDiscovery`). Ray is
imported when an executor starts, not here."""

from .elastic import ElasticRayExecutor, RayHostDiscovery
from .runner import RayExecutor

__all__ = ["RayExecutor", "ElasticRayExecutor", "RayHostDiscovery"]
