"""Data loading (port of ``horovod_tpu/data``): a loader that gives each
rank its share of seeded global batches."""

from .loader import ShardedArrayLoader

__all__ = ["ShardedArrayLoader"]
