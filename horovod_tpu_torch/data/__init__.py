"""Data loading (port of ``horovod_tpu/data``): the loader base, the async
prefetch mixin, and a loader that gives each rank its share of seeded
global batches."""

from .loader import AsyncDataLoaderMixin, BaseDataLoader, ShardedArrayLoader

__all__ = ["AsyncDataLoaderMixin", "BaseDataLoader", "ShardedArrayLoader"]
