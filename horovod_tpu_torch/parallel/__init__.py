"""Sequence-parallel attention of the PyTorch port."""

from .sequence import (heads_to_seq, ring_attention, ring_schedule,
                       seq_to_heads, ulysses_attention, zigzag_schedule,
                       zigzag_shard, zigzag_unshard)

__all__ = ["heads_to_seq", "ring_attention", "ring_schedule", "seq_to_heads",
           "ulysses_attention", "zigzag_schedule", "zigzag_shard",
           "zigzag_unshard"]
