"""Sequence-parallel attention of the PyTorch port."""

from .sequence import heads_to_seq, seq_to_heads, ulysses_attention

__all__ = ["heads_to_seq", "seq_to_heads", "ulysses_attention"]
