"""Gradient wire compression (port of ``horovod_tpu/ops/compression.py``):
a ``Compressor`` compresses a tensor before the collective and decompresses
it after."""

from __future__ import annotations

import torch


class Compressor:
    """Interface: ``compress(tensor) -> (compressed, ctx)``;
    ``decompress(compressed, ctx) -> tensor``."""

    @staticmethod
    def compress(tensor):
        raise NotImplementedError

    @staticmethod
    def decompress(tensor, ctx):
        raise NotImplementedError


class NoneCompressor(Compressor):
    @staticmethod
    def compress(tensor):
        return tensor, None

    @staticmethod
    def decompress(tensor, ctx):
        return tensor


class _CastCompressor(Compressor):
    wire_dtype: torch.dtype = None

    @classmethod
    def compress(cls, tensor):
        ctx = tensor.dtype
        if tensor.is_floating_point():
            return tensor.to(cls.wire_dtype), ctx
        return tensor, ctx

    @classmethod
    def decompress(cls, tensor, ctx):
        if ctx is not None and tensor.dtype != ctx:
            return tensor.to(ctx)
        return tensor


class BF16Compressor(_CastCompressor):
    """bfloat16 on the wire: fp32's range at half the bytes."""
    wire_dtype = torch.bfloat16


class FP16Compressor(_CastCompressor):
    """The reference Horovod's fp16 compressor."""
    wire_dtype = torch.float16


class Compression:
    """Namespace mirroring ``hvd.Compression``."""
    none = NoneCompressor
    fp16 = FP16Compressor
    bf16 = BF16Compressor
