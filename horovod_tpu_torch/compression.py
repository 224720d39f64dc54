"""Gradient wire compression.

Counterpart of ``horovod_tpu/compression.py`` (``:29-71``): cast
floating gradients to fp16 or bf16 before the allreduce and back after.
``Compression.int8`` / ``fp8`` are markers that select the quantized
wire (``ops/quantized.py``).
"""

from __future__ import annotations

import torch

from .ops.quantized import Fp8Compressor, Int8Compressor


class Compressor:
    """A pair of compress/decompress transforms around the wire format."""

    @staticmethod
    def compress(tensor: torch.Tensor):
        raise NotImplementedError

    @staticmethod
    def decompress(tensor: torch.Tensor, ctx):
        raise NotImplementedError


class NoneCompressor(Compressor):
    """Identity."""

    @staticmethod
    def compress(tensor):
        return tensor, None

    @staticmethod
    def decompress(tensor, ctx):
        return tensor


class _CastCompressor(Compressor):
    wire_dtype: torch.dtype

    @classmethod
    def compress(cls, tensor):
        ctx = tensor.dtype
        if tensor.dtype.is_floating_point and tensor.dtype != cls.wire_dtype:
            return tensor.to(cls.wire_dtype), ctx
        return tensor, ctx

    @staticmethod
    def decompress(tensor, ctx):
        if ctx is not None and tensor.dtype != ctx:
            return tensor.to(ctx)
        return tensor


class FP16Compressor(_CastCompressor):
    """Cast floating tensors to fp16 on the wire."""

    wire_dtype = torch.float16


class BF16Compressor(_CastCompressor):
    """Cast floating tensors to bf16 on the wire."""

    wire_dtype = torch.bfloat16


class Compression:
    """``hvd.Compression`` namespace."""

    none = NoneCompressor
    fp16 = FP16Compressor
    bf16 = BF16Compressor
    int8 = Int8Compressor
    fp8 = Fp8Compressor
