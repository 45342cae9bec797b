"""Arithmetic precisions of the reference: float64, and the control's
TF32 (float32 storage and elementwise work, matrix products on operands
rounded to TF32's 10-bit mantissa, float32 sums)."""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 ``x`` rounded to TF32 (1 sign, 8 exponent, 10 mantissa
    bits), to nearest with ties to even, kept as float32."""
    bits = x.contiguous().view(torch.int32)
    lsb = (bits >> 13) & 1
    return ((bits + 0xFFF + lsb) & -8192).view(torch.float32)


def _mm_plain(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return a @ w


class _MatmulTF32(torch.autograd.Function):
    """``a @ w`` as a TF32 product runs it: each operand rounded to TF32,
    float32 sums; the backward's two products the same way."""

    @staticmethod
    def forward(ctx, a, w):
        ar, wr = round_tf32(a), round_tf32(w)
        ctx.save_for_backward(ar, wr)
        return ar @ wr

    @staticmethod
    def backward(ctx, g):
        ar, wr = ctx.saved_tensors
        gr = round_tf32(g)
        return gr @ wr.t(), ar.t() @ gr


def _mm_tf32(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return _MatmulTF32.apply(a, w)


class Precision(NamedTuple):
    name: str
    dtype: torch.dtype
    mm: Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


FLOAT64 = Precision("float64", torch.float64, _mm_plain)
TF32 = Precision("tf32", torch.float32, _mm_tf32)
BY_NAME = {p.name: p for p in (FLOAT64, TF32)}


def ieee_matmuls() -> None:
    """float32 products in IEEE float32: TF32 off wherever PyTorch
    could take it (the reference and the control round explicitly)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
