"""Matrix products of the plain references, in float64 or, for the control,
in a lower precision than float32.

"tf32" and "bf16" round both operands of every product to that type's
mantissa (10 and 7 bits, round to nearest) and accumulate in float32, in the
forward product and in both products of its gradient, as the tensor cores
compute a float32 product with TF32 or bf16 operands.  The same arithmetic
on every device, so the control reads alike on the CPU and on the card.
"""
from __future__ import annotations

import torch


def _round_bits(x: torch.Tensor, drop: int) -> torch.Tensor:
    bits = x.to(torch.float32).contiguous().view(torch.int32)
    bits = (bits + (1 << (drop - 1))) & ~((1 << drop) - 1)
    return bits.view(torch.float32)


ROUND = {"tf32": lambda x: _round_bits(x, 13), "bf16": lambda x: _round_bits(x, 16)}


def dtype_of(precision: str) -> torch.dtype:
    return torch.float64 if precision == "f64" else torch.float32


class _LowpMatmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b, precision):
        rnd = ROUND[precision]
        ra, rb = rnd(a), rnd(b)
        ctx.save_for_backward(ra, rb)
        ctx.precision = precision
        return ra @ rb

    @staticmethod
    def backward(ctx, g):
        ra, rb = ctx.saved_tensors
        rg = ROUND[ctx.precision](g)
        return rg @ rb.T, ra.T @ rg, None


def matmul(a: torch.Tensor, b: torch.Tensor, precision: str) -> torch.Tensor:
    if precision in ("f64", "f32"):
        return a @ b
    return _LowpMatmul.apply(a, b, precision)


def softplus(x: torch.Tensor) -> torch.Tensor:
    """log(1 + e^x), exact in the input's type (no threshold)."""
    return torch.clamp(x, min=0) + torch.log1p(torch.exp(-torch.abs(x)))
