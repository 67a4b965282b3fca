"""Rounding of float32 values to fewer mantissa bits, for the reference and
its control.

The reference states each stage's precision as the configuration does:
products of the bf16 decoder on operands rounded to bf16 (7 explicit
mantissa bits) and summed in f32, bf16 planes, and f32 with TF32 off
elsewhere. Its control is the same code one precision step lower: the
bf16 operands and planes at fp8 e4m3's 3 bits, the f32 products at TF32's
10 bits. Every rounding keeps float32's exponent range (as a per-tensor
scaled fp8 would), so the control measures lost precision, never overflow.
"""

from __future__ import annotations

import dataclasses

import torch

BF16_BITS, TF32_BITS, FP8_BITS = 7, 10, 3


def round_bits(t: torch.Tensor, bits: int | None) -> torch.Tensor:
    """``t`` (as float32) rounded to nearest even at ``bits`` explicit
    mantissa bits; ``t`` unchanged for None. Equal to a cast to bfloat16
    and back at 7 bits, for finite values."""
    t = t.float()
    if bits is None:
        return t
    shift = 23 - bits
    i = t.contiguous().view(torch.int32)
    i = i + ((1 << (shift - 1)) - 1) + ((i >> shift) & 1)
    return (i & -(1 << shift)).view(torch.float32)


@dataclasses.dataclass(frozen=True)
class Precision:
    """The mantissa bits of each kind of value: ``mm`` the operands of f32
    products (None: f32), ``half`` the operands and planes the
    configuration states as bf16."""

    mm: int | None = None
    half: int = BF16_BITS

    def matmul(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """``a @ b`` with both operands rounded to ``mm`` bits and f32 sums."""
        return round_bits(a, self.mm) @ round_bits(b, self.mm)

    def einsum(self, eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return torch.einsum(eq, round_bits(a, self.mm), round_bits(b, self.mm))


#: the configuration's precision, and the control one step below it
STATED = Precision()
LOWERED = Precision(mm=TF32_BITS, half=FP8_BITS)


class Float32Products:
    """Context in which float32 products on the card run in float32: TF32
    off for matmuls and convolutions, restored on exit."""

    def __enter__(self):
        self._saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        return self

    def __exit__(self, *exc):
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = self._saved
        return False
