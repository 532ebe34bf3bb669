"""The TF32 hi/lo split of the 3-pass tensor-core products (`csrc/tf32x3.cuh`)
in torch, for packing static weights and for testing the scheme on the CPU.

`tf32_round(x)` is `cvt.rna.tf32.f32`: float32 rounded to TF32's 10-bit
mantissa, to nearest with ties away from zero, kept as a float32 whose low
13 bits are zero. `split_tf32(x)` -> (hi, lo) with hi = tf32_round(x) and
lo = tf32_round(x - hi); hi + lo equals x within 2^-22 of |x|.
"""

from __future__ import annotations

import torch

_HALF, _MASK = 1 << 12, ~((1 << 13) - 1)


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """Round float32 to TF32 (nearest, ties away), on the bits: the sign
    stays apart, so adding half an ulp to the magnitude's bits and cutting
    them rounds |x|. Inf stays inf; NaN payloads are not preserved."""
    bits = x.to(torch.float32).contiguous().view(torch.int32)
    return ((bits + _HALF) & _MASK).view(torch.float32)


def split_tf32(x: torch.Tensor):
    """(hi, lo) float32 tensors of TF32 values with hi + lo ~= x."""
    x = x.to(torch.float32)
    hi = tf32_round(x)
    return hi, tf32_round(x - hi)
