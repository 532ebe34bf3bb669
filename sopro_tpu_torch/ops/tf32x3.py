"""The TF32 hi/lo split of the 3-pass tensor-core products (`csrc/tf32x3.cuh`)
in torch, for packing static weights and for testing the scheme on the CPU.

`tf32_round(x)` is `cvt.rna.tf32.f32`: float32 rounded to TF32's 10-bit
mantissa, to nearest with ties away from zero, kept as a float32 whose low
13 bits are zero. `split_tf32(x)` -> (hi, lo) with hi = tf32_round(x) and
lo = tf32_round(x - hi); hi + lo equals x within 2^-22 of |x|.

`mm3` and `conv_chunks` emulate the kernels' products on packed K-major
weights (`[N, K]`, as `pack_nar_heads` and `pack_seanet_decoder` lay them
out): the three passes, and the order in which K3's `wgmma` conv kernel sums
its taps and Cin chunks.
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


def mm3(a: torch.Tensor, hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """The 3-pass product of a [..., K] and K-major weights hi / lo [N, K]:
    a_lo.hi + a_hi.lo + a_hi.hi in float32 matmuls (a product of two TF32
    values is exact in float32, so these stand for the tensor cores but for
    their truncating accumulation)."""
    ah, al = split_tf32(a)
    return al @ hi.T + ah @ lo.T + ah @ hi.T


def round_toward_zero(x64: torch.Tensor) -> torch.Tensor:
    """float64 -> float32, rounded toward zero."""
    r = x64.float()
    return torch.where(r.double().abs() > x64.abs(), torch.nextafter(r, torch.zeros_like(r)), r)


def conv_chunks(taps_in, hi: torch.Tensor, lo: torch.Tensor, bk: int = 32,
                truncate: bool = False) -> torch.Tensor:
    """The sum of K3's `wgmma` conv kernel (csrc/seanet.cu conv_wgmma_kernel)
    over taps and input channels: taps_in[j] [M, K] is tap j's input rows,
    hi / lo [taps, N, K] the packed weights. For each Cin chunk of `bk` and
    each tap in order, a fresh float32 accumulator takes the chunk's bk / 8
    k steps of three MMAs (a_lo.b_hi, a_hi.b_lo, a_hi.b_hi) and is added to
    the running sum in round-to-nearest float32. With `truncate`, each MMA
    adds its eight exact products to the accumulator and rounds the sum
    toward zero, as the tensor cores do (slow: for tests at one tile)."""
    m, k = taps_in[0].shape
    acc = torch.zeros((m, hi.shape[1]))
    for c0 in range(0, k, bk):
        for j, x in enumerate(taps_in):
            ks = slice(c0, min(c0 + bk, k))
            if not truncate:
                acc = acc + mm3(x[:, ks], hi[j][:, ks], lo[j][:, ks])
                continue
            ah, al = split_tf32(x[:, ks])
            part = torch.zeros((m, hi.shape[1]))
            for k0 in range(0, ah.shape[1], 8):
                for xa, w in ((al, hi), (ah, lo), (ah, hi)):
                    prod = xa[:, k0:k0 + 8].double() @ w[j][:, c0 + k0:c0 + k0 + 8].double().T
                    part = round_toward_zero(part.double() + prod)
            acc = acc + part
    return acc
