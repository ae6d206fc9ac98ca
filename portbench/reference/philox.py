"""Philox4x32-10 (Salmon et al., SC'11) in plain PyTorch, and the kernels'
bits -> uniform map.

The port's kernels draw their random numbers in the kernel: B1 keys a
replica's stream on (seed[b], b0 + b) with the counter (particle group,
step), B2 on the same key with the counter (tracer, step).  The reference
draws the same words here, from the counter and key alone, in int64
arithmetic: a product of two 32-bit words fits 64 bits, so its low and high
halves are exact, and the high bits that a signed shift or an xor leaves
above bit 31 are masked off before the next product.
"""
from __future__ import annotations

import torch

M0, M1 = 0xD2511F53, 0xCD9E8D57
W0, W1 = 0x9E3779B9, 0xBB67AE85
MASK32 = 0xFFFFFFFF


def philox4x32_10(c0, c1, c2, c3, k0, k1):
    """The four output words of Philox4x32-10 for counters (c0, c1, c2, c3)
    and keys (k0, k1): int64 tensors (or ints) holding values in
    [0, 2^32), broadcast together.  Returns four int64 tensors in
    [0, 2^32)."""
    c0, c1, c2, c3 = torch.broadcast_tensors(
        *(torch.as_tensor(c, dtype=torch.int64) for c in (c0, c1, c2, c3)))
    k0 = torch.as_tensor(k0, dtype=torch.int64)
    k1 = torch.as_tensor(k1, dtype=torch.int64)
    for _ in range(10):
        p0 = c0 * M0            # the full 64-bit product, as int64 bits
        p1 = c2 * M1
        c0 = p1 >> 32
        c0 ^= c1
        c0 ^= k0
        c0 &= MASK32
        c2 = p0 >> 32
        c2 ^= c3
        c2 ^= k1
        c2 &= MASK32
        c1, c3 = p1, p0         # their low halves, masked where read
        k0 = (k0 + W0) & MASK32
        k1 = (k1 + W1) & MASK32
    return c0, c1 & MASK32, c2, c3 & MASK32


def bits_to_uniform(bits: torch.Tensor) -> torch.Tensor:
    """The kernels' map: the low 24 bits times 2^-24, exact in float32."""
    return (bits & 0xFFFFFF).to(torch.float32) * (2.0 ** -24)
