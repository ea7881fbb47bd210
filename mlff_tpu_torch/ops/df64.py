"""Double-f32 ("df64") arithmetic on torch f32 tensors.

PyTorch port of ``mlff_tpu.ops.df64``.  A number is an unevaluated pair
(hi, lo) of f32 with hi = f32(x), lo = f32(x - hi): ~2^-48 relative
precision.  The building blocks are error-free transformations in plain
multiplies and adds (Dekker 1971; Hida, Li & Bailey's QD conventions).

Every operation below is a separate eager PyTorch op: no ``addcmul``, no
``torch.compile``, nothing that could fuse ``a*b + c`` into a fused
multiply-add.  Veltkamp's split ``c - (c - a)`` with ``c = 4097 a`` and
Dekker's product error are exact only when each product is rounded on its
own.  These functions are the plain versions of the CUDA kernels in
``csrc/df64_gemv.cu`` (``ops/df64_gemv.py``), which compute the product
error with an explicit ``fmaf`` instead, an exact and equal result.
"""

from __future__ import annotations

import torch

# Veltkamp splitting constant for f32 (24-bit mantissa): 2^12 + 1
_SPLIT_C = 4097.0


def split_f64(x: torch.Tensor):
    """f64 tensor -> (hi, lo) f32 pair: hi + lo carries the top 48 of f64's
    53 mantissa bits (~2^-48 relative round trip)."""
    hi = x.to(torch.float32)
    lo = (x - hi.to(x.dtype)).to(torch.float32)
    return hi, lo


def join_f64(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """(hi, lo) f32 pair -> f64 tensor."""
    return hi.to(torch.float64) + lo.to(torch.float64)


def veltkamp_split(a: torch.Tensor):
    """f32 -> (a1, a2), a = a1 + a2 exactly, each with <= 12 mantissa bits
    (so products a_i * b_j of split halves are exact in f32)."""
    c = _SPLIT_C * a
    a1 = c - (c - a)
    a2 = a - a1
    return a1, a2


def two_sum(a: torch.Tensor, b: torch.Tensor):
    """Error-free sum: (s, e) with s = fl(a+b), s + e = a + b exactly
    (Knuth's branch-free TwoSum)."""
    s = a + b
    bb = s - a
    e = (a - (s - bb)) + (b - bb)
    return s, e


def fast_two_sum(a: torch.Tensor, b: torch.Tensor):
    """Error-free sum assuming |a| >= |b| (Dekker)."""
    s = a + b
    e = b - (s - a)
    return s, e


def two_prod(a: torch.Tensor, b: torch.Tensor):
    """Error-free product via Veltkamp/Dekker: (p, e) with p = fl(a*b),
    p + e = a*b exactly."""
    p = a * b
    a1, a2 = veltkamp_split(a)
    b1, b2 = veltkamp_split(b)
    e = ((a1 * b1 - p) + a1 * b2 + a2 * b1) + a2 * b2
    return p, e


def df64_add(xh, xl, yh, yl):
    """Pair + pair -> normalized pair (~2^-48 relative)."""
    sh, se = two_sum(xh, yh)
    se = se + (xl + yl)
    return fast_two_sum(sh, se)


def df64_prod(ah, al, bh, bl):
    """Pair * pair -> normalized pair (drops al*bl, ~2^-48 relative)."""
    ph, pe = two_prod(ah, bh)
    pe = pe + (ah * bl + al * bh)
    return fast_two_sum(ph, pe)


def df64_sum_pairwise(hi: torch.Tensor, lo: torch.Tensor, axis: int):
    """Compensated pairwise-tree reduction of an (hi, lo) pair tensor along
    ``axis``: a pair with ~2^-48 relative error independent of the length
    (a plain f32 sum loses sqrt(n) * 2^-24).  The axis is padded to the next
    power of two with zeros."""
    hi = torch.movedim(hi, axis, 0)
    lo = torch.movedim(lo, axis, 0)
    n = hi.shape[0]
    n_pad = 1 << max(0, (n - 1).bit_length())
    if n_pad != n:
        pad = hi.new_zeros((n_pad - n, *hi.shape[1:]))
        hi = torch.cat([hi, pad])
        lo = torch.cat([lo, pad])
    while hi.shape[0] > 1:
        h = hi.shape[0] // 2
        hi, lo = df64_add(hi[:h], lo[:h], hi[h:], lo[h:])
    return hi[0], lo[0]


def df64_dot_bv(Bh, Bl, vh, vl):
    """Compensated u = B^T v for B (n, m), v (n,) given as f32 pairs:
    (uh, ul) (m,) with ~2^-48 relative error.  Per element one TwoProd for
    the hi*hi product plus the plain cross products (2^-24-small already,
    so their rounding is ~2^-48)."""
    ph, pe = two_prod(Bh, vh[:, None])
    pe = pe + (Bh * vl[:, None] + Bl * vh[:, None])
    return df64_sum_pairwise(ph, pe, axis=0)


def df64_dot_bx(Bh, Bl, xh, xl):
    """Compensated y = B x for B (n, m), x (m,) f32 pairs: (yh, yl) (n,)."""
    ph, pe = two_prod(Bh, xh[None, :])
    pe = pe + (Bh * xl[None, :] + Bl * xh[None, :])
    return df64_sum_pairwise(ph, pe, axis=1)
