"""Ozaki-style exact-slice GEMM: f64-grade products from exact f32 passes.

PyTorch port of ``mlff_tpu.ops.ozaki`` (Ozaki, Ogita, Oishi & Rump,
"Error-free transformations of matrix multiplication", Numer. Algorithms
2012).  The JAX package wrote it because a TPU v5e has no f64 unit; the H100
has one, so here it is an option of the solve (``matvec_dtype="ozaki"``,
``apply_impl="ozaki"``, ``MLFF_BUILD_GEMM=ozaki``), never the default.

Per product C = A @ B:
  * scale the rows of A (columns of B) by their max-abs power of two, so
    that every entry has |x| <= 1;
  * slice s fixed-point digits of 8 bits each by repeated multiply-by-256
    and round-to-nearest: every digit is an integer in [-256, 256], stored
    as bf16 (8-bit significand, exact);
  * for each digit pair (i, j) with i + j < s, one f32 matrix product of the
    digits cast to f32, over contraction segments of 256.  Digit products
    are integers of at most 2^16 and a 256-deep sum stays within 2^24, so
    every partial is exact in f32 whatever order or split the BLAS takes,
    as long as TF32 is off (``require_full_f32``);
  * accumulate the segment partials and the pair terms on their 2^-8(i+j+2)
    grid weights and apply the scales.

The error is the slicing truncation, ~2^-(8s) of the row / column scale,
independent of the contraction depth.  The scales are exact powers of two,
made by exponent arithmetic (``_pow2_scale``); the JAX package's
``jnp.exp2(ceil(log2(m)))`` is inexact on XLA:CPU (ROADMAP §3).
"""

from __future__ import annotations

import os

import torch

from .. import require_full_f32

# digits of 8 bits each: 6 -> ~2^-48
DIGITS = 6
_RADIX = 256.0
# contraction segment: a 256-deep integer sum is exact in f32 (<= 2^24)
_SEG = 256
# weight classes w >= s - _F32W accumulate in f32 (gemm_presliced), read
# once; clamped there so that at least the heaviest class stays f64
_F32W = int(os.environ.get("MLFF_OZAKI_F32W", "2"))


def _pow2_scale(m: torch.Tensor) -> torch.Tensor:
    """Smallest power of two >= m (f64, elementwise), 1.0 where m == 0,
    built from the exponent bits: exact at every m.  Scales below the
    smallest normal f64 are clamped to it (still >= m)."""
    mant, e = torch.frexp(m)            # m = mant * 2^e, mant in [0.5, 1)
    e = e.to(torch.int64) - (mant == 0.5).to(torch.int64)
    scale = ((e.clamp(-1022, 1023) + 1023) << 52).view(torch.float64)
    return torch.where(m > 0, scale, torch.ones_like(m))


def slice_digits(X: torch.Tensor, axis: int, s: int = DIGITS):
    """f64 -> (scale, digits): X = scale * sum_t digits[t] * 256^-(t+1) + err,
    |err| <= scale * 2^-(8s), with ``scale`` the per-row max-abs power of
    two over ``axis`` (kept with its singleton axis) and each digit an
    integer-valued bf16 tensor in [-256, 256]."""
    m = torch.amax(torch.abs(X), dim=axis, keepdim=True)
    scale = _pow2_scale(m)
    r = X / scale
    digits = []
    for _ in range(s):
        r = r * _RADIX
        q = torch.round(r)              # half to even, as jnp.rint
        digits.append(q.to(torch.bfloat16))
        r = r - q
    return scale, digits


def _f32(d: torch.Tensor) -> torch.Tensor:
    """A digit tensor as an f32 product operand (exact), TF32 checked."""
    require_full_f32(d)
    return d.to(torch.float32)


def _seg_matmul(a: torch.Tensor, b: torch.Tensor, n_seg: int,
                acc_dtype=torch.float64) -> torch.Tensor:
    """Exact digit-pair product sum: a (n, K) x b (K, m) f32 integer digits
    -> (n, m), f32-accumulated per 256-deep segment (exact) and
    ``acc_dtype``-accumulated across segments.  f32 across segments is for
    low-weight digit pairs only (see gemm_presliced)."""
    if n_seg == 1:
        return (a @ b).to(acc_dtype)
    n, m = a.shape[0], b.shape[1]
    a3 = a.reshape(n, n_seg, _SEG).transpose(0, 1)
    b3 = b.reshape(n_seg, _SEG, m)
    return torch.sum(torch.bmm(a3, b3).to(acc_dtype), dim=0)


def _pad_K(X: torch.Tensor, axis: int, K_pad: int) -> torch.Tensor:
    pad = [0, 0] * X.ndim
    # torch.nn.functional.pad order: last axis first
    pad[2 * (X.ndim - 1 - axis) + 1] = K_pad - X.shape[axis]
    return torch.nn.functional.pad(X, pad)


def gemm(A: torch.Tensor, B: torch.Tensor, s: int = DIGITS) -> torch.Tensor:
    """C = A @ B for f64 A (n, K), B (K, m) at ~2^-(8s) of the row and
    column scales, from s (s + 1) / 2 exact f32 products."""
    return gemm_presliced(slice_digits(A, axis=1, s=s),
                          slice_digits(B, axis=0, s=s), s=s)


def _w_f64(s: int) -> int:
    """Weight classes w < _w_f64(s) accumulate in f64, the rest in f32.
    ``MLFF_OZAKI_F32W >= s`` would leave no f64 class and sum even the
    heaviest digits in f32 (the JAX package allows that); the port keeps
    class 0 in f64."""
    return max(1, s - _F32W)


def gemm_presliced(A_sl, B_sl, s: int | None = None) -> torch.Tensor:
    """gemm() on operands already run through slice_digits: an
    iteration-invariant operand slices once, and each call pays only for
    its other side.  ``s`` (default: the operands' own digit count) sets
    the digit-pair truncation i + j < s.

    Weight-split accumulation: the pairs of a low grid weight (w >=
    _w_f64(s)) accumulate in f32, whose ~2^-24 rounding times the class's
    256^-(w+2) weight lands below the 2^-8s truncation; the heavier classes
    accumulate in f64."""
    sA, dA = A_sl
    sB, dB = B_sl
    if s is None:
        s = min(len(dA), len(dB))
    K = dA[0].shape[1]
    n_seg = -(-K // _SEG) if K > _SEG else 1
    K_pad = n_seg * _SEG if n_seg > 1 else K
    a32 = [_f32(_pad_K(d, 1, K_pad) if K_pad != K else d) for d in dA[:s]]
    b32 = [_f32(_pad_K(d, 0, K_pad) if K_pad != K else d) for d in dB[:s]]
    w_f64 = _w_f64(s)
    acc = None        # f64: classes w < w_f64
    acc32 = None      # f32: low-weight classes, one f64 add at the end
    for w in range(s):
        low = w >= w_f64
        part = None
        for i in range(w + 1):
            p = _seg_matmul(a32[i], b32[w - i], n_seg,
                            torch.float32 if low else torch.float64)
            part = p if part is None else part + p
        if low:
            # weight relative to the f32 accumulator; the common
            # 256^-(w_f64+2) factor is applied at the final f64 add
            term32 = part * (_RADIX ** -(w - w_f64))
            acc32 = term32 if acc32 is None else acc32 + term32
        else:
            term = part * (_RADIX ** -(w + 2))
            acc = term if acc is None else acc + term
    if acc32 is not None:
        acc = acc + acc32.to(torch.float64) * (_RADIX ** -(w_f64 + 2))
    return sA * acc * sB


def matmat(A: torch.Tensor, B: torch.Tensor, s: int = DIGITS) -> torch.Tensor:
    """Alias of gemm (naming symmetry with ops.kernel.matmat_psd)."""
    return gemm(A, B, s=s)
