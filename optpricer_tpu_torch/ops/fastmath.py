"""Bias-free float32 exp / log / inverse normal CDF, and the bit reversal.

Counterpart of ``optpricer_tpu/ops/fastmath.py`` and of
``optpricer_tpu/ops/pallas_mc.py:_bitrev32``. The polynomials exist because
a library's fast f32 ``exp``/``log`` carry a small systematic bias that the
control-variate estimator turns into a price bias at the 1e-4 gate; the
exponent-split forms here have none. Two forms of each:

* plain torch below (bit views through ``Tensor.view``), used by the
  kernels' plain versions;
* ``__device__`` functions in ``csrc/fastmath.cuh``, a straight port of the
  same polynomials that the CUDA kernels inline (no ``expf``/``logf``/
  ``__expf``, no ``--use_fast_math``).

Every operation is float32 and in the JAX package's order. The results
agree with the JAX functions to an ulp or two: XLA:CPU, torch and nvcc
differ only in whether a multiply-add is contracted into an FMA.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["exp32", "log32", "norminv32", "bitrev32"]


def _c(x: float) -> float:
    """A constant rounded to float32 (as ``jnp.float32(c)`` does)."""
    return float(np.float32(x))


LOG2E = _c(1.4426950408889634)
LN2_HI = _c(0.693145751953125)
LN2_LO = _c(1.428606765330187e-06)

# 2^f on f ∈ [−0.5, 0.5]: Taylor coefficients of exp(f·ln2), degree 7
_EXP2_C = tuple(_c(c) for c in (
    1.0,
    6.931471805599453e-01,
    2.402265069591007e-01,
    5.550410866482158e-02,
    9.618129107628477e-03,
    1.3333558146428443e-03,
    1.5403530393381610e-04,
    1.5252733804059840e-05,
))

# Giles' single-precision erfinv (GPU Computing Gems, 2012)
_GILES_CENTRAL = tuple(_c(c) for c in (
    2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
    0.00021858087, -0.00125372503, -0.00417768164, 0.246640727, 1.50140941))
_GILES_TAIL = tuple(_c(c) for c in (
    -0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
    0.00573950773, -0.0076224613, 0.00943887047, 1.00167406, 2.83297682))

_SQRT2 = _c(1.4142135623730951)
_LOG_POLY = tuple(_c(c) for c in (1.0 / 7.0, 1.0 / 5.0, 1.0 / 3.0, 1.0))


def exp32(x: torch.Tensor) -> torch.Tensor:
    """exp(x): 2^n exactly from the exponent field times a degree-7
    polynomial for 2^f, f ∈ [−0.5, 0.5]. Valid for |x| ≲ 85."""
    x = x.to(torch.float32)
    t = x * LOG2E
    n = torch.floor(t + 0.5)
    f = t - n
    p = torch.full_like(f, _EXP2_C[-1])
    for c in reversed(_EXP2_C[:-1]):
        p = p * f + c
    scale = ((n.to(torch.int32) + 127) << 23).view(torch.float32)
    return p * scale


def log32(u: torch.Tensor) -> torch.Tensor:
    """ln(u) for positive normal u: exact exponent/mantissa split, then the
    atanh series on m ∈ [√2/2, √2]."""
    u = u.to(torch.float32)
    bits = u.view(torch.int32)
    e = (bits >> 23) - 127
    m = ((bits & 0x7FFFFF) | (127 << 23)).view(torch.float32)
    big = m > _SQRT2
    m = torch.where(big, m * 0.5, m)
    e = (e + big.to(torch.int32)).to(torch.float32)
    s = (m - 1.0) / (m + 1.0)
    s2 = s * s
    poly = torch.full_like(s, _c(1.0 / 9.0))
    for c in _LOG_POLY:
        poly = poly * s2 + c
    ln_m = 2.0 * s * poly
    return e * LN2_HI + (ln_m + e * LN2_LO)


def _poly32(coeffs, x):
    p = torch.full_like(x, coeffs[0])
    for c in coeffs[1:]:
        p = p * x + c
    return p


def norminv32(u: torch.Tensor) -> torch.Tensor:
    """Φ⁻¹(u) for u ∈ (0, 1): √2·erfinv(2u−1) with Giles' polynomials, both
    regions evaluated; 1−x² formed as 4u(1−u) and floored at 2·2⁻²⁴."""
    u = u.to(torch.float32)
    x = 2.0 * u - 1.0
    onem = 4.0 * u * (1.0 - u)
    w = -log32(torch.clamp(onem, min=_c(1.1920929e-7)))
    p_central = _poly32(_GILES_CENTRAL, w - 2.5)
    p_tail = _poly32(_GILES_TAIL, torch.sqrt(w) - 3.0)
    p = torch.where(w < 5.0, p_central, p_tail)
    return _SQRT2 * p * x


def bitrev32(v: torch.Tensor) -> torch.Tensor:
    """Bit reversal of uint32 values held in an int64 tensor (5-stage
    butterfly): the base-2 radical inverse of the van der Corput sequence."""
    m = 0xFFFFFFFF
    v = v.to(torch.int64) & m
    v = ((v >> 1) & 0x55555555) | ((v & 0x55555555) << 1)
    v = ((v >> 2) & 0x33333333) | ((v & 0x33333333) << 2)
    v = ((v >> 4) & 0x0F0F0F0F) | ((v & 0x0F0F0F0F) << 4)
    v = ((v >> 8) & 0x00FF00FF) | ((v & 0x00FF00FF) << 8)
    return ((v >> 16) | (v << 16)) & m
