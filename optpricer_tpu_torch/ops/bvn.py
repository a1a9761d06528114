"""Bivariate standard-normal CDF Φ₂(h, k, ρ): Genz's algorithm in torch.

Counterpart of ``optpricer_tpu/ops/bvn.py``. The closed forms for
two-asset rainbow options (Stulz 1982) reduce to Φ₂. Genz (2004), the
standard ``bvnu`` construction, vectorised:

* |ρ| ≤ 0.925 — 20-point Gauss-Legendre quadrature of Drezner-Wesolowsky's
  single integral over θ = asin(ρ);
* |ρ| > 0.925 — Genz's expansion around |ρ| = 1: the analytic boundary
  terms plus a Gauss-Legendre remainder in s = √(1−ρ²).

Both branches are evaluated for every element with clamped denominators,
so the unselected one stays finite, and ``torch.where`` picks per element,
in the reference's order of operations. Float64 by default; the input
tensors' floating dtype and device otherwise.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..dtypes import default_dtype

__all__ = ["bvn_cdf"]

# 20-point Gauss-Legendre on [-1, 1], computed once on the host
_GL_X, _GL_W = np.polynomial.legendre.leggauss(20)
_TINY = 1e-30


def _ncdf(x):
    return torch.special.ndtr(x)


def _inputs(h, k, r):
    tensors = [a for a in (h, k, r) if isinstance(a, torch.Tensor)]
    dev = tensors[0].device if tensors else torch.device("cpu")
    dtype = None
    for a in tensors:
        if a.is_floating_point():
            dtype = a.dtype if dtype is None \
                else torch.promote_types(dtype, a.dtype)
    dtype = dtype or default_dtype()
    return torch.broadcast_tensors(*(torch.as_tensor(a, dtype=dtype,
                                                     device=dev)
                                     for a in (h, k, r)))


def _bvnu(h, k, r):
    """P(X > h, Y > k) for a standard bivariate normal with correlation r.

    h, k, r broadcast elementwise; r is clamped to [−1+1e-12, 1−1e-12].
    """
    h, k, r = _inputs(h, k, r)
    dtype, dev = h.dtype, h.device
    r = torch.clamp(r, -1.0 + 1e-12, 1.0 - 1e-12)
    x = torch.as_tensor(_GL_X, dtype=dtype, device=dev)
    w = torch.as_tensor(_GL_W, dtype=dtype, device=dev)

    hk = h * k

    # ---- branch 1: |r| <= 0.925 -------------------------------------
    hs = 0.5 * (h * h + k * k)
    asr = torch.arcsin(r)
    # θ_i = asr(1+x_i)/2 ∈ [0, asr]; ∫₀^asr … dθ = asr/2 · Σ wᵢ f(θᵢ)
    sn = torch.sin(asr[..., None] * (1.0 + x) * 0.5)
    denom = torch.clamp(1.0 - sn * sn, min=_TINY)
    f = torch.exp((sn * hk[..., None] - hs[..., None]) / denom)
    integral = asr * 0.5 * torch.sum(w * f, dim=-1)
    bvn_small = integral / (2.0 * math.pi) + _ncdf(-h) * _ncdf(-k)

    # ---- branch 2: |r| > 0.925 (expansion around |r| = 1) -----------
    # r < 0 maps onto r > 0 through (h, k, r) → (h, −k, −r):
    # P(X>h, Y>k; r<0) = Φ(−h) − P(X>h, Y>−k; −r)
    neg = r < 0.0
    k2 = torch.where(neg, -k, k)
    hk2 = torch.where(neg, -hk, hk)
    ass = torch.clamp((1.0 - r) * (1.0 + r), min=_TINY)   # 1 − r²
    a = torch.sqrt(ass)
    bs = (h - k2) ** 2
    c = (4.0 - hk2) / 8.0
    d = (12.0 - hk2) / 16.0
    asr2 = -0.5 * (bs / ass + hk2)
    t0 = a * torch.exp(asr2) * (1.0 - c * (bs - ass)
                                * (1.0 - d * bs / 5.0) / 3.0
                                + c * d * ass * ass / 5.0)
    b = torch.sqrt(bs)
    sp = math.sqrt(2.0 * math.pi) * _ncdf(-b / torch.clamp(a, min=_TINY))
    t1 = torch.exp(torch.clamp(-0.5 * hk2, max=80.0)) * sp * b \
        * (1.0 - c * bs * (1.0 - d * bs / 5.0) / 3.0)
    acc = t0 - t1
    # remainder: ∫₀^a g(s) ds, s_i = a(1+x_i)/2
    s_i = (a * 0.5)[..., None] * (1.0 + x)
    xs = s_i * s_i
    rs = torch.sqrt(torch.clamp(1.0 - xs, min=_TINY))
    asr1 = -0.5 * (bs[..., None] / torch.clamp(xs, min=_TINY)
                   + hk2[..., None])
    sp1 = 1.0 + c[..., None] * xs * (1.0 + d[..., None] * xs)
    ep = torch.exp(-hk2[..., None] * (1.0 - rs) / (2.0 * (1.0 + rs))) / rs
    g = torch.exp(asr1) * (ep - sp1)
    acc = acc + (a * 0.5) * torch.sum(w * g, dim=-1)
    bvn_big = -acc / (2.0 * math.pi)
    bvn_big_pos = bvn_big + _ncdf(-torch.maximum(h, k2))
    bvn_big_neg = -bvn_big + torch.clamp(_ncdf(k2) - _ncdf(h), min=0.0)
    bvn_big = torch.where(neg, bvn_big_neg, bvn_big_pos)

    out = torch.where(torch.abs(r) <= 0.925, bvn_small, bvn_big)
    return torch.clamp(out, 0.0, 1.0)


def bvn_cdf(h, k, rho):
    """Φ₂(h, k, ρ) = P(X ≤ h, Y ≤ k), X, Y standard normal with
    correlation ρ; elementwise over broadcastable ``h, k, rho`` (tensors,
    arrays or floats). Float64 gives ~1e-15 absolute accuracy."""
    h, k, rho = _inputs(h, k, rho)
    return _bvnu(-h, -k, rho)
