"""Fast analytic American-option approximations.

Counterpart of ``optpricer_tpu/models/american_analytic.py``: an American
option priced in O(1) instead of a lattice's O(N²):

* :func:`bjerksund_stensland_price` — Bjerksund & Stensland (2002)
  two-step flat-boundary approximation, in Φ and the Φ₂ of
  ``ops.bvn.bvn_cdf``.
* :func:`baw_price` — Barone-Adesi & Whaley (1987) quadratic
  approximation: a log-space bisection for the critical price, then a
  power-law early-exercise premium.
* :func:`rgw_price` — Roll-Geske-Whaley: the exact price of an American
  call on a stock paying one cash dividend (escrowed-dividend model).

All three broadcast over their inputs and select regions with
``torch.where``; the bisections are 100 fixed steps of tensor ops, with no
host synchronisation. Plain torch on ``device`` (default ``"cuda"``),
float64 unless ``dtype=`` says otherwise.
"""
from __future__ import annotations

import math

import torch

from ..ops.black_scholes import _mask, _prep, d1_d2, price_core
from ..ops.bvn import bvn_cdf

__all__ = ["bjerksund_stensland_price", "baw_price", "rgw_price"]

_EPS = 1e-12
_ncdf = torch.special.ndtr


# --------------------------------------------------------------------------
# Bjerksund-Stensland (2002)
# --------------------------------------------------------------------------

def _bs2002_phi(S, T, gamma, H, I, r, b, sigma):
    """φ(S,T,γ,H,I) = E[e^{−rT} S_T^γ 1{S_T ≤ H, max S ≤ I}] under the
    flat-boundary heuristic — the single-barrier building block."""
    sq = sigma * torch.sqrt(T)
    lam = (-r + gamma * b + 0.5 * gamma * (gamma - 1.0) * sigma * sigma) * T
    d = -(torch.log(S / H) + (b + (gamma - 0.5) * sigma * sigma) * T) / sq
    kappa = 2.0 * b / (sigma * sigma) + 2.0 * gamma - 1.0
    lIS = torch.log(I / S)
    return torch.exp(lam) * S ** gamma * (
        _ncdf(d) - torch.exp(kappa * lIS) * _ncdf(d - 2.0 * lIS / sq))


def _bs2002_psi(S, T2, gamma, H, I2, I1, t1, r, b, sigma):
    """ψ(S,T₂,γ,H,I₂,I₁,t₁) — the two-period extension of φ: four Φ₂
    rectangles with ρ = ±√(t₁/T₂)."""
    sq1 = sigma * torch.sqrt(t1)
    sq2 = sigma * torch.sqrt(T2)
    drift = b + (gamma - 0.5) * sigma * sigma
    e1 = (torch.log(S / I1) + drift * t1) / sq1
    e2 = (torch.log(I2 * I2 / (S * I1)) + drift * t1) / sq1
    e3 = (torch.log(S / I1) - drift * t1) / sq1
    e4 = (torch.log(I2 * I2 / (S * I1)) - drift * t1) / sq1
    f1 = (torch.log(S / H) + drift * T2) / sq2
    f2 = (torch.log(I2 * I2 / (S * H)) + drift * T2) / sq2
    f3 = (torch.log(I1 * I1 / (S * H)) + drift * T2) / sq2
    f4 = (torch.log(S * I1 * I1 / (H * I2 * I2)) + drift * T2) / sq2
    rho = torch.sqrt(t1 / T2)
    lam = (-r + gamma * b + 0.5 * gamma * (gamma - 1.0) * sigma * sigma) * T2
    kappa = 2.0 * b / (sigma * sigma) + 2.0 * gamma - 1.0
    pI2 = torch.exp(kappa * torch.log(I2 / S))
    pI1 = torch.exp(kappa * torch.log(I1 / S))
    pI12 = torch.exp(kappa * torch.log(I1 / I2))
    return torch.exp(lam) * S ** gamma * (
        bvn_cdf(-e1, -f1, rho) - pI2 * bvn_cdf(-e2, -f2, rho)
        - pI1 * bvn_cdf(-e3, -f3, -rho) + pI12 * bvn_cdf(-e4, -f4, -rho))


def _bs2002_call(S, K, T, r, b, sigma):
    """American CALL under cost of carry b < r (b ≥ r is selected to the
    European price by the caller)."""
    sig2 = sigma * sigma
    # the b ≥ r lane still flows through: clamp the denominators so the
    # unselected branch stays finite for torch.where
    r_b = torch.clamp(r - b, min=_EPS)
    beta = (0.5 - b / sig2) + torch.sqrt(
        torch.clamp((b / sig2 - 0.5) ** 2 + 2.0 * r / sig2, min=_EPS))
    beta = torch.clamp(beta, min=1.0 + 1e-6)
    B_inf = beta / (beta - 1.0) * K
    B0 = torch.maximum(K, r / r_b * K)
    span = torch.clamp(B_inf - B0, min=_EPS)
    t1 = 0.5 * (math.sqrt(5.0) - 1.0) * T
    h_t1 = -(b * t1 + 2.0 * sigma * torch.sqrt(t1)) * K * K / (span * B0)
    h_T = -(b * T + 2.0 * sigma * torch.sqrt(T)) * K * K / (span * B0)
    I1 = B0 + span * (1.0 - torch.exp(h_t1))    # boundary on (t1, T]
    I2 = B0 + span * (1.0 - torch.exp(h_T))     # boundary on [0, t1]
    a1 = (I1 - K) * I1 ** (-beta)
    a2 = (I2 - K) * I2 ** (-beta)

    phi = lambda g, H, I: _bs2002_phi(S, t1, g, H, I, r, b, sigma)
    psi = lambda g, H: _bs2002_psi(S, T, g, H, I2, I1, t1, r, b, sigma)

    amer = (a2 * S ** beta
            - a2 * phi(beta, I2, I2)
            + phi(1.0, I2, I2) - phi(1.0, I1, I2)
            - K * phi(0.0, I2, I2) + K * phi(0.0, I1, I2)
            + a1 * phi(beta, I1, I2)
            - a1 * psi(beta, I1)
            + psi(1.0, I1) - psi(1.0, K)
            - K * psi(0.0, I1) + K * psi(0.0, K))
    return torch.where(S >= I2, S - K, amer)


def _broadcast(dtype, device, kind, *values):
    vals = _prep(dtype, device, *values)
    is_call = _mask(kind, vals[0].device)
    return torch.broadcast_tensors(*vals, is_call)


def bjerksund_stensland_price(S0, K, T, r, q=0.0, *, sigma,
                              kind: str = "call", dtype=None, device=None):
    """American option price, Bjerksund-Stensland (2002) approximation.

    The exercise boundary is a two-step flat barrier (I₂ on [0,t₁], I₁ on
    (t₁,T], t₁ = ½(√5−1)T); the premium is the closed-form value of
    stopping at it. Puts use the McDonald-Schroder transformation
    P(S,K,T,r,q) = C(K,S,T,q,r); calls with cost of carry b ≥ r are the
    European price exactly. Returns a tensor (0-d for scalar inputs).
    """
    return _bs2002_price(*_broadcast(dtype, device, kind, S0, K, T, r, q,
                                     sigma))


def _bs2002_price(S0, K, T, r, q, sigma, is_call):
    """:func:`bjerksund_stensland_price` on broadcast tensors and a
    boolean call mask."""
    # put(S,K,r,q) = call(K,S,q,r): price the transformed call lane-wise
    Sx = torch.where(is_call, S0, K)
    Kx = torch.where(is_call, K, S0)
    rx = torch.where(is_call, r, q)
    qx = torch.where(is_call, q, r)
    bx = rx - qx

    euro = price_core(S0, K, T, r, q, sigma, is_call)
    # b ≥ r ⇒ never exercise ⇒ European (also dodges the r−b=0 poles)
    b_safe = torch.minimum(bx, rx - 1e-6)
    amer = _bs2002_call(Sx, Kx, T, rx, b_safe, sigma)
    out = torch.where(bx >= rx, euro, torch.maximum(amer, euro))
    intrinsic = torch.clamp(torch.where(is_call, S0 - K, K - S0), min=0.0)
    return torch.maximum(out, intrinsic)


# --------------------------------------------------------------------------
# Barone-Adesi & Whaley (1987)
# --------------------------------------------------------------------------

def _baw_critical(K, T, r, b, sigma, qq, is_call):
    """Critical price by 100-step log-space bisection of the
    value-matching condition (monotone in S)."""
    ebr = torch.exp((b - r) * T)

    def gap(S):
        # call: c(S) + (1 − e^{(b−r)T}Φ(d1)) S/q2 − (S − K)   (↓ in S)
        # put:  p(S) − (1 − e^{(b−r)T}Φ(−d1)) S/q1 − (K − S)  (↑ in S)
        v = price_core(S, K, T, r, r - b, sigma, is_call)
        d1 = d1_d2(S, K, T, r, r - b, sigma)[0]
        prem_c = (1.0 - ebr * _ncdf(d1)) * S / qq
        prem_p = -(1.0 - ebr * _ncdf(-d1)) * S / qq
        return torch.where(is_call, v + prem_c - (S - K),
                           v + prem_p - (K - S))

    lo = torch.log(torch.where(is_call, K, 1e-6 * K))
    hi = torch.log(torch.where(is_call, 1e6 * K, K))
    for _ in range(100):
        mid = 0.5 * (lo + hi)
        g = gap(torch.exp(mid))
        go_up = torch.where(is_call, g > 0.0, g < 0.0)
        lo, hi = torch.where(go_up, mid, lo), torch.where(go_up, hi, mid)
    return torch.exp(0.5 * (lo + hi))


def baw_price(S0, K, T, r, q=0.0, *, sigma, kind: str = "call",
              dtype=None, device=None):
    """American option price, Barone-Adesi & Whaley (1987) quadratic
    approximation.

    The premium is A·(S/S*)^γ with γ = [−(N−1) ± √((N−1)² + 4M/h)]/2,
    M = 2r/σ², N = 2b/σ², h = 1 − e^{−rT} (+ root for calls, − for puts);
    S* solves value matching (100-step log-space bisection) and A follows
    from smooth pasting. ``q ≤ 0`` calls and ``r ≤ 0`` puts return the
    European price exactly. Returns a tensor (0-d for scalar inputs).
    """
    S0, K, T, r, q, sigma, is_call = _broadcast(dtype, device, kind, S0, K,
                                                T, r, q, sigma)
    b = r - q
    sig2 = sigma * sigma

    euro = price_core(S0, K, T, r, q, sigma, is_call)

    # degenerate lanes (call with b≥r, put with r≤0) are selected to
    # `euro` below; clamp so their unselected branch stays finite
    r_s = torch.clamp(r, min=1e-6)
    b_s = torch.where(is_call, torch.minimum(b, r_s - 1e-6), b)
    M = 2.0 * r_s / sig2
    N = 2.0 * b_s / sig2
    h = torch.clamp(1.0 - torch.exp(-r_s * T), min=_EPS)
    root = torch.sqrt(torch.clamp((N - 1.0) ** 2 + 4.0 * M / h, min=_EPS))
    qq = 0.5 * (-(N - 1.0) + torch.where(is_call, root, -root))

    Sc = _baw_critical(K, T, r_s, b_s, sigma, qq, is_call)
    d1_c = d1_d2(Sc, K, T, r_s, r_s - b_s, sigma)[0]
    ebr = torch.exp((b_s - r_s) * T)
    A = torch.where(is_call,
                    (Sc / qq) * (1.0 - ebr * _ncdf(d1_c)),
                    -(Sc / qq) * (1.0 - ebr * _ncdf(-d1_c)))
    euro_s = price_core(S0, K, T, r_s, r_s - b_s, sigma, is_call)
    prem = A * torch.exp(qq * torch.log(torch.clamp(S0, min=_EPS) / Sc))
    inside = torch.where(is_call, S0 < Sc, S0 > Sc)
    intrinsic = torch.clamp(torch.where(is_call, S0 - K, K - S0), min=0.0)
    amer = torch.where(inside, euro_s + prem, intrinsic)

    no_early = torch.where(is_call, b >= r, r <= 0.0)
    out = torch.where(no_early, euro, torch.maximum(amer, euro))
    return torch.maximum(out, intrinsic)


# --------------------------------------------------------------------------
# Roll-Geske-Whaley: American call, one cash dividend
# --------------------------------------------------------------------------

def rgw_price(S0, K, T, r, *, sigma, D, t_div, dtype=None, device=None):
    """American call on a stock paying ONE cash dividend ``D`` at
    ``t_div`` ∈ (0, T) — Roll-Geske-Whaley closed form, exact under the
    escrowed-dividend model (S'₀ = S₀ − D·e^{−r·t_div} follows GBM):

        C = S'[Φ(b₁) + Φ₂(a₁,−b₁;ρ)] − Ke^{−rT}Φ₂(a₂,−b₂;ρ)
            − (K−D)e^{−r·t_div}Φ(b₂),   ρ = −√(t_div/T),

    with S̄ the ex-dividend spot where c_BS(S̄,K,T−t_div) = S̄ + D − K
    (log-space bisection). If D ≤ K(1 − e^{−r(T−t_div)}) early exercise
    never pays and the price is the European call on the escrowed spot.
    Returns a tensor (0-d for scalar inputs).
    """
    if not 0.0 < float(t_div) < float(T):
        raise ValueError("need 0 < t_div < T")
    S0, K, T, r, sigma, D, t1 = _prep(dtype, device, S0, K, T, r, sigma,
                                         D, t_div)
    Se = S0 - D * torch.exp(-r * t1)          # escrowed spot
    tau = T - t1
    true_ = torch.tensor(True, device=S0.device)
    zero = torch.zeros_like(r)

    euro = price_core(Se, K, T, r, zero, sigma, true_)

    # S̄: ex-dividend spot where c_BS(S̄, K, τ) = S̄ + D − K (↓ in gap)
    lo = torch.log(1e-6 * K)
    hi = torch.log(1e6 * K)
    for _ in range(100):
        mid = 0.5 * (lo + hi)
        Sm = torch.exp(mid)
        gap = price_core(Sm, K, tau, r, zero, sigma, true_) - (Sm + D - K)
        lo, hi = torch.where(gap > 0.0, mid, lo), torch.where(gap > 0.0, hi,
                                                              mid)
    S_bar = torch.exp(0.5 * (lo + hi))

    sqT = sigma * torch.sqrt(T)
    sq1 = sigma * torch.sqrt(t1)
    a1 = (torch.log(Se / K) + (r + 0.5 * sigma * sigma) * T) / sqT
    a2 = a1 - sqT
    b1 = (torch.log(Se / S_bar) + (r + 0.5 * sigma * sigma) * t1) / sq1
    b2 = b1 - sq1
    rho = -torch.sqrt(t1 / T)
    amer = (Se * (_ncdf(b1) + bvn_cdf(a1, -b1, rho))
            - K * torch.exp(-r * T) * bvn_cdf(a2, -b2, rho)
            - (K - D) * torch.exp(-r * t1) * _ncdf(b2))

    never = D <= K * (1.0 - torch.exp(-r * tau))
    out = torch.where(never, euro, torch.maximum(amer, euro))
    return torch.maximum(out, torch.clamp(S0 - K, min=0.0))
