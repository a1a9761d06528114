"""Closed-form prices: the discrete geometric Asian under GBM.

Counterpart of ``optpricer_tpu/models/analytic.py`` for the one closed
form the path Monte-Carlo engine needs: ``geometric_asian_price_f64`` is
the mean of the geometric-Asian control variate of the arithmetic Asian
(``models/mc_fused.exotic_price_mc(control_variate=True)``) and
``geometric_asian_price`` the same price in float64 torch. The rest of the
reference's module (COS, Merton, SABR, quanto, barrier and lookback closed
forms) waits for its slice of the port.
"""
from __future__ import annotations

import math

import torch

from ..dtypes import canonical, resolve_device
from ..ops.black_scholes import is_call_mask

__all__ = ["geometric_asian_price", "geometric_asian_price_f64"]


def geometric_asian_price_f64(S0, K, T, r, q=0.0, sigma=0.2, *,
                              kind="call", n_steps: int = 252) -> float:
    """Host-float64 scalar :func:`geometric_asian_price`: the control-variate
    mean must not inherit the kernels' f32 precision."""
    m = float(n_steps)
    c = r - q - 0.5 * sigma * sigma
    mu_g = math.log(S0) + c * T * (m + 1.0) / (2.0 * m)
    var_g = sigma * sigma * T * (m + 1.0) * (2.0 * m + 1.0) / (6.0 * m * m)
    sig_g = math.sqrt(var_g)
    df = math.exp(-r * T)
    F_g = math.exp(mu_g + 0.5 * var_g)
    d2 = (mu_g - math.log(K)) / sig_g
    d1 = d2 + sig_g
    Phi = lambda x: 0.5 * (1.0 + math.erf(x / math.sqrt(2.0)))
    if kind == "call":
        return df * (F_g * Phi(d1) - K * Phi(d2))
    return df * (K * Phi(-d2) - F_g * Phi(-d1))


def geometric_asian_price(S0, K, T, r, q=0.0, sigma=0.2, *, kind="call",
                          n_steps: int = 252, dtype=None, device=None):
    """Fixed-strike geometric-average Asian under GBM, exact closed form.

    The average runs over the n_steps grid points t_i = i·T/m, i = 1..m
    (t = 0 excluded), as in the Monte-Carlo engines; ln G is Gaussian with
    mu_G = ln S0 + c·T(m+1)/(2m), c = r − q − σ²/2, and
    sigma_G² = σ²·T·(m+1)(2m+1)/(6m²), so the price is a Black-Scholes
    formula on (mu_G, sigma_G). Inputs broadcast; float64 by default.
    """
    dt_ = canonical(dtype)
    dev = resolve_device(device)
    S0, K, T, r, q, sigma = (torch.as_tensor(v, dtype=dt_, device=dev)
                             for v in (S0, K, T, r, q, sigma))
    is_call = torch.as_tensor(is_call_mask(kind), device=dev)
    m = float(n_steps)
    c = r - q - 0.5 * sigma * sigma
    mu_g = torch.log(S0) + c * T * (m + 1.0) / (2.0 * m)
    var_g = sigma * sigma * T * (m + 1.0) * (2.0 * m + 1.0) / (6.0 * m * m)
    sig_g = torch.sqrt(var_g)
    df = torch.exp(-r * T)
    F_g = torch.exp(mu_g + 0.5 * var_g)
    d2 = (mu_g - torch.log(K)) / sig_g
    d1 = d2 + sig_g
    Phi = torch.special.ndtr
    call = df * (F_g * Phi(d1) - K * Phi(d2))
    put = df * (K * Phi(-d2) - F_g * Phi(-d1))
    return torch.where(is_call, call, put)
