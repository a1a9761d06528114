"""The port's pathwise MLMC Greeks (``mlmc_price(greeks=True)``) against
tests/test_mlmc.py::TestGreeks' oracles, at its eps and seeds and with its
tolerances: the closed-form Black-Scholes delta, vega and rho (the GBM
vanilla, whose correction levels are exactly zero), a central difference
of the reflection formula for the continuously monitored up-and-out
call's delta, the flat local-vol Milstein delta (the Heston Greeks are
in ``test_torch_mlmc_heston.py``); ``greeks=True`` leaves the price and stderr unchanged.
"""
import numpy as np
from scipy.stats import norm

import optpricer_tpu_torch as tp
from tests.torch_threads import torch_one_thread  # noqa: F401

S0, K, T, R, Q, SIG = 100.0, 100.0, 1.0, 0.05, 0.0, 0.2


def _haug_uoc(S, K, H, T, r, q, sig):
    mu = (r - q - 0.5 * sig * sig) / (sig * sig)
    st = sig * np.sqrt(T)
    x1 = np.log(S / K) / st + (1 + mu) * st
    x2 = np.log(S / H) / st + (1 + mu) * st
    y1 = np.log(H * H / (S * K)) / st + (1 + mu) * st
    y2 = np.log(H / S) / st + (1 + mu) * st
    A = S * np.exp(-q * T) * norm.cdf(x1) \
        - K * np.exp(-r * T) * norm.cdf(x1 - st)
    B = S * np.exp(-q * T) * norm.cdf(x2) \
        - K * np.exp(-r * T) * norm.cdf(x2 - st)
    C = (S * np.exp(-q * T) * (H / S) ** (2 * (mu + 1)) * norm.cdf(-y1)
         - K * np.exp(-r * T) * (H / S) ** (2 * mu) * norm.cdf(-y1 + st))
    D = (S * np.exp(-q * T) * (H / S) ** (2 * (mu + 1)) * norm.cdf(-y2)
         - K * np.exp(-r * T) * (H / S) ** (2 * mu) * norm.cdf(-y2 + st))
    return A - B + C - D


def _mlmc(payoff, **kw):
    return tp.mlmc_price(payoff, S0, K, T, R, Q, device="cpu", **kw)


def _bs_greeks():
    d1 = (np.log(S0 / K) + (R + 0.5 * SIG * SIG) * T) / (SIG * np.sqrt(T))
    d2 = d1 - SIG * np.sqrt(T)
    return dict(delta=norm.cdf(d1), vega=S0 * norm.pdf(d1) * np.sqrt(T),
                rho=K * T * np.exp(-R * T) * norm.cdf(d2))


def test_greeks_gbm_barrier_local_vol():
    bs = _bs_greeks()
    px, se, g = _mlmc("vanilla", sigma=SIG, eps=0.01, seed=31, greeks=True)
    for name in ("delta", "vega", "rho"):
        assert abs(g[name] - bs[name]) < 4.0 * g[name + "_stderr"] + 1e-3
    h = 0.05
    ref = (_haug_uoc(S0 + h, K, 130.0, T, R, Q, SIG)
           - _haug_uoc(S0 - h, K, 130.0, T, R, Q, SIG)) / (2 * h)
    px, se, g = _mlmc("barrier", sigma=SIG, eps=0.02, barrier=130.0,
                      barrier_type="up-and-out", seed=33, greeks=True)
    assert abs(g["delta"] - ref) < 4.0 * g["delta_stderr"] + 0.01, (g, ref)
    px, se, g = _mlmc("vanilla", sigma_loc=lambda s, t: 0.2 * s / s,
                      scheme="milstein", eps=0.015, seed=37, greeks=True)
    assert abs(g["delta"] - bs["delta"]) < 4.0 * g["delta_stderr"] + 0.01
    p0, s0_ = _mlmc("asian", sigma=SIG, eps=0.02, seed=39)
    p1, s1_, g = _mlmc("asian", sigma=SIG, eps=0.02, seed=39, greeks=True)
    assert abs(p0 - p1) < 1e-9 and abs(s0_ - s1_) < 1e-9
