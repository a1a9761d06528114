"""The port's multilevel Monte Carlo against tests/test_mlmc.py's oracles,
at its eps and seeds and with its tolerances: closed-form Black-Scholes
(the exact-coupling vanilla), the continuous geometric-Asian closed form,
the reflection formula of the continuously monitored up-and-out call (and
the Heston COS price (``heston_price_cos``), the CEV smile's fine-grid
``fd_price_local_vol``; the arithmetic Asian bracketed by the geometric
and the vanilla; up-in + up-out = vanilla; the float32 barrier finite;
``info``'s table consistent (the Greeks' oracles are in
``test_torch_mlmc_greeks.py``).
``mlmc_price(mesh=get_mesh(devices=["cpu"] * 8))`` against the geometric
closed form (tests/test_mlmc.py::TestMesh) and within 5·hypot(se, se) of
its one-device call.
"""
import numpy as np
import torch
from scipy.stats import norm

import optpricer_tpu_torch as tp
from optpricer_tpu_torch.parallel import get_mesh
from tests.torch_threads import torch_one_thread  # noqa: F401

S0, K, T, R, Q, SIG = 100.0, 100.0, 1.0, 0.05, 0.0, 0.2
HP = dict(v0=0.04, kappa=2.0, theta=0.04, xi=0.3, rho=-0.5)


def _geo_asian_continuous(S0, K, T, r, q, sigma):
    sig_g = sigma / np.sqrt(3.0)
    mu_g = np.log(S0) + 0.5 * (r - q - 0.5 * sigma * sigma) * T
    d1 = (mu_g - np.log(K) + sig_g * sig_g * T) / (sig_g * np.sqrt(T))
    d2 = d1 - sig_g * np.sqrt(T)
    fwd = np.exp(mu_g + 0.5 * sig_g * sig_g * T)
    return np.exp(-r * T) * (fwd * norm.cdf(d1) - K * norm.cdf(d2))


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


def _bs(kind="call"):
    return float(tp.bs_price(tp.OptionSpec(S0=S0, K=K, T=T, r=R, sigma=SIG),
                             kind, device="cpu"))


def _mlmc(payoff, **kw):
    return tp.mlmc_price(payoff, S0, K, T, R, Q, device="cpu", **kw)


def test_gbm_vanilla_and_asians():
    px, se, info = _mlmc("vanilla", sigma=SIG, eps=0.01, seed=3,
                         return_info=True)
    assert max(abs(v) for v in info["var"][1:]) < 1e-10
    assert abs(px - _bs()) < max(4.0 * se, 0.02), (px, _bs())
    ref = _geo_asian_continuous(S0, K, T, R, Q, SIG)
    px, se, info = _mlmc("asian", sigma=SIG, eps=0.01,
                         average_type="geometric", seed=5, return_info=True)
    assert abs(px - ref) < 3.0 * 0.01 + 3.0 * se, (px, ref, info)
    assert info["var"][1] > info["var"][-1]
    assert abs(info["mean"][0] - ref) > 0.05
    px, se = _mlmc("asian", sigma=SIG, eps=0.015, seed=9)
    assert ref - 3 * se < px < _bs()


def test_gbm_barriers():
    ref = _haug_uoc(S0, K, 130.0, T, R, Q, SIG)
    px, se, info = _mlmc("barrier", sigma=SIG, eps=0.02, barrier=130.0,
                         barrier_type="up-and-out", seed=7,
                         return_info=True)
    assert abs(px - ref) < 4.0 * se + 0.02, (px, ref, info)
    assert all(abs(mm) < 0.05 for mm in info["mean"][1:])
    px, se = _mlmc("barrier", sigma=SIG, eps=0.02, barrier=130.0, seed=7,
                   dtype="float32")
    assert np.isfinite(px) and np.isfinite(se)
    assert abs(px - ref) < 4.0 * se + 0.03, (px, ref)
    kw = dict(sigma=SIG, eps=0.02, barrier=130.0, seed=13)
    uo, se_o = _mlmc("barrier", barrier_type="up-and-out", **kw)
    ui, se_i = _mlmc("barrier", barrier_type="up-and-in", **kw)
    assert abs((uo + ui) - _bs()) < 4.0 * (se_o + se_i) + 0.02


def test_heston_and_local_vol():
    ref = float(tp.heston_price_cos(S0, K, T, R, Q, **HP, kind="call",
                                    device="cpu"))
    px, se, info = _mlmc("vanilla", heston=HP, eps=0.015, seed=11,
                         return_info=True)
    assert abs(px - ref) < 3.0 * 0.015 + 3.0 * se, (px, ref, info)
    assert info["var"][1] > info["var"][-1]
    for scheme in ("euler", "milstein"):
        px, se = _mlmc("vanilla", sigma_loc=lambda s, t: 0.2 * s / s,
                       scheme=scheme, eps=0.015, seed=21)
        assert abs(px - _bs()) < 3.0 * 0.015 + 3.0 * se, (scheme, px)
    ref = _geo_asian_continuous(S0, K, T, R, Q, SIG)
    px, se = _mlmc("asian", sigma_loc=lambda s, t: 0.2 * s / s,
                   average_type="geometric", eps=0.02, seed=25)
    assert abs(px - ref) < 3.0 * 0.02 + 3.0 * se, (px, ref)


def test_cev_smile_against_fd_local_vol():
    def sig(s, t):
        return 0.2 * (torch.clamp(s, min=1e-8) / 100.0) ** -0.3

    ref = tp.fd_price_local_vol(S0, K, T, R, Q, sig, "call", N_S=400,
                                N_t=400, device="cpu")
    px, se, info = _mlmc("vanilla", sigma_loc=sig, scheme="milstein",
                         eps=0.015, seed=23, return_info=True)
    assert abs(px - ref) < 3.0 * 0.015 + 3.0 * se, (px, ref, info)
    assert info["var"][1] > info["var"][-1]


def test_info_table_is_consistent():
    px, se, info = _mlmc("asian", sigma=SIG, eps=0.05, seed=1,
                         return_info=True)
    assert info["levels"] == len(info["n"]) == len(info["mean"]) \
        == len(info["var"]) == len(info["fine_steps"])
    assert abs(px - sum(info["mean"])) < 1e-12
    assert all(b == 2 * a for a, b in zip(info["fine_steps"],
                                          info["fine_steps"][1:]))



def test_mesh_price_matches_closed_form_and_one_device():
    mesh = get_mesh(devices=["cpu"] * 8)
    ref = _geo_asian_continuous(S0, K, T, R, Q, SIG)
    kw = dict(sigma=SIG, eps=0.02, average_type="geometric", seed=5)
    pm, sem = tp.mlmc_price("asian", S0, K, T, R, Q, mesh=mesh, **kw)
    assert sem > 0.0
    assert abs(pm - ref) < 3.0 * 0.02 + 3.0 * sem, (pm, ref)
    p1, se1 = tp.mlmc_price("asian", S0, K, T, R, Q, device="cpu", **kw)
    assert abs(pm - p1) < 5.0 * np.hypot(sem, se1)
    assert tp.mlmc_price("asian", S0, K, T, R, Q, mesh=mesh, **kw) \
        == (pm, sem)
