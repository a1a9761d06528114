"""Port vs reference: the risk engine (``optpricer_tpu_torch/risk.py``).

Every function is driven through a deterministic pricer (Black-Scholes in
each package) and held against the reference at rtol 1e-10 in float64.
``exposure_profile`` simulates its own GBM paths, whose draws differ
between the packages, so its book valuation (``_exposure_core``) is held on
shared paths and the whole profile against its martingale property. The
reference's ``ad_greeks`` fails on integer inputs (ROADMAP §C); the port
casts them to float64.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from optpricer_tpu import risk as jr
from optpricer_tpu.ops import black_scholes as jbs
from optpricer_tpu_torch import risk as tr
from optpricer_tpu_torch.ops import black_scholes as tbs
from tests.torch_threads import torch_one_thread  # noqa: F401

RTOL = 1e-10
MARKET = (100.0, 105.0, 0.75, 0.04, 0.01, 0.25)


def j_pricer(S, K, T, r, q, sigma, kind):
    out = jbs.bs_price_vec(S, K, T, r, q, sigma, kind)
    return float(out) if np.ndim(out) == 0 else np.asarray(out)


def t_pricer(S, K, T, r, q, sigma, kind):
    out = tbs.bs_price_vec(S, K, T, r, q, sigma, kind, device="cpu")
    return float(out) if out.ndim == 0 else out


BOOK = [dict(S=100.0, K=K, T=T, r=0.03, q=0.01, sigma=s, kind=k, position=p)
        for K, T, s, k, p in ((90.0, 0.5, 0.2, "call", 3.0),
                              (100.0, 1.0, 0.25, "put", -2.0),
                              (115.0, 2.0, 0.3, "call", 1.5),
                              (95.0, 0.25, 0.18, "put", 4.0))]


def _assert_dicts_close(got, ref, atol=1e-12):
    assert set(got) == set(ref)
    for key, want in ref.items():
        if isinstance(want, list):
            for g, w in zip(got[key], want):
                _assert_dicts_close(g, w, atol)
        else:
            np.testing.assert_allclose(got[key], want, rtol=RTOL, atol=atol,
                                       err_msg=key)


@pytest.mark.parametrize("kind", ["call", "put"])
@pytest.mark.parametrize("T", [0.75, 0.002])
def test_numerical_greeks(kind, T):
    S, K, _, r, q, sigma = MARKET
    # a bump quotient divides the two closed forms' last-bit difference
    # (~1e-15 of a price) by the bump: atol 1e-10 on the Greeks
    _assert_dicts_close(
        tr.numerical_greeks(t_pricer, S, K, T, r, q, sigma, kind),
        jr.numerical_greeks(j_pricer, S, K, T, r, q, sigma, kind),
        atol=1e-10)


@pytest.mark.parametrize("kind", ["call", "put"])
def test_ad_greeks(kind):
    got = tr.ad_greeks(tbs.price_core, *MARKET, kind, device="cpu")
    ref = jr.ad_greeks(jbs.price_core, *(jnp.asarray(v, jnp.float64)
                                         for v in MARKET), kind)
    _assert_dicts_close(got, ref)
    closed = tbs.bs_greeks_vec(*MARKET, kind, device="cpu")
    assert got["delta"] == pytest.approx(float(closed["delta"]), rel=1e-12)


def test_ad_greeks_takes_integer_inputs():
    ints = (100, 100, 1, 0, 0, 1)
    with pytest.raises(TypeError):
        jr.ad_greeks(jbs.price_core, *(jnp.asarray(v) for v in ints), "call")
    got = tr.ad_greeks(tbs.price_core, *ints, "call", device="cpu")
    ref = jr.ad_greeks(jbs.price_core, *(jnp.asarray(float(v), jnp.float64)
                                         for v in ints), "call")
    _assert_dicts_close(got, ref)


@pytest.mark.parametrize("vectorized", [False, True])
def test_scenario_grid(vectorized):
    spots = np.linspace(80.0, 120.0, 5)
    vols = np.array([0.1, 0.2, 0.35])
    got = tr.scenario_grid(t_pricer, *MARKET, "call", spots, vols,
                           vectorized=vectorized)
    ref = jr.scenario_grid(j_pricer, *MARKET, "call", spots, vols,
                           vectorized=vectorized)
    for key in ("spot_values", "vol_values", "prices"):
        np.testing.assert_allclose(got[key], ref[key], rtol=RTOL)
    assert got["prices"].shape == (5, 3)


def test_portfolio_risk():
    _assert_dicts_close(tr.portfolio_risk(BOOK, t_pricer),
                        jr.portfolio_risk(BOOK, j_pricer))


def test_portfolio_risk_fast():
    got = tr.portfolio_risk_fast(BOOK, device="cpu")
    _assert_dicts_close(got, jr.portfolio_risk_fast(BOOK))
    slow = tr.portfolio_risk(BOOK, t_pricer, bump_pct=1e-4)
    assert got["total_delta"] == pytest.approx(slow["total_delta"], rel=1e-5)


@pytest.mark.parametrize("confidence, horizon", [(0.99, 1), (0.95, 10),
                                                 (0.5, 1)])
def test_var_and_cvar(confidence, horizon):
    returns = np.random.default_rng(2).standard_t(4, 1001) * 0.01
    for name in ("var_historical", "cvar_historical"):
        got = getattr(tr, name)(returns, confidence, horizon)
        ref = getattr(jr, name)(returns, confidence, horizon)
        assert isinstance(got, float)
        assert got == pytest.approx(ref, rel=RTOL), name
        assert getattr(tr, name)(torch.as_tensor(returns), confidence,
                                 horizon) == got


def test_exposure_core_on_shared_paths():
    from optpricer_tpu.risk import _exposure_core as j_core

    rng = np.random.default_rng(4)
    paths = 100.0 * np.exp(np.cumsum(
        0.1 * rng.standard_normal((6, 50)), axis=0))
    t_grid = np.linspace(0.0, 1.25, 6)
    Ks = np.array([90.0, 100.0, 115.0, 95.0])
    Ts = np.array([0.5, 1.0, 2.0, 0.25])
    pos = np.array([3.0, -2.0, 1.5, 4.0])
    calls = np.array([True, False, True, False])
    ref = j_core(*(jnp.asarray(a) for a in (paths, t_grid, Ks, Ts, pos)),
                 jnp.asarray(calls), *(jnp.asarray(v, jnp.float64)
                                       for v in (0.03, 0.01, 0.2)))
    got = tr._exposure_core(
        *(torch.as_tensor(a) for a in (paths, t_grid, Ks, Ts, pos)),
        torch.as_tensor(calls),
        *(torch.tensor(v, dtype=torch.float64) for v in (0.03, 0.01, 0.2)))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=RTOL,
                               atol=1e-12)


def test_exposure_profile_is_a_martingale():
    """A long call is always worth its value: EE(t) = V0·e^{rt}."""
    inst = [dict(S=100.0, K=100.0, T=1.0, r=0.03, q=0.0, sigma=0.2,
                 kind="call", position=1.0)]
    out = tr.exposure_profile(inst, n_paths=20_000, n_times=5, seed=3,
                              device="cpu")
    V0 = float(tbs.bs_price_vec(100.0, 100.0, 1.0, 0.03, 0.0, 0.2, "call",
                                device="cpu"))
    for t, ee, se in zip(out["t"][:-1], out["EE"][:-1],
                         out["EE_stderr"][:-1]):
        assert abs(ee - V0 * np.exp(0.03 * t)) < 4 * se + 1e-9, (t, ee)
    assert out["EE"][-1] == 0.0          # settled at expiry
    assert set(out) == {"t", "EE", "EE_stderr", "ENE", "PFE", "EPE",
                        "quantile"}
    np.testing.assert_allclose(out["t"], np.linspace(0.0, 1.0, 5))
    with pytest.raises(ValueError):
        tr.exposure_profile([], device="cpu")
    with pytest.raises(ValueError):
        tr.exposure_profile(inst + [dict(inst[0], sigma=0.3)], device="cpu")
