"""Port vs reference: Black-Scholes closed forms and implied vol (float64).

Both packages evaluate the same formulas in f64 on a numpy-made random
grid; they differ only in the last bits of log/exp/ndtr, so prices and
Greeks agree to rtol 1e-12 (with an absolute floor of 1e-12 for the
near-zero deep out-of-the-money values, where the rounding of the two
cancelling terms sets the relative error).
"""
import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest

from optpricer_tpu import OptionSpec as JOptionSpec
from optpricer_tpu.ops import black_scholes as jbs
import optpricer_tpu_torch as tp
from optpricer_tpu_torch import convert
from optpricer_tpu_torch.ops import black_scholes as tbs
from tests.torch_threads import torch_one_thread  # noqa: F401

GOLDENS = json.loads((Path(__file__).with_name("goldens.json")).read_text())
RTOL, ATOL = 1e-12, 1e-12
GOLDEN_SPEC = dict(S0=100.0, K=105.0, T=0.75, r=0.04, sigma=0.22, q=0.01)


def _grid(n=2000, seed=0):
    rng = np.random.default_rng(seed)
    return dict(
        S=rng.uniform(50.0, 150.0, n), K=rng.uniform(50.0, 150.0, n),
        T=rng.uniform(0.05, 3.0, n), r=rng.uniform(-0.01, 0.08, n),
        q=rng.uniform(0.0, 0.05, n), sigma=rng.uniform(0.05, 0.8, n),
        kind=rng.random(n) < 0.5)


def _args(g):
    return g["S"], g["K"], g["T"], g["r"], g["q"], g["sigma"], g["kind"]


def _close(got, ref):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), rtol=RTOL,
                               atol=ATOL)


def test_price_vec_matches_reference():
    g = _grid()
    ref = jbs.bs_price_vec(*_args(g), dtype=jnp.float64)
    _close(tbs.bs_price_vec(*_args(g), device="cpu"), ref)


@pytest.mark.parametrize("fn", ["bs_greeks_vec", "bs_higher_greeks_vec"])
def test_greeks_match_reference(fn):
    g = _grid(seed=1)
    ref = getattr(jbs, fn)(*_args(g), dtype=jnp.float64)
    got = getattr(tbs, fn)(*_args(g), device="cpu")
    assert got.keys() == ref.keys()
    for name in ref:
        _close(got[name], ref[name])


def test_newton_iv_matches_reference():
    # quotes whose vol is identifiable (no deep-OTM near-zero prices), so
    # the Newton iteration converges in both packages
    rng = np.random.default_rng(2)
    n = 500
    S = rng.uniform(80.0, 120.0, n)
    K = S * rng.uniform(0.85, 1.2, n)
    T = rng.uniform(0.1, 2.0, n)
    r = rng.uniform(0.0, 0.06, n)
    q = rng.uniform(0.0, 0.03, n)
    sigma = rng.uniform(0.1, 0.6, n)
    kind = rng.random(n) < 0.5
    target = np.asarray(jbs.bs_price_vec(S, K, T, r, q, sigma, kind,
                                         dtype=jnp.float64))
    ref = np.asarray(jbs.bs_implied_vol_vec(S, K, T, r, q, target, kind,
                                            dtype=jnp.float64))
    got = tbs.bs_implied_vol_vec(S, K, T, r, q, target, kind,
                                 device="cpu").numpy()
    assert not np.isnan(ref).any()
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got, sigma, rtol=1e-8)


@pytest.mark.parametrize("kind,sigma_true", [("call", 0.35), ("put", 0.12)])
def test_bisection_iv_matches_reference(kind, sigma_true):
    jopt = JOptionSpec(S0=100.0, K=95.0, T=0.5, r=0.03, sigma=0.3, q=0.01)
    target = jbs.price(JOptionSpec(100.0, 95.0, 0.5, 0.03, sigma_true, 0.01),
                       kind)
    ref = jbs.implied_vol(jopt, target, kind)
    got = tbs.implied_vol(convert.option_spec(jopt), target, kind,
                          device="cpu")
    assert got == pytest.approx(ref, rel=RTOL, abs=ATOL)


@pytest.mark.parametrize("name,kind", [("bs_call", "call"), ("bs_put", "put")])
def test_golden_prices(name, kind):
    got = tp.bs_price(tp.OptionSpec(**GOLDEN_SPEC), kind, device="cpu")
    assert got == pytest.approx(GOLDENS[name], rel=1e-12)


def test_golden_greeks():
    got = tp.bs_greeks(tp.OptionSpec(**GOLDEN_SPEC), "call", device="cpu")
    ref = GOLDENS["bs_greeks_call"]
    assert got.keys() == ref.keys()
    for name, value in ref.items():
        assert got[name] == pytest.approx(value, rel=1e-12)


def test_golden_implied_vol_roundtrip():
    target = tp.bs_price(tp.OptionSpec(**GOLDEN_SPEC), "put", device="cpu")
    spec = tp.OptionSpec(**{**GOLDEN_SPEC, "sigma": 0.3})
    got = tp.implied_vol(spec, target, "put", device="cpu")
    assert got == pytest.approx(GOLDENS["implied_vol_roundtrip"], rel=1e-12)


def test_config1_price():
    # BASELINE config 1: S0=100 K=110 T=1 r=3% sigma=20% call
    spec = tp.OptionSpec(S0=100.0, K=110.0, T=1.0, r=0.03, sigma=0.2)
    assert tp.bs_price(spec, "call", device="cpu") == pytest.approx(
        5.2933981, abs=5e-8)
