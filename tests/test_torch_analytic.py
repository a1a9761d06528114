"""Port vs reference: the closed forms and COS pricers of
``optpricer_tpu_torch/models/analytic.py``, in float64 on the CPU.

Inputs are drawn from a seed with numpy and go through both packages.
Tolerances:

* elementary closed forms (Merton, SABR, barriers, lookbacks, double
  barriers, quanto, chooser, compound) at rtol 1e-12, with an absolute
  floor of 1e-13 (1e-15 of the spot): both packages form a price as a
  difference S·Φ(d1) − K·Φ(d2) of terms of size ~S0, so a deep
  out-of-the-money price of 1e-7 carries the round-off of those terms;
* CEV at rtol 1e-9 and atol 1e-10: each package's regularised incomplete
  gamma is within ~1.5e-12 of scipy's (the port's own ``_gammainc`` is
  held to scipy below), and the price sums 2 048 of them times F ≈ 100;
* the COS pricers at rtol 1e-10 with atol 1e-12 (their complex matvec
  sums in another order);
* the goldens ``heston_cos``, ``merton_series`` and ``sabr_hagan`` at
  rtol 1e-9, as ``tests/test_goldens.py``;
* ``heston_greeks_cos``, each Greek, at rtol 1e-9;
* ``fit_heston`` within 1e-6 of the reference's fit, with rmse < 1e-6 on
  a surface generated from known parameters;
* ``_trig_kpi``'s float32 branch: the same fixed-point integers as the
  reference's uint32 arithmetic, and cos/sin within 2 ulp of its.
"""
import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.special
import torch

from optpricer_tpu.models import analytic as ja
from optpricer_tpu_torch.models import analytic as ta
from tests.torch_threads import torch_one_thread  # noqa: F401

GOLDENS = json.loads((Path(__file__).with_name("goldens.json")).read_text())
CPU = dict(device="cpu")
RTOL, ATOL = 1e-12, 1e-13
COS_RTOL, COS_ATOL = 1e-10, 1e-12
HESTON = dict(v0=0.045, kappa=1.8, theta=0.05, xi=0.45, rho=-0.55)
MKT = (100.0, 0.75, 0.04, 0.01)          # S0, T, r, q


def _strikes(seed, n=9, lo=60.0, hi=140.0):
    return np.sort(np.random.default_rng(seed).uniform(lo, hi, n))


def _close(got, want, rtol=RTOL, atol=ATOL):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want, np.float64), rtol=rtol,
                               atol=atol)


# ---------------------------------------------------------------------------
# elementary closed forms
# ---------------------------------------------------------------------------
def _merton(lib, K, kind, **kw):
    return lib.merton_price(100.0, K, 0.75, 0.04, 0.01, sigma=0.22, lam=0.6,
                            mJ=-0.07, sJ=0.13, kind=kind, **kw)


def _sabr(lib, K, kind, **kw):
    return lib.sabr_price_hagan(100.0, K, 0.75, 0.04, 0.01, alpha=0.22,
                                beta=0.7, nu=0.5, rho=-0.4, kind=kind, **kw)


def _sabr_lognormal(lib, K, kind, **kw):
    return lib.sabr_price_hagan(100.0, K, 0.75, 0.04, 0.01, alpha=0.22,
                                nu=0.5, rho=-0.4, kind=kind, **kw)


def _quanto(lib, K, kind, **kw):
    return lib.quanto_price(100.0, K, 1.0, 0.03, 0.01, sigma_S=0.2,
                            sigma_fx=0.1, rho_sfx=-0.3, kind=kind, **kw)


def _chooser(lib, K, kind, **kw):
    del kind
    return lib.chooser_price(100.0, K, 1.0, 0.03, 0.01, sigma=0.2,
                             t_choose=0.4, **kw)


@pytest.mark.parametrize("fn", [_merton, _sabr, _sabr_lognormal, _quanto,
                                _chooser])
@pytest.mark.parametrize("kind", ["call", "put"])
def test_closed_forms_match_reference(fn, kind):
    K = _strikes(1)
    _close(fn(ta, K, kind, **CPU), fn(ja, K, kind))


def test_sabr_implied_vol_matches_reference():
    K = _strikes(2)
    _close(ta.sabr_implied_vol(102.0, K, 0.75, 0.22, 0.7, 0.5, -0.4, **CPU),
           ja.sabr_implied_vol(102.0, K, 0.75, 0.22, 0.7, 0.5, -0.4))


def test_quanto_carry_and_vanilla_limit():
    assert ta.quanto_adjusted_carry(0.01, 0.2, 0.1, -0.3) == \
        ja.quanto_adjusted_carry(0.01, 0.2, 0.1, -0.3)
    K = _strikes(3)
    from optpricer_tpu_torch.ops.black_scholes import bs_price_vec

    assert torch.equal(ta.quanto_price(100.0, K, 1.0, 0.03, 0.01,
                                       sigma_S=0.2, sigma_fx=0.0,
                                       rho_sfx=0.5, **CPU),
                       bs_price_vec(100.0, K, 1.0, 0.03, 0.01, 0.2, "call",
                                    **CPU))


@pytest.mark.parametrize("barrier_type", ["up-and-out", "up-and-in",
                                          "down-and-out", "down-and-in"])
@pytest.mark.parametrize("kind", ["call", "put"])
def test_barrier_matches_reference(barrier_type, kind):
    K = _strikes(4)
    H = 130.0 if barrier_type.startswith("up") else 80.0
    kw = dict(sigma=0.25, barrier=H, barrier_type=barrier_type, kind=kind,
              rebate=1.5)
    _close(ta.barrier_price_bs(100.0, K, 1.0, 0.03, 0.01, **kw, **CPU),
           ja.barrier_price_bs(100.0, K, 1.0, 0.03, 0.01, **kw))


@pytest.mark.parametrize("strike_type", ["floating", "fixed"])
@pytest.mark.parametrize("kind", ["call", "put"])
@pytest.mark.parametrize("q, extremum", [(0.01, None), (0.03, None),
                                         (0.01, "seasoned")])
def test_lookback_matches_reference(strike_type, kind, q, extremum):
    """q = r is the zero-carry limit branch of ``_lb_bonus``."""
    K = _strikes(5, lo=80.0, hi=120.0)
    E = None
    if extremum:   # running min below S0 for floating calls / fixed puts
        lower = (strike_type == "floating") == (kind == "call")
        E = 90.0 if lower else 112.0
    kw = dict(sigma=0.25, kind=kind, strike_type=strike_type, K=K,
              running_extremum=E)
    _close(ta.lookback_price_bs(100.0, 1.0, 0.03, q, **kw, **CPU),
           ja.lookback_price_bs(100.0, 1.0, 0.03, q, **kw))


@pytest.mark.parametrize("kind", ["call", "put"])
@pytest.mark.parametrize("knock", ["in", "out"])
def test_double_barrier_matches_reference(kind, knock):
    K = _strikes(6)
    kw = dict(sigma=0.25, lower=70.0, upper=140.0, kind=kind, knock=knock,
              rebate=0.5)
    _close(ta.double_barrier_price_bs(100.0, K, 1.0, 0.03, 0.01, **kw, **CPU),
           ja.double_barrier_price_bs(100.0, K, 1.0, 0.03, 0.01, **kw))


@pytest.mark.parametrize("kind", ["call", "put"])
@pytest.mark.parametrize("underlying", ["call", "put"])
def test_compound_matches_reference(kind, underlying):
    kw = dict(sigma=0.25, kind=kind, underlying=underlying)
    got = ta.compound_price(100.0, 8.0, 100.0, 0.5, 1.5, 0.03, 0.01, **kw,
                            **CPU)
    assert isinstance(got, float)
    _close(got, ja.compound_price(100.0, 8.0, 100.0, 0.5, 1.5, 0.03, 0.01,
                                  **kw))


@pytest.mark.parametrize("beta, sigma", [(0.5, 2.0), (0.3, 5.0), (0.8, 0.5)])
@pytest.mark.parametrize("kind", ["call", "put"])
def test_cev_matches_reference(beta, sigma, kind):
    K = _strikes(7)
    kw = dict(sigma=sigma, beta=beta, kind=kind)
    _close(ta.cev_price(100.0, K, 1.0, 0.03, 0.01, **kw, **CPU),
           ja.cev_price(100.0, K, 1.0, 0.03, 0.01, **kw), rtol=1e-9,
           atol=1e-10)


def test_gammainc_matches_scipy():
    """The port's incomplete gamma on a grid over the CEV range, through
    the band (a > 20, |x/a − 1| < 0.3) where torch.special.gammainc's
    asymptotic expansion misses by up to 4e-10."""
    a = np.geomspace(0.5, 2100.0, 60)[:, None]
    x = np.geomspace(1e-3, 4000.0, 70)[None, :]
    a, x = np.broadcast_arrays(a, x)
    got = ta._gammainc(torch.tensor(a), torch.tensor(x),
                       16 + int(9.0 * np.sqrt(2100.0)))
    np.testing.assert_allclose(got.numpy(), scipy.special.gammainc(a, x),
                               rtol=0.0, atol=1e-12)


# ---------------------------------------------------------------------------
# COS pricers
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kind", ["call", "put", ("call", "put") * 4 + ("put",)])
def test_heston_cos_matches_reference(kind):
    K = _strikes(8)
    S0, T, r, q = MKT
    _close(ta.heston_price_cos(S0, K, T, r, q, **HESTON, kind=kind, **CPU),
           ja.heston_price_cos(S0, K, T, r, q, **HESTON, kind=kind),
           COS_RTOL, COS_ATOL)


@pytest.mark.parametrize("N", [64, 200])
def test_bates_cos_matches_reference(N):
    K = _strikes(9)
    S0, T, r, q = MKT
    kw = dict(HESTON, lam=0.3, mJ=-0.1, sJ=0.15, kind="put", N=N)
    _close(ta.bates_price_cos(S0, K, T, r, q, **kw, **CPU),
           ja.bates_price_cos(S0, K, T, r, q, **kw), COS_RTOL, COS_ATOL)


def test_bates_without_jumps_is_heston_and_scalars_are_0d():
    K = _strikes(10)
    S0, T, r, q = MKT
    heston = ta.heston_price_cos(S0, K, T, r, q, **HESTON, **CPU)
    bates = ta.bates_price_cos(S0, K, T, r, q, **HESTON, lam=0.0, mJ=-0.1,
                               sJ=0.15, **CPU)
    assert torch.equal(heston, bates)
    one = ta.heston_price_cos(S0, float(K[0]), T, r, q, **HESTON, **CPU)
    assert one.shape == () and float(one) == float(heston[0])
    with pytest.raises(ValueError):
        ta.bates_price_cos(S0, K, T, r, q, **HESTON, lam=-1.0, mJ=0.0,
                           sJ=0.1, **CPU)


@pytest.mark.parametrize("name", ["heston_cos", "merton_series",
                                  "sabr_hagan"])
def test_goldens(name):
    S0, T, r, q = MKT
    if name == "heston_cos":
        got = ta.heston_price_cos(S0, 105.0, 0.75, r, q, **HESTON, **CPU)
    elif name == "merton_series":
        got = _merton(ta, 105.0, "call", **CPU)
    else:
        got = ta.sabr_price_hagan(S0, 105.0, 0.75, r, q, alpha=0.22,
                                  beta=1.0, nu=0.5, rho=-0.4, **CPU)
    assert float(got) == pytest.approx(GOLDENS[name], rel=1e-9)


@pytest.mark.parametrize("kind", ["call", "put"])
def test_heston_greeks_match_reference(kind):
    S0, T, r, q = MKT
    got = ta.heston_greeks_cos(S0, 105.0, T, r, q, **HESTON, kind=kind,
                               **CPU)
    want = ja.heston_greeks_cos(S0, 105.0, T, r, q, **HESTON, kind=kind)
    assert set(got) == set(want)
    for name, value in want.items():
        assert got[name] == pytest.approx(value, rel=1e-9), name


def test_fit_heston_recovers_reference_fit():
    S0, _, r, q = MKT
    from optpricer_tpu_torch.ops.black_scholes import bs_implied_vol_vec

    Ts = np.repeat([0.25, 0.5, 1.0], 5)
    Ks = np.tile(np.linspace(85.0, 115.0, 5), 3)
    px = ta.heston_price_cos(S0, torch.tensor(Ks), torch.tensor(Ts), r, q,
                             **HESTON, N=128, **CPU)
    iv = bs_implied_vol_vec(S0, Ks, Ts, r, q, px, "call", **CPU).numpy()
    got = ta.fit_heston(Ks, Ts, iv, S0, r, q, **CPU)
    want = ja.fit_heston(Ks, Ts, iv, S0, r, q)
    assert got["rmse"] < 1e-6
    for name in ("v0", "kappa", "theta", "xi", "rho"):
        assert abs(got[name] - want[name]) < 1e-6, name
        assert abs(got[name] - HESTON[name]) < 1e-6, name
    with pytest.raises(ValueError):
        ta.fit_heston(Ks, Ts[:-1], iv, S0, r, q, **CPU)


# ---------------------------------------------------------------------------
# the float32 phase reduction
# ---------------------------------------------------------------------------
def test_trig_kpi_float32_reduction():
    """The port forms k·round(frac·2^23) in int64 and masks 24 bits; the
    reference wraps a uint32 product and masks the same 24 bits."""
    rng = np.random.default_rng(11)
    frac = np.concatenate([[0.0, 1.0, 0.5, 1.0 / 3.0],
                           rng.uniform(0.0, 1.0, 60)]).astype(np.float32)
    k = np.arange(4096, dtype=np.float32)
    nf = np.round(frac.astype(np.float32) * np.float32(1 << 23)
                  ).astype(np.uint32)
    want = (k.astype(np.uint32)[None, :] * nf[:, None]) \
        & np.uint32((1 << 24) - 1)
    got = ta._kpi_fixed(torch.tensor(k)[None, :],
                        torch.tensor(frac)[:, None])
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
    cos, sin = ta._trig_kpi(torch.tensor(k)[None, :],
                            torch.tensor(frac)[:, None], torch.float32)
    jcos, jsin = ja._trig_kpi(jnp.asarray(k)[None, :],
                              jnp.asarray(frac)[:, None], jnp.float32)
    ulp = np.spacing(np.float32(1.0))
    for a, b in ((cos, jcos), (sin, jsin)):
        b = np.asarray(b)
        assert a.dtype == torch.float32 and b.dtype == np.float32
        assert np.max(np.abs(a.numpy() - b)) <= 2 * ulp
