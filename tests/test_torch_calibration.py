"""Port vs reference: SVI calibration, the vol surface, Dupire local vol and
the static-arbitrage screens (``optpricer_tpu_torch/models/calibration.py``).

Both packages run in float64 on the CPU. The Levenberg-Marquardt fits are
held on what they produce, the fitted total variance on the quote grid, at
rtol 1e-8: the two solves (LAPACK through XLA, LAPACK through torch) round
differently, so the iterates differ at round-off and the stopping rule may
end them an iteration apart. Everything evaluated on fixed parameters
(surface, Dupire, screens) is held at rtol 1e-10, and the goldens
``svi_fit`` / ``dupire_probe`` at the goldens' own rtol 1e-6.
"""
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from optpricer_tpu.models import calibration as jc
from optpricer_tpu.models import pde as jpde
from optpricer_tpu_torch import convert
from optpricer_tpu_torch.models import calibration as tc
from optpricer_tpu_torch.models import pde as tpde
from tests.torch_threads import torch_one_thread  # noqa: F401

GOLDENS = json.loads((Path(__file__).parent / "goldens.json").read_text())
FIT_RTOL = 1e-8
RTOL = 1e-10


def _market(sizes=(21, 21, 21), seed=0, noise=0.0):
    """The desk workflow's three-slice smile (optionally noisy quotes)."""
    rng = np.random.default_rng(seed)
    S0, r, q = 100.0, 0.05, 0.02
    Ts = (0.25, 0.5, 1.0)
    forwards = {T: S0 * np.exp((r - q) * T) for T in Ts}
    strikes, ivs = {}, {}
    for T, m in zip(Ts, sizes):
        grid = np.linspace(0.75, 1.25, m) * forwards[T]
        k = np.log(grid / forwards[T])
        strikes[T] = grid
        ivs[T] = (0.2 + 0.05 * k * k - 0.02 * k + 0.005 * np.sqrt(T)
                  + noise * rng.standard_normal(m))
    return strikes, forwards, ivs


def _w(params, k):
    """Total variance of a slice (either package's SVIParams) in numpy."""
    km = k - params.m
    return params.a + params.b * (params.rho * km
                                  + np.sqrt(km * km + params.sigma ** 2))


def _assert_surfaces_close(got, ref, strikes, forwards, rtol=FIT_RTOL):
    assert sorted(got.slices) == sorted(ref.slices)
    for T in ref.slices:
        k = np.log(strikes[T] / forwards[T])
        np.testing.assert_allclose(_w(got.slices[T], k),
                                   _w(ref.slices[T], k), rtol=rtol)
        assert got.slices[T].expiry == ref.slices[T].expiry


@pytest.mark.parametrize("noise", [0.0, 0.002])
def test_fit_svi_matches_reference(noise):
    strikes, forwards, ivs = _market(noise=noise, seed=3)
    T = 0.5
    ref = jc.fit_svi(strikes[T], forwards[T], T, ivs[T])
    got = tc.fit_svi(strikes[T], forwards[T], T, ivs[T], device="cpu")
    k = np.log(strikes[T] / forwards[T])
    np.testing.assert_allclose(_w(got, k), _w(ref, k), rtol=FIT_RTOL)


def test_fit_svi_with_guess_and_bounds():
    strikes, forwards, ivs = _market(seed=4, noise=0.001)
    T = 1.0
    kw = dict(initial_guess=(0.03, 0.2, -0.1, 0.0, 0.2),
              bounds=((-0.2, 1e-4, -0.9, -1.0, 1e-3),
                      (1.0, 2.0, 0.9, 1.0, 2.0)))
    ref = jc.fit_svi(strikes[T], forwards[T], T, ivs[T], **kw)
    got = tc.fit_svi(strikes[T], forwards[T], T, ivs[T], device="cpu", **kw)
    k = np.log(strikes[T] / forwards[T])
    np.testing.assert_allclose(_w(got, k), _w(ref, k), rtol=FIT_RTOL)


@pytest.mark.parametrize("sizes", [(21, 21, 21), (15, 21, 9)],
                         ids=["batched", "ragged"])
def test_fit_svi_surface_matches_reference(sizes):
    strikes, forwards, ivs = _market(sizes, noise=0.001, seed=5)
    ref = jc.fit_svi_surface(strikes, forwards, ivs)
    got = tc.fit_svi_surface(strikes, forwards, ivs, device="cpu")
    _assert_surfaces_close(got, ref, strikes, forwards)


def test_batched_fit_equals_per_slice_fits():
    """The batched LM with its per-slice active mask gives each slice the
    parameters of its own fit (the reference's vmap of a while_loop)."""
    strikes, forwards, ivs = _market(noise=0.002, seed=6)
    surf = tc.fit_svi_surface(strikes, forwards, ivs, device="cpu")
    for T in strikes:
        one = tc.fit_svi(strikes[T], forwards[T], T, ivs[T], device="cpu")
        k = np.log(strikes[T] / forwards[T])
        np.testing.assert_allclose(_w(surf.slices[T], k), _w(one, k),
                                   rtol=1e-12)


def test_fit_essvi_matches_reference():
    strikes, forwards, ivs = _market((21, 15, 21), noise=0.001, seed=7)
    ref, ref_info = jc.fit_essvi(strikes, forwards, ivs)
    got, info = tc.fit_essvi(strikes, forwards, ivs, device="cpu")
    _assert_surfaces_close(got, ref, strikes, forwards)
    for key in ("rho", "eta", "gamma"):
        assert info[key] == pytest.approx(ref_info[key], rel=1e-6)
    np.testing.assert_allclose(info["theta"], ref_info["theta"], rtol=1e-6)
    assert info["rmse_w"] == pytest.approx(ref_info["rmse_w"], rel=1e-5)
    np.testing.assert_allclose(info["butterfly_margin"],
                               ref_info["butterfly_margin"], rtol=1e-6)


def _ref_surface(forward=True, n=3):
    sl = {T: jc.SVIParams(a=0.02 * T + 0.02, b=0.15, rho=-0.3, m=0.02,
                          sigma=0.12, expiry=T)
          for T in (0.25, 0.5, 1.0)[:n]}
    fc = {T: 100 * np.exp(0.03 * T) for T in sl} if forward else None
    return jc.VolSurface(sl, forward_curve=fc)


@pytest.mark.parametrize("forward, n", [(True, 3), (False, 3), (True, 1)],
                         ids=["curve", "no-curve", "one-slice"])
def test_dupire_matches_reference(forward, n):
    ref_s = _ref_surface(forward, n)
    got_s = convert.vol_surface(ref_s)
    S = np.linspace(60.0, 150.0, 37)
    for t in (0.0, 1e-5, 0.1, 0.25, 0.3, 0.5, 0.77, 1.0, 1.5):
        ref = np.asarray(jc.dupire_local_vol(ref_s, S, t, 0.03, 0.01))
        got = tc.dupire_local_vol(got_s, torch.as_tensor(S), t, 0.03, 0.01)
        np.testing.assert_allclose(got.numpy(), ref, rtol=RTOL)
    scalar = tc.dupire_local_vol(got_s, 104.0,
                                 torch.tensor(0.4, dtype=torch.float64), 0.03, 0.01,
                                 device="cpu")
    assert scalar.ndim == 0
    assert float(scalar) == pytest.approx(
        float(jc.dupire_local_vol(ref_s, 104.0, 0.4, 0.03, 0.01)), rel=RTOL)


def test_surface_methods_match_reference():
    ref_s = _ref_surface()
    got_s = convert.vol_surface(ref_s)
    k = np.linspace(-0.5, 0.5, 11)
    for T in (0.1, 0.25, 0.4, 1.0, 2.0):
        np.testing.assert_allclose(
            got_s.total_var_from_logm(torch.as_tensor(k), T).numpy(),
            np.asarray(ref_s.total_var_from_logm(k, T)), rtol=RTOL)
        np.testing.assert_allclose(
            got_s.iv_from_logm(torch.as_tensor(k), T).numpy(),
            np.asarray(ref_s.iv_from_logm(k, T)), rtol=RTOL)
        assert float(got_s._get_forward(T, "cpu")) == pytest.approx(
            float(ref_s._get_forward(T)), rel=RTOL)
        assert got_s.iv(95.0, T) == pytest.approx(ref_s.iv(95.0, T),
                                                  rel=RTOL)
    np.testing.assert_allclose(got_s.iv(np.array([90.0, 110.0]), 0.7).numpy(),
                               np.asarray(ref_s.iv(np.array([90.0, 110.0]),
                                                   0.7)), rtol=RTOL)
    np.testing.assert_array_equal(got_s.expiries, ref_s.expiries)
    with pytest.raises(ValueError):
        tc.VolSurface({}, device="cpu")
    with pytest.raises(ValueError, match="Forward"):
        convert.vol_surface(_ref_surface(forward=False)).iv(100.0, 0.5)


def test_slice_derivatives_match_reference():
    p = jc.SVIParams(a=0.03, b=0.14, rho=-0.35, m=0.02, sigma=0.11,
                     expiry=0.5)
    t = tc.SVIParams(**vars(p))
    k = np.linspace(-1.0, 1.0, 41)
    for name in ("total_var", "iv", "dw_dk", "d2w_dk2"):
        np.testing.assert_allclose(getattr(t, name)(k, device="cpu").numpy(),
                                   np.asarray(getattr(p, name)(k)),
                                   rtol=RTOL, err_msg=name)


@pytest.mark.parametrize("params", [
    dict(a=0.03, b=0.14, rho=-0.35, m=0.02, sigma=0.11),
    dict(a=-0.05, b=0.9, rho=-0.95, m=0.1, sigma=0.02)],
    ids=["clean", "arbitrage"])
def test_arbitrage_screens_match_reference(params):
    p = jc.SVIParams(expiry=0.5, **params)
    t = tc.SVIParams(expiry=0.5, **params)
    k = np.linspace(-2.0, 2.0, 101)
    np.testing.assert_allclose(tc.svi_butterfly_g(t, k, device="cpu"),
                               np.asarray(jc.svi_butterfly_g(p, k)),
                               rtol=RTOL, atol=1e-14)
    np.testing.assert_allclose(tc.svi_density(t, k, device="cpu"),
                               np.asarray(jc.svi_density(p, k)), rtol=RTOL,
                               atol=1e-14)
    assert tc.check_butterfly(t, device="cpu") == pytest.approx(
        jc.check_butterfly(p), rel=RTOL)


def test_calendar_and_report_match_reference():
    crossing = {0.5: jc.SVIParams(0.05, 0.1, -0.3, 0.0, 0.1, 0.5),
                1.0: jc.SVIParams(0.04, 0.1, -0.3, 0.0, 0.1, 1.0)}
    for ref_s in (_ref_surface(), jc.VolSurface(crossing)):
        got_s = convert.vol_surface(ref_s)
        ref, got = jc.check_calendar(ref_s), tc.check_calendar(got_s)
        assert got["ok"] == ref["ok"] and got["pair"] == ref["pair"]
        assert got["min_gap"] == pytest.approx(ref["min_gap"], rel=RTOL)
        assert got["k_at_min"] == pytest.approx(ref["k_at_min"], rel=RTOL)
        rep_r, rep_g = jc.arbitrage_report(ref_s), tc.arbitrage_report(got_s)
        assert rep_g["ok"] == rep_r["ok"]
        for T in rep_r["butterfly"]:
            assert rep_g["butterfly"][T] == pytest.approx(
                rep_r["butterfly"][T], rel=RTOL)
    one = convert.vol_surface(jc.VolSurface({0.5: crossing[0.5]}))
    assert tc.check_calendar(one)["ok"]


def test_golden_svi_fit():
    truth = tc.SVIParams(a=0.03, b=0.14, rho=-0.35, m=0.02, sigma=0.11,
                         expiry=0.5)
    k = np.linspace(-0.35, 0.35, 17)
    fit = tc.fit_svi(100.0 * np.exp(k), 100.0, 0.5,
                     truth.iv(k, device="cpu").numpy(), device="cpu")
    for key, want in GOLDENS["svi_fit"].items():
        assert getattr(fit, key) == pytest.approx(want, rel=1e-6, abs=1e-12)


def test_golden_dupire_probe():
    sl = {T: tc.SVIParams(a=0.02 * T + 0.02, b=0.15, rho=-0.3, m=0.02,
                          sigma=0.12, expiry=T) for T in (0.25, 0.5, 1.0)}
    surf = tc.VolSurface(sl, forward_curve={T: 100 * np.exp(0.03 * T)
                                            for T in sl}, device="cpu")
    fn = tc.dupire_local_vol_func(surf, 0.03, 0.0)
    for S in (90, 100, 110):
        for t in (0.3, 0.8):
            got = float(fn(torch.tensor([float(S)], dtype=torch.float64),
                           t)[0])
            assert got == pytest.approx(GOLDENS["dupire_probe"][f"S{S}_t{t}"],
                                        rel=1e-6, abs=1e-12)


def test_dupire_closure_drives_the_local_vol_pde():
    """The Dupire closure runs inside ``fd_price_local_vol`` (a tensor S,
    a 0-d tensor t) and prices as the reference's closure does."""
    strikes, forwards, ivs = _market()
    ref_s = jc.fit_svi_surface(strikes, forwards, ivs)
    got_s = convert.vol_surface(ref_s)
    kw = dict(N_S=64, N_t=32)
    ref = jpde.fd_price_local_vol(100.0, 100.0, 1.0, 0.05, 0.02,
                                  jc.dupire_local_vol_func(ref_s, 0.05, 0.02),
                                  "call", **kw)
    got = tpde.fd_price_local_vol(100.0, 100.0, 1.0, 0.05, 0.02,
                                  tc.dupire_local_vol_func(got_s, 0.05, 0.02),
                                  "call", device="cpu", **kw)
    assert got == pytest.approx(ref, rel=1e-9)
