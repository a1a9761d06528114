"""Port vs reference: ``exotic_price_mc`` / ``exotic_greeks_mc`` and their
host estimators.

* ``exotic_price_mc(device="cpu")`` against JAX
  ``exotic_price_mc(backend="pallas")``, which on the CPU runs the path
  kernel in interpret mode on the same ``sw_prng`` sample. The stats agree
  to ~1e-5 relative (``tests/test_torch_path_mc.py``); the estimators turn
  that into |Δprice| ≤ max(1e-5·|price|, 0.01·stderr) and a stderr within
  rtol 1e-2 (a control-variate stderr is the root of a difference of
  near-equal variances; 5.3e-5 and 3.2e-3 measured on the dual-CV put).
* ``exotic_greeks_mc`` against JAX ``exotic_greeks_mc(backend="pallas")``:
  the same keys, every Greek within rtol 5e-5 (6.6e-6 measured), every
  stderr within rtol 1e-3 (5.8e-5 measured).
* ``backend="qmc"`` against the JAX path-QMC kernel's stats and estimator
  (the JAX entry point takes its staged XLA pipeline on the CPU).
* ``_estimate_from_stats`` and ``geometric_asian_price_f64`` are the same
  float64 code: exactly equal on the same inputs.
* The XLA goldens draw from ``jax.random``, not from the kernels' stream,
  so the port meets them statistically: within 4·√(se² + se_golden²).
"""
import json
from pathlib import Path

import numpy as np
import pytest

import optpricer_tpu as jp
from optpricer_tpu.models import analytic as janalytic
from optpricer_tpu.models import mc_fused as jmf
from optpricer_tpu.ops import pallas_qmc_path as jqp
import optpricer_tpu_torch as tp
from optpricer_tpu_torch import parallel as tpar
from optpricer_tpu_torch.models import analytic as tanalytic
from optpricer_tpu_torch.models import mc_fused as tmf
from optpricer_tpu_torch.ops import path_mc as tpm
from tests.torch_threads import torch_one_thread  # noqa: F401

GOLDENS = json.loads((Path(__file__).with_name("goldens.json")).read_text())
MARKET = (100.0, 105.0, 1.0, 0.03, 0.01)  # S0, K, T, r, q
BASE = dict(n_steps=8, n_paths=6000, seed=3)
HESTON = dict(v0=0.04, kappa=1.5, theta=0.05, xi=0.6, rho=-0.7)
SABR = dict(alpha0=0.2, beta=0.6, nu=0.4, rho=-0.3)


def _close_price(got, ref):
    assert abs(got[0] - ref[0]) <= max(1e-5 * abs(ref[0]), 0.01 * ref[1])
    assert got[1] == pytest.approx(ref[1], rel=1e-2)


@pytest.mark.parametrize("payoff, kw", [
    ("asian", dict(sigma=0.2, control_variate=True)),      # the geo CV
    ("asian", dict(sigma=0.2, average_type="geometric")),
    ("vanilla", dict(sigma=0.2, control_variate=True, kind="put")),
    ("barrier", dict(heston=HESTON, scheme="qe", barrier=125.0,
                     control_variate=True)),
    ("vanilla", dict(sabr=SABR, control_variate=True)),    # CEV
    ("lookback", dict(sigma=0.2, strike_type="floating", antithetic=False)),
    ("digital", dict(sigma=0.2, kind="put", payout=2.0)),
], ids=["asian-geo_cv", "asian-geometric", "vanilla-put-cv", "heston_qe",
        "sabr_cev", "lookback", "digital"])
def test_price_matches_reference_kernel(payoff, kw):
    ref = jp.exotic_price_mc(payoff, *MARKET, backend="pallas", **BASE, **kw)
    got = tp.exotic_price_mc(payoff, *MARKET, device="cpu", **BASE, **kw)
    _close_price(got, ref)


@pytest.mark.parametrize("payoff, kw", [
    ("vanilla", {}), ("asian", dict(average_type="geometric")),
    ("lookback", dict(strike_type="floating")),
    ("barrier", dict(barrier=120.0)), ("digital", dict(kind="put"))])
def test_greeks_match_reference_kernel(payoff, kw):
    ref = jp.exotic_greeks_mc(payoff, *MARKET, sigma=0.2, backend="pallas",
                              **BASE, **kw)
    got = tp.exotic_greeks_mc(payoff, *MARKET, sigma=0.2, device="cpu",
                              **BASE, **kw)
    assert set(got) == set(ref)
    for key, value in ref.items():
        rtol = 1e-3 if key.endswith("stderr") else 5e-5
        assert got[key] == pytest.approx(value, rel=rtol, abs=1e-12), key


def test_qmc_backend_matches_reference_kernel():
    kw = dict(payoff="asian", average_type="geometric")
    stats = jqp.path_qmc_sumstats_pallas(7, 2048, 8, *MARKET, 0.2, True,
                                         interpret=True, **kw)
    for cv in (False, True):
        ref = jqp.qmc_path_estimate(stats, 100.0, 0.01, 1.0,
                                    control_variate=cv)
        got = tp.exotic_price_mc("asian", *MARKET, sigma=0.2, backend="qmc",
                                 n_paths=2048, n_steps=8, seed=7,
                                 average_type="geometric",
                                 control_variate=cv, device="cpu")
        assert got[0] == pytest.approx(ref[0], rel=1e-6)
        assert got[1] == pytest.approx(ref[1], rel=1e-3)


def _stats21(**kw):
    return tpm.path_mc_sumstats_kernel(
        5, 5000, 8, *MARKET, 0.2, True, antithetic=True,
        device="cpu", **kw).double().numpy()


@pytest.mark.parametrize("control_variate", [True, False])
def test_estimate_from_stats_exact(control_variate):
    s = _stats21(payoff="asian", geo_cv=True)
    geo = tanalytic.geometric_asian_price_f64(*MARKET, 0.2, n_steps=8)
    cases = [("gbm", None), ("sv", None), ("gbm", geo)]
    for dynamics, geo_ey in cases:
        for is_call in (True, False):
            args = (s, *MARKET, 0.2, is_call, dynamics, control_variate)
            assert tmf._estimate_from_stats(*args, geo_ey=geo_ey) == \
                jmf._estimate_from_stats(*args, geo_ey=geo_ey)
    empty = np.zeros(21)
    assert np.isnan(tmf._estimate_from_stats(empty, *MARKET, 0.2, True,
                                             "gbm", control_variate)[0])


def test_geometric_asian_closed_forms():
    for kind in ("call", "put"):
        for n_steps in (1, 8, 252):
            args = (100.0, 95.0, 0.7, 0.04, 0.01, 0.3)
            ref = janalytic.geometric_asian_price_f64(*args, kind=kind,
                                                      n_steps=n_steps)
            assert tanalytic.geometric_asian_price_f64(
                *args, kind=kind, n_steps=n_steps) == ref
            vec = tp.geometric_asian_price(*args, kind=kind,
                                           n_steps=n_steps, device="cpu")
            jvec = janalytic.geometric_asian_price(*args, kind=kind,
                                                   n_steps=n_steps)
            assert float(vec) == pytest.approx(float(jvec), rel=1e-13)
            assert float(vec) == pytest.approx(ref, rel=1e-13)
    strikes = np.array([80.0, 100.0, 120.0])
    vec = tp.geometric_asian_price(100.0, strikes, 1.0, 0.03, sigma=0.2,
                                   device="cpu")
    np.testing.assert_allclose(
        vec.numpy(), np.asarray(janalytic.geometric_asian_price(
            100.0, strikes, 1.0, 0.03, sigma=0.2)), rtol=1e-13)


@pytest.mark.parametrize("name, payoff, kw", [
    ("exotic_asian_xla_seed3", "asian",
     dict(S0=100.0, K=100.0, sigma=0.2, seed=3)),
    ("exotic_barrier_heston_xla_seed5", "barrier",
     dict(S0=100.0, K=100.0, seed=5, barrier=135.0,
          heston=dict(v0=0.04, kappa=1.5, theta=0.04, xi=0.4, rho=-0.6))),
    ("exotic_sabr_xla_seed9", "vanilla",
     dict(S0=100.0, K=100.0, seed=9,
          sabr=dict(alpha0=0.25, beta=1.0, nu=0.5, rho=-0.4))),
])
def test_xla_goldens_met_statistically(name, payoff, kw):
    golden = GOLDENS[name]
    kw = dict(kw)
    S0, K = kw.pop("S0"), kw.pop("K")
    px, se = tp.exotic_price_mc(payoff, S0, K, 1.0, 0.03, n_steps=32,
                                n_paths=50_000, device="cpu", **kw)
    assert abs(px - golden["price"]) <= 4.0 * np.hypot(se, golden["stderr"])
    # the kernel counts an antithetic pair as one observation, the XLA
    # engine each path: the pair-averaged stderr is the smaller
    assert 0.0 < se <= golden["stderr"]


def test_seed_reproducible_and_cuda_request_raises():
    kw = dict(sigma=0.2, n_steps=4, n_paths=4096, seed=11, device="cpu")
    assert tp.exotic_price_mc("asian", *MARKET, **kw) == \
        tp.exotic_price_mc("asian", *MARKET, **kw)
    assert tp.exotic_price_mc("asian", *MARKET, dtype="float32", **kw) == \
        tp.exotic_price_mc("asian", *MARKET, **kw)
    if not __import__("torch").cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            tp.exotic_price_mc("asian", *MARKET, sigma=0.2, n_steps=4,
                               n_paths=4096, seed=1)


_SIG = dict(sigma=0.2, n_steps=4, n_paths=4096, device="cpu")
_MESH2 = tpar.get_mesh(devices=["cpu"] * 2)


# Each route here raised NotImplementedError until the ROADMAP item in the
# third column was ported; now each runs and prices.
@pytest.mark.parametrize("fn, kw, item", [
    ("price", dict(sigma_loc=lambda S, t: 0.2, n_steps=4), "A.9"),
    ("price", dict(merton=dict(sigma=0.2, lam=0.1, mJ=0.0, sJ=0.1)), "A.10"),
    ("price", dict(vg=dict(sigma=0.2, theta=-0.1, nu=0.2)), "A.13"),
    ("price", dict(nig=dict(alpha=10.0, beta=-2.0, delta=0.2)), "A.13"),
    ("price", dict(sabr=SABR, scheme="exact"), "A.10"),
    ("price", dict(_SIG, dividends=[(0.5, 1.0)]), "A.10"),
    ("price", dict(_SIG, mesh=_MESH2), "A.15"),
    ("price", dict(_SIG, backend="xla"), "A.10"),
    ("price", dict(_SIG, n_steps=7), "A.10"),
    ("price", dict(_SIG, dtype="float64"), "A.10"),
    ("greeks", dict(heston=HESTON), "A.10"),
    ("greeks", dict(sabr=SABR), "A.10"),
    ("greeks", dict(_SIG, n_steps=7), "A.10"),
    ("greeks", dict(_SIG, backend="xla"), "A.10"),
    ("greeks", dict(_SIG, backend="qmc"), "A.10"),
    ("greeks", dict(_SIG, mesh=_MESH2), "A.15"),
    ("greeks", dict(_SIG, dtype=np.float64), "A.10"),
])
def test_unported_routes_raise(fn, kw, item):
    call = tp.exotic_price_mc if fn == "price" else tp.exotic_greeks_mc
    out = call("vanilla", *MARKET, **dict(dict(n_steps=4, n_paths=2048,
                                               seed=1, device="cpu"), **kw))
    if fn == "price":
        price, se = out
    else:
        price, se = out["price"], out["stderr"]
        assert np.isfinite(out["delta"]) and np.isfinite(out["rho"])
    assert np.isfinite(price) and 0.0 < se < 0.1 * price, item


def test_validation_matches_reference():
    bad = [("straddle", dict(sigma=0.2)), ("asian", {}),
           ("asian", dict(sigma=0.2, heston=HESTON)),
           ("asian", dict(sigma=0.2, kind="forward")),
           ("asian", dict(sigma=0.2, scheme="qe")),
           ("asian", dict(heston=HESTON, backend="qmc"))]
    for payoff, kw in bad:
        with pytest.raises(ValueError) as ref:
            jp.exotic_price_mc(payoff, *MARKET, n_steps=4, n_paths=64,
                               **(dict(backend="pallas") | kw))
        with pytest.raises(ValueError) as got:
            tp.exotic_price_mc(payoff, *MARKET, n_steps=4, n_paths=64,
                               device="cpu", **kw)
        assert str(got.value) == str(ref.value)
    for payoff, kw in [("asian", dict(sigma=0.2, dividends=[(0.5, 1.0)])),
                       ("asian", {}), ("cliquet", dict(sigma=0.2))]:
        with pytest.raises(ValueError) as ref:
            jp.exotic_greeks_mc(payoff, *MARKET, **kw)
        with pytest.raises(ValueError) as got:
            tp.exotic_greeks_mc(payoff, *MARKET, device="cpu", **kw)
        assert str(got.value) == str(ref.value)


# ---------------------------------------------------------------------------
# exotic_price_mc_dupire: the path kernel's Dupire branches
# ---------------------------------------------------------------------------
def _desk_surface():
    """The desk workflow's calibrated surface in both packages."""
    from optpricer_tpu.models import calibration as jcal
    from optpricer_tpu_torch import convert

    S0, r, q = 100.0, 0.05, 0.02
    fwd = {T: S0 * np.exp((r - q) * T) for T in (0.25, 0.5, 1.0)}
    strikes = {T: np.linspace(0.75, 1.25, 21) * F for T, F in fwd.items()}
    ivs = {T: 0.2 + 0.05 * np.log(strikes[T] / F) ** 2
           - 0.02 * np.log(strikes[T] / F) + 0.005 * np.sqrt(T)
           for T, F in fwd.items()}
    ref = jcal.fit_svi_surface(strikes, fwd, ivs)
    return ref, convert.vol_surface(ref)


DUPIRE = dict(n_steps=8, n_paths=6000, seed=4)
ARGS = (100.0, 100.0, 1.0, 0.05, 0.02)       # S0, K, T, r, q


def _reference_svi(surface) -> np.ndarray:
    """The SVI table the reference's route builds (``mc_fused.py:475-477``)."""
    svi = np.zeros((6, surface._T_arr.shape[0]), np.float32)
    svi[:5, :] = np.asarray(surface._P_arr).T
    svi[5, :] = np.asarray(surface._T_arr)
    return svi


def _reference_route(surface, payoff, kw):
    """The reference's kernel route of ``exotic_price_mc_dupire``
    (``mc_fused.py:471-499``) with the path kernel in interpret mode, which
    its CPU entry point does not request: (stats, (price, stderr))."""
    from optpricer_tpu.ops import pallas_path_mc as jpm

    svi = _reference_svi(surface)
    kind = kw.get("kind", "call")
    stats = np.asarray(jpm.path_mc_sumstats_pallas(
        DUPIRE["seed"], DUPIRE["n_paths"], DUPIRE["n_steps"], *ARGS, None,
        kind == "call", payoff=payoff,
        antithetic=kw.get("antithetic", True),
        barrier=kw.get("barrier", 0.0), svi_slices=svi, scheme=kw["scheme"],
        interpret=True, sw_prng=True))
    return stats, jmf._estimate_from_stats(
        stats, *ARGS, 0.0, kind == "call", "local_vol",
        kw.get("control_variate", False))


@pytest.mark.parametrize("payoff, kw", [
    ("barrier", dict(scheme="milstein", barrier=125.0, control_variate=True)),
    ("vanilla", dict(scheme="log_euler", kind="put", control_variate=True)),
    ("asian", dict(scheme="milstein", antithetic=False)),
], ids=["barrier-milstein-cv", "vanilla-log_euler-cv", "asian-milstein"])
def test_dupire_matches_reference_kernel_route(monkeypatch, payoff, kw):
    """On the reference kernel's statistics the port prices exactly as the
    reference's route, from the same SVI table bit for bit; its own kernel
    run prices within 2e-3 of the reference's: the interpreted kernel runs
    in this process, where XLA:CPU contracts FMAs, which moves the Dupire
    sums by up to 8.2e-4 (tests/test_torch_path_mc.py)."""
    ref_s, got_s = _desk_surface()
    stats, ref = _reference_route(ref_s, payoff, kw)
    own = tp.exotic_price_mc_dupire(payoff, got_s, *ARGS, device="cpu",
                                    **DUPIRE, **kw)
    assert abs(own[0] - ref[0]) <= 2e-3 * abs(ref[0])
    # a control-variate stderr is the root of a difference of near-equal
    # variances: rtol 1e-2, as for _close_price
    assert own[1] == pytest.approx(ref[1], rel=1e-2)
    calls = []

    def reference_stats(*a, **k):
        calls.append(k)
        return stats

    monkeypatch.setattr(tmf, "path_mc_sumstats_kernel", reference_stats)
    got = tmf.exotic_price_mc_dupire(payoff, got_s, *ARGS, device="cpu",
                                     **DUPIRE, **kw)
    assert got == pytest.approx(ref, rel=1e-12, abs=1e-14)
    svi = calls[0]["svi_slices"]
    assert svi.dtype == np.float32 and svi.shape == (6, 3)
    np.testing.assert_array_equal(svi, _reference_svi(ref_s))
    np.testing.assert_array_equal(svi[5], [0.25, 0.5, 1.0])
    assert calls[0]["scheme"] == kw["scheme"]


def test_dupire_flat_surface_prices_black_scholes():
    """A flat 0.2 SVI surface (w = 0.04·T, b → 0) gives σ_loc = 0.2: the
    log-Euler kernel route prices the vanilla within 4 se of BS."""
    sl = {T: tp.SVIParams(a=0.04 * T, b=1e-8, rho=0.0, m=0.0, sigma=0.1,
                          expiry=T) for T in (0.25, 0.5, 1.0)}
    surf = tp.VolSurface(sl, device="cpu")
    p, se = tp.exotic_price_mc_dupire("vanilla", surf, 100.0, 105.0, 1.0,
                                      0.03, 0.01, scheme="log_euler",
                                      n_steps=8, n_paths=40_000, seed=2,
                                      device="cpu")
    bs = tp.bs_price(tp.OptionSpec(S0=100.0, K=105.0, T=1.0, r=0.03,
                                   sigma=0.2, q=0.01), "call", device="cpu")
    assert abs(p - bs) < 4 * se + 0.01, (p, bs, se)


@pytest.mark.parametrize("kw, item", [
    (dict(backend="xla"), "A.10"), (dict(backend="qmc"), "A.10"),
    (dict(n_steps=7), "A.10"), (dict(mesh=_MESH2), "A.15")])
def test_dupire_unported_routes_raise(kw, item):
    """The routes that raised until ``item`` was ported: the scan engine
    with the surface's Dupire closure (xla, qmc, an odd step count) and
    the sharded kernel (mesh); each prices within 5 se of the kernel's
    one-device call."""
    _, surf = _desk_surface()
    price, se = tp.exotic_price_mc_dupire(
        "vanilla", surf, 100.0, 100.0, 1.0, 0.05, 0.02, device="cpu",
        **dict(DUPIRE, **kw))
    ref, ref_se = tp.exotic_price_mc_dupire(
        "vanilla", surf, 100.0, 100.0, 1.0, 0.05, 0.02, device="cpu",
        **DUPIRE)
    assert abs(price - ref) <= 5.0 * np.hypot(se, ref_se), item
    with pytest.raises(ValueError):
        tp.exotic_price_mc_dupire("straddle", surf, 100.0, 100.0, 1.0, 0.05,
                                  0.02, device="cpu", **DUPIRE)
