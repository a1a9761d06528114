"""Port vs reference: variance swaps, forward starts and cliquets, rBergomi.

* Deterministic parts at 1e-12: the log-contract replication (a constant
  vol and a VolSurface), the Heston strike, ``_logret_sq_sum`` and the
  cliquet period payoff on one shared path matrix, the Rubinstein
  forward start, ``cliquet_price_bs``, rBergomi's ``_joint_chol`` and its
  core fed the reference's own ``jax.random`` draws for the same key.
* The MC calls (the port draws from ``torch.Generator``) within
  4·hypot(se, se) of the reference's, and the reference tests' oracles
  (tests/test_varswap.py, test_cliquet.py, test_rough.py) at smaller
  sizes with the same tolerances in standard errors.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from optpricer_tpu.models import calibration as jc
from optpricer_tpu.models import cliquet as jcl
from optpricer_tpu.models import rough as jr
from optpricer_tpu.models import varswap as jv
from optpricer_tpu_torch.models import calibration as tc
from optpricer_tpu_torch.models import cliquet as tcl
from optpricer_tpu_torch.models import rough as tr
from optpricer_tpu_torch.models import varswap as tv
from optpricer_tpu_torch.ops.black_scholes import bs_price_vec
from tests.torch_threads import torch_one_thread  # noqa: F401

HP = dict(v0=0.04, kappa=1.5, theta=0.04, xi=0.5, rho=-0.6)
MERTON = dict(sigma=0.2, lam=0.5, mJ=-0.1, sJ=0.15)
BFG = dict(xi0=0.0552, eta=1.9, H=0.07, rho=-0.9)
CPU = dict(device="cpu")


def _close(got, want, tol=1e-12):
    assert abs(got - want) <= tol * max(abs(want), 1.0), (got, want)


def _mc_close(got, want):
    (a, sa), (b, sb) = got, want
    assert abs(a - b) <= 4.0 * np.hypot(sa, sb), (got, want)


def test_replication_matches_reference():
    _close(tv.varswap_strike_replication(0.2, 100.0, 0.03, 0.01, 1.0, **CPU),
           jv.varswap_strike_replication(0.2, 100.0, 0.03, 0.01, 1.0))
    slices = {T: dict(a=0.02 * T, b=0.1, rho=-0.3, m=0.0, sigma=0.2)
              for T in (0.5, 1.0, 2.0)}
    fwd = {T: 100.0 * np.exp(0.02 * T) for T in slices}
    js = jc.VolSurface({T: jc.SVIParams(**p, expiry=T)
                        for T, p in slices.items()}, forward_curve=fwd)
    ts = tc.VolSurface({T: tc.SVIParams(**p, expiry=T)
                        for T, p in slices.items()}, forward_curve=fwd,
                       device="cpu")
    _close(tv.varswap_strike_replication(ts, 100.0, 0.02, 0.0, 1.0,
                                         n_strikes=512, **CPU),
           jv.varswap_strike_replication(js, 100.0, 0.02, 0.0, 1.0,
                                         n_strikes=512))
    for args in ((0.04, 1.5, 0.06, 2.0), (0.09, 2.0, 0.04, 0.5)):
        assert tv.varswap_strike_heston(*args) == \
            jv.varswap_strike_heston(*args)


def test_path_reductions_match_reference_on_one_matrix():
    rng = np.random.default_rng(0)
    paths = 100.0 * np.exp(np.cumsum(rng.normal(0.0, 0.02, (25, 300)),
                                     axis=0))
    paths = np.vstack([np.full((1, 300), 100.0), paths])
    want = np.asarray(jv._logret_sq_sum(jnp.asarray(paths)))
    got = tv._logret_sq_sum(torch.tensor(paths)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-12)
    # the reference's cliquet period payoff, host numpy on the matrix
    for spp, gf, gc in ((1, None, None), (5, 0.01, None), (5, -0.1, 0.05)):
        fix = paths[::spp]
        per = np.clip(fix[1:] / fix[:-1] - 1.0, -0.02, 0.05).sum(axis=0)
        if gf is not None:
            per = np.maximum(per, gf)
        if gc is not None:
            per = np.minimum(per, gc)
        got = tcl._cliquet_payoff(torch.tensor(paths), spp, -0.02, 0.05, gf,
                                  gc).numpy()
        np.testing.assert_allclose(got, per, rtol=1e-12, atol=1e-15)


def test_closed_forms_match_reference():
    for kind in ("call", "put"):
        _close(tcl.forward_start_price(100.0, 1.05, 0.5, 1.5, 0.03, 0.01,
                                       sigma=0.25, kind=kind, **CPU),
               jcl.forward_start_price(100.0, 1.05, 0.5, 1.5, 0.03, 0.01,
                                       sigma=0.25, kind=kind))
    for kw in (dict(local_floor=-0.02, local_cap=0.05),
               dict(local_floor=-1.5, local_cap=0.1, n_periods=4),
               dict(local_floor=0.0, local_cap=0.08, notional=100.0)):
        _close(tcl.cliquet_price_bs(100.0, 1.0, 0.03, 0.01, sigma=0.2, **kw),
               jcl.cliquet_price_bs(100.0, 1.0, 0.03, 0.01, sigma=0.2, **kw))


def test_rbergomi_cholesky_and_core_match_reference():
    n, dt, H = 16, 1.0 / 16, 0.1
    L = jr._joint_chol(n, dt, H)
    np.testing.assert_allclose(tr._joint_chol(n, dt, H), L, rtol=0,
                               atol=1e-12)
    key = jax.random.key(5)
    k1, k2 = jax.random.split(key)
    half = 64
    Z = np.asarray(jax.random.normal(k1, (2 * n, half), jnp.float64))
    Zp = np.asarray(jax.random.normal(k2, (n, half), jnp.float64))
    t_np = dt * np.arange(1, n + 1)
    xi = 0.04 + 0.01 * t_np
    scal = (100.0, 0.03, 0.01, 1.9, 2 * H, -0.9, dt)
    for anti in (True, False):
        Sj, vj = jr._rbergomi_core(
            key, jnp.asarray(L), jnp.asarray(xi), jnp.asarray(t_np),
            *(jnp.asarray(s) for s in scal), n_steps=n,
            n_paths=2 * half if anti else half, antithetic=anti)
        t = lambda a: torch.tensor(a, dtype=torch.float64)
        St, vt = tr._rbergomi_core(t(Z), t(Zp), t(L), t(xi), t(t_np),
                                   *(t(s) for s in scal), antithetic=anti)
        np.testing.assert_allclose(St.numpy(), np.asarray(Sj), rtol=1e-12)
        np.testing.assert_allclose(vt.numpy(), np.asarray(vj), rtol=1e-12)


@pytest.mark.parametrize("dyn", [dict(sigma=0.2), dict(heston=HP),
                                 dict(merton=MERTON)])
def test_mc_calls_within_reference_error(dyn):
    kw = dict(n_steps=32, n_paths=20_000, seed=1)
    _mc_close(tv.varswap_strike_mc(100.0, 0.03, 0.0, 1.0, **dyn, **kw, **CPU),
              jv.varswap_strike_mc(100.0, 0.03, 0.0, 1.0, **dyn, **kw))
    _mc_close(tv.volswap_strike_mc(100.0, 0.03, 0.0, 1.0, **dyn, **kw, **CPU),
              jv.volswap_strike_mc(100.0, 0.03, 0.0, 1.0, **dyn, **kw))
    ckw = dict(n_periods=8, steps_per_period=2, n_paths=20_000, seed=2,
               global_floor=0.01)
    _mc_close(tcl.cliquet_price_mc(100.0, 1.0, 0.03, 0.0, **dyn, **ckw, **CPU),
              jcl.cliquet_price_mc(100.0, 1.0, 0.03, 0.0, **dyn, **ckw))
    fkw = dict(n_steps=16, n_paths=20_000, seed=3, method="mc")
    _mc_close(tcl.forward_start_price(100.0, 1.0, 0.5, 1.0, 0.03, **dyn,
                                      **fkw, **CPU),
              jcl.forward_start_price(100.0, 1.0, 0.5, 1.0, 0.03, **dyn,
                                      **fkw))


def test_rbergomi_price_within_reference_error():
    kw = dict(**BFG, n_steps=32, n_paths=20_000, seed=3)
    _mc_close(tr.rbergomi_price(100.0, 100.0, 0.5, 0.0, **kw, **CPU),
              jr.rbergomi_price(100.0, 100.0, 0.5, 0.0, **kw))


# -- the reference tests' oracles, on the port ---------------------------
def test_varswap_oracles():
    km, se = tv.varswap_strike_mc(100.0, 0.03, 0.0, 1.0, sigma=0.2,
                                  n_steps=252, n_paths=16_384, seed=5, **CPU)
    assert abs(km - 0.04) < 4.0 * se + 1e-4
    kh = tv.varswap_strike_heston(HP["v0"], HP["kappa"], HP["theta"], 1.0)
    km, se = tv.varswap_strike_mc(100.0, 0.03, 0.0, 1.0, heston=HP,
                                  n_steps=64, n_paths=16_384, seed=5, **CPU)
    assert abs(km - kh) < 4.0 * se + 5e-4
    km, se = tv.varswap_strike_mc(100.0, 0.03, 0.0, 1.0, merton=MERTON,
                                  n_steps=252, n_paths=16_384, seed=7, **CPU)
    assert abs(km - (0.04 + 0.5 * (0.1**2 + 0.15**2))) < 5.0 * se + 1e-3
    vs, vse = tv.volswap_strike_mc(100.0, 0.03, 0.0, 1.0, heston=HP,
                                   n_steps=64, n_paths=16_384, seed=3, **CPU)
    assert vs < np.sqrt(kh) - 2.0 * vse and np.sqrt(kh) - vs < 0.02
    assert tv.varswap_strike_replication(0.25, 100.0, 0.03, 0.0, 2.0,
                                         **CPU) == pytest.approx(0.0625,
                                                                 rel=1e-5)
    for bad in (dict(), dict(sigma=0.2, heston=HP)):
        with pytest.raises(ValueError):
            tv.varswap_strike_mc(100.0, 0.03, 0.0, 1.0, **bad, **CPU)
    with pytest.raises(ValueError):
        tv.varswap_strike_replication(0.2, 100.0, 0.03, 0.0, 0.0, **CPU)
    with pytest.raises(ValueError):
        tv.varswap_strike_heston(0.04, -1.0, 0.04, 1.0)


def test_cliquet_oracles():
    rub = tcl.forward_start_price(100.0, 1.0, 0.5, 1.0, 0.03, sigma=0.2,
                                  **CPU)
    px, se = tcl.forward_start_price(100.0, 1.0, 0.5, 1.0, 0.03, sigma=0.2,
                                     method="mc", n_steps=16,
                                     n_paths=65_536, seed=1, **CPU)
    assert abs(px - rub) < 4.0 * se
    kw = dict(sigma=0.2, n_periods=12, local_floor=-0.02, local_cap=0.05)
    cb = tcl.cliquet_price_bs(100.0, 1.0, 0.03, 0.0, **kw)
    cm, cse = tcl.cliquet_price_mc(100.0, 1.0, 0.03, 0.0, **kw,
                                   n_paths=65_536, seed=2, **CPU)
    assert abs(cm - cb) < 4.0 * cse
    gm, _ = tcl.cliquet_price_mc(100.0, 1.0, 0.03, 0.0, **kw,
                                 global_floor=0.05, n_paths=65_536, seed=2,
                                 **CPU)
    assert gm > cm
    for bad in (dict(T0=1.5), dict(k=-1.0), dict(kind="straddle"),
                dict(method="lattice"), dict(method="closed", sigma=None,
                                             heston=HP)):
        args = dict(S0=100.0, k=1.0, T0=0.5, T=1.0, r=0.03, sigma=0.2)
        args.update(bad)
        with pytest.raises(ValueError):
            tcl.forward_start_price(**args, **CPU)
    with pytest.raises(ValueError):
        tcl.forward_start_price(100.0, 1.0, 0.3, 1.0, 0.03, heston=HP,
                                n_steps=4, **CPU)
    with pytest.raises(ValueError):
        tcl.cliquet_price_bs(100.0, 1.0, 0.03, sigma=0.2, local_floor=0.1,
                             local_cap=0.05)


def test_rough_oracles():
    _, v = tr.rbergomi_paths(100.0, 0.0, 0.0, 1.0, 16, 65_536, seed=3,
                             return_variance=True, **BFG, **CPU)
    ev = v.numpy().mean(axis=1)
    assert np.all(np.abs(ev - BFG["xi0"]) < 0.06 * BFG["xi0"])
    S = tr.rbergomi_paths(100.0, 0.0, 0.0, 1.0, 32, 65_536, seed=5, **BFG,
                          **CPU)
    ST = S[-1].numpy()
    assert S.shape == (33, 65_536) and np.all(S[0].numpy() == 100.0)
    assert abs(ST.mean() - 100.0) < 4.0 * ST.std(ddof=1) / np.sqrt(
        ST.size) + 0.1
    p, se = tr.rbergomi_price(100.0, 100.0, 1.0, 0.05, xi0=0.04, eta=1e-9,
                              H=0.5, rho=0.0, n_steps=32, n_paths=65_536,
                              seed=5, **CPU)
    ref = float(bs_price_vec(100.0, 100.0, 1.0, 0.05, 0.0, 0.2, "call",
                             device="cpu"))
    assert abs(p - ref) < 3.0 * se + 0.01
    put, _ = tr.rbergomi_price(100.0, 100.0, 1.0, 0.05, kind="put",
                               xi0=lambda t: 0.04 + 0.01 * t, eta=1.0,
                               H=0.2, rho=-0.5, n_steps=16, n_paths=4_096,
                               seed=1, **CPU)
    assert put > 0.0
    for bad in (dict(H=0.7), dict(rho=1.5), dict(eta=-1.0)):
        args = dict(BFG)
        args.update(bad)
        with pytest.raises(ValueError):
            tr.rbergomi_paths(100.0, 0.0, 0.0, 1.0, 8, 64, **args, **CPU)
    with pytest.raises(ValueError):
        tr.rbergomi_price(100.0, 100.0, 1.0, 0.0, kind="fwd", **BFG, **CPU)
