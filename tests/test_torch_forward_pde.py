"""Port vs reference: the Dupire forward PDE.

* The constant-vol surface (the host-built propagator, the port's CPU
  route) and the local-vol surface (SVI Dupire σ_loc, K7's plain Thomas
  solve a step against the reference's log-depth scan) at n_y 128 and
  n_t 64, calls and puts, at rtol 1e-9 of the surface's largest price.
* The card's propagator build (``_prop_device``: one tridiagonal solve of
  A against [B | e_0 | e_{M−1}], here by K7's plain version) against the
  host banded LU entrywise at 1e-13 of each column's largest entry.
* The float32 ATM error at 128 x 64 and 512 x 256 no worse than the
  reference's float32 march.
* ``dupire_forward_price``, ``forward_surface_iv`` and
  ``reprice_surface_forward`` against the reference; the guards.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from optpricer_tpu.models import calibration as jc
from optpricer_tpu.models import forward_pde as jf
from optpricer_tpu_torch.models import calibration as tc
from optpricer_tpu_torch.models import forward_pde as tf
from optpricer_tpu_torch.ops.black_scholes import bs_price_vec
from tests.torch_threads import torch_one_thread  # noqa: F401

S0, R, Q = 100.0, 0.03, 0.01
SMALL = dict(n_y=128, n_t=64)
SVI = {T: dict(a=0.02 * T, b=0.1, rho=-0.3, m=0.0, sigma=0.2)
       for T in (0.25, 0.5, 1.0)}
FWD = {T: S0 * np.exp((R - Q) * T) for T in SVI}


def _surfaces():
    j = jc.VolSurface({T: jc.SVIParams(**p, expiry=T) for T, p in
                       SVI.items()}, forward_curve=FWD)
    t = tc.VolSurface({T: tc.SVIParams(**p, expiry=T) for T, p in
                       SVI.items()}, forward_curve=FWD, device="cpu")
    return j, t


def _same_surface(got, want):
    np.testing.assert_array_equal(got.K, want.K)
    np.testing.assert_array_equal(got.T, want.T)
    for a, b in ((got.C, want.C), (got.P, want.P)):
        np.testing.assert_allclose(a, b, rtol=0,
                                   atol=1e-9 * np.abs(b).max())


@pytest.mark.parametrize("kw", [dict(sigma=0.2, T=1.0),
                                dict(sigma=0.3, T=2.0, rannacher=0),
                                dict(sigma=0.25, T=0.5, theta=0.6,
                                     rannacher=4)])
def test_constant_vol_surface_matches_reference(kw):
    want = jf.dupire_forward_surface(S0, R, Q, **kw, **SMALL)
    got = tf.dupire_forward_surface(S0, R, Q, **kw, **SMALL, device="cpu")
    _same_surface(got, want)


def test_local_vol_surface_matches_reference():
    js, ts = _surfaces()
    want = jf.dupire_forward_surface(
        S0, R, Q, T=1.0, sigma_loc=jc.dupire_local_vol_func(js, R, Q),
        **SMALL)
    got = tf.dupire_forward_surface(
        S0, R, Q, T=1.0, sigma_loc=tc.dupire_local_vol_func(ts, R, Q),
        **SMALL, device="cpu")
    _same_surface(got, want)


@pytest.mark.parametrize("th", [1.0, 0.5])
def test_propagator_build_matches_host_banded_lu(th):
    y = np.linspace(np.log(S0) - 1.2, np.log(S0) + 1.2, 257)
    args = (y, 1.0 / 128, 0.05, 0.01, 0.2, th)
    host = tf._prop_host(*args)
    dev = tf._prop_device(*args, torch.device("cpu"))
    for h, d in zip(host[:3], dev[:3]):
        err = np.abs(d.numpy() - h).max(axis=0) / np.abs(h).max(axis=0)
        assert err.max() <= 1e-13, err.max()
    assert dev[3:] == host[3:]


@pytest.mark.parametrize("n_y,n_t", [(128, 64), (512, 256)])
def test_float32_atm_error_no_worse_than_reference(n_y, n_t):
    kw = dict(T=1.0, sigma=0.2, n_y=n_y, n_t=n_t)
    atm = float(bs_price_vec(S0, 100.0, 1.0, R, Q, 0.2, "call",
                             device="cpu"))
    want = jf.dupire_forward_surface(S0, R, Q, **kw, dtype=jnp.float32)
    got = tf.dupire_forward_surface(S0, R, Q, **kw, dtype=torch.float32,
                                    device="cpu")
    assert abs(got.price(100.0, 1.0) - atm) <= \
        abs(want.price(100.0, 1.0) - atm)


def test_price_and_iv_readouts_match_reference():
    K, T = np.array([80.0, 95.0, 100.0, 120.0]), np.array([0.3, 0.5, 1.0,
                                                            0.75])
    for kind in ("call", "put"):
        want = jf.dupire_forward_price(S0, K, T, R, Q, kind=kind, sigma=0.2,
                                       **SMALL)
        got = tf.dupire_forward_price(S0, K, T, R, Q, kind=kind, sigma=0.2,
                                      **SMALL, device="cpu")
        np.testing.assert_allclose(got, want, rtol=1e-9)
    fj = jf.dupire_forward_surface(S0, R, Q, T=1.0, sigma=0.2, **SMALL)
    ft = tf.dupire_forward_surface(S0, R, Q, T=1.0, sigma=0.2, **SMALL,
                                   device="cpu")
    np.testing.assert_allclose(tf.forward_surface_iv(ft, K, T, device="cpu"),
                               jf.forward_surface_iv(fj, K, T), rtol=1e-8)
    assert isinstance(tf.forward_surface_iv(ft, 100.0, 1.0, device="cpu"),
                      float)
    assert isinstance(ft.price(100.0, 1.0), float)


def test_reprice_surface_matches_reference():
    js, ts = _surfaces()
    kw = dict(**SMALL, k_lo=-0.5, k_hi=0.5, n_k=9)
    want = jf.reprice_surface_forward(js, S0, R, Q, **kw)
    got = tf.reprice_surface_forward(ts, S0, R, Q, **kw, device="cpu")
    assert got.keys() == want.keys()
    for T in want:
        for a, b in zip(got[T], want[T]):
            np.testing.assert_allclose(a, b, rtol=1e-8, equal_nan=True)


def test_guards():
    for bad in (dict(), dict(sigma=0.2, sigma_loc=lambda K, t: K),
                dict(sigma=0.2, n_y=4), dict(sigma=0.2, T_bad=True)):
        T = -1.0 if bad.pop("T_bad", False) else 1.0
        with pytest.raises(ValueError):
            tf.dupire_forward_surface(S0, R, Q, T=T, **bad, device="cpu")
    fs = tf.dupire_forward_surface(S0, R, Q, T=1.0, sigma=0.2, n_y=16,
                                   n_t=4, device="cpu")
    with pytest.raises(ValueError):
        fs.price(100.0, 0.5, kind="straddle")
