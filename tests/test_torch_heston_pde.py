"""Port vs reference: ``tridiag_inv`` and the Heston ADI PDE.

* ``ops.tridiag.tridiag_inv`` (K7's plain Thomas solve plus the Newton
  step) against the reference's at 1e-12 in f64, and in f32 within 2e-7
  of the f64 inverse cast to f32 (the reference test's oracle).
* ``_build_operators_dev`` against the reference's host builder
  ``_build_operators`` at atol 1e-12, with and without the knock-out mask
  (tests/test_heston_pde.py:282-330), and in f32 at its floor.
* ``heston_fd_grid`` and the five public functions at 48 x 24 x 64 against
  the reference at rtol 1e-9: European, American, Bermudan, barrier up and
  down (out and in), dividends, Greeks, and the ladder equal to its scalar
  calls; the input guards.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from optpricer_tpu.models import heston_pde as jh
from optpricer_tpu.ops import tridiag as jtri
from optpricer_tpu_torch.models import heston_pde as th
from optpricer_tpu_torch.ops import tridiag as ttri
from tests.torch_threads import torch_one_thread  # noqa: F401

HP = dict(v0=0.04, kappa=1.5, theta=0.04, xi=0.5, rho=-0.6)
GRID = dict(n_x=48, n_v=24, n_t=64)
MKT = (100.0, 110.0, 1.0, 0.05, 0.01)


def _bands(shape, seed):
    rng = np.random.default_rng(seed)
    lo = rng.uniform(-1.0, 0.0, shape)
    hi = rng.uniform(-1.0, 0.0, shape)
    mid = 2.5 + rng.uniform(0.0, 1.0, shape)
    return lo, mid, hi


@pytest.mark.parametrize("shape", [(16,), (5, 16), (2, 3, 12)])
def test_tridiag_inv_matches_reference(shape):
    bands = _bands(shape, 0)
    want = np.asarray(jtri.tridiag_inv(*(jnp.asarray(b) for b in bands)))
    got = ttri.tridiag_inv(*(torch.tensor(b) for b in bands)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    raw = ttri.tridiag_inv(*(torch.tensor(b) for b in bands), newton=False)
    np.testing.assert_allclose(raw.numpy(), want, rtol=0, atol=1e-12)


@pytest.mark.parametrize("shape", [(24,), (6, 48)])
def test_tridiag_inv_float32_at_its_floor(shape):
    bands = _bands(shape, 1)
    f64 = ttri.tridiag_inv(*(torch.tensor(b) for b in bands)).numpy()
    got = ttri.tridiag_inv(*(torch.tensor(b, dtype=torch.float32)
                             for b in bands)).numpy()
    want = f64.astype(np.float32)
    assert np.abs(got - want).max() / np.abs(want).max() < 2e-7


def _grids(n_x=64, n_v=24):
    vbar = 0.04
    xh = 6.0 * np.sqrt(vbar)
    x = np.linspace(np.log(100.0) - xh, np.log(100.0) + xh, n_x)
    u = np.linspace(0.0, 1.0, n_v)
    return x, 10.0 * vbar * np.sinh(3.0 * u) / np.sinh(3.0)


@pytest.mark.parametrize("barrier", [False, True])
def test_device_build_matches_host_oracle(barrier):
    x, v = _grids()
    ko = np.exp(x) >= 130.0 if barrier else None
    args = (x, v, 0.05, 0.01, 1.5, 0.04, 0.5, 1.0 / 128, 0.5)
    Ax, Px, Av, Pv = jh._build_operators(*args, ko_mask=ko)
    ax, px, av, pv = th._build_operators_dev(*args, ko_mask=ko,
                                             device="cpu")
    for got, want in ((ttri.tridiag_dense(*ax), Ax), (px, Px), (av, Av),
                      (pv, Pv)):
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-12)
    # the port's host oracle is the reference's
    for got, want in zip(th._build_operators(*args, ko_mask=ko),
                         (Ax, Px, Av, Pv)):
        np.testing.assert_array_equal(got, want)


def test_device_build_float32_at_its_floor():
    x, v = _grids()
    args = (x, v, 0.05, 0.01, 1.5, 0.04, 0.5, 1.0 / 128, 0.5)
    host = jh._build_operators(*args)
    ax, px, av, pv = th._build_operators_dev(*args, dtype=torch.float32,
                                             device="cpu")
    for got, want in zip((ttri.tridiag_dense(*ax), px, av, pv), host):
        err = np.abs(got.double().numpy() - want).max() / np.abs(want).max()
        assert err < 5e-7, err


CASES = {
    "european call": dict(kind="call"),
    "european put": dict(kind="put", theta_scheme=0.6),
    "american put": dict(kind="put", american=True),
    "american call": dict(kind="call", american=True),
    "bermudan put": dict(kind="put", exercise_dates=[0.25, 0.5, 0.75]),
    "bermudan call with dividend": dict(kind="call",
                                        exercise_dates=[0.5, 0.9],
                                        dividends=[(0.4, 1.0)]),
    "dividends put": dict(kind="put", dividends=[(0.3, 2.0), (0.7, 1.5)]),
    "american put dividend": dict(kind="put", american=True,
                                  dividends=[(0.5, 3.0)]),
}


@pytest.mark.parametrize("case", list(CASES))
def test_price_matches_reference(case):
    kw = dict(**HP, **GRID, **CASES[case])
    want = jh.heston_fd_price(*MKT, **kw)
    got = th.heston_fd_price(*MKT, **kw, device="cpu")
    assert abs(got - want) <= 1e-9 * abs(want), (got, want)


def test_grid_matches_reference():
    kw = dict(**HP, **GRID, kind="put", american=True, x_mult=5.0,
              v_mult=8.0)
    xj, vj, Vj = jh.heston_fd_grid(*MKT, **kw)
    xt, vt, Vt = th.heston_fd_grid(*MKT, **kw, device="cpu")
    np.testing.assert_array_equal(xt, xj)
    np.testing.assert_array_equal(vt, vj)
    np.testing.assert_allclose(Vt, Vj, rtol=1e-9, atol=1e-12)


@pytest.mark.parametrize("btype,level,kw", [
    ("up-and-out", 130.0, dict(kind="call")),
    ("down-and-out", 80.0, dict(kind="put")),
    ("up-and-in", 130.0, dict(kind="call")),
    ("down-and-in", 80.0, dict(kind="put")),
    ("up-and-out", 130.0, dict(kind="put", american=True, rebate=2.0)),
])
def test_barrier_matches_reference(btype, level, kw):
    args = (100.0, 100.0, 1.0, 0.05, 0.0)
    want = jh.heston_fd_price_barrier(*args, **HP, barrier=level,
                                      barrier_type=btype, **kw, **GRID)
    got = th.heston_fd_price_barrier(*args, **HP, barrier=level,
                                     barrier_type=btype, **kw, **GRID,
                                     device="cpu")
    assert abs(got - want) <= 1e-9 * abs(want), (got, want)


def test_greeks_match_reference():
    want = jh.heston_fd_greeks(100.0, 100.0, 1.0, 0.05, 0.0, **HP, **GRID)
    got = th.heston_fd_greeks(100.0, 100.0, 1.0, 0.05, 0.0, **HP, **GRID,
                              device="cpu")
    assert got.keys() == want.keys()
    for k in want:
        assert abs(got[k] - want[k]) <= 1e-9 * abs(want[k]), k


@pytest.mark.parametrize("american", [False, True])
def test_ladder_matches_reference_and_its_scalar_calls(american):
    K = np.array([90.0, 100.0, 110.0, 120.0])
    kinds = np.array(["call", "put", "put", "call"])
    kw = dict(**HP, **GRID, american=american)
    want = jh.heston_fd_price_batch(100.0, K, 1.0, 0.05, 0.01, kind=kinds,
                                    **kw)
    got = th.heston_fd_price_batch(100.0, K, 1.0, 0.05, 0.01, kind=kinds,
                                   **kw, device="cpu")
    np.testing.assert_allclose(got, want, rtol=1e-9)
    singles = [th.heston_fd_price(100.0, k, 1.0, 0.05, 0.01, kind=kd, **kw,
                                  device="cpu") for k, kd in zip(K, kinds)]
    np.testing.assert_array_equal(got, singles)
    scalar = th.heston_fd_price_batch(100.0, 100.0, 1.0, 0.05, 0.01,
                                      kind="put", **kw, device="cpu")
    assert np.shape(scalar) == ()


def test_guards_match_reference():
    for bad in (dict(kind="straddle"), dict(theta_scheme=0.0),
                dict(american=True, exercise_dates=[0.5])):
        for fn, dev in ((jh.heston_fd_price, {}),
                        (th.heston_fd_price, {"device": "cpu"})):
            with pytest.raises(ValueError):
                fn(*MKT, **HP, **GRID, **dev, **bad)
    for bad in (dict(barrier_type="sideways"),
                dict(barrier_type="up-and-in", american=True),
                dict(barrier_type="up-and-in", rebate=1.0)):
        with pytest.raises(ValueError):
            th.heston_fd_price_barrier(*MKT, **HP, barrier=130.0, **GRID,
                                       **bad, device="cpu")
    with pytest.raises(ValueError):
        th.heston_fd_price_batch(100.0, [100.0], 1.0, 0.05, kind="fwd",
                                 **HP, **GRID, device="cpu")
