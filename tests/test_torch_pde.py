"""Port vs reference: the θ-scheme FD engines (``models/pde.py``) and the
Galerkin FEM (``models/fem.py``), on the CPU in float64.

Every public function runs in both packages on the same inputs and must
agree to rtol 1e-9: θ ∈ {0, ½, 1}; every per-step solver; projection and
PSOR; discrete dividends; node and operator barriers, in and out, both
rebate modes; the double barrier; the grid Greeks; local vol (the smile
written once in jnp and once in torch) and both ladder functions. The
per-step algorithms differ only where the port's doubling scans or K7's
plain Thomas loop round differently from XLA's scans (1e-16-1e-14
relative measured). The five FD and FEM goldens of ``tests/goldens.json``
are met at their own rtol 1e-9.
"""
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from optpricer_tpu import OptionSpec as JSpec
from optpricer_tpu.models import fem as jfem
from optpricer_tpu.models import pde as jpde
import optpricer_tpu_torch as tp
from optpricer_tpu_torch.models import fem as tfem
from optpricer_tpu_torch.models import pde as tpde
from tests.golden_cases import GOLDEN_PATH
from tests.torch_threads import torch_one_thread  # noqa: F401

RTOL = 1e-9
MKT = dict(S0=100.0, K=100.0, T=1.0, r=0.05, sigma=0.2)
GRID = dict(N_S=64, N_t=32)
DIVS = [(0.3, 1.5), (0.7, 2.0)]


def _specs(**kw):
    m = dict(MKT, **kw)
    return JSpec(**m), tp.OptionSpec(**m)


def _close(got, ref, rtol=RTOL):
    np.testing.assert_allclose(np.asarray(got, float), np.asarray(ref, float),
                               rtol=rtol, atol=0.0)


def _jsmile(S, t):
    return 0.2 + 0.1 * jnp.exp(-((jnp.log(S / 100.0)) ** 2)) + 0.05 * t


def _tsmile(S, t):
    return 0.2 + 0.1 * torch.exp(-((torch.log(S / 100.0)) ** 2)) + 0.05 * t


@pytest.mark.parametrize("theta", [0.0, 0.5, 1.0])
@pytest.mark.parametrize("solver", list(tpde._SOLVERS))
def test_fd_price_every_solver_and_theta(solver, theta):
    js, ts = _specs()
    ref = jpde.fd_price(js, "put", theta=theta, solver=solver, **GRID)
    got = tp.fd_price(ts, "put", theta=theta, solver=solver, device="cpu",
                      **GRID)
    _close(got, ref)


@pytest.mark.parametrize("method", ["projection", "psor"])
@pytest.mark.parametrize("solver", ["auto", "parallel", "thomas", "pallas"])
def test_fd_price_american(method, solver):
    js, ts = _specs(q=0.02)
    kw = dict(american=True, american_method=method, solver=solver, **GRID)
    _close(tp.fd_price(ts, "put", device="cpu", **kw),
           jpde.fd_price(js, "put", **kw))


@pytest.mark.parametrize("kind, american", [("call", True), ("put", False),
                                            ("call", False)])
def test_fd_price_dividends(kind, american):
    js, ts = _specs()
    kw = dict(american=american, dividends=DIVS, **GRID)
    _close(tp.fd_price(ts, kind, device="cpu", **kw),
           jpde.fd_price(js, kind, **kw))


@pytest.mark.parametrize("barrier_type", ["up-and-out", "up-and-in",
                                          "down-and-out", "down-and-in"])
@pytest.mark.parametrize("barrier_mode", ["node", "operator"])
@pytest.mark.parametrize("rebate_mode", ["expiry", "node"])
def test_fd_price_barrier(barrier_type, barrier_mode, rebate_mode):
    js, ts = _specs()
    B = 130.0 if barrier_type.startswith("up") else 80.0
    kw = dict(rebate=2.0, barrier_mode=barrier_mode, rebate_mode=rebate_mode,
              **GRID)
    _close(tp.fd_price_barrier(ts, "call", B, barrier_type, device="cpu",
                               **kw),
           jpde.fd_price_barrier(js, "call", B, barrier_type, **kw))


@pytest.mark.parametrize("knock, rebate", [("out", 0.0), ("out", 1.0),
                                           ("in", 1.0)])
def test_fd_price_double_barrier(knock, rebate):
    js, ts = _specs()
    kw = dict(lower=80.0, upper=130.0, knock=knock, rebate=rebate, **GRID)
    _close(tp.fd_price_double_barrier(ts, "put", device="cpu", **kw),
           jpde.fd_price_double_barrier(js, "put", **kw))


def test_fd_price_double_barrier_already_knocked():
    js, ts = _specs(S0=140.0)
    for knock in ("out", "in"):
        kw = dict(lower=80.0, upper=130.0, knock=knock, rebate=1.0, **GRID)
        _close(tp.fd_price_double_barrier(ts, "call", device="cpu", **kw),
               jpde.fd_price_double_barrier(js, "call", **kw))


@pytest.mark.parametrize("kw", [dict(), dict(american=True, theta=1.0),
                                dict(dividends=DIVS, solver="thomas")])
def test_fd_greeks(kw):
    js, ts = _specs()
    got = tp.fd_greeks(ts, "put", device="cpu", **GRID, **kw)
    ref = jpde.fd_greeks(js, "put", **GRID, **kw)
    assert set(got) == set(ref)
    for name in ref:
        _close(got[name], ref[name])


@pytest.mark.parametrize("solver", ["auto", "parallel", "thomas", "pallas"])
def test_fd_price_local_vol(solver):
    kw = dict(solver=solver, N_S=64, N_t=32, ref_vol=0.3)
    _close(tp.fd_price_local_vol(100.0, 105.0, 1.0, 0.04, 0.01, _tsmile,
                                 "call", device="cpu", **kw),
           jpde.fd_price_local_vol(100.0, 105.0, 1.0, 0.04, 0.01, _jsmile,
                                   "call", **kw))


def test_fd_price_local_vol_constant_callable_is_bs():
    px = tp.fd_price_local_vol(100.0, 100.0, 1.0, 0.05, 0.0,
                               lambda S, t: 0.2 * torch.ones_like(S), "call",
                               N_S=200, N_t=200, ref_vol=0.2, device="cpu")
    ref = tp.bs_price(tp.OptionSpec(**MKT), "call", device="cpu")
    assert abs(px - ref) / ref < 0.002


@pytest.mark.parametrize("kind, american", [("call", False), ("put", True)])
def test_fd_price_batch(kind, american):
    Ks = np.array([90.0, 100.0, 110.0])
    args = (100.0, Ks, 1.0, 0.05, 0.01, 0.2, kind)
    got = tp.fd_price_batch(*args, american=american, device="cpu", **GRID)
    assert isinstance(got, torch.Tensor) and got.shape == (3,)
    _close(got, jpde.fd_price_batch(*args, american=american, **GRID))


@pytest.mark.parametrize("solver", ["auto", "parallel", "thomas", "pallas"])
def test_fd_price_local_vol_batch(solver):
    Ks = np.array([90.0, 100.0, 110.0])
    kinds = np.array(["call", "put", "call"])
    kw = dict(solver=solver, N_S=64, N_t=32, ref_vol=0.3)
    got = tp.fd_price_local_vol_batch(100.0, Ks, 1.0, 0.04, 0.01, _tsmile,
                                      kinds, device="cpu", **kw)
    _close(got, jpde.fd_price_local_vol_batch(100.0, Ks, 1.0, 0.04, 0.01,
                                              _jsmile, kinds, **kw))


@pytest.mark.parametrize("solver", ["auto", "parallel", "thomas", "pallas"])
@pytest.mark.parametrize("kind", ["call", "put"])
def test_fem_price(solver, kind):
    js, ts = _specs(q=0.01)
    kw = dict(solver=solver, N_S=64, N_t=32)
    _close(tfem.fem_price(ts, kind, device="cpu", **kw),
           jfem.fem_price(js, kind, **kw))


@pytest.mark.parametrize("theta", [0.0, 1.0])
def test_fem_price_theta(theta):
    js, ts = _specs()
    kw = dict(theta=theta, N_S=48, N_t=96)
    _close(tp.fem_price(ts, "call", device="cpu", **kw),
           jfem.fem_price(js, "call", **kw))


_GOLDEN_CALLS = {
    "fd_cn_call": lambda o: tp.fd_price(o, "call", N_S=128, N_t=128,
                                        device="cpu"),
    "fd_amer_put_projection": lambda o: tp.fd_price(
        o, "put", N_S=128, N_t=128, american=True, device="cpu"),
    "fd_amer_put_psor": lambda o: tp.fd_price(
        o, "put", N_S=128, N_t=128, american=True, american_method="psor",
        device="cpu"),
    "fd_barrier_uo_call": lambda o: tp.fd_price_barrier(
        o, "call", 130.0, "up-and-out", N_S=128, N_t=128, device="cpu"),
    "fem_call": lambda o: tp.fem_price(o, "call", N_S=128, N_t=64,
                                       device="cpu"),
}


@pytest.mark.parametrize("name", sorted(_GOLDEN_CALLS))
def test_goldens(name):
    want = json.loads(GOLDEN_PATH.read_text())[name]
    opt = tp.OptionSpec(S0=100.0, K=105.0, T=0.75, r=0.04, sigma=0.22,
                        q=0.01)
    _close(_GOLDEN_CALLS[name](opt), want)


def test_float32_runs_everywhere():
    """dtype="float32": the propagator, PSOR and local vol, against the
    reference's float32 runs to f32 round-off of a 32-step march."""
    js, ts = _specs()
    for kw in (dict(), dict(american=True, american_method="psor")):
        _close(tp.fd_price(ts, "put", dtype="float32", device="cpu",
                           **GRID, **kw),
               jpde.fd_price(js, "put", dtype=jnp.float32, **GRID, **kw),
               rtol=2e-5)
    _close(tp.fd_price_local_vol(100.0, 105.0, 1.0, 0.04, 0.01, _tsmile,
                                 dtype=torch.float32, device="cpu", **GRID),
           jpde.fd_price_local_vol(100.0, 105.0, 1.0, 0.04, 0.01, _jsmile,
                                   dtype=jnp.float32, **GRID), rtol=2e-5)


def test_input_checks_match_reference():
    js, ts = _specs()
    for bad in (dict(solver="lu"),):
        with pytest.raises(ValueError):
            tp.fd_price(ts, "call", device="cpu", **bad)
        with pytest.raises(ValueError):
            jpde.fd_price(js, "call", **bad)
    with pytest.raises(ValueError):
        tp.fd_price_barrier(ts, "call", 120.0, barrier_mode="x",
                            device="cpu")
    with pytest.raises(ValueError):
        tp.fd_price(ts, "call", dividends=[(2.0, 1.0)], device="cpu")
    with pytest.raises(ValueError):
        tp.fd_price_double_barrier(ts, "call", lower=120.0, upper=90.0,
                                   device="cpu")


def test_div_schedule_matches_reference():
    for dt_ in (None, "float32"):
        np.testing.assert_array_equal(
            tpde._div_schedule(DIVS + [(0.31, 0.5)], 1.0, 32, dt_,
                               "cpu").double().numpy(),
            np.asarray(jpde._div_schedule(DIVS + [(0.31, 0.5)], 1.0, 32,
                                          jnp.float32 if dt_ else
                                          jnp.float64), np.float64))
