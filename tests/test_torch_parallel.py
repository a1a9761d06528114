"""Port vs reference: ``parallel/`` — the single-controller mesh, the three
sharded kernel entries, the batch pricers and the ``mesh=`` routes.

* The mesh API: ``optpricer_tpu_torch.parallel`` exports the reference's
  four ``mesh`` names and ``parallel.batch`` its four ``batch`` names, with
  the reference's parameters; layouts, repeats and refusals.
* The sharded kernel entries' plain versions (each shard the plain
  version over its program offset, then the ordered sum) on
  ``get_mesh(devices=["cpu"] * 8)`` against the reference's sharded
  entries on its 8-device CPU mesh, interpreted Pallas on the same
  ``sw_prng`` stream, at the smallest grids (one or two programs a
  device): counts equal, every other stat within rtol 2e-5, the kernels'
  f32 tolerance (the path kernel's signed Greek sums within
  2e-5·√(n·ΣY²)); a (2, 4) multislice mesh shards as its row-major list.
* The batch pricers against the reference's on an 8-device mesh: 1e-12
  (Black-Scholes), 1e-10 (CRR), 1e-8 + 1e-10 relative (FD), as
  ``tests/test_parallel.py`` holds them.
* Every ``mesh=`` route of the engines on a 4-way CPU mesh within
  5·hypot(se, se) of its one-device call, and each reference refusal with
  its message.
"""
import inspect

import numpy as np
import pytest
import torch

import optpricer_tpu as jp
from optpricer_tpu import parallel as jpar
from optpricer_tpu.ops import pallas_basket_mc as jbk
from optpricer_tpu.ops import pallas_mc as jmc
from optpricer_tpu.ops import pallas_path_mc as jpm
from optpricer_tpu.parallel import batch as jbatch
import optpricer_tpu_torch as tp
from optpricer_tpu_torch import parallel as tpar
from optpricer_tpu_torch.ops import basket_mc as tbk
from optpricer_tpu_torch.ops import path_mc as tpm
from optpricer_tpu_torch.ops import terminal_mc as tmc
from optpricer_tpu_torch.parallel import batch as tbatch
from tests.torch_threads import torch_one_thread  # noqa: F401

MARKET = (100.0, 110.0, 1.0, 0.03, 0.01, 0.2)
RTOL = 2e-5
CPU8 = ["cpu"] * 8


def _assert_stats(got, ref, signed=()):
    got = np.asarray(got.numpy(), np.float64)
    ref = np.asarray(ref, np.float64)
    assert got[0] == ref[0]
    unsigned = [i for i in range(1, got.size) if i not in signed]
    np.testing.assert_allclose(got[unsigned], ref[unsigned], rtol=RTOL,
                               atol=0.0)
    for i in signed:
        assert abs(got[i] - ref[i]) <= RTOL * np.sqrt(ref[0] * ref[i + 1]), i


# ---------------------------------------------------------------------------
# the mesh API
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("module, names", [
    ("", ("get_mesh", "get_mesh_multislice", "mesh_axes",
          "mc_sumstats_sharded")),
    ("batch", ("bs_price_sharded", "bs_greeks_sharded", "crr_vec_sharded",
               "fd_batch_sharded"))])
def test_exports_match_reference(module, names):
    ref = jbatch if module else jpar
    got = tbatch if module else tpar
    for name in names:
        assert hasattr(got, name) and hasattr(ref, name), name
        assert list(inspect.signature(getattr(got, name)).parameters) == \
            list(inspect.signature(getattr(ref, name)).parameters), name
    if module:
        assert sorted(got.__all__) == sorted(ref.__all__)


def test_mesh_layouts_and_refusals(monkeypatch):
    mesh = tpar.get_mesh(devices=CPU8)
    assert mesh.devices.size == 8 and tpar.mesh_axes(mesh) == ("paths",)
    assert tpar.get_mesh(3, axis="x", devices=CPU8).devices.shape == (3,)
    ms = tpar.get_mesh_multislice(2, devices=CPU8)
    assert ms.devices.shape == (2, 4)
    assert tpar.mesh_axes(ms) == ("slice", "chip")
    assert ms.shape == {"slice": 2, "chip": 4}
    assert all(d == torch.device("cpu") for d in ms.device_list)
    with pytest.raises(ValueError, match="need 10 devices"):
        tpar.get_mesh_multislice(2, 5, devices=CPU8)
    with pytest.raises(ValueError, match="cannot lay out"):
        tpar.get_mesh_multislice(0, 2, devices=CPU8)
    with pytest.raises(ValueError, match="at least one"):
        tpar.get_mesh(devices=[])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            tpar.get_mesh()
        with pytest.raises(RuntimeError, match="cuda"):
            tpar.get_mesh(devices=["cuda:0"] * 2)
    # a mixed mesh is refused whether or not the card is there
    monkeypatch.setattr(tpar.mesh, "resolve_device", torch.device)
    with pytest.raises(ValueError, match="one device type"):
        tpar.get_mesh(devices=["cpu", "cuda:0"])


# ---------------------------------------------------------------------------
# the sharded kernel entries against the reference's, on 8-device meshes
# ---------------------------------------------------------------------------
def _meshes(layout):
    if layout == "1d":
        return jpar.get_mesh(8), tpar.get_mesh(devices=CPU8)
    return (jpar.get_mesh_multislice(2, 4),
            tpar.get_mesh_multislice(2, 4, devices=CPU8))


@pytest.mark.parametrize("layout", ["1d", "2x4"])
@pytest.mark.parametrize("is_call", [True, False])
def test_terminal_sharded_matches_reference(layout, is_call):
    jmesh, tmesh = _meshes(layout)
    n = 16 * 2 * tmc.TILE - 777          # two programs a device
    ref = jmc.mc_sumstats_pallas_sharded(jmesh, 7, n, *MARKET, is_call,
                                         antithetic=True)
    got = tmc.mc_sumstats_kernel_sharded(tmesh, 7, n, *MARKET, is_call,
                                         antithetic=True)
    assert got.device == torch.device("cpu") and got.shape == (13,)
    _assert_stats(got, ref)


@pytest.mark.parametrize("payoff, kw", [
    ("vanilla", dict(greek_stats=True)),
    ("barrier", dict(greek_stats=True, barrier=125.0)),
    ("asian", dict(geo_cv=True)),
    ("vanilla", dict(heston=dict(v0=0.04, kappa=1.5, theta=0.05, xi=0.6,
                                 rho=-0.7), scheme="qe")),
], ids=["vanilla-greeks", "barrier-greeks", "asian-geo_cv", "heston_qe"])
def test_path_sharded_matches_reference(payoff, kw):
    n = 8 * tpm.TILE - 100               # one program a device
    args = (9, n, 4, *MARKET, True)
    ref = jpm.path_mc_sumstats_pallas_sharded(
        jpar.get_mesh(8), *args, payoff=payoff, antithetic=True, **kw)
    got = tpm.path_mc_sumstats_kernel_sharded(
        tpar.get_mesh(devices=CPU8), *args, payoff=payoff, antithetic=True,
        **kw)
    assert got.shape == (tpm.NSTAT,)
    _assert_stats(got, ref, signed=(11, 13, 15, 17, 19)
                  if kw.get("greek_stats") else ())


@pytest.mark.parametrize("payoff, barrier_type", [
    ("asian_basket", "down-and-in"), ("worstof_barrier", "down-and-in"),
    ("basket_barrier", "up-and-out")])
def test_basket_sharded_matches_reference(payoff, barrier_type):
    a = 3
    corr = 0.5 * np.eye(a) + 0.5
    chol = np.linalg.cholesky(corr)
    n = 8 * tbk.TILE - 37
    args = (4, n, 4, [100.0, 95.0, 105.0], [0.4, 0.3, 0.3], 100.0, 1.0,
            0.03, [0.0, 0.01, 0.02], [0.2, 0.3, 0.25], chol, True)
    kw = dict(payoff=payoff, antithetic=True,
              barrier=85.0 if barrier_type.startswith("down") else 125.0,
              barrier_type=barrier_type, rebate=1.0)
    ref = jbk.basket_path_sumstats_pallas_sharded(jpar.get_mesh(8), *args,
                                                  **kw)
    got = tbk.basket_path_sumstats_kernel_sharded(
        tpar.get_mesh(devices=CPU8), *args, **kw)
    _assert_stats(got, ref)


def test_sharded_sum_is_the_ordered_sum_of_shards():
    """The entry's result is the shards' plain stats added in mesh order,
    bit for bit."""
    mesh = tpar.get_mesh(devices=["cpu"] * 4)
    n = 5 * 2 * tmc.TILE + 99
    reps, per, shards = tmc._shard_plan(mesh, n, 2 * tmc.TILE)
    params = tmc._terminal_params(n, *MARKET, True)
    parts = [tmc._mc_sumstats_plain(tmc._seed_pair(3, "cpu", off), params,
                                    n_programs=per, reps=reps,
                                    antithetic=False)
             for _, off in shards]
    want = parts[0] + parts[1] + parts[2] + parts[3]
    got = tmc.mc_sumstats_kernel_sharded(mesh, 3, n, *MARKET, True,
                                         antithetic=False)
    assert torch.equal(got, want)
    assert [off for _, off in shards] == [0, per, 2 * per, 3 * per]


# ---------------------------------------------------------------------------
# batch pricers
# ---------------------------------------------------------------------------
def test_batch_pricers_match_reference():
    jmesh, tmesh = jpar.get_mesh(8), tpar.get_mesh(devices=CPU8)
    rng = np.random.default_rng(0)
    B = 37                                  # ragged: padded to 40
    S = rng.uniform(80, 120, B)
    K = rng.uniform(80, 120, B)
    T = rng.uniform(0.1, 2.0, B)
    sig = rng.uniform(0.1, 0.5, B)
    kinds = np.where(rng.random(B) > 0.5, "call", "put")
    mask = kinds == "call"
    args = (S, K, T, 0.03, 0.01, sig, mask)
    np.testing.assert_allclose(tbatch.bs_price_sharded(tmesh, *args),
                               jbatch.bs_price_sharded(jmesh, *args),
                               rtol=1e-12, atol=1e-12)
    got = tbatch.bs_greeks_sharded(tmesh, *args)
    ref = jbatch.bs_greeks_sharded(jmesh, *args)
    assert got.keys() == ref.keys()
    for k in ref:
        assert got[k].shape == (B,)
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-12, atol=1e-12)
    strikes = np.linspace(80.0, 120.0, 11)
    for american in (False, True):
        np.testing.assert_allclose(
            tbatch.crr_vec_sharded(tmesh, 100.0, strikes, 1.0, 0.05, 0.0,
                                   0.2, "put", N=200, american=american),
            jbatch.crr_vec_sharded(jmesh, 100.0, strikes, 1.0, 0.05, 0.0,
                                   0.2, "put", N=200, american=american),
            rtol=1e-10, atol=1e-12)
        got = tbatch.fd_batch_sharded(tmesh, 100.0, strikes, 1.0, 0.05,
                                      0.0, 0.2, "put", N_S=128, N_t=64,
                                      american=american)
        ref = np.asarray(jbatch.fd_batch_sharded(
            jmesh, 100.0, strikes, 1.0, 0.05, 0.0, 0.2, "put", N_S=128,
            N_t=64, american=american))
        assert got.shape == (11,)
        np.testing.assert_allclose(got, ref, rtol=1e-8, atol=1e-10)


# ---------------------------------------------------------------------------
# the engines' mesh= routes
# ---------------------------------------------------------------------------
HESTON = dict(v0=0.04, kappa=1.5, theta=0.05, xi=0.6, rho=-0.7)
M4 = dict(devices=["cpu"] * 4)


def _surface():
    sl = {Tx: tp.SVIParams(a=0.04 * Tx, b=0.02, rho=-0.3, m=0.0, sigma=0.2,
                           expiry=Tx) for Tx in (0.25, 0.5, 1.0)}
    return tp.VolSurface(sl, device="cpu")


def _route(name):
    """(call(mesh or None) -> (price, stderr) or Greek dict, Greek key)."""
    spec = tp.OptionSpec(S0=100.0, K=105.0, T=1.0, r=0.03, sigma=0.2,
                         q=0.01)
    mkt = (100.0, 105.0, 1.0, 0.03, 0.01)
    small = dict(n_steps=8, n_paths=8192, seed=3)
    book = dict(S0s=[100.0, 95.0, 105.0], weights=[0.4, 0.3, 0.3],
                K=100.0, T=1.0, r=0.03, sigmas=[0.2, 0.3, 0.25],
                corr=0.5 * np.eye(3) + 0.5)

    def dev(mesh):
        return dict(mesh=mesh) if mesh is not None else dict(device="cpu")

    routes = {
        "euro-kernel": lambda m: tp.euro_price_mc(
            spec, n_paths=1 << 17, seed=5, **dev(m)),
        "euro-xla": lambda m: tp.euro_price_mc(
            spec, n_paths=40_000, seed=5, backend="xla", chunk_size=5000,
            **dev(m)),
        "euro-greeks": (lambda m: tp.euro_greeks_mc(
            spec, n_paths=1 << 17, seed=5, **dev(m)), "delta"),
        "exotic-kernel": lambda m: tp.exotic_price_mc(
            "asian", *mkt, sigma=0.2, control_variate=True, **small,
            **dev(m)),
        "exotic-scan": lambda m: tp.exotic_price_mc(
            "vanilla", *mkt, merton=dict(sigma=0.2, lam=0.5, mJ=-0.1,
                                          sJ=0.15), **small, **dev(m)),
        "exotic-scan-geo": lambda m: tp.exotic_price_mc(
            "asian", *mkt, sigma=0.2, control_variate=True, backend="xla",
            **small, **dev(m)),
        "greeks-kernel": (lambda m: tp.exotic_greeks_mc(
            "vanilla", *mkt, sigma=0.2, **small, **dev(m)), "vega"),
        "greeks-ad": (lambda m: tp.exotic_greeks_mc(
            "vanilla", *mkt, heston=HESTON, n_steps=8, n_paths=4096, seed=3,
            **dev(m)), "d_v0"),
        "dupire-kernel": lambda m: tp.exotic_price_mc_dupire(
            "vanilla", _surface(), *mkt, **small, **dev(m)),
        "basket-price": lambda m: tp.basket_price_mc(
            **book, n_paths=20_000, seed=3, **dev(m)),
        "basket-kernel": lambda m: tp.basket_exotic_mc(
            **book, n_steps=8, n_paths=8192, seed=3, **dev(m)),
        "basket-scan": lambda m: tp.basket_exotic_mc(
            **book, n_steps=8, n_paths=8192, seed=3, backend="xla",
            **dev(m)),
    }
    route = routes[name]
    return route if isinstance(route, tuple) else (route, None)


@pytest.mark.parametrize("name", [
    "euro-kernel", "euro-xla", "euro-greeks", "exotic-kernel", "exotic-scan",
    "exotic-scan-geo", "greeks-kernel", "greeks-ad", "dupire-kernel",
    "basket-price", "basket-kernel", "basket-scan"])
def test_mesh_route_meets_one_device_call(name):
    call, greek = _route(name)
    mesh = tpar.get_mesh(**M4)
    got, one = call(mesh), call(None)
    if greek is None:
        (p1, s1), (p0, s0) = got, one
    elif f"{greek}_stderr" in one:
        p1, s1 = got[greek], got[f"{greek}_stderr"]
        p0, s0 = one[greek], one[f"{greek}_stderr"]
    else:   # euro_greeks_mc has no Greek stderrs: the price's kernel stderr
        p1, p0 = got[greek], one[greek]
        s1 = s0 = 0.01 * abs(p0)
    assert np.isfinite(p1) and s1 > 0.0
    assert abs(p1 - p0) <= 5.0 * np.hypot(s1, s0), (p1, p0, s1, s0)


def test_lsv_mesh_routes():
    model = tp.lsv_calibrate(_surface(), HESTON, 100.0, 0.03, 0.01, T=1.0,
                             n_steps=8, n_paths=4096, n_bins=32, seed=1,
                             device="cpu")
    mesh = tpar.get_mesh(**M4)
    for backend in ("auto", "xla"):
        kw = dict(n_paths=8192, seed=2, backend=backend)
        p1, s1 = tp.lsv_price_mc("vanilla", model, 100.0, mesh=mesh, **kw)
        p0, s0 = tp.lsv_price_mc("vanilla", model, 100.0, device="cpu", **kw)
        assert abs(p1 - p0) <= 5.0 * np.hypot(s1, s0), backend
    g1 = tp.lsv_greeks_mc("vanilla", model, 100.0, n_paths=2048, seed=2,
                          mesh=mesh)
    g0 = tp.lsv_greeks_mc("vanilla", model, 100.0, n_paths=2048, seed=2,
                          device="cpu")
    assert g1.keys() == g0.keys()
    assert abs(g1["delta"] - g0["delta"]) <= \
        5.0 * np.hypot(g1["delta_stderr"], g0["delta_stderr"])


def test_mesh_refusals_match_reference():
    jmesh, tmesh = jpar.get_mesh(4), tpar.get_mesh(**M4)
    mkt = (100.0, 100.0, 1.0, 0.03, 0.01)
    sabr = dict(alpha0=2.0, beta=0.5, nu=0.0, rho=0.0)
    with pytest.raises(ValueError) as ref:
        jp.exotic_price_mc("vanilla", *mkt, sabr=sabr, scheme="exact",
                           n_paths=64, n_steps=2, mesh=jmesh)
    with pytest.raises(ValueError) as got:
        tp.exotic_price_mc("vanilla", *mkt, sabr=sabr, scheme="exact",
                           n_paths=64, n_steps=2, mesh=tmesh)
    assert str(got.value) == str(ref.value)
    with pytest.raises(ValueError) as ref:
        jp.exotic_greeks_mc("barrier", *mkt, sigma=0.2, barrier=120.0,
                            n_paths=64, n_steps=3, mesh=jmesh)
    with pytest.raises(ValueError) as got:
        tp.exotic_greeks_mc("barrier", *mkt, sigma=0.2, barrier=120.0,
                            n_paths=64, n_steps=3, mesh=tmesh)
    assert str(got.value) == str(ref.value)
