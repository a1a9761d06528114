"""Port vs reference: the multi-asset stack (``optpricer_tpu_torch/ops/
bvn.py``, ``models/basket.py``, ``ops/basket_mc.py``).

* Closed forms (``bvn_cdf``, ``geometric_basket_price``, ``margrabe_price``,
  ``rainbow_price_stulz``) in float64 at rtol 1e-12. ``bvn_cdf`` also gets
  atol 1e-15, the algorithm's stated absolute accuracy: near |ρ| → 1 the
  expansion branch returns an O(1) difference, and where the true value is
  ~1e-70 both packages return round-off of that difference.
* The Monte-Carlo cores fed the same standard normals: the test swaps
  ``jax.random.normal`` for a function that hands out numpy arrays in call
  order, replaces ``jax.lax.scan`` by a Python loop (so the scan body draws
  once per step) and runs the reference's jitted core through
  ``__wrapped__``; the stats vectors agree at rtol 1e-12 in float64.
* The basket kernel's plain version (K6) against the interpreted TPU
  kernel, fed the reference's own operand through
  ``convert.basket_params``: counts equal, the other five sums at rtol 2e-5
  (the tile sums run in another order than XLA:CPU's reductions, and
  cos/sin differ by an ulp); with non-negative weights X ≥ 0 and Y > 0, so
  every sum is unsigned.
* The port's own draws, statistically: the kernel route against the torch
  scan within 5·(se + se) + 1e-3 (``bench.py``'s gate), the 1-asset limits
  against ``exotic_price_mc`` and Black-Scholes, the closed-form oracles
  within 4 se.
"""
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from optpricer_tpu.models import basket as jb
from optpricer_tpu.ops import bvn as jbvn
from optpricer_tpu.ops import pallas_basket_mc as jbk
from optpricer_tpu.ops import pallas_mc as jmc
import optpricer_tpu_torch as tp
from optpricer_tpu_torch import convert
from optpricer_tpu_torch.models import basket as tb
from optpricer_tpu_torch.ops import basket_mc as tbk
from optpricer_tpu_torch.ops import bvn as tbvn
from optpricer_tpu_torch.ops import terminal_mc as tmc
from tests.torch_threads import torch_one_thread  # noqa: F401

GOLDENS = json.loads((Path(__file__).with_name("goldens.json")).read_text())
RTOL = 1e-12
KRTOL = 2e-5
CORR = np.array([[1.0, 0.5, 0.3], [0.5, 1.0, 0.4], [0.3, 0.4, 1.0]])
SIG = np.array([0.2, 0.3, 0.25])
S0 = np.array([100.0, 95.0, 105.0])
W = np.array([0.4, 0.3, 0.3])
QS = np.array([0.01, 0.0, 0.02])


@pytest.fixture
def feed(monkeypatch):
    """Hand the reference numpy arrays in place of its normal draws, and
    run its scans as Python loops so each step draws anew."""
    queue = []

    def normal(key, shape, dtype=None):
        arr = queue.pop(0)
        assert arr.shape == tuple(shape)
        return jnp.asarray(arr)

    def loop_scan(f, init, xs, length=None):
        n = jax.tree_util.tree_leaves(xs)[0].shape[0]
        carry, ys = init, []
        for i in range(n):
            carry, y = f(carry, jax.tree_util.tree_map(lambda a: a[i], xs))
            ys.append(y)
        if ys[0] is None:
            return carry, None
        return carry, jax.tree_util.tree_map(lambda *a: jnp.stack(a), *ys)

    monkeypatch.setattr(jax.random, "normal", normal)
    monkeypatch.setattr(jax.lax, "scan", loop_scan)
    return queue


def _close(got, ref, rtol=RTOL, atol=0.0):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(ref, np.float64), rtol=rtol,
                               atol=atol)


def _j(*values):
    return [jnp.asarray(v, jnp.float64) for v in values]


def _t(*values):
    return [torch.as_tensor(np.asarray(v, np.float64)) for v in values]


# ---------------------------------------------------------------------------
# closed forms
# ---------------------------------------------------------------------------
def test_bvn_cdf_grid():
    h = np.linspace(-3.0, 3.0, 9)
    k = np.linspace(-2.5, 2.0, 7)
    rho = np.array([-0.9999, -0.999, -0.95, -0.925, -0.5, 0.0, 0.3, 0.925,
                    0.93, 0.999, 0.9999])
    H, K, R = np.meshgrid(h, k, rho, indexing="ij")
    ref = np.asarray(jbvn.bvn_cdf(H, K, R))
    got = tbvn.bvn_cdf(*_t(H, K, R))
    assert got.dtype == torch.float64 and got.shape == H.shape
    _close(got, ref, atol=1e-15)
    # a scalar call and the package export
    assert float(tp.bvn_cdf(0.3, -0.2, 0.4)) == pytest.approx(
        float(jbvn.bvn_cdf(0.3, -0.2, 0.4)), rel=RTOL)


def test_geometric_basket_and_margrabe():
    for kind in ("call", "put"):
        ref = jb.geometric_basket_price(S0, W, 100.0, 1.0, 0.03, QS, SIG,
                                        CORR, kind=kind)
        got = tb.geometric_basket_price(S0, W, 100.0, 1.0, 0.03, QS, SIG,
                                        CORR, kind=kind, device="cpu")
        _close(got, ref)
    ref = jb.margrabe_price(100.0, 95.0, 1.5, 0.01, 0.02, sigma1=0.2,
                            sigma2=0.3, rho=0.4)
    got = tb.margrabe_price(100.0, 95.0, 1.5, 0.01, 0.02, sigma1=0.2,
                            sigma2=0.3, rho=0.4, device="cpu")
    _close(got, ref)


@pytest.mark.parametrize("mode", ["min", "max"])
@pytest.mark.parametrize("kind", ["call", "put"])
@pytest.mark.parametrize("rho", [-0.6, 0.4, 0.97])
def test_rainbow_stulz(mode, kind, rho):
    args = (100.0, 95.0, 98.0, 1.0, 0.03, 0.01, 0.02)
    kw = dict(sigma1=0.2, sigma2=0.3, rho=rho, kind=kind, mode=mode)
    ref = jb.rainbow_price_stulz(*args, **kw)
    got = tb.rainbow_price_stulz(*args, **kw, device="cpu")
    assert isinstance(got, float)
    assert got == pytest.approx(ref, rel=RTOL)


# ---------------------------------------------------------------------------
# Monte-Carlo cores fed the same normals
# ---------------------------------------------------------------------------
N_PATHS, N_STEPS = 256, 6


def _book(a=3):
    return (S0[:a], W[:a] / W[:a].sum(), 100.0, 1.0, 0.03, QS[:a], SIG[:a],
            np.linalg.cholesky(CORR[:a, :a]))


@pytest.mark.parametrize("payoff", ["basket", "spread", "rainbow_max",
                                    "rainbow_min"])
@pytest.mark.parametrize("antithetic", [True, False])
def test_basket_stats_same_normals(feed, payoff, antithetic):
    z = np.random.default_rng(1).standard_normal((N_PATHS, 3))
    book = _book()
    feed.append(z)
    ref = jb._basket_stats.__wrapped__(
        jax.random.key(0), *_j(*book), payoff=payoff, is_call=True,
        n_paths=N_PATHS, antithetic=antithetic, n_assets=3,
        dtype=jnp.float64)
    got = tb._basket_stats(torch.as_tensor(z), *_t(*book), payoff=payoff,
                           is_call=True, antithetic=antithetic)
    _close(got, ref)


@pytest.mark.parametrize("payoff, kind", [("basket", "call"),
                                          ("rainbow_max", "put"),
                                          ("rainbow_min", "call")])
def test_basket_greek_moments_same_normals(feed, payoff, kind):
    z = np.random.default_rng(2).standard_normal((N_PATHS, 3))
    book = _book()
    feed.append(z)
    ref = jb._basket_greek_moments.__wrapped__(
        jax.random.key(0), *_j(*book), payoff=payoff, is_call=kind == "call",
        n_paths=N_PATHS, antithetic=True, n_assets=3, dtype=jnp.float64)
    got = tb._basket_greek_moments(torch.as_tensor(z), *_t(*book),
                                   payoff=payoff, is_call=kind == "call",
                                   antithetic=True)
    _close(got, ref)


PATH_CASES = {
    "asian": ("asian_basket", 0.0, "down-and-in", 0.0, True),
    "worst-up-out": ("worstof_barrier", 118.0, "up-and-out", 0.0, True),
    "worst-down-in": ("worstof_barrier", 85.0, "down-and-in", 1.5, False),
    "basket-up-in": ("basket_barrier", 108.0, "up-and-in", 0.0, False),
    "basket-down-out": ("basket_barrier", 95.0, "down-and-out", 2.0, True),
}


@pytest.mark.parametrize("case", list(PATH_CASES))
def test_basket_path_stats_same_normals(feed, case):
    payoff, barrier, btype, rebate, is_call = PATH_CASES[case]
    rng = np.random.default_rng(3)
    zs = [rng.standard_normal((N_PATHS, 3)) for _ in range(N_STEPS)]
    feed.extend(zs)
    book = _book()
    static = dict(payoff=payoff, is_call=is_call, n_steps=N_STEPS,
                  antithetic=True, barrier_up=btype.startswith("up"),
                  knock_in=btype.endswith("in"))
    ref = jb._basket_path_stats.__wrapped__(
        jax.random.key(0), *_j(*book, barrier, rebate), n_paths=N_PATHS,
        n_assets=3, dtype=jnp.float64, **static)
    assert not feed
    got = tb._basket_path_stats(lambda t: torch.as_tensor(zs[t]),
                                *_t(*book, barrier, rebate), **static)
    _close(got, ref)


# ---------------------------------------------------------------------------
# K6's plain version against the interpreted TPU kernel
# ---------------------------------------------------------------------------
def _market(a):
    rng = np.random.default_rng(10 + a)
    S = rng.uniform(80.0, 120.0, a)
    corr = np.full((a, a), 0.4) + 0.6 * np.eye(a)
    return (S, np.full(a, 1.0 / a), float(S.mean()), 1.0, 0.03,
            rng.uniform(0.0, 0.02, a), rng.uniform(0.15, 0.35, a),
            np.linalg.cholesky(corr))


# (a, payoff, barrier as a fraction of the level at t = 0, type, rebate,
# antithetic, is_call)
K6_CASES = {
    "a3-asian": (3, "asian_basket", 0.0, "down-and-in", 0.0, True, True),
    "a3-asian-put-plain": (3, "asian_basket", 0.0, "down-and-in", 0.0,
                           False, False),
    "a1-worst-up-out": (1, "worstof_barrier", 1.15, "up-and-out", 0.0, True,
                        True),
    "a4-worst-down-in": (4, "worstof_barrier", 0.9, "down-and-in", 1.5,
                         True, False),
    "a3-basket-up-in": (3, "basket_barrier", 1.1, "up-and-in", 0.0, False,
                        True),
    "a4-basket-down-out": (4, "basket_barrier", 0.92, "down-and-out", 2.0,
                           True, True),
}
K6_N = 2 * jbk.TILE + 37     # two full tiles and a remainder
K6_STEPS = 12


def _k6_call(case, seed=5, **over):
    a, payoff, frac, btype, rebate, anti, is_call = K6_CASES[case]
    S, w, K, T, r, qs, sig, chol = _market(a)
    lvl = float(S.min()) if payoff == "worstof_barrier" else float(S @ w)
    kw = dict(payoff=payoff, antithetic=anti, barrier=frac * lvl,
              barrier_type=btype, rebate=rebate)
    kw.update(over)
    return (seed, K6_N, K6_STEPS, S, w, K, T, r, qs, sig, chol, is_call), kw


def _assert_k6_close(got, ref):
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    assert got.shape == ref.shape == (tbk.NSTAT,)
    assert got[0] == ref[0]
    np.testing.assert_allclose(got[1:], ref[1:], rtol=KRTOL, atol=0.0)


@pytest.mark.parametrize("case", list(K6_CASES))
def test_plain_basket_kernel_matches_interpret_kernel(case):
    call, kw = _k6_call(case)
    ref = jbk.basket_path_sumstats_pallas(*call, **kw, interpret=True)
    a = len(call[3])
    b_up = kw["barrier_type"].startswith("up")
    params = jbk._build_params(K6_N, K6_STEPS, *call[3:11],
                               kw["barrier"], kw["rebate"], call[11],
                               kw["payoff"], b_up)
    reps, n_prog = jmc._plan_grid(K6_N, jbk.TILE)
    got = tbk.basket_mc(
        tmc._seed_pair(call[0], "cpu"), convert.basket_params(params),
        n_programs=n_prog, reps=reps, n_assets=a, n_steps=K6_STEPS,
        antithetic=kw["antithetic"], payoff_id=tbk.PAYOFF_IDS[kw["payoff"]],
        barrier_up=b_up, knock_in=kw["barrier_type"].endswith("in"))
    assert got.dtype == torch.float32
    _assert_k6_close(got.numpy(), ref)
    # the public entry point builds the same operand itself
    entry = tbk.basket_path_sumstats_kernel(*call, **kw, device="cpu")
    assert torch.equal(entry, got)


def test_plain_basket_kernel_in_out_identity():
    """Knock-in + knock-out (same barrier, no rebate) = the live payoff on
    the same draws: exact per path, so the sums meet at f32 round-off."""
    call, kw = _k6_call("a3-basket-up-in", seed=9)
    s_in, s_out = (tbk.basket_path_sumstats_kernel(
        *call, **dict(kw, barrier_type=t), device="cpu").double().numpy()
        for t in ("up-and-in", "up-and-out"))
    s_van = tbk.basket_path_sumstats_kernel(
        *call, **dict(kw, barrier=1e12, barrier_type="up-and-out"),
        device="cpu").double().numpy()
    assert abs(s_in[1] + s_out[1] - s_van[1]) < 1e-5 * abs(s_van[1])


def test_basket_params_shape_checked():
    with pytest.raises(ValueError):
        convert.basket_params(np.zeros(10, np.float32))
    with pytest.raises(ValueError, match="MAX_ASSETS"):
        tbk.basket_path_sumstats_kernel(
            1, 100, 4, np.full(17, 100.0), np.full(17, 1 / 17), 100.0, 1.0,
            0.0, None, np.full(17, 0.2), np.eye(17), True,
            payoff="asian_basket", device="cpu")


# ---------------------------------------------------------------------------
# the port's own draws, statistically
# ---------------------------------------------------------------------------
def _exotic(backend, payoff, **extra):
    return tp.basket_exotic_mc(S0, W, 100.0, 1.0, 0.03, sigmas=SIG,
                               corr=CORR, payoff=payoff, n_steps=16,
                               n_paths=1 << 13, seed=11, backend=backend,
                               device="cpu", **extra)


@pytest.mark.parametrize("payoff, extra", [
    ("asian_basket", {}),
    ("worstof_barrier", dict(barrier=80.0, barrier_type="down-and-out")),
    ("basket_barrier", dict(barrier=115.0, barrier_type="up-and-out",
                            rebate=1.0)),
])
def test_kernel_route_matches_torch_scan(payoff, extra):
    p_k, s_k = _exotic("auto", payoff, **extra)
    p_x, s_x = _exotic("xla", payoff, **extra)
    assert s_k > 0.0 and s_x > 0.0
    assert abs(p_k - p_x) < 5 * (s_k + s_x) + 1e-3, (p_k, p_x)


def test_one_asset_limits():
    p_b, se_b = tp.basket_exotic_mc(
        [100.0], [1.0], 100.0, 1.0, 0.04, sigmas=[0.2], corr=[[1.0]],
        payoff="worstof_barrier", barrier=130.0, barrier_type="up-and-out",
        n_steps=16, n_paths=1 << 14, seed=5, device="cpu")
    p_s, se_s = tp.exotic_price_mc(
        "barrier", 100.0, 100.0, 1.0, 0.04, sigma=0.2, barrier=130.0,
        barrier_type="up-and-out", n_steps=16, n_paths=1 << 14, seed=6,
        device="cpu")
    assert abs(p_b - p_s) < 5 * np.hypot(se_b, se_s) + 1e-3
    # basket_price_mc on one asset is Black-Scholes; its pathwise Greeks too
    spec = tp.OptionSpec(S0=100.0, K=100.0, T=1.0, r=0.03, sigma=0.2)
    bs = tp.bs_price(spec, "call", device="cpu")
    px, se = tp.basket_price_mc([100.0], [1.0], 100.0, 1.0, 0.03,
                                sigmas=[0.2], corr=[[1.0]], n_paths=1 << 15,
                                seed=3, control_variate=False, device="cpu")
    assert abs(px - bs) < 4 * se
    g = tp.basket_greeks_mc([100.0], [1.0], 100.0, 1.0, 0.03, sigmas=[0.2],
                            corr=[[1.0]], n_paths=1 << 15, seed=4,
                            device="cpu")
    ref = tp.bs_greeks(spec, "call", device="cpu")
    assert abs(g["delta"][0] - ref["delta"]) < 4 * g["delta_stderr"][0]
    assert abs(g["vega"][0] - ref["vega"]) < 4 * g["vega_stderr"][0]


def test_closed_form_oracles():
    corr2 = [[1.0, 0.4], [0.4, 1.0]]
    kw = dict(sigmas=[0.2, 0.3], corr=corr2, n_paths=1 << 15, seed=7,
              device="cpu")
    px, se = tp.basket_price_mc([100.0, 95.0], [1.0, -1.0], 0.0, 1.0, 0.03,
                                payoff="spread", **kw)
    ref = float(tp.margrabe_price(100.0, 95.0, 1.0, sigma1=0.2, sigma2=0.3,
                                  rho=0.4, device="cpu"))
    assert abs(px - ref) < 4 * se + 1e-4
    for mode in ("min", "max"):
        px, se = tp.basket_price_mc([100.0, 95.0], [0.5, 0.5], 98.0, 1.0,
                                    0.03, payoff=f"rainbow_{mode}", **kw)
        ref = tp.rainbow_price_stulz(100.0, 95.0, 98.0, 1.0, 0.03,
                                     sigma1=0.2, sigma2=0.3, rho=0.4,
                                     mode=mode, device="cpu")
        assert abs(px - ref) < 4 * se + 1e-4, (mode, px, ref)
    # the geometric-basket control variate cuts the stderr, same price
    book = dict(sigmas=SIG, corr=CORR, n_paths=1 << 14, seed=9,
                device="cpu")
    p_cv, se_cv = tp.basket_price_mc(S0, W, 100.0, 1.0, 0.03, **book)
    p_raw, se_raw = tp.basket_price_mc(S0, W, 100.0, 1.0, 0.03,
                                       control_variate=False, **book)
    assert se_cv < 0.2 * se_raw and abs(p_cv - p_raw) < 4 * se_raw


def test_basket_golden_met_statistically():
    """``basket_mc_seed5`` (tests/golden_cases.py: 2 assets, float64, 2^16
    paths) comes from the reference's ``jax.random`` draws; the port draws
    with torch, so the two prices agree within 4·hypot(se, golden se)."""
    golden = GOLDENS["basket_mc_seed5"]
    px, se = tp.basket_price_mc(
        [100.0, 95.0], [0.6, 0.4], 100.0, 1.0, 0.03, sigmas=[0.2, 0.3],
        corr=np.array([[1.0, 0.5], [0.5, 1.0]]), seed=5, n_paths=1 << 16,
        dtype="float64", device="cpu")
    assert abs(px - golden["price"]) <= 4.0 * np.hypot(se, golden["stderr"])
    assert 0.0 < se < 4.0 * golden["stderr"]


def test_guards():
    with pytest.raises(ValueError, match="16 assets"):
        tp.basket_exotic_mc(np.full(20, 100.0), np.full(20, 0.05), 100.0,
                            1.0, 0.03, sigmas=np.full(20, 0.2),
                            corr=np.eye(20), backend="pallas", device="cpu")
    with pytest.raises(ValueError, match="f32"):
        _exotic("pallas", "asian_basket", dtype="float64")
    with pytest.raises(ValueError, match="backend"):
        _exotic("mxu", "asian_basket")
    # mesh= raised until A.15 was ported: both routes now price
    from optpricer_tpu_torch.parallel import get_mesh

    mesh = get_mesh(devices=["cpu"] * 2)
    for price, se in (_exotic("auto", "asian_basket", mesh=mesh),
                      tp.basket_price_mc(S0, W, 100.0, 1.0, 0.03, sigmas=SIG,
                                         corr=CORR, mesh=mesh)):
        assert np.isfinite(price) and 0.0 < se < 0.1 * price
    with pytest.raises(ValueError, match="weights"):
        tp.basket_price_mc(S0, [0.5, 0.6, -0.1], 100.0, 1.0, 0.03,
                           sigmas=SIG, corr=CORR, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            tp.basket_exotic_mc(S0, W, 100.0, 1.0, 0.03, sigmas=SIG,
                                corr=CORR)
