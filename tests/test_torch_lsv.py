"""Port vs reference: the LSV engine (``optpricer_tpu_torch/models/lsv.py``)
and the path kernel's ``lsv`` / ``lsv_qe`` branches (K4).

* The deterministic cores fed the same standard normals: the test swaps
  ``jax.random.normal`` for a function that hands out numpy arrays in call
  order, replaces ``jax.lax.scan`` by a Python loop (the scan bodies draw
  once per step) and runs the reference's jitted cores through
  ``__wrapped__``, in float64:
  - ``_calibrate_scan`` (8 steps × 2 048 particles × 32 bins, both
    regressions, both schemes, the same Dupire σ grid): the leverage table
    at rtol 1e-10;
  - ``_lsv_paths`` (five payoffs, euler and qe) and the path matrix of
    ``lsv_path_matrix``: the stats vector at rtol 1e-12 (the sums; a path's
    QE variance inverts Φ(z) near 1, where the two packages' ``ndtr`` differ
    by an ulp that 1/(1 − u) amplifies, so single paths meet only at ~1e-12
    relative);
  - ``lsv_calibrate`` end to end (4 steps), its table at rtol 1e-10.
* K4-lsv's plain version against the interpreted TPU kernel on the
  ``tests/test_lsv.py:211-219`` model at 2^12 + 37 paths × 8 steps, both
  schemes, all five payoffs: counts equal, every other stat at rtol 2e-5
  (the tile sums run in another order, cos/sin differ by an ulp).
* The port's own draws, statistically: the kernel route against the torch
  scan within 4·(se + se), ``lsv_greeks_mc``'s delta and d_v0 against CRN
  bumps, the flat-surface limit against Black-Scholes.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from optpricer_tpu.models import calibration as jcal
from optpricer_tpu.models import lsv as jl
from optpricer_tpu.ops import pallas_path_mc as jpm
import optpricer_tpu_torch as tp
from optpricer_tpu_torch import convert
from optpricer_tpu_torch.models import calibration as tcal
from optpricer_tpu_torch.models import lsv as tl
from optpricer_tpu_torch.ops import path_mc as tpm
from tests.torch_threads import torch_one_thread  # noqa: F401

S0, R, Q, T = 100.0, 0.03, 0.0, 1.0
HESTON = dict(v0=0.04, kappa=1.5, theta=0.04, xi=0.5, rho=-0.6)
N_STEPS, N_PATHS, N_BINS = 8, 2048, 32


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


def _normals(seed, n=N_PATHS, n_steps=N_STEPS):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(n) for _ in range(2 * n_steps)]


def _feeder(zs):
    zt = [torch.as_tensor(z) for z in zs]
    return lambda k: (zt[2 * k], zt[2 * k + 1])


def _smile(lib, device=None):
    slices = {Te: lib.SVIParams(a=0.03 * Te, b=0.12 * Te, rho=-0.4, m=0.0,
                                sigma=0.25, expiry=Te)
              for Te in (0.25, 0.5, 1.0)}
    fwd = {Te: S0 * np.exp((R - Q) * Te) for Te in slices}
    if device is None:
        return lib.VolSurface(slices, forward_curve=fwd)
    return lib.VolSurface(slices, forward_curve=fwd, device=device)


def _table_model(scheme="euler", n_steps=N_STEPS, lib=jl):
    """tests/test_lsv.py:211-219's model (64 bins on [-1, 1])."""
    x_bins = np.linspace(-1.0, 1.0, 64)
    lev = np.stack([1.0 + 0.3 * x_bins ** 2 * np.exp(-0.5 * k / 8)
                    for k in range(n_steps)])
    if lib is jl:
        return jl.LSVModel(S0=S0, r=R, q=Q, T=T, x_bins=jnp.asarray(x_bins),
                           leverage=jnp.asarray(lev), scheme=scheme,
                           **HESTON)
    return tl.LSVModel(S0=S0, r=R, q=Q, T=T, x_bins=torch.as_tensor(x_bins),
                       leverage=torch.as_tensor(lev), scheme=scheme,
                       **HESTON)


# ---------------------------------------------------------------------------
# deterministic cores
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def sig_grid():
    """The Dupire σ grid both calibrators are fed: the port's
    ``dupire_local_vol`` (held to the reference's in
    tests/test_torch_calibration.py) on the smile."""
    surf = _smile(tcal, "cpu")
    x_bins = np.linspace(-0.9, 0.9, N_BINS)
    rows = [tcal.dupire_local_vol(surf, S0 * np.exp((R - Q) * t)
                                  * np.exp(x_bins), t, R, Q, device="cpu")
            for t in np.maximum(np.arange(N_STEPS) * (T / N_STEPS), 1e-6)]
    return x_bins, torch.stack(rows).numpy()


@pytest.mark.parametrize("scheme", ["euler", "qe"])
@pytest.mark.parametrize("regression", ["local_linear", "nw"])
def test_calibrate_scan_same_normals(feed, sig_grid, scheme, regression):
    x_bins, sig = sig_grid
    fixed = dict(S0=S0, r=R, q=Q, T=T, x0=x_bins[0],
                 dx=x_bins[1] - x_bins[0], **HESTON)
    zs = _normals(4)
    feed.extend(zs)
    static = dict(n_steps=N_STEPS, n_paths=N_PATHS, n_bins=N_BINS,
                  antithetic=True, regression=regression, smooth=3,
                  scheme=scheme)
    L_ref, S_ref, _ = jl._calibrate_scan.__wrapped__(
        jax.random.key(0), jnp.asarray(sig),
        {k: jnp.asarray(v, jnp.float64) for k, v in fixed.items()},
        dtype=jnp.float64, **static)
    assert not feed
    L, S, _ = tl._calibrate_scan(
        _feeder(zs), torch.as_tensor(sig),
        {k: torch.tensor(float(v), dtype=torch.float64)
         for k, v in fixed.items()}, dtype=torch.float64, **static)
    assert L.shape == (N_STEPS, N_BINS)
    np.testing.assert_allclose(L.numpy(), np.asarray(L_ref), rtol=1e-10)
    np.testing.assert_allclose(S.sum().item(), float(np.sum(S_ref)),
                               rtol=1e-12)


@pytest.mark.parametrize("scheme", ["euler", "qe"])
def test_lsv_calibrate_same_normals(feed, monkeypatch, scheme):
    # 4 steps: the reference's jit traces the looped scan step by step
    zs = _normals(5, n_steps=4)
    feed.extend(zs)
    kw = dict(T=T, n_steps=4, n_paths=N_PATHS, n_bins=N_BINS,
              seed=0, scheme=scheme, dtype="float64")
    ref = jl.lsv_calibrate(_smile(jcal), HESTON, S0, R, Q, **kw)
    monkeypatch.setattr(tl, "_step_draws",
                        lambda seed, n, dtype, device: _feeder(zs))
    got = tp.lsv_calibrate(_smile(tcal, "cpu"), HESTON, S0, R, Q, **kw,
                           device="cpu")
    assert got.scheme == scheme and got.n_steps == 4
    # the grids meet to an ulp (the two linspaces round differently)
    np.testing.assert_allclose(got.x_bins.numpy(), np.asarray(ref.x_bins),
                               rtol=1e-14)
    np.testing.assert_allclose(got.leverage.numpy(),
                               np.asarray(ref.leverage), rtol=1e-10)


PAYOFFS = {
    "vanilla": ("vanilla", {}),
    "barrier": ("barrier", dict(barrier=118.0, barrier_type="up-and-out",
                                rebate=0.5)),
    "asian-geo": ("asian", dict(average_type="geometric")),
    "digital": ("digital", dict(payout=2.0)),
    "lookback-floating": ("lookback", dict(strike_type="floating")),
}


@pytest.mark.parametrize("scheme", ["euler", "qe"])
@pytest.mark.parametrize("case", list(PAYOFFS))
def test_lsv_paths_same_normals(feed, scheme, case):
    payoff, kw = PAYOFFS[case]
    zs = _normals(6)
    feed.extend(zs)
    fixed = dict(S0=S0, K=100.0, T=T, r=R, q=Q,
                 barrier=kw.get("barrier", 0.0),
                 rebate=kw.get("rebate", 0.0), payout=kw.get("payout", 1.0))
    static = dict(payoff=payoff, kind="put" if case == "digital" else "call",
                  n_steps=N_STEPS, n_paths=N_PATHS, antithetic=True,
                  barrier_type=kw.get("barrier_type", "up-and-out"),
                  average_type=kw.get("average_type", "arithmetic"),
                  strike_type=kw.get("strike_type", "fixed"))
    pay_ref, S_ref = jl._lsv_paths.__wrapped__(
        jax.random.key(0), _table_model(scheme),
        {k: jnp.asarray(v, jnp.float64) for k, v in fixed.items()},
        dtype=jnp.float64, **static)
    pay, S = tl._lsv_paths(
        _feeder(zs), convert.lsv_model(_table_model(scheme)),
        {k: torch.tensor(v, dtype=torch.float64) for k, v in fixed.items()},
        dtype=torch.float64, **static)
    ref = np.asarray(pay_ref)
    got = pay.numpy()
    stats = lambda x, s: np.array([x.sum(), (x * x).sum(), s.sum()])
    np.testing.assert_allclose(stats(got, S.numpy()),
                               stats(ref, np.asarray(S_ref)), rtol=1e-12)


@pytest.mark.parametrize("scheme", ["euler", "qe"])
def test_lsv_path_matrix_same_normals(feed, scheme):
    zs = _normals(7, n=256, n_steps=N_STEPS)
    feed.extend(zs[:12])     # T = 0.75: the first 6 of 8 rows
    S_ref, v_ref = jl.lsv_path_matrix(_table_model(scheme), n_paths=256,
                                      T=0.75, seed=0, dtype="float64")
    S, v = tl._lsv_matrix(_feeder(zs), convert.lsv_model(
        _table_model(scheme)), n_paths=256, T=0.75, antithetic=True,
        dtype=torch.float64, device=torch.device("cpu"))
    assert S.shape == v.shape == (7, 512) == tuple(S_ref.shape)
    for got, ref in ((S, S_ref), (v, v_ref)):
        ref = np.asarray(ref)
        np.testing.assert_allclose(got.numpy().sum(axis=1), ref.sum(axis=1),
                                   rtol=1e-12)
        np.testing.assert_allclose((got.numpy() ** 2).sum(axis=1),
                                   (ref ** 2).sum(axis=1), rtol=1e-12)
    S2, _ = tp.lsv_path_matrix(convert.lsv_model(_table_model(scheme)),
                               n_paths=64, antithetic=False, seed=1,
                               device="cpu")
    assert S2.shape == (9, 64) and torch.all(S2[0] == S0)
    with pytest.raises(ValueError, match="multiple"):
        tp.lsv_path_matrix(convert.lsv_model(_table_model(scheme)),
                           n_paths=64, T=0.4, device="cpu")


def test_leverage_poly_is_the_reference_fit():
    model = _table_model()
    coeffs, x_width = jl._leverage_poly(model)
    got, got_w = tl._leverage_poly(convert.lsv_model(model))
    assert got.dtype == np.float32 and got.shape == (N_STEPS, 13)
    np.testing.assert_array_equal(got, coeffs)
    assert got_w == x_width


# ---------------------------------------------------------------------------
# K4-lsv's plain version against the interpreted TPU kernel
# ---------------------------------------------------------------------------
K4_N = (1 << 12) + 37
K4_PAYOFFS = {
    "vanilla": dict(payoff="vanilla"),
    "barrier-up-out": dict(payoff="barrier", barrier=125.0, rebate=0.5),
    "asian": dict(payoff="asian"),
    "digital": dict(payoff="digital", payout=2.0),
    "lookback-floating": dict(payoff="lookback", strike_type="floating"),
}


def _k4_lsv(scheme):
    model = _table_model(scheme)
    coeffs, x_width = jl._leverage_poly(model)
    return dict(model.heston, coeffs=coeffs, x_width=x_width, scheme=scheme)


@pytest.mark.parametrize("scheme", ["euler", "qe"])
@pytest.mark.parametrize("case", list(K4_PAYOFFS))
def test_plain_lsv_kernel_matches_interpret_kernel(scheme, case):
    kw = dict(K4_PAYOFFS[case], antithetic=True, lsv=_k4_lsv(scheme))
    args = (3, K4_N, N_STEPS, S0, 100.0, T, R, Q, 0.0, True)
    ref = np.asarray(jpm.path_mc_sumstats_pallas(*args, interpret=True,
                                                 **kw), np.float64)
    got = tpm.path_mc_sumstats_kernel(*args, device="cpu", **kw)
    assert got.dtype == torch.float32 and got.shape == (tpm.NSTAT,)
    got = got.numpy().astype(np.float64)
    assert got[0] == ref[0] == K4_N
    np.testing.assert_allclose(got[1:11], ref[1:11], rtol=2e-5, atol=0.0)
    assert not got[11:].any() and not ref[11:].any()


def test_lsv_kernel_guards():
    lsv = _k4_lsv("euler")
    with pytest.raises(ValueError, match="coeffs"):
        tpm.path_mc_sumstats_kernel(
            1, 100, 6, S0, 100.0, T, R, Q, 0.0, True, payoff="vanilla",
            antithetic=True, lsv=lsv, device="cpu")
    with pytest.raises(ValueError, match="greek_stats"):
        tpm.path_mc_sumstats_kernel(
            1, 100, N_STEPS, S0, 100.0, T, R, Q, 0.0, True,
            payoff="vanilla", antithetic=True, lsv=lsv, greek_stats=True,
            device="cpu")


# ---------------------------------------------------------------------------
# the port's own draws, statistically
# ---------------------------------------------------------------------------
def _flat(vol=0.2):
    slices = {Te: tcal.SVIParams(a=vol ** 2 * Te, b=1e-6, rho=0.0, m=0.0,
                                 sigma=0.1, expiry=Te)
              for Te in (0.25, 0.5, 1.0)}
    return tcal.VolSurface(slices, forward_curve={
        Te: S0 * np.exp((R - Q) * Te) for Te in slices}, device="cpu")


@pytest.mark.parametrize("scheme", ["euler", "qe"])
def test_kernel_route_matches_scan_and_surface(scheme):
    model = tp.lsv_calibrate(_smile(tcal, "cpu"), HESTON, S0, R, Q, T=T,
                             n_steps=16, n_paths=8192, n_bins=48, seed=0,
                             scheme=scheme, device="cpu")
    kw = dict(n_paths=1 << 13, seed=3, device="cpu")
    for payoff, extra in (("vanilla", {}), ("barrier", dict(barrier=130.0))):
        p_k, s_k = tp.lsv_price_mc(payoff, model, 100.0, **kw, **extra)
        p_x, s_x = tp.lsv_price_mc(payoff, model, 100.0, backend="xla", **kw,
                                   **extra)
        assert s_k > 0.0 and s_x > 0.0
        assert abs(p_k - p_x) < 4 * (s_k + s_x), (payoff, p_k, p_x)
    # the smile's own Black-Scholes price within 4 se and 25 bp
    F = S0 * np.exp((R - Q) * T)
    iv = float(_smile(tcal, "cpu").iv_from_logm(np.log(100.0 / F), T))
    ref = tp.bs_price(tp.OptionSpec(S0=S0, K=100.0, T=T, r=R, sigma=iv),
                      "call", device="cpu")
    p_k, s_k = tp.lsv_price_mc("vanilla", model, 100.0, **kw)
    assert abs(p_k - ref) < max(4 * s_k, 0.25), (p_k, ref)


def _unit_model(**over):
    base = dict(S0=S0, r=R, q=Q, T=T, v0=0.04, kappa=1.5, theta=0.04,
                xi=0.4, rho=-0.5)
    base.update(over)
    return tl.LSVModel(x_bins=torch.linspace(-1.2, 1.2, 48),
                       leverage=torch.ones(8, 48), **base)


def test_greeks_match_crn_bumps():
    g = tp.lsv_greeks_mc("vanilla", _unit_model(), 100.0, n_paths=1 << 13,
                         seed=3, device="cpu")
    kw = dict(n_paths=1 << 13, seed=3, backend="xla", device="cpu")
    h = 0.5
    up, _ = tp.lsv_price_mc("vanilla", _unit_model(S0=S0 + h), 100.0, **kw)
    dn, _ = tp.lsv_price_mc("vanilla", _unit_model(S0=S0 - h), 100.0, **kw)
    fd = (up - dn) / (2 * h)
    assert abs(g["delta"] - fd) < 0.02 * max(1.0, abs(fd)) \
        + 4 * g["delta_stderr"]
    px, se = tp.lsv_price_mc("vanilla", _unit_model(), 100.0, **kw)
    assert abs(g["price"] - px) < 1e-9 * px      # the same draws
    ga = tp.lsv_greeks_mc("asian", _unit_model(), 100.0, n_paths=1 << 13,
                          seed=4, device="cpu")
    h = 0.002
    kw["seed"] = 4
    up, _ = tp.lsv_price_mc("asian", _unit_model(v0=0.04 + h), 100.0, **kw)
    dn, _ = tp.lsv_price_mc("asian", _unit_model(v0=0.04 - h), 100.0, **kw)
    fd = (up - dn) / (2 * h)
    assert abs(ga["d_v0"] - fd) < 0.05 * max(1.0, abs(fd)) \
        + 4 * ga["d_v0_stderr"]
    assert ga["d_v0"] > 0.0 and g["theta"] < 0.0 and 0.4 < g["delta"] < 0.75


def test_flat_degenerate_leverage_is_flat_vol():
    """v ≡ 1 (κ = ξ = 0): the leverage is the flat surface's vol."""
    m = tp.lsv_calibrate(_flat(0.2), dict(v0=1.0, kappa=0.0, theta=1.0,
                                          xi=0.0, rho=0.0), S0, R, Q, T=T,
                         n_steps=16, n_paths=8192, n_bins=48, seed=0,
                         device="cpu")
    interior = m.leverage[:, 12:36]
    assert torch.all((interior - 0.2).abs() < 0.02)


def test_guards():
    m = _unit_model()
    with pytest.raises(ValueError, match="unknown payoff"):
        tp.lsv_price_mc("rainbow", m, 100.0, device="cpu")
    with pytest.raises(ValueError, match="kind"):
        tp.lsv_price_mc("vanilla", m, 100.0, kind="straddle", device="cpu")
    with pytest.raises(ValueError, match="even"):
        tp.lsv_price_mc("vanilla", tl.LSVModel(
            S0, R, Q, T, 0.04, 1.5, 0.04, 0.5, -0.6, torch.linspace(-1, 1, 16),
            torch.ones(7, 16)), 100.0, backend="pallas", device="cpu")
    # mesh= raised until A.15 was ported: the route now prices
    from optpricer_tpu_torch.parallel import get_mesh

    price, se = tp.lsv_price_mc("vanilla", m, 100.0, n_paths=8192,
                                mesh=get_mesh(devices=["cpu"] * 2))
    assert np.isfinite(price) and 0.0 < se < 0.1 * price
    with pytest.raises(ValueError, match="continuous"):
        tp.lsv_greeks_mc("barrier", m, 100.0, device="cpu")
    with pytest.raises(ValueError, match="point mass"):
        tp.lsv_greeks_mc("vanilla", tl.LSVModel(
            S0, R, Q, T, 0.04, 1.5, 0.04, 0.5, -0.6, m.x_bins, m.leverage,
            scheme="qe"), 100.0, device="cpu")
    with pytest.raises(ValueError, match="scheme"):
        tp.lsv_calibrate(_flat(), HESTON, S0, R, Q, T=T, scheme="milstein",
                         device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            tp.lsv_price_mc("vanilla", m, 100.0)
