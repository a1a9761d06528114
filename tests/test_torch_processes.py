"""Port vs reference: the path-matrix generators and the exotic payoff
evaluators (``optpricer_tpu_torch/models/processes.py``, ``exotics.py``).

The two packages draw from different generators (``jax.random`` keys,
``torch.Generator``), so each generator is held in two parts:

* its deterministic core against the reference's, fed the same standard
  normals (and Poisson counts) made with numpy: the test swaps
  ``jax.random.normal`` / ``jax.random.poisson`` for functions that hand
  out those arrays in call order and runs the reference's jitted core
  through ``__wrapped__`` (the local-vol generators build a new jitted
  closure on every call, so they trace anew). Float64, rtol 1e-12;
* its draws, statistically: the mean of e^{−rT}S_T against S0·e^{−qT}
  within 4 standard errors.

The payoff evaluators are deterministic given the matrix and are held on
one shared matrix at rtol 1e-12.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from optpricer_tpu.models import calibration as jc
from optpricer_tpu.models import exotics as jx
from optpricer_tpu.models import processes as jp
from optpricer_tpu_torch import convert
from optpricer_tpu_torch.models import calibration as tc
from optpricer_tpu_torch.models import exotics as tx
from optpricer_tpu_torch.models import processes as tp
from tests.torch_threads import torch_one_thread  # noqa: F401

RTOL = 1e-12
S0, R, Q, T = 100.0, 0.04, 0.01, 1.0
N_STEPS, N_PATHS = 12, 64
HESTON = (0.04, 1.5, 0.05, 0.6, -0.7)          # v0, κ, θ, ξ, ρ
SABR = (0.25, 0.6, 0.4, -0.3)                  # α0, β, ν, ρ
MERTON = (0.5, -0.1, 0.15)                     # λ, mJ, sJ


@pytest.fixture
def feed(monkeypatch):
    """Hand the reference numpy arrays in place of its random draws."""
    queue = {"normal": [], "poisson": []}

    def fake(kind):
        def draw(key, *args, **kwargs):
            return jnp.asarray(queue[kind].pop(0))
        return draw

    monkeypatch.setattr(jax.random, "normal", fake("normal"))
    monkeypatch.setattr(jax.random, "poisson", fake("poisson"))
    return queue


def _normals(seed, k=1, shape=(N_STEPS, N_PATHS)):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape) for _ in range(k)]


def _t(*arrays):
    return [torch.as_tensor(a, dtype=torch.float64) for a in arrays]


def _s(*values):
    return [torch.tensor(float(v), dtype=torch.float64) for v in values]


def _close(got, ref):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), rtol=RTOL,
                               atol=1e-12)


def _key():
    return jax.random.key(0)


def _j(*values):
    return [jnp.asarray(v, jnp.float64) for v in values]


@pytest.mark.parametrize("antithetic", [True, False])
def test_gbm_and_milstein_cores(feed, antithetic):
    (Z,) = _normals(1)
    st = dict(n_steps=N_STEPS, n_paths=N_PATHS, antithetic=antithetic,
              dtype=jnp.float64)
    for jcore, tcore in ((jp._gbm_core, tp._gbm_core),
                         (jp._gbm_milstein_core, tp._gbm_milstein_core)):
        feed["normal"].append(Z)
        ref = jcore.__wrapped__(_key(), *_j(S0, R, Q, 0.2, T), **st)
        got = tcore(*_t(Z), *_s(S0, R, Q, 0.2, T), antithetic=antithetic)
        assert got.shape == (N_STEPS + 1, N_PATHS * (2 if antithetic else 1))
        _close(got, ref)


def test_merton_core(feed):
    Z, ZJ = _normals(2, 2)
    K = np.random.default_rng(3).poisson(0.3, (N_STEPS, N_PATHS)).astype(
        np.float64)
    feed["normal"] += [Z, ZJ]
    feed["poisson"].append(K)
    ref = jp._merton_core.__wrapped__(
        _key(), *_j(S0, R, Q, 0.2, T, *MERTON), n_steps=N_STEPS,
        n_paths=N_PATHS, antithetic=True, dtype=jnp.float64)
    got = tp._merton_core(*_t(Z, K, ZJ), *_s(S0, R, Q, 0.2, T, *MERTON),
                          antithetic=True)
    _close(got, ref)


@pytest.mark.parametrize("scheme", ["euler", "qe"])
def test_heston_cores(feed, scheme):
    Za, Zb = _normals(4, 2)
    feed["normal"] += [Za, Zb]
    jcore = jp._heston_qe_core if scheme == "qe" else jp._heston_core
    tcore = tp._heston_qe_core if scheme == "qe" else tp._heston_core
    S_ref, v_ref = jcore.__wrapped__(
        _key(), *_j(S0, R, Q, *HESTON, T), n_steps=N_STEPS, n_paths=N_PATHS,
        antithetic=True, dtype=jnp.float64)
    S, v = tcore(*_t(Za, Zb), *_s(S0, R, Q, *HESTON, T), antithetic=True)
    _close(S, S_ref)
    _close(v, v_ref)


def test_qe_transition_matches():
    zv, zs = _normals(5, 2, (200,))
    S = np.linspace(60.0, 140.0, 200)
    v = np.linspace(0.0, 0.2, 200)
    kw = dict(r=R, q=Q, kappa=1.5, theta=0.05, xi=0.9, rho=-0.7, dt=0.1)
    ref = jp.qe_transition(*_j(S, v, zv, zs), **kw)
    got = tp.qe_transition(*_t(S, v, zv, zs),
                           **{k: torch.tensor(x, dtype=torch.float64)
                              for k, x in kw.items()})
    for g, r in zip(got, ref):
        _close(g, r)


def test_bates_jump_factor(feed):
    (zj,) = _normals(6)
    nj = np.random.default_rng(6).poisson(0.2, (N_STEPS, N_PATHS)).astype(
        np.float64)
    feed["poisson"].append(nj)
    feed["normal"].append(zj)
    ref = jp._jump_factor.__wrapped__(_key(), *_j(*MERTON, T),
                                      n_steps=N_STEPS, n_paths=N_PATHS,
                                      dtype=jnp.float64)
    got = tp._jump_factor(*_t(nj, zj), *_s(*MERTON, T))
    _close(got, ref)


@pytest.mark.parametrize("beta", [1.0, 0.6])
def test_sabr_core(feed, beta):
    Z2, Zp = _normals(7, 2)
    feed["normal"] += [Z2, Zp]
    a0, _, nu, rho = SABR
    ref = jp._sabr_core.__wrapped__(
        _key(), *_j(S0, R, Q, a0, beta, nu, rho, T), n_steps=N_STEPS,
        n_paths=N_PATHS, antithetic=True, dtype=jnp.float64,
        lognormal=beta == 1.0)
    got = tp._sabr_core(*_t(Z2, Zp), *_s(S0, R, Q, a0, beta, nu, rho, T),
                        antithetic=True, lognormal=beta == 1.0)
    _close(got, ref)


def _smile_jax(S, t):
    return 0.2 + 0.1 * jnp.exp(-jnp.log(S / 100.0) ** 2) + 0.05 * t


def _smile_torch(S, t):
    return 0.2 + 0.1 * torch.exp(-torch.log(S / 100.0) ** 2) + 0.05 * t


def _desk_surfaces():
    Ts = (0.25, 0.5, 1.0)
    fwd = {T_: S0 * np.exp((R - Q) * T_) for T_ in Ts}
    strikes = {T_: np.linspace(0.75, 1.25, 21) * fwd[T_] for T_ in Ts}
    ivs = {T_: 0.2 + 0.05 * np.log(strikes[T_] / fwd[T_]) ** 2
           - 0.02 * np.log(strikes[T_] / fwd[T_]) for T_ in Ts}
    ref = jc.fit_svi_surface(strikes, fwd, ivs)
    return ref, convert.vol_surface(ref)


@pytest.mark.parametrize("sigma", ["smile", "dupire"])
@pytest.mark.parametrize("milstein", [False, True])
def test_local_vol_generators(feed, sigma, milstein):
    """The public generators, with the reference's draws injected; σ(S, t)
    a closed-form smile or each package's Dupire closure on one surface."""
    if sigma == "smile":
        sj, st = _smile_jax, _smile_torch
    else:
        ref_s, got_s = _desk_surfaces()
        sj = jc.dupire_local_vol_func(ref_s, R, Q)
        st = tc.dupire_local_vol_func(got_s, R, Q)
    (Z,) = _normals(8)
    feed["normal"].append(Z)
    if milstein:
        ref = jp.milstein_local_vol_paths(S0, R, Q, T, N_STEPS, N_PATHS, sj,
                                          seed=1, dS_bump=0.02)
        got = tp._milstein_lv_core(*_t(Z), *_s(S0, R, Q, T, 0.02), st,
                                   antithetic=True)
    else:
        ref = jp.local_vol_paths(S0, R, Q, T, N_STEPS, N_PATHS, sj, seed=1)
        got = tp._local_vol_core(*_t(Z), *_s(S0, R, Q, T), st,
                                 antithetic=True)
    _close(got, ref)


GENERATORS = {
    "gbm": lambda **kw: tp.gbm_paths(S0, R, Q, 0.2, T, 16, 20_000, **kw),
    "merton": lambda **kw: tp.merton_jump_paths(
        S0, R, Q, 0.2, T, 16, 20_000, lam=0.5, mJ=-0.1, sJ=0.15, **kw),
    "heston": lambda **kw: tp.heston_paths(S0, R, Q, *HESTON, T, 32, 20_000,
                                           **kw),
    "heston_qe": lambda **kw: tp.heston_paths(S0, R, Q, *HESTON, T, 16,
                                              20_000, scheme="qe", **kw),
    "bates": lambda **kw: tp.bates_paths(S0, R, Q, *HESTON, T, 16, 20_000,
                                         lam=0.5, mJ=-0.1, sJ=0.15, **kw),
    "sabr": lambda **kw: tp.sabr_paths(S0, R, Q, *SABR, T, 32, 20_000, **kw),
    "local_vol": lambda **kw: tp.local_vol_paths(S0, R, Q, T, 16, 20_000,
                                                 _smile_torch, **kw),
    "gbm_milstein": lambda **kw: tp.gbm_milstein_paths(S0, R, Q, 0.2, T, 16,
                                                       20_000, **kw),
    "milstein_local_vol": lambda **kw: tp.milstein_local_vol_paths(
        S0, R, Q, T, 16, 20_000, _smile_torch, **kw),
}


@pytest.mark.parametrize("name", list(GENERATORS))
def test_draws_are_martingale(name):
    """e^{−rT}S_T has mean S0·e^{−qT} under every model: within 4 se."""
    paths = GENERATORS[name](seed=11, device="cpu")
    assert paths.dtype == torch.float64 and paths.shape[1] == 40_000
    assert torch.equal(paths[0], torch.full_like(paths[0], S0))
    assert torch.isfinite(paths).all()
    X = np.exp(-R * T) * paths[-1].numpy()
    # antithetic pairs are one observation
    pair = 0.5 * (X[:20_000] + X[20_000:])
    se = pair.std(ddof=1) / np.sqrt(pair.size)
    assert abs(pair.mean() - S0 * np.exp(-Q * T)) < 4 * se, (pair.mean(), se)
    again = GENERATORS[name](seed=11, device="cpu")
    assert torch.equal(paths, again)


def test_heston_returns_variance_and_validates():
    S, v = tp.heston_paths(S0, R, Q, *HESTON, T, 8, 100, seed=1,
                           return_variance=True, antithetic=False,
                           device="cpu")
    assert S.shape == v.shape == (9, 100) and float(v.min()) >= 0.0
    for bad in (lambda: tp.gbm_paths(S0, R, Q, 0.2, T, 0, 10, device="cpu"),
                lambda: tp.heston_paths(S0, R, Q, 0.04, 1.5, 0.05, 0.6, -1.5,
                                        T, 8, 10, device="cpu"),
                lambda: tp.heston_paths(S0, R, Q, *HESTON, T, 8, 10,
                                        scheme="exact", device="cpu"),
                lambda: tp.sabr_paths(S0, R, Q, 0.2, 1.5, 0.4, 0.0, T, 8, 10,
                                      device="cpu"),
                lambda: tp.merton_jump_paths(S0, R, Q, 0.2, T, 8, 10,
                                             lam=-1.0, mJ=0.0, sJ=0.1,
                                             device="cpu")):
        with pytest.raises(ValueError):
            bad()


def _shared_matrix():
    rng = np.random.default_rng(12)
    Z = rng.standard_normal((N_STEPS, 500))
    logp = np.cumsum(-0.02 * T / N_STEPS + 0.2 * np.sqrt(T / N_STEPS) * Z,
                     axis=0)
    return np.vstack([np.full((1, 500), S0), S0 * np.exp(logp)])


@pytest.mark.parametrize("fn, args, kw", [
    ("barrier_price", (100.0, R, T, "call", 115.0, "up-and-out"), {}),
    ("barrier_price", (100.0, R, T, "put", 90.0, "down-and-in"),
     dict(rebate=1.5)),
    ("barrier_price", (100.0, R, T, "call", 120.0, "up-and-in"), {}),
    ("barrier_price", (100.0, R, T, "put", 85.0, "down-and-out"), {}),
    ("asian_price", (100.0, R, T, "call"), {}),
    ("asian_price", (100.0, R, T, "put"), dict(average_type="geometric")),
    ("asian_price", (100.0, R, T, "call"), dict(strike_type="floating")),
    ("digital_price", (105.0, R, T, "call"), dict(payout=2.0)),
    ("digital_price", (95.0, R, T, "put"), {}),
    ("lookback_price", (R, T, "call"), {}),
    ("lookback_price", (R, T, "put"), dict(K=100.0, strike_type="fixed")),
    ("double_barrier_price", (100.0, R, T, "call", 80.0, 125.0), {}),
    ("double_barrier_price", (100.0, R, T, "put", 80.0, 125.0),
     dict(knock="in", rebate=0.5)),
])
def test_exotics_on_a_shared_matrix(fn, args, kw):
    paths = _shared_matrix()
    ref = getattr(jx, fn)(jnp.asarray(paths), *args, **kw)
    got = getattr(tx, fn)(torch.as_tensor(paths), *args, **kw)
    assert isinstance(got[0], float) and isinstance(got[1], float)
    np.testing.assert_allclose(got, [float(v) for v in ref], rtol=RTOL)
    np.testing.assert_allclose(getattr(tx, fn)(paths, *args, **kw), got,
                               rtol=0.0)


def test_exotics_validate_like_the_reference():
    paths = _shared_matrix()
    for fn, args in (("barrier_price", (100.0, R, T, "call", 115.0,
                                        "sideways")),
                     ("asian_price", (100.0, R, T, "call")),
                     ("double_barrier_price", (100.0, R, T, "call", 130.0,
                                               90.0))):
        kw = dict(average_type="harmonic") if fn == "asian_price" else {}
        with pytest.raises(ValueError):
            getattr(jx, fn)(jnp.asarray(paths), *args, **kw)
        with pytest.raises(ValueError):
            getattr(tx, fn)(torch.as_tensor(paths), *args, **kw)
