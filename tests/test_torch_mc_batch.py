"""Port vs reference: the heterogeneous-book kernel's plain version (K3)
and ``euro_price_mc_batch``.

The JAX kernel runs as the JAX package's own tests run it on the CPU,
``_run_batch_kernel(..., interpret=True)`` on the software Threefry
stream; the port's ``mc_batch`` on CPU tensors runs its plain version. They
draw the same numbers, so per contract lane the count agrees exactly and
the other nine sums to rtol 2e-5 (f32 sums in another order; 1.9e-6
measured) plus atol 1e-4: cos/sin differ by an ulp between XLA and torch,
and a path whose S_T lies that close to its strike moves its payoff (and
the sums' tiny totals of deep out-of-the-money lanes) by a few ulps of S
(5e-6 seen). The host estimator is held exactly (rtol 1e-12) on the
reference's own statistics. End to end, the prices without control
variate agree within 5e-6 absolute, the scale of the estimator's own f32
round-off floor 2e-6·(1 + |price|); with the
dual control variate the f32 differences pass through a 2×2 regression
whose variances nearly cancel, so the CV prices are compared on shared
statistics only (ROADMAP §C); for contracts in the money on nearly every
path that regression turns a few ulps of ΣY2 into tens of stderr, in both
estimators alike.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from optpricer_tpu.ops import pallas_mc_batch as jmb
from optpricer_tpu_torch import convert
from optpricer_tpu_torch.ops import mc_batch as tmb
from tests.torch_threads import torch_one_thread  # noqa: F401

RTOL = 2e-5


def _book(B=200, seed=0):
    """B contracts (two ktiles, the second ragged): calls and puts, mixed
    spot, strike, expiry and vol."""
    rng = np.random.default_rng(seed)
    return (rng.uniform(90.0, 110.0, B), rng.uniform(70.0, 130.0, B),
            rng.uniform(0.2, 2.0, B), 0.03, 0.01, rng.uniform(0.1, 0.4, B),
            np.where(rng.random(B) < 0.5, "call", "put"))


def _ref_stats(kparams, n_paths, antithetic, seed=5):
    reps, n_programs = tmb._plan(n_paths)
    return np.asarray(jmb._run_batch_kernel(
        jnp.asarray([seed], jnp.int32), jnp.asarray([float(n_paths)],
                                                    jnp.float32),
        jnp.asarray(kparams), n_programs=n_programs,
        n_ktiles=kparams.shape[0], reps=reps, antithetic=antithetic,
        interpret=True), np.float64)


def _assert_stats_close(got, ref):
    assert got.shape == ref.shape
    np.testing.assert_array_equal(got[:, 0], ref[:, 0])
    np.testing.assert_allclose(got[:, 1:], ref[:, 1:], rtol=RTOL, atol=1e-4)


@pytest.mark.parametrize("n_paths", [3000, 1024 * 16 + 37])
@pytest.mark.parametrize("antithetic", [True, False])
def test_plain_version_matches_interpret_kernel(n_paths, antithetic):
    kparams, book = tmb.batch_kparams(*_book())
    assert kparams.shape == (2, 8, 128)
    ref = _ref_stats(kparams, n_paths, antithetic)
    reps, n_programs = tmb._plan(n_paths)
    got = tmb.mc_batch(torch.tensor([5], dtype=torch.int32),
                       torch.tensor([float(n_paths)]),
                       convert.mc_batch_kparams(kparams),
                       n_programs=n_programs, reps=reps,
                       antithetic=antithetic)
    assert got.dtype == torch.float32 and got.shape == (2, 10, 128)
    assert (got[:, 0] == n_paths).all()
    _assert_stats_close(got.numpy().astype(np.float64), ref)


def test_plan_and_kparams_are_the_reference_layout():
    args = _book(300, seed=1)
    kparams, _ = tmb.batch_kparams(*args)
    ref_kp = []

    def spy(seed, params, kp, **kw):
        ref_kp.append((np.asarray(kp), kw))
        n_kt = kp.shape[0]
        return jnp.ones((n_kt, 10, 128), jnp.float32)

    orig = jmb._run_batch_kernel
    jmb._run_batch_kernel = spy
    try:
        jmb.euro_price_mc_batch(*args, n_paths=100_000, seed=3)
    finally:
        jmb._run_batch_kernel = orig
    kp, kw = ref_kp[0]
    np.testing.assert_array_equal(kparams, kp)
    assert tmb._plan(100_000) == (kw["reps"], kw["n_programs"])
    for n in (1, 511, 512 * 16 + 1, 1_000_003, 1 << 24):
        reps, progs = tmb._plan(n)
        assert progs * reps * 512 >= n > (progs * reps - reps) * 512


@pytest.mark.parametrize("control_variate", [True, False])
def test_estimator_matches_reference_on_its_stats(monkeypatch,
                                                  control_variate):
    args = _book(150, seed=2)
    n_paths = 4000
    ref_p, ref_s = jmb.euro_price_mc_batch(*args, n_paths=n_paths, seed=7,
                                           control_variate=control_variate,
                                           interpret=True)
    kparams, _ = tmb.batch_kparams(*args)
    stats = _ref_stats(kparams, n_paths, True, seed=7)
    monkeypatch.setattr(tmb, "mc_batch",
                        lambda *a, **k: torch.as_tensor(stats))
    got_p, got_s = tmb.euro_price_mc_batch(*args, n_paths=n_paths, seed=7,
                                           control_variate=control_variate,
                                           device="cpu")
    assert got_p.shape == got_s.shape == (150,)
    np.testing.assert_allclose(got_p, ref_p, rtol=1e-12, atol=1e-14)
    np.testing.assert_allclose(got_s, ref_s, rtol=1e-12, atol=1e-14)


def test_prices_without_cv_match_reference():
    args = _book(130, seed=4)
    ref_p, ref_s = jmb.euro_price_mc_batch(*args, n_paths=6000, seed=9,
                                           control_variate=False,
                                           interpret=True)
    got_p, got_s = tmb.euro_price_mc_batch(*args, n_paths=6000, seed=9,
                                           control_variate=False,
                                           device="cpu")
    np.testing.assert_allclose(got_p, ref_p, rtol=0.0, atol=5e-6)
    np.testing.assert_allclose(got_s, ref_s, rtol=0.0, atol=5e-6)


def test_cv_prices_agree_with_black_scholes():
    from optpricer_tpu_torch.ops.black_scholes import bs_price_vec

    args = _book(64, seed=6)
    p, se = tmb.euro_price_mc_batch(*args, n_paths=20_000, seed=1,
                                    device="cpu")
    bs = bs_price_vec(*args, device="cpu").numpy()
    assert np.all(np.abs(p - bs) < 5 * se + 1e-4), np.max(np.abs(p - bs)
                                                          / se)
    assert np.all(se >= 2e-6 * (1.0 + np.abs(p)))


def test_deep_itm_cv_price_is_round_off_in_both_estimators(monkeypatch):
    """Contracts in the money on all but ~1e-5 of paths: the dual-CV
    regression takes Var(Y2) as the difference of f32 moments of ~1, so a
    change of ΣY2 by 2e-6 of itself (a few f32 ulps, ten times inside the
    kernel-vs-plain rtol) moves their CV price by many stderr, in the
    reference's estimator as in the port's; the plain mean does not read
    ΣY2 (ROADMAP §C)."""
    K = np.concatenate([np.linspace(48.0, 54.0, 8),
                        np.linspace(178.0, 184.0, 8)])
    args = (100.0, K, 0.5, 0.03, 0.01, 0.2, ["call"] * 8 + ["put"] * 8)
    n_paths = 1 << 16
    kparams, _ = tmb.batch_kparams(*args)
    reps, n_programs = tmb._plan(n_paths)
    stats = tmb.mc_batch(torch.tensor([3], dtype=torch.int32),
                         torch.tensor([float(n_paths)]),
                         torch.as_tensor(kparams), n_programs=n_programs,
                         reps=reps, antithetic=True).numpy().astype(float)
    nudged = stats.copy()
    nudged[:, 6] *= 1.0 + 2e-6

    def both(s, control_variate):
        monkeypatch.setattr(jmb, "_run_batch_kernel",
                            lambda *a, **k: jnp.asarray(s))
        monkeypatch.setattr(tmb, "mc_batch",
                            lambda *a, **k: torch.as_tensor(s))
        kw = dict(n_paths=n_paths, seed=3, control_variate=control_variate)
        ref = jmb.euro_price_mc_batch(*args, **kw)
        got = tmb.euro_price_mc_batch(*args, device="cpu", **kw)
        for g, r in zip(got, ref):
            np.testing.assert_allclose(g, r, rtol=1e-12, atol=1e-14)
        return got

    price, se = both(stats, True)
    moved = np.abs(both(nudged, True)[0] - price) / se
    assert moved.max() > 10.0, moved
    np.testing.assert_array_equal(both(nudged, False)[0],
                                  both(stats, False)[0])


def test_wrapper_rejects_bad_inputs():
    kparams, _ = tmb.batch_kparams(*_book(10))
    ok = (torch.tensor([1], dtype=torch.int32), torch.tensor([100.0]),
          torch.as_tensor(kparams))
    kw = dict(n_programs=1, reps=1, antithetic=True)
    with pytest.raises(ValueError):
        tmb.mc_batch(ok[0].long(), *ok[1:], **kw)
    with pytest.raises(ValueError):
        tmb.mc_batch(ok[0], ok[1].double(), ok[2], **kw)
    with pytest.raises(ValueError):
        tmb.mc_batch(*ok[:2], ok[2][:, :6], **kw)
    with pytest.raises(ValueError, match="empty grid"):
        tmb.mc_batch(*ok, **dict(kw, reps=0))
    with pytest.raises(ValueError, match="2\\*\\*24"):
        tmb.mc_batch(*ok, **dict(kw, n_programs=1 << 12, reps=1 << 12))
    with pytest.raises(ValueError):
        tmb.euro_price_mc_batch(100.0, 100.0, 1.0, 0.0, 0.0, 0.2, "straddle",
                                device="cpu")
