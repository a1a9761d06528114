"""The traced single-control estimator of ``ops/stats.py`` (ROADMAP A.17):
``sumstats`` and ``cv_mean_se`` against the JAX package's on the same
inputs, made with numpy from a seed, with and without a 0/1 weight, in
float32 and float64, and at a constant control (Var(Y) = 0, ĉ = 0). The
estimator's tangent with respect to the stats is ``torch.func.jacfwd``'s
against ``jax.jacfwd``'s, finite at the constant control.

Tolerances: rtol 1e-12 in float64, 1e-6 in float32 (the sums of 4 096
terms reduce in another order).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from optpricer_tpu.ops import stats as js
from optpricer_tpu_torch.ops import stats as ts

RTOL = {np.float32: 1e-6, np.float64: 1e-12}
TORCH = {np.float32: torch.float32, np.float64: torch.float64}
N_DRAWS = 4096
EY = 1.25


def _inputs(seed, dtype, weighted, control):
    """X, Y and the weight (or None) as numpy arrays of ``dtype``; a
    ``"constant"`` control is EY everywhere, so Var(Y) is exactly 0."""
    rng = np.random.default_rng(seed)
    z = rng.standard_normal(N_DRAWS)
    Y = EY + 0.3 * z if control == "correlated" else np.full(N_DRAWS, EY)
    X = np.maximum(Y * np.exp(0.2 * rng.standard_normal(N_DRAWS)) - 1.0, 0.0)
    w = None
    if weighted:
        w = np.ones(N_DRAWS)
        w[N_DRAWS - 1000:] = 0.0     # a tail chunk's masked lanes
    return tuple(None if a is None else a.astype(dtype) for a in (X, Y, w))


CASES = [(seed, dtype, weighted, control)
         for seed, control in ((0, "correlated"), (1, "constant"))
         for dtype in (np.float32, np.float64)
         for weighted in (False, True)]


def _ids(case):
    seed, dtype, weighted, control = case
    return f"{control}-{dtype.__name__}-{'weight' if weighted else 'all'}"


def _jax(a):
    return None if a is None else jnp.asarray(a)


def _torch(a):
    return None if a is None else torch.from_numpy(a)


@pytest.mark.parametrize("case", CASES, ids=map(_ids, CASES))
def test_sumstats_matches_reference(case):
    X, Y, w = _inputs(*case)
    ref = np.asarray(js.sumstats(_jax(X), _jax(Y), _jax(w)))
    got = ts.sumstats(_torch(X), _torch(Y), _torch(w))
    assert got.shape == (6,) and got.dtype == TORCH[case[1]]
    np.testing.assert_allclose(got.numpy(), ref, rtol=RTOL[case[1]], atol=0)
    n = N_DRAWS if w is None else N_DRAWS - 1000
    assert got[0].item() == n


@pytest.mark.parametrize("case", CASES, ids=map(_ids, CASES))
def test_cv_mean_se_matches_reference(case):
    dtype = case[1]
    X, Y, w = _inputs(*case)
    stats = np.array(js.sumstats(_jax(X), _jax(Y), _jax(w)))
    ref = [float(v) for v in js.cv_mean_se(jnp.asarray(stats), EY)]
    got = ts.cv_mean_se(torch.from_numpy(stats), EY)
    assert all(v.shape == () and v.dtype == TORCH[dtype] for v in got)
    np.testing.assert_allclose([v.item() for v in got], ref,
                               rtol=RTOL[dtype], atol=0)
    if case[3] == "constant":   # ĉ = 0: the plain mean and its stderr
        assert got[0].item() == pytest.approx(float(stats[1] / stats[0]),
                                              rel=RTOL[dtype])


def test_cv_mean_se_takes_ey_as_a_tensor():
    X, Y, w = _inputs(0, np.float64, True, "correlated")
    stats = ts.sumstats(_torch(X), _torch(Y), _torch(w))
    as_float = ts.cv_mean_se(stats, EY)
    for ey in (torch.tensor(EY, dtype=torch.float64),
               torch.tensor(EY, dtype=torch.float32)):
        got = ts.cv_mean_se(stats, ey)
        assert all(v.dtype == torch.float64 for v in got)
        assert [v.item() for v in got] == [v.item() for v in as_float]


@pytest.mark.parametrize("control", ["correlated", "constant"])
def test_cv_mean_se_tangent_matches_reference(control):
    X, Y, w = _inputs(2, np.float64, False, control)
    stats = np.array(js.sumstats(_jax(X), _jax(Y)))

    def jax_fn(s):
        return jnp.stack(js.cv_mean_se(s, EY))

    def torch_fn(s):
        return torch.stack(ts.cv_mean_se(s, EY))

    ref = np.asarray(jax.jacfwd(jax_fn)(jnp.asarray(stats)))
    got = torch.func.jacfwd(torch_fn)(torch.from_numpy(stats)).numpy()
    assert got.shape == (2, 6)
    assert np.isfinite(got).all()
    if control == "constant":   # the double where's branch was taken
        n, _, _, sy, sy2, _ = stats
        assert sy2 / n - (sy / n) ** 2 == 0.0
    np.testing.assert_allclose(got, ref, rtol=1e-12, atol=1e-300)
