"""Port vs reference: the two Monte-Carlo kernels' plain versions.

The JAX kernels run as the JAX package's own tests run them on the CPU:
``mc_sumstats_pallas(..., interpret=True)`` (which selects the software
Threefry stream) and ``mc_sumstats_qmc(..., interpret=True)``. The port
runs on ``device="cpu"``, which takes the plain torch versions of its CUDA
kernels. Both draw the same numbers, so:

* the counts (stat 0) must agree exactly;
* every other stat agrees to rtol 2e-5: the f32 tile sums are taken in
  another order than XLA:CPU's reduce-window tree, and sin/cos differ by an
  ulp (max 9.2e-6 measured, on ΣY2, a sum of one repeated value);
* the host estimators are the same float64 code, so on the SAME stats
  vector they must agree exactly.
"""
import numpy as np
import pytest
import torch

from optpricer_tpu.ops import pallas_mc as jmc
from optpricer_tpu.ops import stats as jstats
from optpricer_tpu_torch import convert
from optpricer_tpu_torch.ops import stats as tstats
from optpricer_tpu_torch.ops import terminal_mc as tmc
from tests.torch_threads import torch_one_thread  # noqa: F401

MARKET = dict(S0=100.0, K=110.0, T=1.0, r=0.03, q=0.01, sigma=0.2)
RTOL = 2e-5


def _market_args():
    m = MARKET
    return m["S0"], m["K"], m["T"], m["r"], m["q"], m["sigma"]


def _assert_stats_close(got, ref):
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    np.testing.assert_array_equal(got[..., 0], ref[..., 0])
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=0.0)


@pytest.mark.parametrize("n_paths", [1 << 17, 100_003])
@pytest.mark.parametrize("is_call", [True, False])
@pytest.mark.parametrize("antithetic", [True, False])
@pytest.mark.parametrize("invcdf", [False, True])
def test_terminal_plain_matches_interpret_kernel(n_paths, is_call,
                                                 antithetic, invcdf):
    seed = 3
    ref = jmc.mc_sumstats_pallas(seed, n_paths, *_market_args(), is_call,
                                 antithetic=antithetic, interpret=True,
                                 invcdf=invcdf)
    got = tmc.mc_sumstats_kernel(seed, n_paths, *_market_args(), is_call,
                                 antithetic=antithetic, invcdf=invcdf,
                                 device="cpu")
    assert got.dtype == torch.float32 and got.shape == (tmc.NSTAT,)
    assert float(got[0]) == float(n_paths)
    _assert_stats_close(got.numpy(), ref)


@pytest.mark.parametrize("is_call", [True, False])
def test_qmc_plain_matches_interpret_kernel(is_call):
    ref = jmc.mc_sumstats_qmc(11, 100_000, *_market_args(), is_call,
                              n_replicates=8, interpret=True)
    got = tmc.mc_sumstats_qmc(11, 100_000, *_market_args(), is_call,
                              n_replicates=8, device="cpu")
    assert got.shape == (8, tmc.NSTAT) and got.dtype == np.float64
    _assert_stats_close(got, ref)


def test_converted_host_vectors_drive_the_same_kernel():
    """JAX's own params and seed pair, converted, give the port's."""
    n = 100_003
    args = (n, *_market_args(), True)
    params = convert.terminal_params(jmc._terminal_params(*args))
    assert torch.equal(params, tmc._terminal_params(*args))
    seed = convert.seed_pair(np.asarray([5 % (2**31 - 1), 0], np.int32))
    reps, n_programs = tmc._plan_grid(n, 2 * tmc.TILE)
    assert (reps, n_programs) == jmc._plan_grid(n, 2 * jmc.TILE)
    got = tmc.terminal_mc(seed, params, n_programs=n_programs, reps=reps,
                          antithetic=True)
    ref = tmc.mc_sumstats_kernel(5, *args, antithetic=True, device="cpu")
    assert torch.equal(got, ref)


def test_plan_grid_is_the_reference_layout():
    for n in (1, 100_003, 1 << 20, 1_000_000, 1 << 30, 3 << 31):
        for n_dev in (1, 4):
            assert tmc._plan_grid(n, 2 * tmc.TILE, n_dev) == \
                jmc._plan_grid(n, 2 * jmc.TILE, n_dev)


def _stats_vector(seed=0):
    # a realistic stats vector (one reference run), then reused by both
    return np.asarray(jmc.mc_sumstats_pallas(
        seed, 1 << 16, *_market_args(), True, antithetic=True,
        interpret=True), np.float64)


@pytest.mark.parametrize("control_variate", [True, False])
def test_terminal_estimate_exact(control_variate):
    s = _stats_vector()
    for is_call in (True, False):
        ref = jmc.pallas_estimate(s, *_market_args(), is_call,
                                  control_variate)
        got = tmc.terminal_estimate(torch.from_numpy(s), *_market_args(),
                                    is_call, control_variate)
        assert got == ref


def test_terminal_greeks_exact():
    s = _stats_vector(1)
    for is_call in (True, False):
        assert tmc.terminal_greeks(s, *_market_args(), is_call) == \
            jmc.pallas_greeks(s, *_market_args(), is_call)


def test_stats_estimators_exact():
    s = _stats_vector(2)
    assert tstats.cv2_mean_se(s, 100.0, 0.4) == jstats.cv2_mean_se(s, 100.0,
                                                                   0.4)
    assert tstats.cv_mean_se_np(s, 99.0) == jstats.cv_mean_se_np(s, 99.0)
    ref = tuple(float(v) for v in jstats.mean_se(s))
    assert tstats.mean_se(s) == pytest.approx(ref, rel=1e-15)


def test_combine_scan_matches_reference():
    rows = np.random.default_rng(4).standard_normal((37, 13)) \
        .astype(np.float32) * np.float32(1e4)
    ref = np.asarray(jstats.combine_scan(rows))
    got = tstats.combine_scan(torch.from_numpy(rows)).numpy()
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("control_variate", [True, False])
def test_qmc_estimate_exact(control_variate):
    rows = jmc.mc_sumstats_qmc(2, 100_000, *_market_args(), True,
                               n_replicates=8, interpret=True)
    assert tmc.qmc_estimate(rows, *_market_args(), True, control_variate) \
        == jmc.qmc_estimate(rows, *_market_args(), True, control_variate)


def test_plain_version_is_deterministic():
    a = tmc.mc_sumstats_kernel(9, 100_003, *_market_args(), False,
                               antithetic=True, device="cpu")
    b = tmc.mc_sumstats_kernel(9, 100_003, *_market_args(), False,
                               antithetic=True, device="cpu")
    assert torch.equal(a, b)


def test_wrappers_reject_bad_inputs():
    params = tmc._terminal_params(1000, *_market_args(), True)
    seed = torch.tensor([1, 0], dtype=torch.int32)
    with pytest.raises(ValueError):
        tmc.terminal_mc(seed.to(torch.int64), params, n_programs=1, reps=1,
                        antithetic=True)
    with pytest.raises(ValueError):
        tmc.terminal_mc(seed, params.double(), n_programs=1, reps=1,
                        antithetic=True)
    with pytest.raises(ValueError, match="contiguous"):
        tmc.terminal_mc(torch.tensor([1, 7, 0, 7], dtype=torch.int32)[::2],
                        params, n_programs=1, reps=1, antithetic=True)
    with pytest.raises(ValueError):
        tmc.terminal_mc(seed, params, n_programs=1 << 12, reps=1 << 12,
                        antithetic=True)
    with pytest.raises(ValueError, match="n_paths must be positive"):
        tmc.mc_sumstats_kernel(1, 0, *_market_args(), True, antithetic=True,
                               device="cpu")
    with pytest.raises(ValueError, match=r"2\*\*31"):
        tmc.mc_sumstats_qmc(1, 1 << 36, *_market_args(), True, device="cpu")
