"""Port vs reference: the path-QMC kernel's host tables and plain version (K5).

* The Sobol direction numbers, the bridge schedule and matrix, and the
  replicate shift words are host integer / float64 code on both sides and
  must be exactly equal (the shifts for seeds above 2^31 and 2^32 too, up
  to 16 replicates x 252 steps; a cached result is handed out as a copy).
* The plain version against ``path_qmc_sumstats_pallas(..., interpret=True)``
  at 2 048 points × 8 replicates × 8 steps: the same points, so the counts
  agree exactly and every other sum to rtol 2e-5 (XLA:CPU forms z @ B and
  the tile sums in another order and sums the programs of a replicate in
  f32, the port in f64; 2.6e-7 measured).
* ``qmc_path_estimate`` is the same float64 code: exactly equal on the same
  stats.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from optpricer_tpu.ops import pallas_qmc_path as jqp
from optpricer_tpu.ops import sobol as jsobol
from optpricer_tpu_torch import convert
from optpricer_tpu_torch.ops import qmc_path as tqp
from optpricer_tpu_torch.ops import sobol as tsobol
from optpricer_tpu_torch.ops import swprng
from tests.torch_threads import torch_one_thread  # noqa: F401

MARKET = (100.0, 105.0, 1.0, 0.03, 0.01, 0.2)  # S0, K, T, r, q, sigma
RTOL = 2e-5
SEEDS = (0, 11, 2**31 - 2, 2**31 + 5, 2**32 + 9)


@pytest.mark.parametrize("d, m_bits", [(1, 11), (8, 11), (64, 16),
                                       (252, 21), (300, 32)])
def test_direction_numbers_equal(d, m_bits):
    np.testing.assert_array_equal(tsobol.direction_numbers(d, m_bits),
                                  jsobol.direction_numbers(d, m_bits))


def test_torch_table_equals_reference_fallback():
    np.testing.assert_array_equal(tsobol._direction_numbers_torch(40, 30),
                                  jsobol._direction_numbers_torch(40, 30))


@pytest.mark.parametrize("d", [1, 2, 7, 8, 64, 252])
def test_bridge_tables_equal(d):
    for got, ref in zip(tsobol.brownian_bridge_order(d),
                        jsobol.brownian_bridge_order(d)):
        np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(tsobol.bridge_matrix(d, 1.7),
                                  jqp.bridge_matrix(d, 1.7))


@pytest.mark.parametrize("R, d, d_pad", [(8, 12, 128), (16, 252, 256)])
@pytest.mark.parametrize("seed", SEEDS)
def test_replicate_shifts_equal(seed, R, d, d_pad):
    ref = np.asarray(jqp._replicate_shifts(seed, R=R, d=d, d_pad=d_pad))
    got = tqp._replicate_shifts(seed, R=R, d=d, d_pad=d_pad)
    np.testing.assert_array_equal(got, ref)
    # the words are cached; each call hands out its own copy
    got[:] = 0
    np.testing.assert_array_equal(
        tqp._replicate_shifts(seed, R=R, d=d, d_pad=d_pad), ref)


@pytest.mark.parametrize("seed", SEEDS)
def test_fold_in_bits_equal_jax(seed):
    for i in (0, 3, 2**31 + 1):
        ref = jax.random.bits(jax.random.fold_in(jax.random.key(seed), i),
                              (5,), jnp.uint32)
        np.testing.assert_array_equal(swprng.jax_fold_in_bits(seed, i, 5),
                                      np.asarray(ref))
        # a sequence of counters gives one row each
        np.testing.assert_array_equal(
            swprng.jax_fold_in_bits(seed, [1, i], 5)[1], np.asarray(ref))


# (payoff kwargs, is_call)
VARIANTS = {
    "vanilla": (dict(payoff="vanilla"), True),
    "asian-arith": (dict(payoff="asian"), True),
    "asian-geo-floating": (dict(payoff="asian", average_type="geometric",
                                strike_type="floating"), False),
    "barrier-up-out": (dict(payoff="barrier", barrier=120.0), True),
    "barrier-down-in": (dict(payoff="barrier", barrier=92.0,
                             barrier_type="down-and-in", rebate=1.5), False),
    "digital": (dict(payoff="digital", payout=2.0), True),
    "lookback-fixed": (dict(payoff="lookback"), False),
    "lookback-floating": (dict(payoff="lookback", strike_type="floating"),
                          True),
}


def _both(variant, seed=11, n_points=2048, n_steps=8):
    kw, is_call = VARIANTS[variant]
    ref = jqp.path_qmc_sumstats_pallas(seed, n_points, n_steps, *MARKET,
                                       is_call, interpret=True, **kw)
    got = tqp.path_qmc_sumstats_kernel(seed, n_points, n_steps, *MARKET,
                                       is_call, device="cpu", **kw)
    return got, np.asarray(ref, np.float64)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_plain_matches_interpret_kernel(variant):
    got, ref = _both(variant)
    assert got.shape == (8, tqp.NSTAT) and got.dtype == np.float64
    np.testing.assert_array_equal(got[:, 0], ref[:, 0])
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=0.0)


def test_ragged_points_and_estimate_exact():
    # the reference packs the seed into an int32 pair, so 2^31 - 2 is its
    # largest; the shift words above 2^31 are held by the tests above
    got, ref = _both("asian-arith", seed=2**31 - 2, n_points=3000,
                     n_steps=6)
    np.testing.assert_array_equal(got[:, 0], np.full(8, 3000.0))
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=0.0)
    for cv in (True, False):
        assert tqp.qmc_path_estimate(got, 100.0, 0.01, 1.0,
                                     control_variate=cv) == \
            jqp.qmc_path_estimate(got, 100.0, 0.01, 1.0, control_variate=cv)


def test_reference_tables_drive_the_same_kernel():
    """The reference's own host arrays, converted, give the port's rows."""
    seed, n, d, R = 4, 1000, 8, 8
    m_bits, d_pad, reps, ppr = tqp._plan(n, d, R)
    V = np.zeros((m_bits, d_pad), np.uint32)
    V[:, :d] = jsobol.direction_numbers(d, m_bits)
    shifts = jqp._replicate_shifts(seed, R=R, d=d, d_pad=d_pad)
    B = np.zeros((d_pad, d_pad), np.float32)
    B[:d, :d] = (0.2 * jqp.bridge_matrix(d, 1.0)).astype(np.float32)
    ours = tqp._kernel_inputs(seed, n, d, *MARKET, n_replicates=R,
                              barrier=0.0, rebate=0.0, payout=1.0)
    theirs = (convert.seed_pair(ours[0]),
              convert.qmc_path_params(np.asarray(ours[1])),
              convert.int32_table(V), convert.int32_table(shifts),
              convert.float32_table(B), convert.float32_table(ours[5]))
    for t, a in zip(theirs, ours):
        assert torch.equal(t, torch.from_numpy(a))
    kw = dict(n_programs=R * ppr, reps=reps, progs_per_rep=ppr, n_steps=d,
              d_pad=d_pad, m_bits=m_bits, payoff_id=0, barrier_up=True,
              knock_in=False, is_call=True, arithmetic=True,
              fixed_strike=True)
    rows = tqp.qmc_path(*theirs, **kw).double().numpy()
    np.testing.assert_array_equal(
        rows.reshape(R, ppr, 6).sum(1),
        tqp.path_qmc_sumstats_kernel(seed, n, d, *MARKET, True,
                                     device="cpu"))


def test_wrapper_rejects_bad_inputs():
    arrays = tqp._kernel_inputs(1, 512, 8, *MARKET, n_replicates=8,
                                barrier=0.0, rebate=0.0, payout=1.0)
    t = [torch.from_numpy(a) for a in arrays]
    kw = dict(n_programs=16, reps=1, progs_per_rep=2, n_steps=8, d_pad=128,
              m_bits=11, payoff_id=0, barrier_up=True, knock_in=False,
              is_call=True, arithmetic=True, fixed_strike=True)
    tqp.qmc_path(*t, **kw)
    with pytest.raises(ValueError, match="B must be"):
        tqp.qmc_path(*t[:4], t[4].double(), t[5], **kw)
    with pytest.raises(ValueError, match="shifts must be"):
        tqp.qmc_path(*t, **dict(kw, n_programs=8))
    with pytest.raises(ValueError, match="shared memory"):
        tqp.qmc_path(*t, **dict(kw, n_steps=56_065, d_pad=56_192))
    with pytest.raises(ValueError, match="unknown payoff"):
        tqp.path_qmc_sumstats_kernel(1, 512, 8, *MARKET, True,
                                     payoff="cliquet", device="cpu")
    with pytest.raises(ValueError, match="2\\^31"):
        tqp.path_qmc_sumstats_kernel(1, 1 << 32, 8, *MARKET, True,
                                     device="cpu")
