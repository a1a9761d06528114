"""Port vs reference: the path kernel's plain version (K4).

The JAX kernel runs as the JAX package's own tests run it on the CPU:
``path_mc_sumstats_pallas(..., interpret=True)``, which selects the
software Threefry stream. The port runs on ``device="cpu"``, which takes
the plain torch version of its CUDA kernel. Both draw the same numbers and
walk the same per-path recursion, so on the 21 statistics:

* the count (stat 0) agrees exactly;
* every unsigned sum (payoff, control variates, exercise indicator and
  every ΣY²) agrees to rtol 2e-5: the tile sums run in another order than
  XLA:CPU's reductions and cos/sin differ by an ulp (max 7.8e-6 measured,
  on ΣY2, a sum of one repeated value);
* every signed Greek sum ΣY (vega, rho, theta, LR delta, gamma) agrees
  within 2e-5·√(n·ΣY²), a relative bound on the sum's natural scale
  (a signed sum can cancel to near zero).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from optpricer_tpu.ops import pallas_mc as jmc
from optpricer_tpu.ops import pallas_path_mc as jpm
from optpricer_tpu_torch import convert
from optpricer_tpu_torch.ops import path_mc as tpm
from optpricer_tpu_torch.ops import terminal_mc as tmc
from tests.torch_threads import torch_one_thread  # noqa: F401

MARKET = (100.0, 105.0, 1.0, 0.03, 0.01, 0.2)  # S0, K, T, r, q, sigma
RTOL = 2e-5
SIGNED = (11, 13, 15, 17, 19)
HESTON = dict(v0=0.04, kappa=1.5, theta=0.05, xi=0.6, rho=-0.7)
SABR = dict(alpha0=0.2, beta=0.6, nu=0.4, rho=-0.3)


def _assert_stats_close(got, ref):
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    assert got.shape == ref.shape == (tpm.NSTAT,)
    assert got[0] == ref[0]
    unsigned = [i for i in range(tpm.NSTAT) if i not in SIGNED]
    np.testing.assert_allclose(got[unsigned], ref[unsigned], rtol=RTOL,
                               atol=0.0)
    for i in SIGNED:
        scale = np.sqrt(ref[0] * ref[i + 1])
        assert abs(got[i] - ref[i]) <= RTOL * scale, (i, got[i], ref[i])


# (payoff kwargs, is_call) for every payoff variant the kernel has
VARIANTS = {
    "vanilla": (dict(payoff="vanilla"), True),
    "barrier-up-out": (dict(payoff="barrier", barrier=120.0,
                            barrier_type="up-and-out"), True),
    "barrier-down-in": (dict(payoff="barrier", barrier=92.0,
                             barrier_type="down-and-in", rebate=1.5), False),
    "asian-arith-geo_cv": (dict(payoff="asian", geo_cv=True), True),
    "asian-geo-floating": (dict(payoff="asian", average_type="geometric",
                                strike_type="floating"), False),
    "digital": (dict(payoff="digital", payout=2.0), False),
    "lookback-fixed": (dict(payoff="lookback"), True),
    "lookback-floating": (dict(payoff="lookback", strike_type="floating"),
                          False),
}


def _both(seed, n_paths, n_steps, is_call, **kw):
    ref = jpm.path_mc_sumstats_pallas(seed, n_paths, n_steps, *MARKET,
                                      is_call, interpret=True, **kw)
    got = tpm.path_mc_sumstats_kernel(seed, n_paths, n_steps, *MARKET,
                                      is_call, device="cpu", **kw)
    assert got.dtype == torch.float32 and got.shape == (tpm.NSTAT,)
    return got.numpy(), np.asarray(ref)


@pytest.mark.parametrize("greeks", [False, True])
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_payoffs_match_interpret_kernel(variant, greeks):
    kw, is_call = VARIANTS[variant]
    got, ref = _both(3, 4096, 8, is_call, antithetic=not greeks,
                     greek_stats=greeks, **kw)
    _assert_stats_close(got, ref)
    if not greeks:
        assert not got[11:].any()


@pytest.mark.parametrize("dynamics", [
    dict(heston=HESTON), dict(heston=HESTON, scheme="qe"),
    dict(sabr=dict(SABR, beta=1.0)), dict(sabr=SABR)],
    ids=["heston", "heston_qe", "sabr_ln", "sabr_cev"])
@pytest.mark.parametrize("variant", ["vanilla", "barrier-up-out"])
def test_dynamics_match_interpret_kernel(dynamics, variant):
    kw, is_call = VARIANTS[variant]
    got, ref = _both(5, 4096, 8, is_call, antithetic=True, **dynamics, **kw)
    _assert_stats_close(got, ref)


def test_ragged_count_matches_interpret_kernel():
    got, ref = _both(9, 8192 - 1001, 8, True, antithetic=True,
                     payoff="asian", greek_stats=True)
    assert got[0] == 8192 - 1001
    _assert_stats_close(got, ref)


@pytest.mark.parametrize("greeks", [False, True])
def test_two_reps_match_reference_runner(greeks):
    """Both sides' internal runners on one program of two reps, fed the
    reference's own params through ``convert`` (the reference's ``svi``
    operand is read by its lv/lsv branches only, which are not ported)."""
    n_paths = 6000
    params, svi, static = jpm._resolve_config(
        n_paths, 8, *MARKET, True, "lookback", True, 0.0, "up-and-out", 0.0,
        "arithmetic", "floating", 1.0, None, "log_euler", 0.01, None)
    seed = jnp.asarray([17, 0], jnp.int32)
    ref = jpm._run_path_kernel(seed, params, svi, n_programs=1, reps=2,
                               interpret=True, sw_prng=True,
                               with_greeks=greeks, **static)
    t_params = convert.path_params(params)
    t_params_own, t_static = tpm._resolve_config(
        n_paths, 8, *MARKET, True, "lookback", True, 0.0, "up-and-out", 0.0,
        "arithmetic", "floating", 1.0, None, "log_euler", 0.01, None)
    assert torch.equal(t_params, t_params_own)
    got = tpm.path_mc(convert.seed_pair(seed), t_params, n_programs=1,
                      reps=2, with_greeks=greeks, **t_static)
    assert float(got[0]) == n_paths
    _assert_stats_close(got.numpy(), ref)


def test_plan_grid_is_the_reference_layout():
    for n in (1, 4097, 1_000_000, 1 << 26):
        assert tmc._plan_grid(n, tpm.TILE) == jmc._plan_grid(n, jpm.TILE)


def test_plain_version_is_deterministic():
    kw = dict(payoff="barrier", barrier=115.0, antithetic=True,
              heston=HESTON, scheme="qe", device="cpu")
    a = tpm.path_mc_sumstats_kernel(2, 5000, 8, *MARKET, True, **kw)
    b = tpm.path_mc_sumstats_kernel(2, 5000, 8, *MARKET, True, **kw)
    assert torch.equal(a, b)


def test_wrapper_rejects_bad_inputs():
    params, static = tpm._resolve_config(
        4096, 8, *MARKET, True, "vanilla", True, 0.0, "up-and-out", 0.0,
        "arithmetic", "fixed", 1.0, None, "log_euler", 0.01, None)
    seed = torch.tensor([1, 0], dtype=torch.int32)
    kw = dict(n_programs=1, reps=1, **static)
    with pytest.raises(ValueError):
        tpm.path_mc(seed.long(), params, **kw)
    with pytest.raises(ValueError):
        tpm.path_mc(seed, params[:7], **kw)
    with pytest.raises(ValueError, match="even"):
        tpm.path_mc(seed, params, **dict(kw, n_steps=7))
    with pytest.raises(ValueError, match="GBM"):
        tpm.path_mc(seed, params,
                    **dict(kw, dynamics="heston", with_greeks=True))
    with pytest.raises(ValueError, match="geo_cv"):
        tpm.path_mc(seed, params, **dict(kw, geo_cv=True))
    with pytest.raises(ValueError, match="2\\*\\*24"):
        tpm.path_mc(seed, params, **dict(kw, n_programs=1 << 12,
                                               reps=1 << 12))
    with pytest.raises(ValueError, match="even n_steps"):
        tpm.path_mc_sumstats_kernel(1, 4096, 9, *MARKET, True,
                                    payoff="vanilla", antithetic=True,
                                    device="cpu")
    with pytest.raises(NotImplementedError, match="B.3.2"):
        tpm.path_mc_sumstats_kernel(1, 4096, 8, *MARKET, True,
                                    payoff="vanilla", antithetic=True,
                                    svi_slices=np.zeros((6, 2)),
                                    device="cpu")
    with pytest.raises(NotImplementedError, match="B.3.5"):
        tpm.path_mc_sumstats_kernel(1, 4096, 8, *MARKET, True,
                                    payoff="vanilla", antithetic=True,
                                    lsv=dict(HESTON), device="cpu")
