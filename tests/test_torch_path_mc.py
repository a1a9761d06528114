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

The Dupire branches (``svi_slices=``) are held against the interpreted
kernel run by ``tests/torch_lv_reference.py`` in a process of its own with
XLA:CPU's FMA contraction off (``--xla_cpu_max_isa=AVX``). Their σ_loc
takes ∂w/∂T as an f32 difference quotient over 2e-4 in T, which turns one
ulp of the total variance w into ~2e-4 of σ, so every rounding counts:

* with FMA contraction on, as XLA:CPU compiles by default, the unsigned
  sums differ by up to 8.2e-4 (log-Euler barrier) from the plain version,
  which rounds every operation as the CUDA kernel does;
* with it off they differ by 2.8e-5 at most (Milstein barrier), held at
  ``LV_RTOL`` = 5e-5: torch's cos/sin miss XLA's by an ulp here and there,
  and Milstein's σ′ quotient amplifies the ulp;
* with it off and the reference's own cos/sin in the plain version's
  Box-Muller step, they agree to 3.1e-6, held at the file's 2e-5.

``test_local_vol_sigma_matches_dupire`` holds the plain σ_loc against the
reference's float64 ``dupire_local_vol`` on the same surface at that
resolution (3e-3; 1.1e-3 measured).
"""
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from optpricer_tpu.models import calibration as jcal
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


def _assert_stats_close(got, ref, rtol=RTOL):
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    assert got.shape == ref.shape == (tpm.NSTAT,)
    assert got[0] == ref[0]
    unsigned = [i for i in range(tpm.NSTAT) if i not in SIGNED]
    np.testing.assert_allclose(got[unsigned], ref[unsigned], rtol=rtol,
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
    operand is read by its lv/lsv branches only, so GBM leaves it out)."""
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
    with pytest.raises(ValueError, match="MAX_SLICES"):
        tpm.path_mc_sumstats_kernel(1, 4096, 8, *MARKET, True,
                                    payoff="vanilla", antithetic=True,
                                    svi_slices=np.ones((6, tpm.MAX_SLICES
                                                        + 1)),
                                    device="cpu")
    with pytest.raises(ValueError, match="svi"):
        tpm.path_mc(seed, params, **dict(kw, dynamics="lv_euler"))
    with pytest.raises(ValueError, match="lsv dict misses"):
        tpm.path_mc_sumstats_kernel(1, 4096, 8, *MARKET, True,
                                    payoff="vanilla", antithetic=True,
                                    lsv=dict(HESTON), device="cpu")
    with pytest.raises(ValueError, match="svi"):
        tpm.path_mc(seed, params, **dict(kw, dynamics="lsv_qe"))


# a 3-slice SVI table: rows a, b, ρ, m, σ, T
SVI = np.array([[0.01, 0.02, 0.035], [0.12, 0.14, 0.15], [-0.4, -0.3, -0.25],
                [0.0, 0.02, 0.03], [0.1, 0.12, 0.15], [0.25, 0.5, 1.0]],
               np.float32)
LV_MARKET = MARKET[:5] + (None,)
LV_RTOL = 5e-5
LV_CASES = [(v, s) for s in ("log_euler", "milstein")
            for v in ("vanilla", "barrier-up-out", "asian-geo-floating",
                      "digital", "lookback-floating")]


@pytest.fixture(scope="module")
def lv_reference(tmp_path_factory):
    """The interpreted kernel's statistics for every ``LV_CASES`` case, and
    the plain version's with the reference's cos/sin, from one run of
    ``tests/torch_lv_reference.py`` with FMA contraction off."""
    out = tmp_path_factory.mktemp("lv") / "lv_reference.npz"
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "")
                        + " --xla_cpu_max_isa=AVX").strip()
    script = Path(__file__).with_name("torch_lv_reference.py")
    subprocess.run([sys.executable, str(script), str(out)], env=env,
                   check=True, timeout=600)
    with np.load(out) as data:
        return {key: data[key] for key in data.files}


@pytest.mark.parametrize("variant,scheme", LV_CASES)
def test_local_vol_matches_interpret_kernel(variant, scheme, lv_reference):
    kw, is_call = VARIANTS[variant]
    got = tpm.path_mc_sumstats_kernel(7, 4096, 8, *LV_MARKET, is_call,
                                      antithetic=True, svi_slices=SVI,
                                      scheme=scheme, device="cpu", **kw)
    _assert_stats_close(got.numpy(), lv_reference[f"ref|{variant}|{scheme}"],
                        rtol=LV_RTOL)
    assert not got[11:].any()


@pytest.mark.parametrize("variant,scheme", LV_CASES)
def test_local_vol_same_normals_match_interpret_kernel(variant, scheme,
                                                       lv_reference):
    got = lv_reference[f"same_normals|{variant}|{scheme}"]
    _assert_stats_close(got, lv_reference[f"ref|{variant}|{scheme}"])
    assert not got[11:].any()


def test_local_vol_sigma_matches_dupire():
    """The plain σ_loc (f32, the kernel's forward S0·e^{(r−q)t} and select
    chain) against the reference's float64 Dupire on the same surface,
    whose log-linear forward curve through S0·e^{(r−q)T} is that forward
    exactly; t sweeps the short, interpolated and flat-vol regions."""
    S0, r, q = 100.0, 0.03, 0.01
    surf = jcal.VolSurface(
        {float(T): jcal.SVIParams(*(float(v) for v in SVI[:5, i]),
                                  expiry=float(T))
         for i, T in enumerate(SVI[5])},
        forward_curve={float(T): S0 * np.exp((r - q) * float(T))
                       for T in SVI[5]})
    params = tpm._common_params(4096, 8, S0, 100.0, 1.0, r, q, 0.0, True,
                                0.0, 0.0, 1.0, 0.01)
    p = tpm._Scalars(params, "lv_euler", torch.as_tensor(SVI))
    S = np.linspace(60.0, 160.0, 201).astype(np.float32)
    for t in np.linspace(0.0, 1.4, 29).astype(np.float32):
        ref = np.asarray(jcal.dupire_local_vol(surf, S.astype(np.float64),
                                               float(t), r, q))
        got = tpm._sigma_loc(p, torch.as_tensor(S), t).numpy()
        np.testing.assert_allclose(got, ref, rtol=3e-3, err_msg=str(t))
