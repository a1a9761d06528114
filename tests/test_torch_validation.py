"""Port vs reference: ``optpricer_tpu_torch/validation.py`` on the CPU.

* ``cross_validate`` / ``convergence_analysis``: the deterministic engines
  (Black-Scholes, CRR, FD, FEM) equal to the reference's at rtol 1e-9 (the
  PDE stack's parity band, ``tests/test_torch_pde.py``); the Monte-Carlo
  entries draw from the port's own stream and agree within 4 combined
  standard errors; ``max_discrepancy`` below 0.5 at the defaults and below
  0.1 for ``["bs", "fdm"]`` (``tests/test_validation.py:17``, ``:24``).
* ``stress_test``: the Black-Scholes cube and the per-point tree cube at
  rtol 1e-12 with atol 1e-13.
* ``backtest_delta_hedge`` fed the same float64 paths: every path's P&L at
  atol 1e-10 (1e-12 of the spot: the P&L sums n_steps cash flows of size
  ~S0 that cancel to O(1)), and the summary statistics with it.
"""
import numpy as np
import pytest

from optpricer_tpu import core as jcore
from optpricer_tpu import validation as jv
import optpricer_tpu_torch as tp
from optpricer_tpu_torch import validation as tv
from tests.torch_threads import torch_one_thread  # noqa: F401

CPU = dict(device="cpu")
SPEC = dict(S0=100.0, K=105.0, T=0.75, r=0.04, sigma=0.22, q=0.01)
SMALL = dict(mc_paths=20_000, tree_N=200, fd_N_S=120, fd_N_t=120,
             fem_N_S=120, fem_N_t=120)


@pytest.mark.parametrize("kind", ["call", "put"])
def test_cross_validate_matches_reference(kind):
    got = tv.cross_validate(tp.OptionSpec(**SPEC), kind, **SMALL, **CPU)
    want = jv.cross_validate(jcore.OptionSpec(**SPEC), kind, **SMALL)
    assert set(got) == set(want)
    for name in ("bs", "tree", "fdm", "fem"):
        assert got[name] == pytest.approx(want[name], rel=1e-9), name
    (px, se), (ref, ref_se) = got["mc"], want["mc"]
    assert abs(px - ref) <= 4.0 * np.hypot(se, ref_se)
    assert got["max_discrepancy"] < 0.1


def test_cross_validate_defaults_and_subsets():
    spec = tp.OptionSpec(S0=100.0, K=100.0, T=1.0, r=0.05, sigma=0.2)
    assert tv.cross_validate(spec, "call", **CPU)["max_discrepancy"] < 0.5
    two = tv.cross_validate(spec, "call", methods=["bs", "fdm"], **CPU)
    assert set(two) == {"bs", "fdm", "max_discrepancy"}
    assert two["max_discrepancy"] < 0.1
    assert np.isnan(tv.cross_validate(spec, "call", methods=["tree"],
                                      tree_N=50, **CPU)["max_discrepancy"])


@pytest.mark.parametrize("method, values", [("tree", [50, 100, 200]),
                                            ("fdm", [40, 80]),
                                            ("fem", [40, 80])])
def test_convergence_analysis_matches_reference(method, values):
    got = tv.convergence_analysis(tp.OptionSpec(**SPEC), "put", method, "N",
                                  values, **CPU)
    want = jv.convergence_analysis(jcore.OptionSpec(**SPEC), "put", method,
                                   "N", values)
    assert got["params"] == want["params"]
    np.testing.assert_allclose(got["prices"], want["prices"], rtol=1e-9)
    assert got["order"] == pytest.approx(want["order"], abs=1e-6)


def test_convergence_analysis_mc_and_errors():
    spec = tp.OptionSpec(**SPEC)
    got = tv.convergence_analysis(spec, "call", "mc", "n_paths",
                                  [4_000, 64_000], reference=6.0, **CPU)
    assert got["errors"] == [abs(p - 6.0) for p in got["prices"]]
    with pytest.raises(ValueError):
        tv.convergence_analysis(spec, "call", "lsmc", "N", [10], **CPU)


@pytest.mark.parametrize("pricer", ["bs", "tree"])
def test_stress_test_matches_reference(pricer):
    spots, vols, rates = [0.8, 1.0, 1.2], [-0.05, 0.0, 0.1], [0.0, 0.01]
    if pricer == "tree":
        spots, vols, rates = [0.9, 1.1], [0.0, 0.05], [0.0]
    got = tv.stress_test(tp.OptionSpec(**SPEC), "put", spots, vols, rates,
                         pricer=pricer, **CPU)
    want = jv.stress_test(jcore.OptionSpec(**SPEC), "put", spots, vols,
                          rates, pricer=pricer)
    assert isinstance(got, np.ndarray) and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-13)
    with pytest.raises(ValueError):
        tv.stress_test(tp.OptionSpec(**SPEC), "put", spots, vols, rates,
                       pricer="mc", **CPU)


@pytest.mark.parametrize("kind", ["call", "put"])
@pytest.mark.parametrize("freq", [1, 4, 7])
def test_backtest_delta_hedge_matches_reference(kind, freq):
    paths = tp.gbm_paths(100.0, 0.04, 0.01, 0.22, 0.75, 21, 300, seed=3,
                         **CPU).numpy()
    got = tv.backtest_delta_hedge(tp.OptionSpec(**SPEC), kind, paths, freq,
                                  **CPU)
    want = jv.backtest_delta_hedge(jcore.OptionSpec(**SPEC), kind, paths,
                                   freq)
    assert set(got) == set(want)
    np.testing.assert_allclose(got["pnl"], want["pnl"], rtol=0.0, atol=1e-10)
    for name in ("mean_pnl", "std_pnl", "max_drawdown"):
        assert got[name] == pytest.approx(want[name], abs=1e-10), name
