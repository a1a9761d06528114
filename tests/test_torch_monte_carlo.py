"""Port vs reference: the Monte-Carlo slice as a whole.

The port's public ``euro_price_mc`` / ``euro_greeks_mc`` run on
``device="cpu"`` (the kernels' plain versions). The JAX side is the
composition its own ``backend="pallas"`` path makes —
``mc_sumstats_pallas(interpret=True)`` and ``pallas_estimate`` /
``pallas_greeks`` — because the JAX entry point refuses the Pallas backend
off-TPU. Both price the same draws, so the prices differ only by f32 sum
order: held to 0.05 standard errors (0.017 measured), the Greeks to
rtol 1e-4 (1.1e-5 measured).
"""
import json
from pathlib import Path

import pytest
import torch

from optpricer_tpu.ops import pallas_mc as jmc
import optpricer_tpu_torch as tp
from tests.torch_threads import torch_one_thread  # noqa: F401

GOLDENS = json.loads((Path(__file__).with_name("goldens.json")).read_text())
SPEC = dict(S0=100.0, K=110.0, T=1.0, r=0.03, sigma=0.2, q=0.0)
SEED, N_PATHS = 7, 1 << 17


def _market(spec):
    return (spec["S0"], spec["K"], spec["T"], spec["r"], spec["q"],
            spec["sigma"])


def _reference_stats(kind, antithetic):
    return jmc.mc_sumstats_pallas(SEED, N_PATHS, *_market(SPEC),
                                  kind == "call", antithetic=antithetic,
                                  interpret=True)


@pytest.mark.parametrize("kind", ["call", "put"])
@pytest.mark.parametrize("antithetic", [True, False])
@pytest.mark.parametrize("control_variate", [True, False])
def test_price_matches_reference(kind, antithetic, control_variate):
    ref_px, ref_se = jmc.pallas_estimate(
        _reference_stats(kind, antithetic), *_market(SPEC), kind == "call",
        control_variate)
    px, se = tp.euro_price_mc(tp.OptionSpec(**SPEC), kind, n_paths=N_PATHS,
                              seed=SEED, antithetic=antithetic,
                              control_variate=control_variate, device="cpu")
    assert abs(px - ref_px) <= 0.05 * ref_se
    assert se == pytest.approx(ref_se, rel=0.05)


@pytest.mark.parametrize("kind", ["call", "put"])
def test_greeks_match_reference(kind):
    ref = jmc.pallas_greeks(_reference_stats(kind, True), *_market(SPEC),
                            kind == "call")
    got = tp.euro_greeks_mc(tp.OptionSpec(**SPEC), kind, n_paths=N_PATHS,
                            seed=SEED, device="cpu")
    assert got.keys() == ref.keys()
    for name, value in ref.items():
        assert got[name] == pytest.approx(value, rel=1e-4), name


def test_price_against_black_scholes():
    spec = tp.OptionSpec(**SPEC)
    bs = tp.bs_price(spec, "call", device="cpu")
    px, se = tp.euro_price_mc(spec, "call", n_paths=N_PATHS, seed=SEED,
                              device="cpu")
    assert abs(px - bs) <= 4.0 * se + 1e-4


def test_qmc_golden():
    # tests/golden_cases.py "mc_qmc_call_seed7", read without running JAX.
    # 5e-6 abs (3.2e-6 measured, 0.022 stderr): the golden's f32 replicate
    # sums carry XLA:CPU's summation order, the port's torch's.
    golden = GOLDENS["mc_qmc_call_seed7"]
    spec = tp.OptionSpec(S0=100.0, K=105.0, T=0.75, r=0.04, sigma=0.22,
                         q=0.01)
    px, se = tp.euro_price_mc(spec, "call", n_paths=1 << 18, seed=7,
                              backend="qmc", device="cpu")
    assert px == pytest.approx(golden["price"], abs=5e-6)
    assert se == pytest.approx(golden["stderr"], rel=0.01)


def test_seed_reproducible():
    spec = tp.OptionSpec(**SPEC)
    a = tp.euro_price_mc(spec, "put", n_paths=50_000, seed=123, device="cpu")
    b = tp.euro_price_mc(spec, "put", n_paths=50_000, seed=123, device="cpu")
    assert a == b


@pytest.mark.parametrize("fn", ["euro_price_mc", "euro_greeks_mc"])
def test_unported_paths_raise(fn):
    spec = tp.OptionSpec(**SPEC)
    engine = getattr(tp, fn)
    with pytest.raises(NotImplementedError, match="xla"):
        engine(spec, "call", n_paths=1000, seed=1, backend="xla",
               device="cpu")
    with pytest.raises(NotImplementedError, match="mesh"):
        engine(spec, "call", n_paths=1000, seed=1, mesh=object(),
               device="cpu")


def test_cuda_request_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: nothing to refuse")
    spec = tp.OptionSpec(**SPEC)
    with pytest.raises(RuntimeError, match="cuda"):
        tp.euro_price_mc(spec, "call", n_paths=1000, seed=1, device="cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        tp.euro_price_mc(spec, "call", n_paths=1000, seed=1)  # the default
    with pytest.raises(RuntimeError, match="cuda"):
        tp.euro_greeks_mc(spec, "call", n_paths=1000, seed=1)
