"""Port vs reference: the CRR lattice (float64).

The port's backward induction is a Python loop over a batched
(batch, N+1) tensor; the reference's a ``lax.scan``. Same operations in the
same order, so the prices agree to rtol 1e-10 (XLA:CPU may contract a
multiply-add the port rounds twice).
"""
import json
from pathlib import Path

import numpy as np
import pytest

from optpricer_tpu import OptionSpec as JOptionSpec
from optpricer_tpu.models import binomial as jbin
import optpricer_tpu_torch as tp
from optpricer_tpu_torch import convert
from tests.torch_threads import torch_one_thread  # noqa: F401

GOLDENS = json.loads((Path(__file__).with_name("goldens.json")).read_text())
RTOL = 1e-10
JSPEC = JOptionSpec(S0=100.0, K=105.0, T=0.75, r=0.04, sigma=0.22, q=0.01)


@pytest.mark.parametrize("kind", ["call", "put"])
@pytest.mark.parametrize("american", [False, True])
def test_crr_matches_reference(kind, american):
    ref = jbin.crr(JSPEC, kind, N=150, american=american)
    got = tp.crr(convert.option_spec(JSPEC), kind, N=150, american=american,
                 device="cpu")
    assert got == pytest.approx(ref, rel=RTOL)


def test_bermudan_matches_reference():
    dates = [0.25, 0.5]
    ref = jbin.crr(JSPEC, "put", N=120, exercise_dates=dates)
    got = tp.crr(convert.option_spec(JSPEC), "put", N=120,
                 exercise_dates=dates, device="cpu")
    assert got == pytest.approx(ref, rel=RTOL)
    euro = tp.crr(convert.option_spec(JSPEC), "put", N=120, device="cpu")
    amer = tp.crr(convert.option_spec(JSPEC), "put", N=120, american=True,
                  device="cpu")
    assert euro < got < amer


def test_bermudan_and_american_are_exclusive():
    with pytest.raises(ValueError):
        tp.crr(convert.option_spec(JSPEC), "put", N=10, american=True,
               exercise_dates=[0.5], device="cpu")


def test_crr_vec_mixed_kinds_matches_reference():
    rng = np.random.default_rng(0)
    K = rng.uniform(70.0, 130.0, 16)
    kinds = np.where(rng.random(16) < 0.5, "call", "put")
    for american in (False, True):
        ref = np.asarray(jbin.crr_vec(100.0, K, 0.75, 0.04, 0.01, 0.22,
                                      kinds, N=100, american=american))
        got = tp.crr_vec(100.0, K, 0.75, 0.04, 0.01, 0.22, kinds, N=100,
                         american=american, device="cpu").numpy()
        np.testing.assert_allclose(got, ref, rtol=RTOL)


def test_config2_slice():
    # BASELINE config 2 (American put, 1k strikes, N=500), cut to 64
    # strikes and N=200 for the CPU suite
    K = np.linspace(80.0, 120.0, 64)
    ref = np.asarray(jbin.crr_vec(100.0, K, 1.0, 0.03, 0.0, 0.2, "put",
                                  N=200, american=True))
    got = tp.crr_vec(100.0, K, 1.0, 0.03, 0.0, 0.2, "put", N=200,
                     american=True, device="cpu")
    assert got.shape == (64,)
    np.testing.assert_allclose(got.numpy(), ref, rtol=RTOL)


@pytest.mark.parametrize("name,kind,american", [
    ("crr_euro_call_n200", "call", False),
    ("crr_amer_put_n200", "put", True),
])
def test_goldens(name, kind, american):
    spec = tp.OptionSpec(S0=100.0, K=105.0, T=0.75, r=0.04, sigma=0.22,
                         q=0.01)
    got = tp.crr(spec, kind, N=200, american=american, device="cpu")
    assert got == pytest.approx(GOLDENS[name], rel=1e-10)


def test_invalid_tree_raises():
    with pytest.raises(ValueError):
        tp.crr(tp.OptionSpec(100.0, 100.0, 1.0, 0.03, 0.2), N=0,
               device="cpu")
