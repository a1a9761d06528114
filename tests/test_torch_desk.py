"""The config-5 desk workflow on the port, end to end on the CPU at a
reduced size (``optpricer_tpu_torch/scripts/desk_workflow_localvol_barrier``:
SVI calibration → Dupire σ(S, t) → local-vol FDM, Milstein path matrix and
the path kernel's Dupire branches → Greeks). Every number is finite and the
prices are ordered as the contract implies; the two local-vol Monte-Carlo
barriers (path matrix, fused kernel) agree within their error bars, and the
calibrated surface is the reference's (tests/test_torch_calibration.py
holds the fit itself)."""
import math

import numpy as np
import pytest

from optpricer_tpu.models import calibration as jc
from optpricer_tpu_torch.scripts import desk_workflow_localvol_barrier as desk
from tests.torch_threads import torch_one_thread  # noqa: F401


@pytest.fixture(scope="module")
def out():
    return desk.run(n_paths=4000, n_steps=20, device="cpu")


def _numbers(value):
    if isinstance(value, dict):
        for v in value.values():
            yield from _numbers(v)
    elif isinstance(value, (list, tuple)):
        for v in value:
            yield from _numbers(v)
    elif isinstance(value, float):
        yield value


def test_every_number_is_finite(out):
    values = list(_numbers(out))
    assert len(values) > 40
    assert all(math.isfinite(v) for v in values)
    assert set(out["times"]) == {"calibration", "dupire", "fdm", "fdm_lv",
                                 "mc_paths", "fused", "greeks"}


def test_prices_are_ordered(out):
    assert 0.0 < out["fdm_barrier"] < out["fdm_vanilla"]
    assert out["fdm_vanilla"] == pytest.approx(out["bs_vanilla"], rel=1e-3)
    for ko in ("mc_barrier", "fused_barrier"):
        assert 0.0 < out[ko] < out["fdm_lv_vanilla"], ko
    gap = abs(out["mc_barrier"] - out["fused_barrier"])
    assert gap < 5.0 * math.hypot(out["mc_se"], out["fused_se"]) + 1e-3
    assert abs(out["mc_vanilla"] - out["fdm_lv_vanilla"]) < 0.5
    assert abs(out["grid_greeks"]["delta"]
               - out["bump_greeks"]["delta"]) < 0.005
    assert all(0.01 <= s <= 5.0 for _, _, s in out["dupire"])


def test_calibration_is_the_reference_fit(out):
    S0, r, q, _, forwards, strikes, ivs = desk.synth_market()
    ref = jc.fit_svi_surface(strikes, forwards, ivs)
    for T, p in ref.slices.items():
        k = np.log(strikes[T] / forwards[T])
        w_ref = p.a + p.b * (p.rho * (k - p.m)
                             + np.sqrt((k - p.m) ** 2 + p.sigma ** 2))
        s = out["svi"][T]
        w = s["a"] + s["b"] * (s["rho"] * (k - s["m"])
                               + np.sqrt((k - s["m"]) ** 2 + s["sigma"] ** 2))
        np.testing.assert_allclose(w, w_ref, rtol=1e-8)
        assert s["rmse"] < 1e-3


def test_main_prints_the_six_stages(capsys):
    desk.main(["--device", "cpu", "--n-paths", "2000", "--n-steps", "8"])
    text = capsys.readouterr().out
    for step in range(1, 7):
        assert f"Step {step} —" in text
    assert "Fused kernel (local vol)" in text and "2,000 paths" in text
