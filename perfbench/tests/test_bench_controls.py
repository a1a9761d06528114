"""The comparison that decides ``correct`` fails what it must fail.

* The control: the plain reference in bfloat16 (the nearest precision
  below the float32 the configurations state), put in the program's place,
  comes out not correct.
* The faults: a run with the timed path broken underneath, half of its
  batch left out (the mean taken over the rest) or an answer altered
  where it is produced, comes out not correct, where the same run
  unbroken is correct.

On the CPU both run at sizes a test can hold, the program on its plain
torch versions; ``calibrate.py`` reads the control at the cells' own
sizes on the card.
"""
import json
from pathlib import Path

import pytest
import torch

from perfbench import generator, harness

SEED = 2**31 + 4242
# sizes a CPU test can hold; noise in the standard errors shrinks with
# the draws, so the MC cells keep many paths and few steps, and the book
# keeps its strikes' span at 128 contracts
BOOK = json.loads((Path(__file__).resolve().parents[1] / "traffic"
                   / "book.json").read_text())["groups"]
MIX = {"gbm_mc.asian": {"sizes": {"n_paths": 65536, "n_steps": 4}},
       "lv_desk.barrier_mc": {"sizes": {"n_paths": 65536, "n_steps": 4}},
       "gbm_mc.euro_book": {"sizes": {"n_paths": 262144},
                            "groups": [dict(BOOK[0], n=128)]}}
CELLS = list(MIX)


@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(name):
    cell = harness.with_mix(harness.load_cell(name), MIX[name])
    n = min(cell["sample"], 4)
    reqs = generator.Requests(cell["config_data"], cell["traffic_data"],
                              SEED, generator.WINDOW).take(n)
    outs = harness.reference(cell["traffic_data"]["entry"]).control(
        cell["config_data"], cell["traffic_data"], reqs, device="cpu",
        seed=SEED, dtype=torch.bfloat16)
    checks = harness.judge(cell, list(zip(reqs, outs)), SEED, "cpu")
    assert any(c["value"] > c["limit"] for c in checks.values()), checks


def _wrap(monkeypatch, module, name, fn):
    orig = getattr(module, name)
    monkeypatch.setattr(module, name, lambda *a, **k: fn(orig, *a, **k))


def half_batch(monkeypatch, entry):
    """Half of the draws left out, the rest standing for all."""
    if entry in ("path_mc_asian", "path_mc_barrier_lv"):
        from optpricer_tpu_torch.models import mc_fused

        def half(orig, seed, n_paths, *a, **k):
            return orig(seed, n_paths // 2, *a, **k)
        _wrap(monkeypatch, mc_fused, "path_mc_sumstats_kernel", half)
    else:
        from optpricer_tpu_torch.ops import mc_batch as tmb

        def half(orig, seed, params, *a, **k):
            return orig(seed, params / 2, *a, **k)
        _wrap(monkeypatch, tmb, "mc_batch", half)


def altered(monkeypatch, entry):
    """The payoff's sum raised by 1% where the kernel produces it."""
    if entry in ("path_mc_asian", "path_mc_barrier_lv"):
        from optpricer_tpu_torch.models import mc_fused

        def bump(orig, *a, **k):
            s = orig(*a, **k).clone()
            s[1] *= 1.01
            return s
        _wrap(monkeypatch, mc_fused, "path_mc_sumstats_kernel", bump)
    else:
        from optpricer_tpu_torch.ops import mc_batch as tmb

        def bump(orig, *a, **k):
            s = orig(*a, **k).clone()
            s[:, 1, :] *= 1.01
            return s
        _wrap(monkeypatch, tmb, "mc_batch", bump)


def _run(name):
    return harness.run_cell(name, SEED, 0.5, False, device="cpu",
                            mix=MIX[name])


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name):
    r = _run(name)
    assert r["correct"], r["checks"]


@pytest.mark.parametrize("fault", [half_batch, altered])
@pytest.mark.parametrize("name", CELLS)
def test_fault_is_not_correct(name, fault, monkeypatch):
    fault(monkeypatch, harness.load_cell(name)["traffic_data"]["entry"])
    r = _run(name)
    assert not r["correct"], r["checks"]


@pytest.mark.cuda
def test_control_on_the_card_at_the_cells_size():
    """The control at a cell's own size on the card (the readings come
    from ``calibrate.py``; this keeps one seed of two books)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cell = harness.load_cell("gbm_mc.euro_book")
    reqs = generator.Requests(cell["config_data"], cell["traffic_data"],
                              SEED, generator.WINDOW).take(2)
    outs = harness.reference("mc_batch_book").control(
        cell["config_data"], cell["traffic_data"], reqs, device="cuda",
        seed=SEED, dtype=torch.bfloat16)
    checks = harness.judge(cell, list(zip(reqs, outs)), SEED, "cuda")
    assert any(c["value"] > c["limit"] for c in checks.values()), checks
