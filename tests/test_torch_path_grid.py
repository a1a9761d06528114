"""The path kernel's (K4) launch plan and input checks, on the CPU.

``path_mc`` sizes the kernel's scratch from ``_launch_plan``: one block of
128 paths per (program, rep, block in tile) for every dynamics but the
Dupire ones, whose threads loop over the reps, so a program's stats rows
(the first combine pass's segment) are reps x 32 or 32. The LSV branches
stage their leverage table ``LEV_WINDOW`` steps at a time, so the input
checks put no bound on ``n_steps``; the plain version prices such a table
as the interpreted TPU kernel does, on one tile. An unknown dynamics is
refused with the known names. Nothing here launches a kernel.
"""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from optpricer_tpu_torch.ops import path_mc as tpm

CSRC = Path(tpm.__file__).resolve().parent.parent / "csrc" / "path_mc.cu"
PER_PATH = ["gbm", "heston", "heston_qe", "sabr_ln", "sabr_cev", "lsv",
            "lsv_qe"]
GRIDS = [(64, 1), (62, 4), (3, 7), (1, 1)]


def _kernel_constant(name: str) -> int:
    m = re.search(rf"constexpr int {name} = (\d+);", CSRC.read_text())
    assert m, name
    return int(m.group(1))


@pytest.mark.parametrize("dynamics", PER_PATH)
@pytest.mark.parametrize("n_programs, reps", GRIDS)
def test_launch_plan_is_one_block_per_program_rep_and_tile_block(
        dynamics, n_programs, reps):
    blocks, rows = tpm._launch_plan(dynamics, n_programs, reps)
    assert rows == reps * tpm.TILE // 128
    assert blocks == n_programs * reps * 32 == n_programs * rows


@pytest.mark.parametrize("dynamics", ["lv_euler", "lv_milstein"])
@pytest.mark.parametrize("n_programs, reps", GRIDS)
def test_launch_plan_keeps_the_dupire_rep_loop(dynamics, n_programs, reps):
    blocks, rows = tpm._launch_plan(dynamics, n_programs, reps)
    assert rows == 32
    assert blocks == n_programs * 32


def test_launch_plan_covers_every_path_once():
    # a block holds 128 paths: the per-path grid's blocks cover the
    # (n_programs, reps, TILE) paths of the plain version exactly once
    for n_paths in (1, 4096, (1 << 18) + 123, 1_000_000, 1 << 20):
        reps, n_programs = tpm._plan_grid(n_paths, tpm.TILE)
        blocks, rows = tpm._launch_plan("gbm", n_programs, reps)
        assert blocks * 128 == n_programs * reps * tpm.TILE >= n_paths
        assert rows * 128 == reps * tpm.TILE


def test_config3_grid_rows():
    # config 3's asian: 1M paths on 62 programs x 4 reps, 7 936 rows of
    # 96 bytes, each program's 128 rows one combine segment
    reps, n_programs = tpm._plan_grid(1_000_000, tpm.TILE)
    assert (reps, n_programs) == (4, 62)
    assert tpm._launch_plan("gbm", n_programs, reps) == (7936, 128)
    assert tpm._launch_plan("lv_milstein", n_programs, reps) == (1984, 32)


def test_kernel_constants_match_the_wrapper():
    assert _kernel_constant("LEV_WINDOW") == tpm.LEV_WINDOW
    assert tpm.LEV_WINDOW % 2 == 0   # a step pair never straddles two windows
    assert _kernel_constant("MAX_COEFFS") == tpm.MAX_COEFFS
    assert _kernel_constant("THREADS") == tpm._THREADS
    assert _kernel_constant("ROW") == tpm._ROW


def _lsv(n_steps, deg, scheme="euler", seed=0):
    rng = np.random.default_rng(seed)
    coeffs = 0.05 * rng.standard_normal((n_steps, deg + 1))
    coeffs[:, -1] += 1.0
    return dict(v0=0.04, kappa=1.5, theta=0.04, xi=0.5, rho=-0.6,
                coeffs=coeffs, x_width=0.6, scheme=scheme)


@pytest.mark.parametrize("n_steps, deg", [
    (tpm.LEV_WINDOW, 12), (tpm.LEV_WINDOW + 2, 12),
    (2 * tpm.LEV_WINDOW + 2, 5), (2, 0)])
def test_input_checks_accept_tables_beyond_one_window(n_steps, deg):
    params, static = tpm._resolve_config(
        4096, n_steps, 100.0, 100.0, 1.0, 0.03, 0.0, None, True, "vanilla",
        True, 0.0, "up-and-out", 0.0, "arithmetic", "fixed", 1.0, None,
        "log_euler", 0.01, None, lsv=_lsv(n_steps, deg))
    assert tuple(static["svi"].shape) == (n_steps, deg + 1)
    seed = torch.tensor([1, 0], dtype=torch.int32)
    tpm._check_inputs(seed, params, 1, 1, n_steps, static["dynamics"],
                      False, static["payoff_id"], False, static["svi"])


@pytest.mark.parametrize("scheme", ["euler", "qe"])
def test_plain_version_prices_past_one_window(scheme):
    # a table one step pair past LEV_WINDOW: the port's plain version
    # against the interpreted TPU kernel on one 32 x 128 tile
    from optpricer_tpu.ops import pallas_path_mc as jpm

    n, n_steps = tpm.TILE, tpm.LEV_WINDOW + 2
    args = (3, n, n_steps, 100.0, 100.0, 1.0, 0.03, 0.0, 0.0, True)
    kw = dict(payoff="barrier", barrier=125.0, antithetic=True,
              lsv=_lsv(n_steps, 12, scheme))
    ref = np.asarray(jpm.path_mc_sumstats_pallas(*args, interpret=True,
                                                 **kw), np.float64)
    got = tpm.path_mc_sumstats_kernel(*args, device="cpu", **kw)
    got = got.numpy().astype(np.float64)
    assert got[0] == ref[0] == n
    np.testing.assert_allclose(got[1:11], ref[1:11], rtol=2e-5, atol=0.0)
    assert not got[11:].any() and not ref[11:].any()


def test_unknown_dynamics_is_refused_with_the_known_names():
    seed = torch.zeros(2, dtype=torch.int32)
    params = torch.zeros(tpm.NPARAM, dtype=torch.float32)
    with pytest.raises(ValueError, match="unknown dynamics 'gbm2'") as err:
        tpm.path_mc(seed, params, n_programs=1, reps=1, n_steps=8,
                    antithetic=False, payoff_id=0, barrier_up=True,
                    knock_out=True, average_geo=False, strike_floating=False,
                    is_call=True, dynamics="gbm2")
    for name in tpm.DYNAMICS:
        assert name in str(err.value)
