"""The randomised-QMC terminal kernel's (K2) launch plan, on the CPU.

``terminal_qmc_kernel`` runs a program as one cluster of ``_QMC_CLUSTER``
blocks, each block ``_QMC_ROWS`` of the program's 128 block rows, a group
of ``_QMC_GROUP`` threads a row at a time, a thread ``_QMC_ELEMS``
elements of a row's 32-element warp row, which it folds in registers as
``block_row``'s shuffle tree pairs them. Here, with plain mirrors of that
arithmetic:

* every (program, rep, element) point is formed exactly once, at every
  block size the wrapper chooses from;
* every program is full (no weight) at the main path's 2^20 x 16 and
  2^22 x 16, and a ragged count has the tail the plain version's f32
  weights give;
* the register fold plus the remaining shuffle levels equals
  ``block_row``'s pairing bit for bit on random f32 rows;
* the plan's constants and the argument words equal those of
  ``csrc/terminal_mc.cu``.

Nothing here launches a kernel.
"""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from optpricer_tpu_torch.dtypes import MC_DTYPE
from optpricer_tpu_torch.ops import terminal_mc as tmc
from tests.torch_threads import torch_one_thread  # noqa: F401

SRC = (Path(tmc.__file__).resolve().parent.parent / "csrc"
       / "terminal_mc.cu").read_text()
MARKET = (100.0, 110.0, 1.0, 0.03, 0.01, 0.2)


def _constant(name: str) -> int:
    m = re.search(rf"constexpr int {name} = ([^;]+);", SRC)
    assert m, name
    return m.group(1)


def test_plan_constants_match_the_kernel():
    assert int(_constant("QMC_CLUSTER")) == tmc._QMC_CLUSTER
    assert int(_constant("QMC_ELEMS")) == tmc._QMC_ELEMS
    assert int(_constant("THREADS")) == tmc._THREADS
    assert _constant("TILE") == "256 * 128" and tmc.TILE == 256 * 128
    assert _constant("QMC_ROWS") == "BLOCKS_PER_PROGRAM / QMC_CLUSTER"
    assert _constant("QMC_SEG") == "32 / QMC_ELEMS"
    assert _constant("QMC_GROUP") == "THREADS / QMC_ELEMS"
    assert _constant("QMC_MAX_THREADS") == "QMC_ROWS * QMC_GROUP"
    assert (tmc._QMC_ROWS, tmc._QMC_SEG, tmc._QMC_GROUP) == (16, 8, 64)
    # each block size gives every group the same number of rows, and the
    # largest a row a group: the kernel's QMC_MAX_THREADS
    for threads in tmc._QMC_BLOCK_SIZES:
        assert threads % tmc._QMC_GROUP == 0
        assert tmc._QMC_ROWS % (threads // tmc._QMC_GROUP) == 0
    assert max(tmc._QMC_BLOCK_SIZES) == tmc._QMC_ROWS * tmc._QMC_GROUP
    # a warp holds whole warp rows, so the shuffles stay in their segments
    assert 32 % tmc._QMC_SEG == 0 and tmc._QMC_GROUP % 32 == 0


def test_args_are_the_seed_and_the_params_bits():
    assert re.search(r"struct QmcArgs \{\s*int key, pid0;\s*float par\[7\];"
                     r"\s*\};", SRC)
    seed = torch.tensor([123456789, 40], dtype=torch.int32)
    params = tmc._terminal_params(262_144, *MARKET, False)
    words = tmc._qmc_args(seed, params)
    assert words.dtype == np.int32 and words.shape == (9,)
    assert words[:2].tolist() == [123456789, 40]
    assert np.array_equal(words[2:].view(np.float32), params.numpy())


@pytest.mark.parametrize("n_programs, reps, ppr, threads", [
    (32, 1, 2, 512),          # 2^20 x 16
    (64, 2, 4, 256),          # 2^22 x 16
    (3, 3, 1, 1024), (2, 1, 2, 128), (1, 2, 1, 64)])
def test_every_point_is_formed_once(n_programs, reps, ppr, threads):
    points = tmc._qmc_points(n_programs, reps, ppr, threads)
    assert points.shape == (n_programs, reps * tmc.TILE)
    for pid in range(n_programs):
        first = (pid % ppr) * reps * tmc.TILE
        assert np.array_equal(np.sort(points[pid]),
                              first + np.arange(reps * tmc.TILE))


def _full_by_weights(n_rep: int, reps: int, ppr: int) -> int:
    """How many of a replicate's programs have every weight 1 under the
    plain version's f32 masks (base_elem < n_rep − local0)."""
    n = float(np.float32(n_rep))
    last = float(tmc.TILE - 1)
    full = 0
    for tile_idx in range(ppr):
        ok = all(last < n - float(np.float32((tile_idx * reps + j)
                                             * tmc.TILE))
                 for j in range(reps))
        full += ok
    return full


@pytest.mark.parametrize("n, R", [(1 << 20, 16), (1 << 22, 16),
                                  (1 << 24, 16), (100_000, 16),
                                  (3_000_017, 16), (5 * tmc.TILE + 9, 1)])
def test_full_programs_are_those_with_unit_weights(n, R):
    n_rep, reps, ppr = tmc._plan_qmc(n, R)
    full = tmc._qmc_full_tiles(n_rep, reps, ppr)
    assert full == _full_by_weights(n_rep, reps, ppr)
    # the kernel's block-uniform test: (tile_idx + 1)·reps·TILE <= n
    assert full == sum((t + 1) * reps * tmc.TILE <= n_rep
                       for t in range(ppr))
    if n in (1 << 20, 1 << 22, 1 << 24):
        assert full == ppr
    else:
        assert full == ppr - 1


def test_main_path_plans():
    assert tmc._plan_qmc(1 << 22, 16) == (262_144, 2, 4)
    assert tmc._plan_qmc(1 << 20, 16) == (65_536, 1, 2)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_register_fold_equals_the_block_tree(seed):
    rng = np.random.default_rng(seed)
    # a wide range of magnitudes and signs, so that any other pairing
    # rounds differently
    v = (rng.standard_normal((64, 256, 13))
         * 10.0 ** rng.integers(-6, 7, (64, 256, 13))).astype(np.float32)
    v = torch.from_numpy(v)
    tree = tmc._block_row_plain(v)
    assert tree.shape == (64, 13) and tree.dtype == MC_DTYPE
    assert torch.equal(tmc._qmc_row_plain(v), tree)
    # the test tells pairings apart: a sequential sum differs somewhere
    seq = torch.zeros_like(tree)
    for e in range(256):
        seq = seq + v[:, e]
    assert not torch.equal(seq, tree)


def test_block_tree_mirror_is_the_shuffle_tree():
    """``_block_row_plain`` against a lane-by-lane shuffle simulation."""
    rng = np.random.default_rng(7)
    v = torch.from_numpy(rng.standard_normal((256, 13)).astype(np.float32))
    warps = []
    for w in range(8):
        lanes = [v[w * 32 + i] for i in range(32)]
        for off in (16, 8, 4, 2, 1):
            lanes = [lanes[i] + lanes[i + off] if i + off < 32 else lanes[i]
                     for i in range(32)]
        warps.append(lanes[0])
    t = torch.zeros(13, dtype=MC_DTYPE)
    for w in warps:
        t = t + w
    assert torch.equal(tmc._block_row_plain(v), t)
