"""The basket (K6) and book (K3) kernels' host-side plans, on the CPU.

``basket_mc`` sizes the basket kernel's scratch from ``_launch_plan``: one
block of 128 path pairs per (program, rep, block in tile), so a program's
stats rows (the first combine pass's segment) are reps x 32, in (rep,
block) order. It passes the kernel its constants in the struct
``BasketParams`` of ``csrc/basket_mc.cu``, packed by ``_pack_params`` from
``_build_params``' f32 params; each asset count from 1 to ``MAX_ASSETS``
has its own instantiation with its own register budget. The book kernel
runs a block-uniform body with no draw weights on its full programs
(``_full_programs``), whose weights must then all be 1 under the plain
version's f32 masks. Nothing here launches a kernel.
"""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from optpricer_tpu_torch.ops import basket_mc as tbk
from optpricer_tpu_torch.ops import mc_batch as tmb
from optpricer_tpu_torch.ops import terminal_mc as tmc

CSRC = Path(tbk.__file__).resolve().parent.parent / "csrc"
BASKET_SRC = (CSRC / "basket_mc.cu").read_text()
GRIDS = [(64, 1), (33, 2), (49, 4), (3, 7), (1, 1)]


def _constant(name: str) -> int:
    m = re.search(rf"constexpr int {name} = (\d+);", BASKET_SRC)
    assert m, name
    return int(m.group(1))


def _min_blocks() -> list:
    m = re.search(r"constexpr int MIN_BLOCKS\[MAX_ASSETS \+ 1\] = "
                  r"\{([^}]*)\};", BASKET_SRC)
    assert m
    return [int(v) for v in m.group(1).split(",")]


def _struct_layout() -> dict:
    """field -> (first word, words) of ``BasketParams``, in declaration
    order, from the source."""
    body = re.search(r"struct BasketParams \{(.*?)\n\};", BASKET_SRC,
                     re.S).group(1)
    sizes = {"MAX_ASSETS": tbk.MAX_ASSETS,
             "MAX_CHOL": tbk.MAX_ASSETS * (tbk.MAX_ASSETS + 1) // 2}
    layout, word = {}, 0
    for decl in re.findall(r"float ([^;]*);", body):
        for field in decl.split(","):
            m = re.fullmatch(r"\s*(\w+)(?:\[(\w+)\])?\s*", field)
            words = sizes[m.group(2)] if m.group(2) else 1
            layout[m.group(1)] = (word, words)
            word += words
    return layout


def _params(a: int, seed: int = 0) -> torch.Tensor:
    rng = np.random.default_rng(seed + a)
    corr = np.full((a, a), 0.3) + 0.7 * np.eye(a)
    return tbk._build_params(
        4096 * 3 + 17, 24, list(rng.uniform(80, 120, a)),
        list(np.full(a, 1.0 / a)), 100.0, 1.5, 0.03,
        list(rng.uniform(0.0, 0.02, a)), list(rng.uniform(0.15, 0.4, a)),
        np.linalg.cholesky(corr), 112.0, 1.5, False, "basket_barrier", True)


# ---------------------------------------------------------------------------
# K6: the launch plan
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n_programs, reps", GRIDS)
def test_launch_plan_is_one_block_per_program_rep_and_tile_block(
        n_programs, reps):
    blocks, rows = tbk._launch_plan(n_programs, reps)
    assert rows == reps * tbk.TILE // 128 == reps * 32
    assert blocks == n_programs * rows


@pytest.mark.parametrize("n_programs, reps", GRIDS)
def test_launch_plan_covers_every_path_pair_once(n_programs, reps):
    # the kernel's map: block b is (program, rep) = divmod(b // 32, reps),
    # its thread t the element (b % 32) * 128 + t; a program's rows are
    # consecutive, in (rep, block) order
    blocks, rows = tbk._launch_plan(n_programs, reps)
    b = np.arange(blocks).repeat(128)
    t = np.tile(np.arange(128), blocks)
    pid, rep = np.divmod(b // 32, reps)
    elem = (b % 32) * 128 + t
    flat = (pid * reps + rep) * tbk.TILE + elem
    assert np.array_equal(np.sort(flat),
                          np.arange(n_programs * reps * tbk.TILE))
    assert np.array_equal(b // rows, pid)
    assert np.array_equal(b % rows, rep * 32 + (b % 32))


@pytest.mark.parametrize("n_paths", [1, 4096, (1 << 16) + 123,
                                     (1 << 18) + 123, 3 * (1 << 18) + 123,
                                     1 << 20])
def test_launch_plan_at_the_grids_of_the_entry(n_paths):
    reps, n_programs = tmc._plan_grid(n_paths, tbk.TILE)
    blocks, rows = tbk._launch_plan(n_programs, reps)
    assert blocks * 128 == n_programs * reps * tbk.TILE >= n_paths
    assert rows * 128 == reps * tbk.TILE


def test_the_main_paths_grids():
    # [basket-path] and the 16-asset barrier: 64 programs x 1 rep; the
    # 1-asset worst-of at 2^20 pairs: 64 x 4, 8 192 blocks
    for n, (reps, n_programs, blocks) in {1 << 18: (1, 64, 2048),
                                          1 << 20: (4, 64, 8192)}.items():
        assert tmc._plan_grid(n, tbk.TILE) == (reps, n_programs)
        assert tbk._launch_plan(n_programs, reps)[0] == blocks


# ---------------------------------------------------------------------------
# K6: the kernel-parameter struct
# ---------------------------------------------------------------------------
def test_struct_layout_matches_the_source():
    layout = _struct_layout()
    scalars = ["K", "df", "n_paths", "sign", "barrier", "rebate",
               "crossed0"]
    # the 7 scalars in params' order (_P_K ... _P_CROSSED0), then a pad
    assert list(layout)[:8] == scalars + ["pad"]
    assert [layout[s][0] for s in scalars] == [
        tbk._P_K, tbk._P_DF, tbk._P_NPATHS, tbk._P_SIGN, tbk._P_BARRIER,
        tbk._P_REBATE, tbk._P_CROSSED0]
    for f, name in enumerate(tbk._STRUCT_FIELDS):
        assert layout[name] == (tbk._STRUCT_SCALARS + f * tbk.MAX_ASSETS,
                                tbk.MAX_ASSETS)
    assert layout["L"] == (tbk._STRUCT_CHOL, tbk.MAX_ASSETS
                           * (tbk.MAX_ASSETS + 1) // 2)
    assert sum(w for _, w in layout.values()) == tbk._STRUCT_WORDS
    assert "constexpr int PARAM_WORDS = 8 + 4 * MAX_ASSETS + MAX_CHOL;" \
        in BASKET_SRC


@pytest.mark.parametrize("a", [1, 2, 3, 7, 10, 16])
def test_pack_params_moves_every_value_to_its_struct_word(a):
    params = _params(a)
    packed = tbk._pack_params(params, a)
    assert packed.dtype == np.float32 and packed.shape == (tbk._STRUCT_WORDS,)
    v = params.numpy()
    layout = _struct_layout()
    for name, index in (("K", 0), ("df", 1), ("n_paths", 2), ("sign", 3),
                        ("barrier", 4), ("rebate", 5), ("crossed0", 6)):
        assert packed[layout[name][0]].tobytes() == v[index].tobytes()
    assert packed[layout["pad"][0]] == 0.0
    for f, name in enumerate(tbk._STRUCT_FIELDS):
        lo, n = layout[name]
        want = v[tbk._P_ASSETS + f:tbk._P_ASSETS + 4 * a:4]
        assert packed[lo:lo + a].tobytes() == want.tobytes()
        assert not packed[lo + a:lo + n].any()
    lo, n = layout["L"]
    chol = v[tbk._P_ASSETS + 4 * a:].reshape(a, a)
    for i in range(a):
        for j in range(i + 1):      # row i at i(i+1)/2, as the kernel reads
            assert packed[lo + i * (i + 1) // 2 + j].tobytes() \
                == chol[i, j].tobytes()
    assert not packed[lo + a * (a + 1) // 2:lo + n].any()


@pytest.mark.parametrize("a", [1, 4, 10, 16])
def test_pack_params_round_trips_bit_for_bit(a):
    # reading the struct back as the kernel does gives params' f32 values
    params = _params(a, seed=3)
    packed = tbk._pack_params(params, a)
    layout = _struct_layout()
    per_asset = np.stack([packed[layout[f][0]:layout[f][0] + a]
                          for f in tbk._STRUCT_FIELDS], axis=1).reshape(-1)
    chol = np.zeros((a, a), np.float32)
    chol[np.tril_indices(a)] = packed[tbk._STRUCT_CHOL:tbk._STRUCT_CHOL
                                      + a * (a + 1) // 2]
    back = np.concatenate([packed[:tbk._P_ASSETS], per_asset,
                           chol.reshape(-1)])
    assert back.tobytes() == params.numpy().tobytes()


# ---------------------------------------------------------------------------
# K6: the instantiations against the source
# ---------------------------------------------------------------------------
def test_kernel_constants_match_the_wrapper():
    assert _constant("MAX_ASSETS") == tbk.MAX_ASSETS
    assert _constant("THREADS") == tbk._THREADS
    assert _constant("ROW") == tbk._ROW
    assert _constant("NSTAT") == tbk.NSTAT
    assert "constexpr int TILE = 32 * 128;" in BASKET_SRC
    assert tbk.TILE == 32 * 128


def test_every_asset_count_has_its_own_instantiation():
    # the dispatch walks A = 1 .. MAX_ASSETS to the count it is given, and
    # MIN_BLOCKS holds one budget a count
    assert re.search(r"if \(l\.a != A\) return launch_assets<PAYOFF, ANTI, "
                     r"A \+ 1>\(l\);", BASKET_SRC)
    assert "if constexpr (A < MAX_ASSETS)" in BASKET_SRC
    budget = _min_blocks()
    assert len(budget) == tbk.MAX_ASSETS + 1 and budget[0] == 0


@pytest.mark.parametrize("a", range(1, 17))
def test_register_budget_of_each_asset_count(a):
    budget = _min_blocks()
    assert 1 <= budget[a] <= 16
    # the main path's counts: at least 4 blocks an SM at 16 assets, 6 at 10
    assert budget[16] >= 4 and budget[10] >= 6


# ---------------------------------------------------------------------------
# K3: full and tail programs
# ---------------------------------------------------------------------------
def _plain_weights(n_paths, reps, n_programs):
    """(n_programs, reps, 2, 256) f32 weights, as ``_mc_batch_plain``
    forms them."""
    pid_f = torch.arange(n_programs, dtype=torch.float32).view(-1, 1, 1)
    j = torch.arange(reps, dtype=torch.float32).view(1, -1, 1)
    row_f = torch.arange(tmb.BLOCK_R, dtype=torch.float32).view(1, 1, -1)
    rem1 = torch.tensor(float(n_paths), dtype=torch.float32) \
        - (pid_f * reps + j) * (2.0 * tmb.BLOCK_R)
    w1 = (row_f < rem1).to(torch.float32)
    w2 = (row_f < rem1 - tmb.BLOCK_R).to(torch.float32)
    return torch.stack([w1, w2], dim=2)


@pytest.mark.parametrize("n_paths", [1, 511, 512, 1 << 20, 1_000_003])
def test_full_programs_have_every_weight_one(n_paths):
    reps, n_programs = tmb._plan(n_paths)
    full = tmb._full_programs(n_paths, n_programs, reps)
    w = _plain_weights(n_paths, reps, n_programs)
    assert bool((w[:full] == 1.0).all())
    # the split is tight: every other program holds a weight of 0, and
    # only the last program can
    assert all(bool((w[p] == 0.0).any()) for p in range(full, n_programs))
    assert full >= n_programs - 1
    assert float(w.sum()) == n_paths


def test_full_programs_at_the_main_path():
    # 1 000 contracts x 1M paths (and 2^20): no tail program; a ragged
    # count: the last one
    for n_paths, tail in ((1_000_000, 1), (1 << 20, 0), (1_000_003, 1)):
        reps, n_programs = tmb._plan(n_paths)
        assert tmb._full_programs(n_paths, n_programs, reps) \
            == n_programs - tail
