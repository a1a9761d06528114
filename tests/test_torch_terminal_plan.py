"""The terminal kernel's (K1) cuts, on the CPU.

``terminal_mc_kernel`` runs a block-uniform body with no draw index,
compare or weight on its full programs (``_full_programs``), whose
weights must then all be 1 under the plain version's f32 masks. Under
antithetic sampling its rep loop sums f(z) + f(−z) instead of averaging
them, and its last combine pass scales each stat by its power of two
(``ANTI_HALF`` / ``ANTI_QUARTER`` in ``csrc/terminal_mc.cu``); a plain
mirror of that form here must give the sums of the plain version, which
averages each pair, bit for bit. Nothing here launches a kernel.
"""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from optpricer_tpu_torch.dtypes import MC_DTYPE
from optpricer_tpu_torch.ops import stats as stats_ops
from optpricer_tpu_torch.ops import terminal_mc as tmc
from optpricer_tpu_torch.ops.fastmath import log32, norminv32
from optpricer_tpu_torch.ops.swprng import threefry2x32
from tests.torch_threads import torch_one_thread  # noqa: F401

SRC = (Path(tmc.__file__).resolve().parent.parent / "csrc"
       / "terminal_mc.cu").read_text()
MARKET = (100.0, 110.0, 1.0, 0.03, 0.01, 0.2)


def _weights_all_one(n_paths: int, n_programs: int, reps: int):
    """Per program, whether every weight of the plain version's f32 tail
    masks is 1: its last element is below both remainders in every rep."""
    n = float(np.float32(n_paths))
    pid_f = torch.arange(n_programs, dtype=MC_DTYPE)[:, None]
    last = float(tmc.TILE - 1)
    full = torch.ones(n_programs, dtype=torch.bool)
    for j in range(reps):
        rem1 = n - (pid_f * reps + j) * (2.0 * tmc.TILE)
        full &= (last < rem1 - tmc.TILE)[:, 0]
    return full


@pytest.mark.parametrize("n_paths", [1 << 30, 1 << 24, 1_000_000,
                                     1_000_003, 5 * 2 * tmc.TILE])
def test_full_programs_are_those_with_unit_weights(n_paths):
    reps, n_programs = tmc._plan_grid(n_paths, 2 * tmc.TILE)
    n_full = tmc._full_programs(n_paths, n_programs, reps)
    full = _weights_all_one(n_paths, n_programs, reps)
    assert full.tolist() == [p < n_full for p in range(n_programs)]
    # the kernel's block-uniform test: (pid + 1) * reps * 2 * TILE <= n
    assert n_full == sum((p + 1) * reps * 2 * tmc.TILE <= n_paths
                         for p in range(n_programs))
    assert n_full >= n_programs - 1


def test_full_programs_at_the_main_path_counts():
    assert tmc._plan_grid(1 << 30, 2 * tmc.TILE) == (256, 64)
    assert tmc._full_programs(1 << 30, 64, 256) == 64
    assert tmc._full_programs(1_000_000, 16, 1) == 15
    assert tmc._full_programs(1_000_003, 16, 1) == 15
    # a grid slice offset by whole programs
    assert tmc._full_programs(1_000_000, 8, 1, offset=8) == 7
    assert tmc._full_programs(1_000_000, 4, 1, offset=16) == 0


def _mask(name: str) -> int:
    m = re.search(rf"constexpr unsigned {name} = ([^;]*);", SRC, re.S)
    assert m, name
    return sum(1 << int(b) for b in re.findall(r"1u << (\d+)", m.group(1)))


def _anti_scale():
    """The kernel's scale of each antithetic stat, from its masks."""
    half, quarter = _mask("ANTI_HALF"), _mask("ANTI_QUARTER")
    assert half & quarter == 0
    return [0.5 if half >> k & 1 else 0.25 if quarter >> k & 1 else 1.0
            for k in range(tmc.NSTAT)]


def test_antithetic_scale_matches_the_kernel_masks():
    # the degree of each stat in the halved observables X, Y1, Y2 and the
    # z-moments: the count 0, the sums 1, the products of two 2
    degree = [0, 1, 2, 1, 2, 2, 1, 2, 2, 2, 1, 1, 1]
    assert _anti_scale() == [0.5 ** d for d in degree]


def _scaled_pairs_plain(seed, params, *, n_programs: int, reps: int,
                        invcdf: bool):
    """The kernel's antithetic form: each pair's observables summed,
    f(z) + f(−z), then each stat of the combined sums scaled by its power
    of two (``_anti_scale``)."""
    key0, offset = (int(v) for v in seed.tolist())
    S0, K, mu, sig, df, n_paths, sign = params.tolist()
    pid = (offset + torch.arange(n_programs, dtype=torch.int64))[:, None]
    elem = torch.arange(tmc.TILE, dtype=torch.int64)[None, :]
    base_elem = elem.to(MC_DTYPE)
    pid_f = pid.to(MC_DTYPE)
    obs = lambda z: tmc._observe(z, S0, K, mu, sig, df, sign)
    acc = torch.zeros((n_programs, tmc.NSTAT), dtype=MC_DTYPE)
    comp = torch.zeros_like(acc)
    for j in range(reps):
        bits_a, bits_b = threefry2x32(key0, pid, elem, j)
        u1 = ((bits_a >> 8).to(MC_DTYPE) + 0.5) * tmc._TINY
        if invcdf:
            u2 = ((bits_b >> 8).to(MC_DTYPE) + 0.5) * tmc._TINY
            z1, z2 = norminv32(u1), norminv32(u2)
        else:
            u2 = (bits_b >> 8).to(MC_DTYPE) * tmc._TINY
            rad = torch.sqrt(-2.0 * log32(u1))
            theta = tmc._TWO_PI * u2
            z1, z2 = rad * torch.cos(theta), rad * torch.sin(theta)
        rem1 = n_paths - (pid_f * reps + j) * (2.0 * tmc.TILE)
        w1 = (base_elem < rem1).to(MC_DTYPE)
        w2 = (base_elem < rem1 - tmc.TILE).to(MC_DTYPE)

        def pair(z, w):
            return tmc._moments(*(a + b for a, b in zip(obs(z), obs(-z))),
                                w)
        acc, comp = stats_ops.kahan_add(acc, comp,
                                        pair(z1, w1) + pair(z2, w2))
    return stats_ops.combine_scan(acc) * torch.tensor(_anti_scale(),
                                                      dtype=MC_DTYPE)


@pytest.mark.parametrize("n_paths, is_call, invcdf", [
    (1_000_003, True, False), (1_000_003, False, False),
    (300_001, True, True), (5_000_011, True, False)])
def test_summed_pairs_scaled_equal_the_halved_pairs(n_paths, is_call,
                                                    invcdf):
    reps, n_programs = tmc._plan_grid(n_paths, 2 * tmc.TILE)
    params = tmc._terminal_params(n_paths, *MARKET, is_call)
    seed = tmc._seed_pair(29, "cpu")
    kw = dict(n_programs=n_programs, reps=reps, invcdf=invcdf)
    got = _scaled_pairs_plain(seed, params, **kw)
    ref = tmc._mc_sumstats_plain(seed, params, antithetic=True, **kw)
    assert torch.equal(got, ref)
    assert got.dtype == MC_DTYPE and torch.isfinite(got).all()


def test_plain_without_antithetic_is_unscaled():
    n = 200_003
    reps, n_programs = tmc._plan_grid(n, 2 * tmc.TILE)
    params = tmc._terminal_params(n, *MARKET, True)
    s = tmc._mc_sumstats_plain(tmc._seed_pair(3, "cpu"), params,
                               n_programs=n_programs, reps=reps,
                               antithetic=False)
    assert float(s[0]) == n
