"""The path-QMC kernel's (K5) plan, sparse bridge and split Sobol words.

``qmc_path_kernel`` forms each time step's log-spot from the nonzeros of
its column of B = σA alone (A the Brownian bridge), which the host writes
once per shape, σ and T into a plan (``_bridge_plan``): a table of
``_plan_width(d)`` entries a column in ascending k, padded with zeros. A
thread keeps each normal in one of ``_SLOTS`` slots from the group of 8
columns of its first use to that of its last (a greedy colouring by the
plan); a B that is not a bridge the plan can hold is refused. Its Sobol
words are the block-common word (the shift and the Gray-code bits 6 and
up, the same for a block's 64 points) XOR the point's own 6 low bits.
Here, on the CPU, with the plain mirrors of those steps:

* the plan holds exactly the nonzeros of the f32 B, in ascending k, and
  no two dimensions live in one group share a slot;
* the bridge through the slots equals the dense product of
  ``_qmc_path_plain`` bit for bit (``torch.equal``), σ = 0 giving empty
  columns;
* a column wider than the table, or more live dimensions than slots, is
  refused;
* the split words equal the full XOR ladder across block and tile
  boundaries;
* the kernel's shared-memory limit and its constants;
* the Asian's step-order mirror (``_qmc_path_plain(step_order=True)``,
  the running sums formed step by step as the kernel forms them, which
  ``tests/test_torch_cuda.py`` holds the kernel to at 2 048 steps) meets
  the plain version's ``torch.sum`` average within rtol 2e-5.

Nothing here launches a kernel.
"""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from optpricer_tpu_torch.dtypes import MC_DTYPE
from optpricer_tpu_torch.ops import qmc_path as tqp
from optpricer_tpu_torch.ops.fastmath import norminv32
from optpricer_tpu_torch.ops.sobol import bridge_matrix, direction_numbers
from tests.torch_threads import torch_one_thread  # noqa: F401

SRC = (Path(tqp.__file__).resolve().parent.parent / "csrc"
       / "qmc_path.cu").read_text()
STEPS = (1, 2, 3, 63, 64, 130, 252)
SIGMAS = (0.0, 0.2, 1.5)


def _constant(name: str) -> int:
    m = re.search(rf"constexpr int {name} = (\d+);", SRC)
    assert m, name
    return int(m.group(1))


def _B(d: int, sigma: float) -> torch.Tensor:
    """(d_pad, d_pad) f32 B = σA as ``_kernel_inputs`` builds it."""
    d_pad = -(-d // tqp.LANES) * tqp.LANES
    B = np.zeros((d_pad, d_pad), np.float32)
    B[:d, :d] = (sigma * bridge_matrix(d, 1.0)).astype(np.float32)
    return torch.from_numpy(B)


def _V(d: int, m_bits: int = 11) -> torch.Tensor:
    d_pad = -(-d // tqp.LANES) * tqp.LANES
    V = np.zeros((m_bits, d_pad), np.uint32)
    V[:, :d] = direction_numbers(d, m_bits)
    return torch.from_numpy(V.view(np.int32))


def _normals(n_points: int, d: int, seed: int = 0) -> torch.Tensor:
    """(n_points, d) f32 normals as the kernel makes them: norminv32 of
    cell-centred 24-bit uniforms."""
    rng = np.random.default_rng(seed)
    bits = rng.integers(0, 1 << 24, (n_points, d))
    u = (torch.from_numpy(bits).to(MC_DTYPE) + 0.5) * tqp._TINY
    return norminv32(u)


def _dense(z: torch.Tensor, B: torch.Tensor, d: int) -> torch.Tensor:
    """``_qmc_path_plain``'s product: one multiply and one add per k."""
    dot = torch.zeros_like(z)
    for k in range(d):
        dot = dot + z[..., k:k + 1] * B[k, :d]
    return dot


def test_plan_constants_match_the_kernel():
    assert _constant("THREADS") == tqp._THREADS
    assert _constant("LOW_BITS") == tqp._LOW_BITS == 6
    assert 1 << tqp._LOW_BITS == tqp._THREADS
    assert _constant("JB") == tqp._JB
    assert _constant("MAX_SMEM") == tqp._MAX_SMEM
    assert _constant("P_TILE") == tqp.P_TILE
    assert _constant("SLOTS") == tqp._SLOTS
    assert "(static_cast<size_t>(SLOTS) * THREADS + n_steps)" in SRC


@pytest.mark.parametrize("d", list(range(1, 70)) + [127, 128, 129, 252,
                                                     255, 256, 257, 500, 894])
def test_plan_width_covers_the_bridge(d):
    B = (1.5 * bridge_matrix(d, 1.0)).astype(np.float32)
    most = int((B != 0).sum(axis=0).max())
    assert most <= tqp._plan_width(d)
    if d in (64, 252):
        assert most == tqp._plan_width(d) == {64: 7, 252: 9}[d]


def _plan(B, d):
    """(entries, groups, gen, vlow) of B's plan, as torch tensors."""
    plan = tqp._bridge_plan(B.numpy(), _V(d).numpy(), d)
    assert plan.dtype == np.int32
    assert plan.shape == (tqp._plan_layout(d, tqp._plan_width(d))[1],)
    return tuple(torch.from_numpy(np.ascontiguousarray(t))
                 for t in tqp._plan_parts(plan, d))


def _gen_rows(groups) -> int:
    """The gen rows a plan uses: the last group's first row + its count."""
    return int(groups[-1, 0]) + int(groups[-1, 1])


@pytest.mark.parametrize("sigma", SIGMAS)
@pytest.mark.parametrize("d", STEPS)
def test_plan_holds_the_nonzeros_in_ascending_k(d, sigma):
    B = _B(d, sigma)
    width = tqp._plan_width(d)
    entries, groups, gen, vlow = _plan(B, d)
    n_groups = -(-d // 8)
    assert entries.shape == (n_groups, width, 16)
    assert groups.shape == (n_groups, 2) and gen.shape == (d, 2)
    assert vlow.shape == (d, 8)
    slot_of = {int(k): int(off) for k, off in
               gen[:_gen_rows(groups)].tolist()}
    for j in range(n_groups * 8):
        g, c = divmod(j, 8)
        ks = torch.nonzero(B[:d, j] != 0.0).flatten() if j < d \
            else torch.zeros(0, dtype=torch.int64)
        if sigma == 0.0:
            assert ks.numel() == 0
        n = ks.numel()
        assert n <= width
        assert entries[g, :n, c].tolist() == [slot_of[int(k)] for k in ks]
        assert torch.equal(entries[g, :n, 8 + c],
                           B[ks, j].view(torch.int32))
        assert not entries[g, n:, c].any() and not entries[g, n:, 8 + c].any()
    assert not gen[_gen_rows(groups):].any()
    assert torch.equal(vlow[:, :6], _V(d)[:6, :d].t())
    assert not vlow[:, 6:].any()


@pytest.mark.parametrize("d", STEPS + (500, 894, 2048))
def test_plan_gives_live_dimensions_distinct_slots(d):
    B = _B(d, 0.2)
    entries, groups, gen, _ = _plan(B, d)
    used = (B[:d, :d] != 0).any(dim=1)
    assert _gen_rows(groups) == int(used.sum())
    nz = [torch.nonzero(B[k, :d]).flatten() for k in range(d)]
    live = {}
    for g in range(len(groups)):
        first, count = int(groups[g, 0]), int(groups[g, 1])
        for k, off in gen[first:first + count].tolist():
            assert int(nz[k][0]) // 8 == g            # generated at first use
            assert 0 <= off < tqp._SLOTS * 64 and off % 64 == 0
            live[k] = (g, int(nz[k][-1]) // 8, off)
    assert sorted(live) == torch.nonzero(used).flatten().tolist()
    for g in range(len(groups)):
        offs = [off for lo, hi, off in live.values() if lo <= g <= hi]
        assert len(offs) == len(set(offs)) <= tqp._SLOTS


@pytest.mark.parametrize("sigma", SIGMAS)
@pytest.mark.parametrize("d", STEPS)
def test_sparse_product_equals_the_dense_one_bit_for_bit(d, sigma):
    B = _B(d, sigma)
    plan = tqp._bridge_plan(B.numpy(), _V(d).numpy(), d)
    z = _normals(257, d, seed=d)
    got = tqp._bridge_sparse_plain(z, plan, n_steps=d)
    want = _dense(z, B, d)
    assert torch.equal(got, want)
    assert not torch.signbit(got[got == 0.0]).any()  # never −0


def test_kernel_inputs_carry_the_plan_of_their_B():
    d = 252
    arrays = tqp._kernel_inputs(3, 4096, d, 100.0, 110.0, 1.0, 0.03, 0.0,
                                0.2, n_replicates=2, barrier=0.0,
                                rebate=0.0, payout=1.0)
    V, B, plan = arrays[2], arrays[4], arrays[6]
    assert np.array_equal(plan, tqp._bridge_plan(B, V, d))
    assert torch.equal(torch.from_numpy(B), _B(d, 0.2))
    # each call gets its own arrays, not the cache's
    again = tqp._kernel_inputs(3, 4096, d, 100.0, 110.0, 1.0, 0.03, 0.0,
                               0.2, n_replicates=2, barrier=0.0, rebate=0.0,
                               payout=1.0)
    assert not np.shares_memory(again[4], B)
    assert not np.shares_memory(again[6], plan)


def test_a_column_wider_than_the_table_is_refused():
    d = 40
    B = _B(d, 0.2)
    B[:d, 9] = 0.01                     # column 9: 40 nonzeros, width 7
    with pytest.raises(ValueError, match="column of 40 nonzeros"):
        tqp._bridge_plan(B.numpy(), _V(d).numpy(), d)


def test_more_live_dimensions_than_slots_are_refused():
    d = 48
    B = torch.zeros(128, 128)
    # dimension k used by columns k // 7 (group 0) and 40 + k // 7 (group
    # 5): 7 nonzeros a column at most, and all 48 live from group 0 on
    for k in range(d):
        B[k, k // 7] = B[k, 40 + k // 7] = 0.01
    assert int((B != 0).sum(0).max()) <= tqp._plan_width(d)
    with pytest.raises(ValueError, match="more than 32 dimensions live"):
        tqp._bridge_plan(B.numpy(), _V(d).numpy(), d)


def _full_ladder(idx, V, shift, m_bits):
    """``_qmc_path_plain``'s words: every Gray-code bit below m_bits."""
    gray = (idx ^ (idx >> 1)).unsqueeze(-1)
    Vd = V.to(torch.int64) & 0xFFFFFFFF
    x = (shift.to(torch.int64) & 0xFFFFFFFF).expand(idx.shape + shift.shape)
    for b in range(m_bits):
        x = x ^ (((gray >> b) & 1) * Vd[b])
    return x


@pytest.mark.parametrize("m_bits", [11, 16, 20, 31])
def test_split_sobol_words_equal_the_full_ladder(m_bits):
    d = 37
    V = torch.from_numpy(direction_numbers(d, m_bits).view(np.int32))
    rng = np.random.default_rng(m_bits)
    shift = torch.from_numpy(rng.integers(0, 1 << 32, d, dtype=np.uint64)
                             .astype(np.uint32).view(np.int32))
    top = 1 << m_bits
    starts = [0, 64 - 3, 256 - 5, 1024 * 3 - 7, top // 2 - 9, top - 300]
    idx = torch.cat([torch.arange(s, s + 300, dtype=torch.int64)
                     for s in starts])
    idx = idx[(idx >= 0) & (idx < top)]
    got = tqp._sobol_words_split(idx, V, shift, m_bits=m_bits)
    assert torch.equal(got, _full_ladder(idx, V, shift, m_bits))


def _check_kw(d: int):
    d_pad = -(-d // tqp.LANES) * tqp.LANES
    m_bits = 11
    tensors = (torch.zeros(2, dtype=torch.int32),
               torch.zeros(6, dtype=MC_DTYPE),
               torch.zeros((m_bits, d_pad), dtype=torch.int32),
               torch.zeros((1, d_pad), dtype=torch.int32),
               torch.zeros((d_pad, d_pad), dtype=MC_DTYPE),
               torch.zeros((1, d_pad), dtype=MC_DTYPE))
    return tensors, dict(n_programs=1, reps=1, progs_per_rep=1, n_steps=d,
                         d_pad=d_pad, m_bits=m_bits)


def test_shared_memory_is_the_slots_and_common_words():
    assert tqp._shared_bytes(252) == (32 * 64 + 252) * 4
    most = tqp._MAX_SMEM // 4 - 32 * 64
    assert tqp._shared_bytes(most) <= tqp._MAX_SMEM \
        < tqp._shared_bytes(most + 1)
    tensors, kw = _check_kw(8)
    d_pad = -(-most // tqp.LANES) * tqp.LANES
    # at the most steps only the (small) tensors' shapes are wrong
    with pytest.raises(ValueError, match="V must be"):
        tqp._check_inputs(*tensors, **dict(kw, n_steps=most, d_pad=d_pad))
    with pytest.raises(ValueError, match="shared memory"):
        tqp._check_inputs(*tensors, **dict(kw, n_steps=most + 1,
                                           d_pad=d_pad + tqp.LANES))


def test_check_inputs_checks_the_plan():
    d = 64
    arrays = tqp._kernel_inputs(3, 4096, d, 100.0, 110.0, 1.0, 0.03, 0.0,
                                0.2, n_replicates=1, barrier=0.0,
                                rebate=0.0, payout=1.0)
    t = [torch.from_numpy(a) for a in arrays]
    kw = dict(n_programs=1, reps=1, progs_per_rep=1, n_steps=d, d_pad=128,
              m_bits=12)
    tqp._check_inputs(*t, **kw)
    with pytest.raises(ValueError, match="plan must be"):
        tqp._check_inputs(*t[:6], t[6][:-4], **kw)


def test_check_inputs_rejects_too_few_sobol_bits():
    tensors, kw = _check_kw(8)
    with pytest.raises(ValueError, match="m_bits"):
        tqp._check_inputs(*tensors, **dict(kw, m_bits=5))


@pytest.mark.parametrize("arithmetic", [True, False])
@pytest.mark.parametrize("sigma", [0.0, 0.2])
def test_step_order_average_meets_the_plain_version(arithmetic, sigma):
    n, d, R = 2048, 96, 2
    m_bits, d_pad, reps, ppr = tqp._plan(n, d, R)
    arrays = tqp._kernel_inputs(3, n, d, 100.0, 100.0, 1.0, 0.03, 0.0,
                                sigma, n_replicates=R, barrier=0.0,
                                rebate=0.0, payout=1.0)
    tensors = [torch.from_numpy(a) for a in arrays]
    kw = dict(n_programs=R * ppr, reps=reps, progs_per_rep=ppr, n_steps=d,
              d_pad=d_pad, m_bits=m_bits,
              payoff_id=tqp.PAYOFF_IDS["asian"], barrier_up=True,
              knock_in=False, is_call=True, arithmetic=arithmetic,
              fixed_strike=True)
    plain = tqp._qmc_path_plain(*tensors, **kw)
    mirror = tqp._qmc_path_plain(*tensors, **kw, step_order=True)
    assert torch.equal(mirror[:, 0], plain[:, 0])
    assert torch.isfinite(mirror).all() and (mirror[:, 1] > 0).all()
    torch.testing.assert_close(mirror, plain, rtol=2e-5, atol=0.0)
