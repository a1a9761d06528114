"""The fused local-vol march's (K8) launch plan and step plan, on the CPU.

``fd_lv`` sizes its grid, its shared memory and its buffers from
``_launch_plan``: ``PCR_STRIKES`` strikes a PCR block with one thread per
row, ``THOMAS_STRIKES`` strikes a Thomas block of ``THOMAS_THREADS``
threads with two steps' plan and each strike's columns in shared memory up
to ``THOMAS_SMEM_ROWS`` rows. The pre-kernel
writes the strike-independent terms of every (step, row) once per launch;
its plain version ``_fd_lv_plan_plain``, marched strike by strike by
``_fd_lv_march_plain`` as the kernels march, gives ``_fd_lv_plain``'s layer
bit for bit (``torch.equal``): the same f32 operations on the same operands
in the same order, each computed once instead of once per strike.
``_fd_lv_plain`` itself is held against the interpreted TPU kernel by
``tests/test_torch_fd_lv.py``. Nothing here launches a kernel.
"""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from optpricer_tpu_torch.ops import fd_lv as tlv
from optpricer_tpu_torch.ops.fastmath import exp32
from tests.torch_threads import torch_one_thread  # noqa: F401

CSRC = Path(tlv.__file__).resolve().parent.parent / "csrc" / "fd_lv.cu"
GROUPS = {"pcr": tlv.PCR_STRIKES, "thomas": tlv.THOMAS_STRIKES}
G = tlv.PCR_STRIKES
LADDERS = [1, 7, G - 1, G, G + 1, 1024, 1025, 5000]
ROWS = [8, 16, 64, 504, 512, 768, 1000, 1024]


def _kernel_constant(name: str) -> int:
    m = re.search(rf"constexpr int {name} = (\d+);", CSRC.read_text())
    assert m, name
    return int(m.group(1))


def _smile(S, t):
    return 0.2 + 0.1 * torch.exp(-((torch.log(S / 100.0)) ** 2)) + 0.05 * t


def _ladder(N_S, N_t):
    """A mixed call/put ladder's kernel operands on the CPU."""
    Ks = np.array([80.0, 95.0, 100.0, 100.0, 105.0, 120.0, 130.0])
    calls = np.array([True, False, True, False, False, True, False])
    (x_np, dt, _, _, params, K, sign, m, m_pad) = tlv._kernel_inputs(
        100.0, Ks, 1.0, 0.04, 0.01, calls, N_S=N_S, N_t=N_t, S_max_mult=4.0,
        ref_vol=0.3)
    tab = tlv._sigma_table(_smile, x_np, dt, N_S, N_t, m_pad, "cpu")
    ops = [torch.from_numpy(a) for a in (params, K, sign)]
    return ops, tab, m, m_pad


def test_kernel_constants_match_the_wrapper():
    for name in ("PCR_STRIKES", "THOMAS_STRIKES", "THOMAS_THREADS",
                 "PLAN_WORDS", "MAX_SMEM"):
        assert _kernel_constant(name) == getattr(tlv, name), name
    # two steps' plan, the layer and d' columns of every strike, S
    assert re.search(r"constexpr int THOMAS_ROW_WORDS = 16 \+ 2 \* "
                     r"THOMAS_STRIKES \+ 1;", CSRC.read_text())
    assert tlv.THOMAS_ROW_WORDS == 2 * 2 * 4 + 2 * tlv.THOMAS_STRIKES + 1
    assert tlv.THOMAS_SMEM_ROWS == tlv.MAX_SMEM // (tlv.THOMAS_ROW_WORDS * 4)
    assert tlv.THOMAS_SMEM_ROWS >= 1024


@pytest.mark.parametrize("method", sorted(GROUPS))
@pytest.mark.parametrize("n_strikes", LADDERS)
def test_launch_plan_covers_every_strike_once(method, n_strikes):
    plan = tlv._launch_plan(method, n_strikes, 512, 512)
    g = plan.strikes_per_block
    assert g == GROUPS[method]
    # block k takes strikes k·g .. k·g + g − 1, those below B
    covered = [k * g + j for k in range(plan.blocks) for j in range(g)
               if k * g + j < n_strikes]
    assert covered == list(range(n_strikes))
    assert (plan.blocks - 1) * g < n_strikes


@pytest.mark.parametrize("method", sorted(GROUPS))
@pytest.mark.parametrize("m_pad", ROWS)
def test_launch_plan_fits_one_block(method, m_pad):
    n_t = 512
    plan = tlv._launch_plan(method, 1024, m_pad, n_t)
    assert 1 <= plan.threads <= 1024
    assert 0 < plan.smem_bytes <= tlv.MAX_SMEM
    assert plan.scratch_floats == 0
    assert plan.plan_floats == n_t * m_pad * tlv.PLAN_WORDS + n_t + 1 + m_pad
    if method == "pcr":
        # one thread per row; layers, a, c and d of every strike
        assert plan.threads == m_pad
        assert plan.smem_bytes == (3 * G + 4) * m_pad * 4
    else:
        assert plan.threads == tlv.THOMAS_THREADS == 128
        assert plan.smem_bytes == tlv.THOMAS_ROW_WORDS * m_pad * 4


def test_main_path_shape_holds_128_blocks():
    for method in GROUPS:
        assert tlv._launch_plan(method, 1024, 512, 512).blocks == 128


def test_thomas_columns_leave_shared_memory_above_its_rows():
    rows = tlv.THOMAS_SMEM_ROWS
    inside = tlv._launch_plan("thomas", 1025, rows, 4)
    assert inside.smem_bytes <= tlv.MAX_SMEM and inside.scratch_floats == 0
    above = tlv._launch_plan("thomas", 1025, rows + 8, 4)
    assert above.smem_bytes == 0
    assert above.scratch_floats == (rows + 8) * 1025


def test_launch_plan_rejects_pcr_above_1024_rows():
    with pytest.raises(ValueError):
        tlv._launch_plan("pcr", 8, 1032, 4)
    with pytest.raises(ValueError):
        tlv._launch_plan("lu", 8, 64, 4)
    assert tlv._launch_plan("thomas", 8, 1032, 4).threads == 128


@pytest.mark.parametrize("method", sorted(GROUPS))
@pytest.mark.parametrize("american", [False, True])
@pytest.mark.parametrize("N_S", [9, 62])          # m_pad 8 (m = 8), 64 (61)
@pytest.mark.parametrize("N_t", [2, 17])
def test_plan_then_march_equals_the_plain_march(method, american, N_S, N_t):
    ops, tab, m, m_pad = _ladder(N_S, N_t)
    kw = dict(n_t=N_t, m=m, m_pad=m_pad)
    plan = tlv.fd_lv_plan(ops[0], tab, **kw, theta=0.5, method=method)
    got = tlv._fd_lv_march_plain(plan, *ops, **kw, american=american,
                                 method=method)
    ref = tlv._fd_lv_plain(*ops, tab, **kw, theta=0.5, american=american,
                           method=method)
    assert torch.isfinite(ref).all() and ref.abs().max() > 0
    assert torch.equal(got, ref)


@pytest.mark.parametrize("method", sorted(GROUPS))
def test_plan_layout(method):
    N_t = 5
    ops, tab, m, m_pad = _ladder(62, N_t)
    params = ops[0]
    plan = tlv._fd_lv_plan_plain(params, tab, n_t=N_t, m=m, m_pad=m_pad,
                                 theta=0.5, method=method)
    assert plan.shape == (tlv._launch_plan(method, 1, m_pad,
                                           N_t).plan_floats,)
    o_disc, o_S = tlv._plan_offsets(N_t, m_pad)
    words = plan[:o_disc].view(N_t, m_pad, tlv.PLAN_WORDS)
    # the Dirichlet transfer terms sit on rows 0 and m − 1 only
    assert not words[:, 1:, 3].any() and words[:, 0, 3].all()
    assert not torch.cat([words[:, :m - 1, 4], words[:, m:, 4]], 1).any()
    # exp32(−r·τ) from τ = 0, and S on the interior nodes
    assert plan[o_disc] == 1.0
    tau = torch.arange(1, N_t + 1, dtype=torch.float32) * params[2]
    assert torch.equal(plan[o_disc + 1:o_S], exp32(-params[3] * tau))
    x = params[0] + (torch.arange(m_pad, dtype=torch.float32) + 1.0) \
        * params[1]
    assert torch.equal(plan[o_S:], exp32(x))
    other = tlv._fd_lv_plan_plain(params, tab, n_t=N_t, m=m, m_pad=m_pad,
                                  theta=0.5,
                                  method="thomas" if method == "pcr"
                                  else "pcr")
    # the rhs words are the same for both methods
    assert torch.equal(words[..., :5], other[:o_disc].view(
        N_t, m_pad, tlv.PLAN_WORDS)[..., :5])
    if method == "thomas":
        # the back substitution's c' is 0 on the last row, a_lhs 0 on row 0
        assert not words[:, -1, 5].any() and not words[:, 0, 6].any()
        assert words[:, :m, 5].all() and words[:, 1:m, 6].all()
