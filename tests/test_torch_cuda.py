"""The port's CUDA kernels against their plain torch versions, on the card.

Every test here needs a CUDA card (the kernels have no CPU mode) and skips
without one. On a machine with a card (jax not needed there):

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest \\
        -p no:cacheprovider -o addopts=""

Tolerances as in ``chip_smoke.py``: counts equal, every other stat within
rtol 2e-5 (the kernel sums per thread, then a fixed block tree; the plain
version per tile; the terminal kernel's Box-Muller angle is sincospi(2u)),
and the path kernel's signed Greek sums within 2e-5·√(n·ΣY²). The PDE
kernels: the batched tridiagonal solve (K7) against the plain Thomas
solve to rtol 1e-10 in f64 and 2e-5 in f32, with an absolute floor of
rtol·max|x|, the fused local-vol march (K8) within 2e-5 of its plain
version (PCR and Thomas, calls and puts mixed, European and American, 1,
9 and 1 025 strikes on 8, 512 and 1 024 rows, Thomas also past its
shared-memory rows) and its pre-kernel's plan equal to the plain plan.
The path kernel's Dupire branches and the book kernel (K3) at rtol 2e-5
too, and so the basket kernel (K6, every asset count it instantiates
separately at one, two and four reps; at one rep the recorded sums of the
`[basket-path]` book and the 16-asset barrier bit for bit) and the path
kernel's LSV branches, and the path kernel's per-path grid at one, two and
four reps; the path-QMC kernel (K5) at 1 to 2 048 steps, a call without
B's plan refused, and its sums at chip_smoke.py's K5 cases equal to the
recorded ones (``QMC_PATH_SUMS``) bit for bit, its arithmetic Asian at
2 048 steps against the step-order plain mirror; the terminal kernel's
(K1) full and tail programs at ragged and whole counts; the QMC terminal
kernel's (K2) rows equal to the recorded ones (``K2_SUMS``) bit for bit,
and to its plain version at tails, one to eight reps and more programs
than the card holds clusters, one launch counted a call;
its Box-Muller sincosf is held to cosf and sinf bit for bit on every
angle it can draw. The closed-form slice (no kernel of its own): every
public function of ``analytic``, ``american_analytic``, ``levy``,
``validation`` and ``american_implied_vol`` on the card equal to the same
call on the CPU, at the tolerances of its CPU parity test; the Lévy cores
fed the same draws; the port's gamma sampler and ``vg_paths`` held
statistically; ``profiling.trace`` naming K1 and ``device_memory`` the
card. The American and multilevel slice (no kernel of its own): every
deterministic core on the card equal to the CPU's at 1e-12 in float64,
the float32 regression betas unchanged by a process-wide TF32 setting,
the LSMC passes free of host syncs (``-k "american or lsmc"``). The LSMC
ladder's date kernel (``csrc/lsmc.cu``): one date's exercise and normal
equations against float64 sums of the same state, its β against a float64
solve, the last date's moments against float64 sums and its prices and
standard errors against their float64 formulas, the float32 ladder against the plain pass in float64 on the same
paths, strikes never in the money, a seed repeated bit for bit.
"""
import numpy as np
import pytest
import torch

import optpricer_tpu_torch as tp
from optpricer_tpu_torch import OptionSpec, fd_price, fd_price_local_vol_batch
from optpricer_tpu_torch.ops import basket_mc as tbk
from optpricer_tpu_torch.ops import fd_lv as tlv
from optpricer_tpu_torch.ops import mc_batch as tmb
from optpricer_tpu_torch.ops import path_mc as tpm
from optpricer_tpu_torch.ops import qmc_path as tqp
from optpricer_tpu_torch.ops import terminal_mc as tmc
from optpricer_tpu_torch.ops import thomas as tth
from torch_lsmc_layout import pack_tau, unpack_tau

pytestmark = pytest.mark.cuda

MARKET = (100.0, 110.0, 1.0, 0.03, 0.01, 0.2)
RTOL = 2e-5


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda", 0)


def _assert_close(kernel, plain, signed=()):
    k, p = kernel.double().cpu(), plain.double().cpu()
    assert torch.equal(k[..., 0], p[..., 0])
    unsigned = [i for i in range(k.shape[-1]) if i not in signed]
    torch.testing.assert_close(k[..., unsigned], p[..., unsigned], rtol=RTOL,
                               atol=0.0)
    for i in signed:
        scale = float(torch.sqrt(p[0] * p[i + 1]))
        assert abs(float(k[i] - p[i])) <= RTOL * scale, i


@pytest.mark.parametrize("is_call", [True, False])
@pytest.mark.parametrize("antithetic", [True, False])
@pytest.mark.parametrize("invcdf", [False, True])
def test_terminal_kernel_matches_plain(cuda_device, is_call, antithetic,
                                       invcdf):
    n = 1_000_003
    reps, n_programs = tmc._plan_grid(n, 2 * tmc.TILE)
    params = tmc._terminal_params(n, *MARKET, is_call).to(cuda_device)
    seed = tmc._seed_pair(17, cuda_device)
    kw = dict(n_programs=n_programs, reps=reps, antithetic=antithetic,
              invcdf=invcdf)
    _assert_close(tmc.terminal_mc(seed, params, **kw),
                  tmc._mc_sumstats_plain(seed, params, **kw))


def test_terminal_kernel_multi_rep_is_deterministic(cuda_device):
    n = 1 << 23  # two reps per program
    reps, n_programs = tmc._plan_grid(n, 2 * tmc.TILE)
    assert reps == 2
    params = tmc._terminal_params(n, *MARKET, False).to(cuda_device)
    seed = tmc._seed_pair(3, cuda_device)
    kw = dict(n_programs=n_programs, reps=reps, antithetic=True)
    a = tmc.terminal_mc(seed, params, **kw).clone()
    b = tmc.terminal_mc(seed, params, **kw).clone()
    assert torch.equal(a, b)
    _assert_close(a, tmc._mc_sumstats_plain(seed, params, **kw))


@pytest.mark.parametrize("is_call", [True, False])
def test_qmc_kernel_matches_plain(cuda_device, is_call):
    R, n = 16, 1 << 20
    n_rep, reps, ppr = tmc._plan_qmc(n, R)
    params = tmc._terminal_params(n_rep, *MARKET, is_call).to(cuda_device)
    seed = tmc._seed_pair(5, cuda_device)
    kw = dict(n_programs=R * ppr, reps=reps, progs_per_rep=ppr)
    _assert_close(tmc.terminal_qmc(seed, params, **kw),
                  tmc._mc_qmc_plain(seed, params, **kw))


# K2's (n_programs, 13) rows as the kernel of commit 4bc6091 (a block per
# 256 elements, a block tree and a combine pass) gave them on an NVIDIA
# H100, by SHA-256 of their f32 bytes, at chip_smoke.py's K2_CASES ("seed
# kind points replicates", its market K5_MARKET below). The cluster design
# must keep them bit for bit.
K2_SUMS = {
    "5 call 1048576 16":
        "4473a6fd6d69fbb2353b3cd4a47868378eadbdeb3fd38679daac183de8dc610d",
    "5 put 1048576 16":
        "d54f1ad47d2d658cfd571018085e33904fcf9a9459c130ac1ed5c8de7b9e58be",
    "5 call 4194304 16":
        "cea23402e1917cf4291bd548c76f93bd23f34fe9f8859dca060905311e44c7c2",
    "7 call 4194304 16":
        "55e0342e094411742b9e1b387a94a0d9044951533232fa69af18cb3e8d413d85",
}


def _k2_setup(case):
    seed, kind, n, R = case.split()
    n_rep, reps, ppr = tmc._plan_qmc(int(n), int(R))
    params = tmc._terminal_params(n_rep, *K5_MARKET, kind == "call")
    kw = dict(n_programs=int(R) * ppr, reps=reps, progs_per_rep=ppr)
    return tmc._seed_pair(int(seed), "cpu"), params, kw


@pytest.mark.parametrize("case", list(K2_SUMS))
def test_qmc_kernel_gives_the_recorded_rows(cuda_device, case):
    import hashlib

    seed, params, kw = _k2_setup(case)
    # by value from the host, as mc_sumstats_qmc passes them, and from
    # tensors on the card
    for got in (tmc.terminal_qmc(seed, params, device=cuda_device, **kw),
                tmc.terminal_qmc(seed.to(cuda_device),
                                 params.to(cuda_device), **kw)):
        assert got.shape == (kw["n_programs"], tmc.NSTAT)
        digest = hashlib.sha256(got.cpu().numpy().tobytes()).hexdigest()
        assert digest == K2_SUMS[case]


@pytest.mark.parametrize("n, R", [(100_000, 16), (1 << 22, 16),
                                  (3_000_017, 16), (1 << 24, 16),
                                  (5 * tmc.TILE + 9, 1), (1 << 20, 128)])
def test_qmc_kernel_rows_match_plain(cuda_device, n, R):
    """Tails, two reps, more than two reps (the Kahan instantiation), one
    replicate and more programs than the card holds clusters."""
    n_rep, reps, ppr = tmc._plan_qmc(n, R)
    params = tmc._terminal_params(n_rep, *MARKET, True).to(cuda_device)
    seed = tmc._seed_pair(9, cuda_device)
    kw = dict(n_programs=R * ppr, reps=reps, progs_per_rep=ppr)
    got = tmc.terminal_qmc(seed, params, **kw)
    want = tmc._mc_qmc_plain(seed, params, **kw)
    assert float(got[:, 0].sum()) == n_rep * R
    _assert_close(got, want)


def test_qmc_kernel_counts_one_launch_a_call(cuda_device):
    seed, params, kw = _k2_setup("7 call 4194304 16")
    before = tmc.terminal_qmc.launches
    for i in range(3):
        tmc.terminal_qmc(seed, params, device=cuda_device, **kw)
        assert tmc.terminal_qmc.launches == before + i + 1
    tmc.terminal_qmc(seed, params, **kw)        # on the CPU: the plain version
    tmc.mc_sumstats_qmc(7, 1 << 20, *K5_MARKET, True, device=cuda_device)
    assert tmc.terminal_qmc.launches == before + 4
    with pytest.raises(ValueError, match="device"):
        tmc.terminal_qmc(seed.to(cuda_device), params.to(cuda_device),
                         device="cpu", **kw)


def test_launch_counters_count_kernel_launches(cuda_device):
    before = (tmc.terminal_mc.launches, tmc.terminal_qmc.launches)
    tmc.mc_sumstats_kernel(1, 100_000, *MARKET, True, antithetic=True,
                           device=cuda_device)
    tmc.mc_sumstats_qmc(1, 100_000, *MARKET, True, device=cuda_device)
    tmc.mc_sumstats_kernel(1, 100_000, *MARKET, True, antithetic=True,
                           device="cpu")
    assert (tmc.terminal_mc.launches, tmc.terminal_qmc.launches) == \
        (before[0] + 1, before[1] + 1)


_HESTON = dict(v0=0.04, kappa=1.5, theta=0.05, xi=0.6, rho=-0.7)


@pytest.mark.parametrize("payoff, kw, greeks", [
    ("vanilla", {}, True),
    ("barrier", dict(barrier=120.0), True),
    ("asian", dict(geo_cv=True), False),
    ("lookback", dict(strike_type="floating"), True),
    ("digital", {}, False),
    ("barrier", dict(barrier=120.0, heston=_HESTON, scheme="qe"), False),
    ("vanilla", dict(sabr=dict(alpha0=0.2, beta=0.6, nu=0.4, rho=-0.3)),
     False),
])
@pytest.mark.parametrize("antithetic", [True, False])
def test_path_kernel_matches_plain(cuda_device, payoff, kw, greeks,
                                   antithetic):
    n, n_steps = (1 << 18) + 123, 16
    kw = dict(kw)
    params, static = tpm._resolve_config(
        n, n_steps, *MARKET, True, payoff, antithetic, kw.get("barrier", 0.0),
        "up-and-out", 0.0, "arithmetic", kw.get("strike_type", "fixed"), 1.0,
        None, kw.get("scheme", "log_euler"), 0.01, kw.get("heston"),
        kw.get("sabr"), kw.get("geo_cv", False))
    reps, n_programs = tmc._plan_grid(n, tpm.TILE)
    seed = tmc._seed_pair(5, cuda_device)
    params = params.to(cuda_device)
    run = dict(n_programs=n_programs, reps=reps, with_greeks=greeks,
               **static)
    _assert_close(tpm.path_mc(seed, params, **run),
                  tpm._path_mc_plain(seed, params, **run),
                  signed=(11, 13, 15, 17, 19))


@pytest.mark.parametrize("payoff", list(tqp.PAYOFF_IDS))
def test_qmc_path_kernel_matches_plain(cuda_device, payoff):
    n, d, R = 65_536, 64, 8
    m_bits, d_pad, reps, ppr = tqp._plan(n, d, R)
    arrays = tqp._kernel_inputs(3, n, d, *MARKET, n_replicates=R,
                                barrier=120.0, rebate=0.0, payout=1.0)
    tensors = [torch.from_numpy(a).to(cuda_device) for a in arrays]
    kw = dict(n_programs=R * ppr, reps=reps, progs_per_rep=ppr, n_steps=d,
              d_pad=d_pad, m_bits=m_bits, payoff_id=tqp.PAYOFF_IDS[payoff],
              barrier_up=True, knock_in=False, is_call=True,
              arithmetic=True, fixed_strike=True)
    _assert_close(tqp.qmc_path(*tensors, **kw),
                  tqp._qmc_path_plain(*tensors, **kw))


# K5 as chip_smoke.py's k5_setup drives it: seed 3, S0 100, K 110, T 1,
# r 0.03, q 0, σ 0.2, barrier 130 (up-and-out), 8 replicates
K5_MARKET = (100.0, 110.0, 1.0, 0.03, 0.0, 0.2)


def _k5_setup(device, payoff, n, d, R=8):
    m_bits, d_pad, reps, ppr = tqp._plan(n, d, R)
    arrays = tqp._kernel_inputs(3, n, d, *K5_MARKET, n_replicates=R,
                                barrier=130.0, rebate=0.0, payout=1.0)
    tensors = [torch.from_numpy(a).to(device) for a in arrays]
    kw = dict(n_programs=R * ppr, reps=reps, progs_per_rep=ppr, n_steps=d,
              d_pad=d_pad, m_bits=m_bits, payoff_id=tqp.PAYOFF_IDS[payoff],
              barrier_up=True, knock_in=False, is_call=True,
              arithmetic=payoff != "asian", fixed_strike=True)
    return tensors, kw


@pytest.mark.parametrize("payoff", ["asian", "vanilla", "barrier"])
@pytest.mark.parametrize("d", [64, 252, 3, 130])
def test_qmc_path_kernel_step_counts_match_plain(cuda_device, payoff, d):
    tensors, kw = _k5_setup(cuda_device, payoff, 65_536, d)
    _assert_close(tqp.qmc_path(*tensors, **kw),
                  tqp._qmc_path_plain(*tensors, **kw))


@pytest.mark.parametrize("d", [1, 500, 1024, 2048])
@pytest.mark.parametrize("sigma", [0.0, 0.2])
def test_qmc_path_kernel_long_bridges_match_plain(cuda_device, d, sigma):
    m_bits, d_pad, reps, ppr = tqp._plan(4096, d, 2)
    arrays = tqp._kernel_inputs(3, 4096, d, 100.0, 100.0, 1.0, 0.03, 0.0,
                                sigma, n_replicates=2, barrier=0.0,
                                rebate=0.0, payout=1.0)
    tensors = [torch.from_numpy(a).to(cuda_device) for a in arrays]
    # the floating-strike lookback: its terminal spot and running minimum
    # are exact functions of every step's logS, which the kernel keeps bit
    # for bit (an arithmetic Asian's step sum rounds in another order in
    # the plain version's torch.sum)
    kw = dict(n_programs=2 * ppr, reps=reps, progs_per_rep=ppr, n_steps=d,
              d_pad=d_pad, m_bits=m_bits,
              payoff_id=tqp.PAYOFF_IDS["lookback"], barrier_up=True,
              knock_in=False, is_call=True, arithmetic=True,
              fixed_strike=False)
    _assert_close(tqp.qmc_path(*tensors, **kw),
                  tqp._qmc_path_plain(*tensors, **kw))


@pytest.mark.parametrize("sigma", [0.2, 0.0])
def test_qmc_path_kernel_arithmetic_asian_past_252_steps(cuda_device, sigma):
    """The arithmetic Asian at 2 048 steps against the plain mirror that
    sums the steps in step order, as the kernel does."""
    n, d, R = 4096, 2048, 2
    m_bits, d_pad, reps, ppr = tqp._plan(n, d, R)
    arrays = tqp._kernel_inputs(3, n, d, 100.0, 100.0, 1.0, 0.03, 0.0,
                                sigma, n_replicates=R, barrier=0.0,
                                rebate=0.0, payout=1.0)
    tensors = [torch.from_numpy(a).to(cuda_device) for a in arrays]
    kw = dict(n_programs=R * ppr, reps=reps, progs_per_rep=ppr, n_steps=d,
              d_pad=d_pad, m_bits=m_bits, payoff_id=tqp.PAYOFF_IDS["asian"],
              barrier_up=True, knock_in=False, is_call=True,
              arithmetic=True, fixed_strike=True)
    _assert_close(tqp.qmc_path(*tensors, **kw),
                  tqp._qmc_path_plain(*tensors, **kw, step_order=True))


@pytest.mark.parametrize("plan", ["missing", "short"])
def test_qmc_path_kernel_needs_the_plan(cuda_device, plan):
    tensors, kw = _k5_setup(cuda_device, "asian", 4096, 40)
    tensors = tensors[:6] if plan == "missing" \
        else tensors[:6] + [tensors[6][:-4]]
    with pytest.raises(ValueError, match="plan"):
        tqp.qmc_path(*tensors, **kw)


# K5's (n_programs, 6) sums as the kernel of commit 95d2791 (the dense
# bridge product over a slab of B, the full Sobol ladder a thread) gave
# them on an NVIDIA H100, by SHA-256 of their f32 bytes: the five payoffs
# at 65 536 points x 8 replicates x 64 steps, the Asian and vanilla at 252
# steps and the Asian at 2^20 x 8 x 252 (chip_smoke.py's K5 cases). The
# sparse bridge and the split Sobol words must keep them bit for bit.
QMC_PATH_SUMS = {
    "vanilla 65536 64":
        "891d870dd3e92158cc85dc304308d8840518e762052627316cb06f6979bb18fa",
    "barrier 65536 64":
        "445e9e42afd753643d92e5803394da8a98afeabbbb57a27e934f6127a3d521aa",
    "asian 65536 64":
        "41e0c4e03854ad262d198dfe2ddb614ca5598789724a413976b83204f3f799fc",
    "digital 65536 64":
        "da60608d60c335a45320c99361e5b0eb02c7eacd3fb4c7eeb796728e728df8df",
    "lookback 65536 64":
        "ce6670c0400ab04e301ba04ad9ff01eb012c91eb6dafd5fb9bea77fb5a5c1249",
    "asian 65536 252":
        "e215d071f5fce1b80c16c367eee975d0acadfe7b74b102900d049d7c98eb7ea8",
    "vanilla 65536 252":
        "891d870dd3e92158cc85dc304308d8840518e762052627316cb06f6979bb18fa",
    "asian 1048576 252":
        "fbdfd7084212c7ec22695357b7042bfba4d2f4c6acd256b81d3ff886cbea26b9",
}


@pytest.mark.parametrize("case", list(QMC_PATH_SUMS))
def test_qmc_path_kernel_gives_the_recorded_sums(cuda_device, case):
    import hashlib

    payoff, n, d = case.split()
    tensors, kw = _k5_setup(cuda_device, payoff, int(n), int(d))
    got = tqp.qmc_path(*tensors, **kw).cpu().numpy()
    assert hashlib.sha256(got.tobytes()).hexdigest() == QMC_PATH_SUMS[case]


@pytest.mark.parametrize("n", [3 * 2 * tmc.TILE, 1_000_003, 5_000_011,
                               (1 << 22) + 1])
@pytest.mark.parametrize("antithetic", [True, False])
def test_terminal_kernel_full_and_tail_programs(cuda_device, n, antithetic):
    reps, n_programs = tmc._plan_grid(n, 2 * tmc.TILE)
    assert tmc._full_programs(n, n_programs, reps) >= n_programs - 1
    params = tmc._terminal_params(n, *MARKET, True).to(cuda_device)
    seed = tmc._seed_pair(13, cuda_device)
    kw = dict(n_programs=n_programs, reps=reps, antithetic=antithetic)
    got = tmc.terminal_mc(seed, params, **kw)
    assert float(got[0]) == n
    _assert_close(got, tmc._mc_sumstats_plain(seed, params, **kw))


def test_terminal_and_qmc_path_occupancy_queries(cuda_device):
    for anti in (True, False):
        for inv in (True, False):
            assert 1 <= tmc.blocks_per_sm(anti, inv) <= 8
    # registers, not shared memory, bound K5 at the main path's step counts;
    # at 2 048 steps the common words make shared memory bind
    for payoff_id in tqp.PAYOFF_IDS.values():
        for d in (64, 252):
            assert tqp.blocks_per_sm(payoff_id, d) == 16
        assert 8 <= tqp.blocks_per_sm(payoff_id, 2048) < 16


def test_path_launch_counters_count_kernel_launches(cuda_device):
    before = (tpm.path_mc.launches, tqp.qmc_path.launches)
    kw = dict(payoff="asian", antithetic=True)
    tpm.path_mc_sumstats_kernel(1, 10_000, 8, *MARKET, True,
                                device=cuda_device, **kw)
    tpm.path_mc_sumstats_kernel(1, 10_000, 8, *MARKET, True, device="cpu",
                                **kw)
    tqp.path_qmc_sumstats_kernel(1, 1024, 8, *MARKET, True,
                                 device=cuda_device)
    assert (tpm.path_mc.launches, tqp.qmc_path.launches) == \
        (before[0] + 1, before[1] + 1)


# K7 and K8: f64 solves to rtol 1e-10, f32 to 2e-5, entry by entry with an
# absolute floor of rtol·max|x| (K7 solves by cyclic reduction, its plain
# version by Thomas: the two round differently, so an entry far below the
# solution's scale is held to the scale, as the CPU tests hold the plain
# mirror of K7's algorithm); the
# fused march's prices within 2e-5 of the plain version's (both built
# without FMA contraction, so they round alike).
def _tridiag(n, batch, dtype, device, seed=0):
    g = torch.Generator().manual_seed(seed)
    a, b, c, d = (torch.randn(n, batch, generator=g, dtype=torch.float64)
                  for _ in range(4))
    return [x.to(dtype=dtype, device=device) for x in (a, b + 4.0, c, d)]


@pytest.mark.parametrize("n, batch, dtype, rtol", [
    (511, 1024, torch.float64, 1e-10), (511, 1024, torch.float32, 2e-5),
    (511, 511, torch.float64, 1e-10), (37, 3, torch.float64, 1e-10),
    (511, 1, torch.float64, 1e-10), (199, 1, torch.float32, 2e-5),
    (1, 4, torch.float64, 1e-10), (2, 4, torch.float64, 1e-10),
    (3, 4, torch.float64, 1e-10), (1025, 8, torch.float64, 1e-10),
    (1536, 8, torch.float64, 1e-10), (1025, 8, torch.float32, 2e-5),
    (4095, 8, torch.float64, 1e-10)])
def test_thomas_kernel_matches_plain(cuda_device, n, batch, dtype, rtol):
    a, b, c, d = _tridiag(n, batch, dtype, cuda_device)
    a[0] = 1e30           # unused corners hold garbage
    c[-1] = float("nan")
    x = tth.tridiag_solve_kernel(a, b, c, d)
    torch.cuda.synchronize()
    ref = tth._thomas_plain(a, b, c, d)
    assert torch.isfinite(x).all()
    torch.testing.assert_close(x, ref, rtol=rtol,
                               atol=rtol * ref.abs().max().item())


def test_thomas_lastdim_with_row_coefficients(cuda_device):
    a, b, c, d = _tridiag(37, 3, torch.float64, cuda_device, seed=2)
    rows = [t[:, 0] for t in (a, b, c)]
    before = tth.tridiag_solve_kernel.launches
    shape_before = tth.tridiag_solve_kernel.launches_by_shape[(37, 3)]
    got = tth.tridiag_solve_kernel_lastdim(*rows, d.t())
    assert tth.tridiag_solve_kernel.launches == before + 1
    assert tth.tridiag_solve_kernel.launches_by_shape[(37, 3)] == \
        shape_before + 1
    ref = tth._thomas_plain(*(r[:, None] for r in rows), d)
    torch.testing.assert_close(got, ref.t(), rtol=1e-10,
                               atol=1e-10 * ref.abs().max().item())


@pytest.mark.parametrize("bands, rhs, dtype, rtol", [
    ((3, 1, 37), (4, 37), torch.float64, 1e-10),
    ((2, 1, 1100), (5, 1100), torch.float64, 1e-10),
    ((3, 1, 37), (4, 37), torch.float32, 2e-5)])
def test_thomas_lastdim_shared_along_each_system_axis(cuda_device, bands,
                                                      rhs, dtype, rtol):
    """Bands shared along the inner system axis and right-hand sides shared
    along the outer one (tridiag_inv's layout), read in place, solve as
    their broadcast."""
    g = torch.Generator().manual_seed(5)
    lo, mid, hi = (torch.randn(bands, generator=g, dtype=torch.float64)
                   for _ in range(3))
    d = torch.randn(rhs, generator=g, dtype=torch.float64)
    ops = [x.to(dtype=dtype, device=cuda_device)
           for x in (lo, mid + 4.0, hi, d)]
    got = tth.tridiag_solve_kernel_lastdim(*ops)
    shape = (bands[0], rhs[0], bands[-1])
    ref = tth._thomas_plain(*(t.expand(shape).movedim(-1, 0) for t in ops))
    torch.testing.assert_close(got, ref.movedim(0, -1), rtol=rtol,
                               atol=rtol * ref.abs().max().item())


@pytest.mark.parametrize("m, n, dtype, rtol", [
    (96, 256, torch.float64, 1e-10), (96, 256, torch.float32, 2e-5),
    (2, 1100, torch.float64, 1e-10)])
def test_tridiag_inv_matches_plain(cuda_device, m, n, dtype, rtol):
    from optpricer_tpu_torch.ops.tridiag import tridiag_dense, tridiag_inv

    g = torch.Generator().manual_seed(6)
    lo, mid, hi = (torch.randn(m, n, generator=g, dtype=torch.float64)
                   for _ in range(3))
    lo, mid, hi = (x.to(dtype=dtype, device=cuda_device)
                   for x in (lo, mid + 4.0, hi))
    before = tth.tridiag_solve_kernel.launches_by_shape[(n, m * n)]
    raw = tridiag_inv(lo, mid, hi, newton=False)
    assert tth.tridiag_solve_kernel.launches_by_shape[(n, m * n)] == \
        before + 1
    eye = torch.eye(n, dtype=dtype, device=cuda_device)
    shape = (m, n, n)
    ref = tth._thomas_plain(*(t.expand(shape).movedim(-1, 0) for t in (
        lo[:, None], mid[:, None], hi[:, None], eye)))
    ref = ref.movedim(0, -1).transpose(-1, -2)
    torch.testing.assert_close(raw, ref, rtol=rtol,
                               atol=rtol * ref.abs().max().item())
    if dtype == torch.float64:
        inv = tridiag_inv(lo, mid, hi)
        lib = torch.linalg.inv(tridiag_dense(lo, mid, hi))
        torch.testing.assert_close(inv, lib, rtol=0.0,
                                   atol=1e-12 * lib.abs().max().item())


def _smile(S, t):
    return 0.2 + 0.1 * torch.exp(-((torch.log(S / 100.0)) ** 2)) + 0.05 * t


def _fd_lv_ladder(device, n_strikes, N_S, N_t=32):
    """K8's operands for a ladder of calls and puts alternating (a call
    first), strikes 70..130, on ``device``."""
    calls = np.arange(n_strikes) % 2 == 0
    (x_np, dt, _, _, params, K, sign, m, m_pad) = tlv._kernel_inputs(
        100.0, np.linspace(70.0, 130.0, n_strikes), 1.0, 0.04, 0.01, calls,
        N_S=N_S, N_t=N_t, S_max_mult=4.0, ref_vol=0.3)
    tab = tlv._sigma_table(_smile, x_np, dt, N_S, N_t, m_pad, device)
    ops = [torch.from_numpy(t).to(device) for t in (params, K, sign)]
    return ops, tab, dict(n_t=N_t, m=m, m_pad=m_pad, theta=0.5)


# K8 ladders: 1 strike, a PCR block and one more, 1 025 (a ragged last
# block); m_pad 8 (m = 8), 512 (m = 511, the main path's) and 1 024
# (m = 1 020, PCR's largest)
@pytest.mark.parametrize("method", ["pcr", "thomas"])
@pytest.mark.parametrize("american", [False, True])
@pytest.mark.parametrize("n_strikes", [1, tlv.PCR_STRIKES + 1, 1025])
@pytest.mark.parametrize("N_S", [9, 512, 1021])
def test_fd_lv_kernel_matches_plain(cuda_device, method, american,
                                    n_strikes, N_S):
    ops, tab, kw = _fd_lv_ladder(cuda_device, n_strikes, N_S)
    kw = dict(kw, american=american, method=method)
    before = tlv.fd_lv.launches
    by_method = tlv.fd_lv.launches_by_method[method]
    got = tlv.fd_lv(*ops, tab, **kw)
    torch.cuda.synchronize()
    assert tlv.fd_lv.launches == before + 1
    assert tlv.fd_lv.launches_by_method[method] == by_method + 1
    ref = tlv._fd_lv_plain(*ops, tab, **kw)
    assert got.shape == (kw["m_pad"], n_strikes)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, ref, rtol=0.0, atol=2e-5)


@pytest.mark.parametrize("american", [False, True])
def test_fd_lv_thomas_beyond_shared_memory(cuda_device, american):
    """Above ``THOMAS_SMEM_ROWS`` rows the Thomas kernel reads the plan
    from device memory and keeps its columns in the output and a scratch:
    the same layer as the plain version."""
    N_S = tlv.THOMAS_SMEM_ROWS + 10
    ops, tab, kw = _fd_lv_ladder(cuda_device, tlv.THOMAS_STRIKES + 3, N_S,
                                 N_t=4)
    assert tlv._launch_plan("thomas", 11, kw["m_pad"], 4).smem_bytes == 0
    kw = dict(kw, american=american, method="thomas")
    got = tlv.fd_lv(*ops, tab, **kw)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, tlv._fd_lv_plain(*ops, tab, **kw),
                               rtol=0.0, atol=2e-5)


@pytest.mark.parametrize("method", ["pcr", "thomas"])
@pytest.mark.parametrize("N_S", [9, 512, 1021])
def test_fd_lv_plan_kernel_matches_plain(cuda_device, method, N_S):
    """The pre-kernel's plan equals its plain version on the card exactly:
    the same correctly rounded f32 operations (torch's CUDA division and
    reciprocal are IEEE, nothing is contracted), and its march from the
    kernel's plan is the kernel's layer."""
    ops, tab, kw = _fd_lv_ladder(cuda_device, 9, N_S, N_t=17)
    got = tlv.fd_lv_plan(ops[0], tab, **kw, method=method)
    ref = tlv._fd_lv_plan_plain(ops[0], tab, **kw, method=method)
    assert torch.equal(got, ref)
    march = dict(n_t=kw["n_t"], m=kw["m"], m_pad=kw["m_pad"],
                 american=True, method=method)
    layer = tlv.fd_lv(*ops, tab, **dict(kw, american=True, method=method))
    torch.testing.assert_close(
        layer, tlv._fd_lv_march_plain(got, *ops, **march), rtol=0.0,
        atol=2e-5)


def test_pde_entry_points_launch_the_kernels(cuda_device):
    spec = OptionSpec(S0=100.0, K=100.0, T=1.0, r=0.05, sigma=0.2)
    before = (tth.tridiag_solve_kernel.launches, tlv.fd_lv.launches)
    cuda = fd_price(spec, "put", N_S=64, N_t=16, american=True,
                    american_method="psor", device=cuda_device)
    cpu = fd_price(spec, "put", N_S=64, N_t=16, american=True,
                   american_method="psor", device="cpu")
    assert abs(cuda - cpu) <= 1e-9 * abs(cpu)
    fd_price_local_vol_batch(100.0, np.array([90.0, 110.0]), 1.0, 0.04, 0.0,
                             _smile, "call", N_S=64, N_t=16, solver="fused",
                             device=cuda_device)
    assert tth.tridiag_solve_kernel.launches == before[0] + 16
    assert tlv.fd_lv.launches == before[1] + 1


# K4's Dupire branches on a 3-slice SVI table (rows a, b, ρ, m, σ, T)
_SVI = np.array([[0.01, 0.02, 0.035], [0.12, 0.14, 0.15],
                 [-0.4, -0.3, -0.25], [0.0, 0.02, 0.03],
                 [0.1, 0.12, 0.15], [0.25, 0.5, 1.0]], np.float32)


@pytest.mark.parametrize("payoff, kw", [
    ("vanilla", {}), ("barrier", dict(barrier=120.0)), ("asian", {}),
    ("digital", {}), ("lookback", dict(strike_type="floating"))])
@pytest.mark.parametrize("scheme", ["log_euler", "milstein"])
@pytest.mark.parametrize("antithetic", [True, False])
def test_path_kernel_local_vol_matches_plain(cuda_device, payoff, kw, scheme,
                                             antithetic):
    n, n_steps = (1 << 18) + 123, 16
    params, static = tpm._resolve_config(
        n, n_steps, *MARKET[:5], None, True, payoff, antithetic,
        kw.get("barrier", 0.0), "up-and-out", 0.0, "arithmetic",
        kw.get("strike_type", "fixed"), 1.0, _SVI, scheme, 0.01, None)
    reps, n_programs = tmc._plan_grid(n, tpm.TILE)
    seed = tmc._seed_pair(5, cuda_device)
    static["svi"] = static["svi"].to(cuda_device)
    run = dict(n_programs=n_programs, reps=reps, **static)
    params = params.to(cuda_device)
    _assert_close(tpm.path_mc(seed, params, **run),
                  tpm._path_mc_plain(seed, params, **run))


# K4's Dupire arithmetic (csrc/path_mc.cu div_rn_fast, sqrt_rn_fast) on
# the ranges its note states, against IEEE's own division and sqrtf, built
# in the same file; exponents of b in [-60, 59], of a in [-100, 99], their
# difference in [-119, 119]
_DIV_EB, _DIV_EA, _DIV_GAP = (-60, 59), (-100, 99), 119


def _f32_bits(exponent, mantissa, negative=None):
    bits = ((exponent + 127) << 23) | mantissa
    if negative is not None:
        bits = bits - (negative.to(torch.int64) << 31)   # the sign bit
    return bits.to(torch.int32).view(torch.float32)


def _fast_vs_ieee(a, b, fast_op):
    got = tpm._fast_ops(a, b, fast_op).view(torch.int32)
    want = tpm._fast_ops(a, b, fast_op + 1).view(torch.int32)
    if fast_op in (0, 2):   # the kernel's IEEE op is the host's, on a sample
        x, y = a[:4096].cpu().numpy(), b[:4096].cpu().numpy()
        host = x / y if fast_op == 0 else np.sqrt(x)
        assert np.array_equal(want[:4096].cpu().numpy(), host.view(np.int32))
    differ = got != want
    if bool(differ.any()):
        i = int(differ.nonzero()[0])
        raise AssertionError(
            f"op {fast_op}: a={float(a[i]).hex()} b={float(b[i]).hex()}: "
            f"{float(got[i].view(torch.float32)).hex()} against IEEE "
            f"{float(want[i].view(torch.float32)).hex()}")


def test_sqrt_rn_fast_is_sqrtf_on_every_float_in_range(cuda_device):
    # every float in [2^-100, FLT_MAX], 2^27 at a time
    lo, hi = (-100 + 127) << 23, 0x7F7FFFFF
    for start in range(lo, hi + 1, 1 << 27):
        x = torch.arange(start, min(start + (1 << 27), hi + 1),
                         dtype=torch.int32, device=cuda_device)
        x = x.view(torch.float32)
        _fast_vs_ieee(x, x, 2)


def test_lv_log32_is_log32_on_every_float(cuda_device):
    # its one division in range for every input: all 2^32 bit patterns,
    # 2^28 at a time
    for start in range(-(1 << 31), 1 << 31, 1 << 28):
        x = torch.arange(start, start + (1 << 28), dtype=torch.int32,
                         device=cuda_device).view(torch.float32)
        _fast_vs_ieee(x, x, 4)


def test_lv_radius_is_ieee_on_every_box_muller_draw(cuda_device):
    # every u1 = (k + 0.5) 2^-24 the kernel draws, 1 (k = 2^24 - 1) among
    # them
    k = torch.arange(1 << 24, dtype=torch.int32, device=cuda_device)
    u1 = (k.to(torch.float32) + 0.5) * 2.0 ** -24
    assert float(u1[-1]) == 1.0
    _fast_vs_ieee(u1, u1, 6)


def test_div_rn_fast_is_ieee_on_random_pairs(cuda_device):
    # 2^30 pairs, b's and a's exponents uniform over the range, a of
    # either sign, one a in 64 zero; 2^26 at a time
    gen = torch.Generator(device=cuda_device).manual_seed(20)
    n = 1 << 26
    for _ in range(16):
        def ints(lo, hi):
            return torch.randint(lo, hi + 1, (n,), generator=gen,
                                 device=cuda_device, dtype=torch.int64)

        eb = ints(*_DIV_EB)
        ea = torch.clamp(eb + ints(-_DIV_GAP, _DIV_GAP), *_DIV_EA)
        b = _f32_bits(eb, ints(0, (1 << 23) - 1))
        a = _f32_bits(ea, ints(0, (1 << 23) - 1), ints(0, 1))
        a = torch.where(ints(0, 63) == 0, 0.0, a)
        _fast_vs_ieee(a, b, 0)


def test_div_rn_fast_is_ieee_on_every_exponent_pair(cuda_device):
    # every exponent pair in range, each with the mantissas at their ends
    # (1 and 2 - 2^-23) and 252 random pairs, both signs of a
    gen = torch.Generator(device=cuda_device).manual_seed(21)
    eb = torch.arange(_DIV_EB[0], _DIV_EB[1] + 1, device=cuda_device)
    ea = torch.arange(_DIV_EA[0], _DIV_EA[1] + 1, device=cuda_device)
    eb, ea = (t.reshape(-1) for t in torch.meshgrid(eb, ea, indexing="ij"))
    keep = (ea - eb).abs() <= _DIV_GAP
    eb, ea = eb[keep], ea[keep]
    top = (1 << 23) - 1
    ends = torch.tensor([[0, 0], [0, top], [top, 0], [top, top]],
                        device=cuda_device)
    rand = torch.randint(0, top + 1, (252, 2), generator=gen,
                         device=cuda_device)
    mant = torch.cat([ends, rand]).to(torch.int64)
    for negative in (0, 1):
        ma, mb = mant[:, 0].view(1, -1), mant[:, 1].view(1, -1)
        b = _f32_bits(eb.view(-1, 1), mb).reshape(-1)
        a = _f32_bits(ea.view(-1, 1), ma, torch.full_like(
            ma.expand(len(ea), -1), negative)).reshape(-1)
        _fast_vs_ieee(a, b, 0)


def _desk_k4(cuda_device, scheme, scale=1.0, n=None, n_steps=None):
    """chip_smoke.py's desk K4 call on the recorded table (``DESK_SVI``):
    (seed, params, run), spot, strike and barrier times ``scale``."""
    import chip_smoke
    from optpricer_tpu_torch.scripts import \
        desk_workflow_localvol_barrier as desk

    slc = chip_smoke.Config5Slice(cuda_device, "")
    S0, K, T, r, q = slc.MARKET
    return slc.k4_lv(n or slc.DESK["n_paths"],
                     n_steps or slc.DESK["n_steps"],
                     dict(payoff="barrier", barrier=130.0 * scale), scheme,
                     True, chip_smoke.desk_svi(),
                     market=(S0 * scale, K * scale, T, r, q), seed=desk.SEED)


# the degree in the spot of each of the 11 price sums: n, ΣX, ΣX², ΣY1,
# ΣY1², ΣXY1, ΣY2, ΣY2², ΣXY2, ΣY1Y2, ΣY3
_SPOT_DEGREE = (0, 1, 2, 1, 2, 2, 0, 0, 1, 1, 0)


@pytest.mark.parametrize("scheme", ["milstein", "log_euler"])
def test_dupire_fast_arithmetic_keeps_the_desk_sums(cuda_device, scheme):
    # the desk's call: every state inside the range (no thread falls
    # back), the recorded sums bit for bit
    import chip_smoke

    seed, params, run = _desk_k4(cuda_device, scheme)
    got = tpm.path_mc(seed, params, **run).cpu()
    assert tpm.path_mc.lv_fallbacks() == 0
    want = torch.zeros_like(got)
    sums = chip_smoke.DESK_SUMS[scheme]
    want[:len(sums)] = torch.tensor([float.fromhex(h) for h in sums])
    assert torch.equal(got, want)


@pytest.mark.parametrize("scheme", ["milstein", "log_euler"])
@pytest.mark.parametrize("power, some", [(34, False), (33, True)])
def test_dupire_fallback_gives_the_fast_bits(cuda_device, scheme, power,
                                             some):
    # spot, strike and barrier times 2^power: every operation scales
    # exactly, so each sum is the desk's times 2^(power x its degree), bit
    # for bit; at 2^34 the spot starts above the range (every thread
    # steps with IEEE's code), at 2^33 the paths that rise ~27% leave it
    scale = 2.0 ** power
    seed, params, run = _desk_k4(cuda_device, scheme)
    base = tpm.path_mc(seed, params, **run).cpu().double()
    seed, params, run = _desk_k4(cuda_device, scheme, scale)
    got = tpm.path_mc(seed, params, **run).cpu().double()
    fallbacks = tpm.path_mc.lv_fallbacks()
    threads = run["n_programs"] * tpm.TILE
    assert 0 < fallbacks < threads if some else fallbacks == threads
    degree = torch.tensor(_SPOT_DEGREE + (0,) * (tpm.NSTAT - 11),
                          dtype=torch.float64)
    assert torch.equal(got, base * scale ** degree)


def test_dupire_fallback_matches_plain(cuda_device):
    # every thread on IEEE's code (the spot above the range) against the
    # plain version, at test_path_kernel_local_vol_matches_plain's rtol
    seed, params, run = _desk_k4(cuda_device, "milstein", 2.0 ** 34,
                                 n=(1 << 18) + 123, n_steps=16)
    got = tpm.path_mc(seed, params, **run)
    assert tpm.path_mc.lv_fallbacks() == run["n_programs"] * tpm.TILE
    _assert_close(got, tpm._path_mc_plain(seed, params, **run))


def _book(B=1000, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.uniform(90.0, 110.0, B), np.linspace(70.0, 130.0, B),
            rng.uniform(0.1, 2.0, B), 0.03, 0.01, rng.uniform(0.1, 0.4, B),
            np.where(np.arange(B) % 2 == 0, "call", "put"))


# n_paths -> the full programs of its grid: every one (2^20, 3 x 16 x 512),
# all but the last (1 000 003), none (511)
_BOOK_GRIDS = {1 << 20: 16, 1_000_003: 15, 24_576: 16, 511: 0}


@pytest.mark.parametrize("n_paths", list(_BOOK_GRIDS))
@pytest.mark.parametrize("antithetic", [True, False])
def test_book_kernel_matches_plain(cuda_device, n_paths, antithetic):
    kparams, _ = tmb.batch_kparams(*_book())
    reps, n_programs = tmb._plan(n_paths)
    assert tmb._full_programs(n_paths, n_programs, reps) \
        == _BOOK_GRIDS[n_paths]
    ops = (torch.tensor([7], dtype=torch.int32, device=cuda_device),
           torch.tensor([float(n_paths)], device=cuda_device),
           torch.from_numpy(kparams).to(cuda_device))
    kw = dict(n_programs=n_programs, reps=reps, antithetic=antithetic)
    before = tmb.mc_batch.launches
    got = tmb.mc_batch(*ops, **kw)
    assert tmb.mc_batch.launches == before + 1
    ref = tmb._mc_batch_plain(*ops, **kw)
    assert torch.equal(got[:, 0], torch.full_like(got[:, 0], n_paths))
    # (n_ktiles, 10, 128) → one row of 10 sums per lane
    _assert_close(got.transpose(1, 2).reshape(-1, 10),
                  ref.transpose(1, 2).reshape(-1, 10))


def test_book_kernel_is_deterministic(cuda_device):
    kparams, _ = tmb.batch_kparams(*_book(300))
    reps, n_programs = tmb._plan(1 << 18)
    ops = (torch.tensor([3], dtype=torch.int32, device=cuda_device),
           torch.tensor([float(1 << 18)], device=cuda_device),
           torch.from_numpy(kparams).to(cuda_device))
    kw = dict(n_programs=n_programs, reps=reps, antithetic=True)
    assert torch.equal(tmb.mc_batch(*ops, **kw).clone(),
                       tmb.mc_batch(*ops, **kw).clone())


# K6 (the basket kernel) and K4's lsv / lsv_qe branches: counts equal, the
# other sums at rtol 2e-5 (with non-negative weights K6's six are unsigned).
def _basket_setup(a, payoff, btype, anti, device, n=(1 << 16) + 123,
                  n_steps=16):
    rng = np.random.default_rng(a)
    S = rng.uniform(80.0, 120.0, a)
    w = np.full(a, 1.0 / a)
    chol = np.linalg.cholesky(np.full((a, a), 0.35) + 0.65 * np.eye(a))
    lvl = float(S.min()) if payoff == "worstof_barrier" else float(S @ w)
    up = btype.startswith("up")
    params = tbk._build_params(n, n_steps, list(S), list(w), float(S.mean()),
                               1.0, 0.03, [0.01] * a,
                               list(rng.uniform(0.15, 0.4, a)), chol,
                               lvl * (1.1 if up else 0.9), 1.0, True, payoff,
                               up).to(device)
    reps, n_programs = tmc._plan_grid(n, tbk.TILE)
    return params, dict(n_programs=n_programs, reps=reps, n_assets=a,
                        n_steps=n_steps, antithetic=anti,
                        payoff_id=tbk.PAYOFF_IDS[payoff], barrier_up=up,
                        knock_in=btype.endswith("in"))


# path pairs at 16 steps -> reps of the grid
_BASKET_REPS = {(1 << 16) + 123: 1, (1 << 18) + 123: 2,
                3 * (1 << 18) + 123: 4}


@pytest.mark.parametrize("a", [1, 2, 3, 4, 5, 8, 9, 10, 12, 16])
@pytest.mark.parametrize("payoff, btype", [
    ("asian_basket", "down-and-in"), ("worstof_barrier", "down-and-out"),
    ("worstof_barrier", "up-and-in"), ("basket_barrier", "up-and-out"),
    ("basket_barrier", "down-and-in")])
@pytest.mark.parametrize("antithetic", [True, False])
@pytest.mark.parametrize("n", list(_BASKET_REPS))
def test_basket_kernel_matches_plain(cuda_device, a, payoff, btype,
                                     antithetic, n):
    params, run = _basket_setup(a, payoff, btype, antithetic, cuda_device,
                                n=n)
    assert run["reps"] == _BASKET_REPS[n]
    seed = tmc._seed_pair(5, cuda_device)
    before = tbk.basket_mc.launches
    got = tbk.basket_mc(seed, params, **run)
    assert tbk.basket_mc.launches == before + 1
    ref = tbk._basket_mc_plain(seed, params, **run)
    k, p = got.double().cpu(), ref.double().cpu()
    assert k[0] == p[0] == n
    torch.testing.assert_close(k[1:], p[1:], rtol=RTOL, atol=0.0)


def test_basket_kernel_is_deterministic(cuda_device):
    params, run = _basket_setup(10, "asian_basket", "down-and-in", True,
                                cuda_device, n=1 << 18, n_steps=64)
    seed = tmc._seed_pair(3, cuda_device)
    assert torch.equal(tbk.basket_mc(seed, params, **run).clone(),
                       tbk.basket_mc(seed, params, **run).clone())


# K6's 6 sums at one rep, recorded from the kernel of commit 84a5d63 (one
# thread per (program, element) looping over the reps, the asset count
# bucketed) on an NVIDIA H100: bench.py's [basket-path] book (10 assets,
# 2^18 pairs x 64 steps, seed 3, Asian) through the public entry, and the
# 16-asset basket barrier (up-and-in at 110% of the basket) of
# chip_smoke.py's K6_SHAPES. An edit of the kernel must keep them bit for
# bit, or it changes per-path results.
BASKET_SUMS = {
    "basket_path": ("0x1.0000000000000p+18", "0x1.1a4d520000000p+20",
                    "0x1.dde59e0000000p+22", "0x1.6f0e680000000p+24",
                    "0x1.0751c80000000p+31", "0x1.9a01300000000p+26"),
    "16_assets_barrier": ("0x1.0000000000000p+18", "0x1.efd1ea0000000p+20",
                          "0x1.9289d00000000p+24", "0x1.78d67a0000000p+24",
                          "0x1.158b760000000p+31", "0x1.73f5180000000p+27"),
}


def _bench_book(a):
    """bench.py:360-388's book (default_rng(2) spots U(60, 140) and vols
    U(0.15, 0.4), correlation 0.35, equal weights, K = mean spot) at ``a``
    assets, drawn as chip_smoke.py's MultiAssetLsvSlice.book draws it."""
    rng = np.random.default_rng(2)
    n = max(a, 10)
    S0s, sig = rng.uniform(60, 140, n)[:a], rng.uniform(0.15, 0.4, n)[:a]
    corr = 0.35 * np.ones((a, a)) + (1 - 0.35) * np.eye(a)
    return S0s, np.ones(a) / a, float(S0s.mean()), sig, corr


@pytest.mark.parametrize("case", list(BASKET_SUMS))
def test_basket_kernel_gives_the_recorded_sums(cuda_device, case):
    if case == "basket_path":
        S0s, w, K, sig, corr = _bench_book(10)
        got = tbk.basket_path_sumstats_kernel(
            3, 1 << 18, 64, S0s, w, K, 1.0, 0.03, None, sig,
            np.linalg.cholesky(corr), True, payoff="asian_basket",
            device=cuda_device)
    else:
        S0s, w, K, sig, corr = _bench_book(16)
        params = tbk._build_params(
            1 << 18, 64, list(S0s), list(w), K, 1.0, 0.03, [0.0] * 16,
            list(sig), np.linalg.cholesky(corr), 1.1 * float(S0s @ w), 0.0,
            True, "basket_barrier", True)
        reps, n_programs = tmc._plan_grid(1 << 18, tbk.TILE)
        assert reps == 1
        got = tbk.basket_mc(
            tmc._seed_pair(3, cuda_device), params.to(cuda_device),
            n_programs=n_programs, reps=reps, n_assets=16, n_steps=64,
            antithetic=True, payoff_id=tbk.PAYOFF_IDS["basket_barrier"],
            barrier_up=True, knock_in=True, host_params=params)
    assert [float(v).hex() for v in got.cpu()] == list(BASKET_SUMS[case])


def _lsv_table(n_steps, scheme):
    from optpricer_tpu_torch.models import lsv as tl

    x_bins = np.linspace(-1.0, 1.0, 64)
    lev = np.stack([1.0 + 0.3 * x_bins ** 2 * np.exp(-0.5 * k / 8)
                    for k in range(n_steps)])
    model = tl.LSVModel(100.0, 0.03, 0.0, 1.0, 0.04, 1.5, 0.04, 0.5, -0.6,
                        torch.as_tensor(x_bins), torch.as_tensor(lev))
    coeffs, x_width = tl._leverage_poly(model)
    return dict(model.heston, coeffs=coeffs, x_width=x_width, scheme=scheme)


@pytest.mark.parametrize("scheme", ["euler", "qe"])
@pytest.mark.parametrize("payoff, kw", [
    ("vanilla", {}), ("barrier", dict(barrier=125.0)), ("asian", {}),
    ("digital", {}), ("lookback", dict(strike_type="floating"))])
@pytest.mark.parametrize("antithetic", [True, False])
def test_path_kernel_lsv_matches_plain(cuda_device, scheme, payoff, kw,
                                       antithetic):
    n, n_steps = (1 << 18) + 123, 16
    params, static = tpm._resolve_config(
        n, n_steps, 100.0, 100.0, 1.0, 0.03, 0.0, None, True, payoff,
        antithetic, kw.get("barrier", 0.0), "up-and-out", 0.0, "arithmetic",
        kw.get("strike_type", "fixed"), 1.0, None, "log_euler", 0.01, None,
        lsv=_lsv_table(n_steps, scheme))
    assert static["dynamics"] == ("lsv_qe" if scheme == "qe" else "lsv")
    reps, n_programs = tmc._plan_grid(n, tpm.TILE)
    seed = tmc._seed_pair(5, cuda_device)
    static["svi"] = static["svi"].to(cuda_device)
    run = dict(n_programs=n_programs, reps=reps, **static)
    params = params.to(cuda_device)
    _assert_close(tpm.path_mc(seed, params, **run),
                  tpm._path_mc_plain(seed, params, **run))


def test_basket_and_lsv_entry_points_launch_the_kernels(cuda_device):
    from optpricer_tpu_torch import basket_exotic_mc, lsv_price_mc
    from optpricer_tpu_torch.models import lsv as tl

    before = (tbk.basket_mc.launches, tpm.path_mc.launches)
    px, se = basket_exotic_mc([100.0, 95.0], [0.5, 0.5], 100.0, 1.0, 0.03,
                              sigmas=[0.2, 0.3], corr=[[1, 0.4], [0.4, 1]],
                              n_steps=8, n_paths=1 << 14, seed=1,
                              device=cuda_device)
    model = tl.LSVModel(100.0, 0.03, 0.0, 1.0, 0.04, 1.5, 0.04, 0.5, -0.6,
                        torch.linspace(-1, 1, 32), torch.ones(8, 32))
    px2, se2 = lsv_price_mc("vanilla", model, 100.0, n_paths=1 << 14,
                            seed=1, device=cuda_device)
    assert np.isfinite([px, se, px2, se2]).all()
    assert (tbk.basket_mc.launches, tpm.path_mc.launches) == \
        (before[0] + 1, before[1] + 1)


# K4's per-path grid (one thread per (program, rep, element) path): the
# kernel against its plain version at one, two and four reps, at 2, 252 and
# one past a staged leverage window of steps, the LSV branches at the
# reference's degree 12 (the unrolled Horner) and degree 5 (the loop over a
# shared row), with and without antithetic sampling.
_GRID_CASES = {
    "gbm asian geo_cv": dict(payoff="asian", geo_cv=True),
    "gbm asian greeks": dict(payoff="asian", greeks=True),
    "heston": dict(payoff="vanilla", heston=_HESTON),
    "heston_qe barrier": dict(payoff="barrier", barrier=125.0,
                              heston=_HESTON, scheme="qe"),
    "sabr_ln": dict(payoff="vanilla",
                    sabr=dict(alpha0=0.25, beta=1.0, nu=0.5, rho=-0.4)),
    "lsv barrier": dict(payoff="barrier", barrier=125.0, lsv="euler"),
    "lsv_qe barrier": dict(payoff="barrier", barrier=125.0, lsv="qe"),
}


def _lsv_coeffs(n_steps, deg, scheme):
    rng = np.random.default_rng(deg)
    coeffs = 0.05 * rng.standard_normal((n_steps, deg + 1))
    coeffs[:, -1] += 1.0
    return dict(v0=0.04, kappa=1.5, theta=0.04, xi=0.5, rho=-0.6,
                coeffs=coeffs, x_width=0.6, scheme=scheme)


def _grid_run(case, n, n_steps, antithetic, device, deg=12):
    kw = dict(_GRID_CASES[case])
    lsv = _lsv_coeffs(n_steps, deg, kw["lsv"]) if "lsv" in kw else None
    params, static = tpm._resolve_config(
        n, n_steps, 100.0, 100.0, 1.0, 0.03, 0.0, None if lsv else 0.2,
        True, kw["payoff"], antithetic, kw.get("barrier", 0.0),
        "up-and-out", 0.0, "arithmetic", "fixed", 1.0, None,
        kw.get("scheme", "log_euler"), 0.01, kw.get("heston"),
        kw.get("sabr"), kw.get("geo_cv", False), lsv=lsv)
    reps, n_programs = tmc._plan_grid(n, tpm.TILE)
    if static["svi"] is not None:
        static["svi"] = static["svi"].to(device)
    run = dict(n_programs=n_programs, reps=reps,
               with_greeks=kw.get("greeks", False), **static)
    return tmc._seed_pair(9, device), params.to(device), run


@pytest.mark.parametrize("case", list(_GRID_CASES))
@pytest.mark.parametrize("n, reps", [(1 << 18, 1), ((1 << 18) + 123, 2),
                                     (1_000_000, 4)])
@pytest.mark.parametrize("antithetic", [True, False])
def test_path_kernel_per_path_grid_matches_plain(cuda_device, case, n, reps,
                                                 antithetic):
    seed, params, run = _grid_run(case, n, 16, antithetic, cuda_device)
    assert run["reps"] == reps
    before = tpm.path_mc.launches
    got = tpm.path_mc(seed, params, **run)
    assert tpm.path_mc.launches == before + 1
    _assert_close(got, tpm._path_mc_plain(seed, params, **run),
                  signed=(11, 13, 15, 17, 19))


@pytest.mark.parametrize("case", ["gbm asian geo_cv", "lsv barrier",
                                  "lsv_qe barrier"])
@pytest.mark.parametrize("n_steps", [2, 252, tpm.LEV_WINDOW + 2])
def test_path_kernel_step_counts_match_plain(cuda_device, case, n_steps):
    seed, params, run = _grid_run(case, (1 << 16) + 123, n_steps, True,
                                  cuda_device)
    _assert_close(tpm.path_mc(seed, params, **run),
                  tpm._path_mc_plain(seed, params, **run))


@pytest.mark.parametrize("case", ["lsv barrier", "lsv_qe barrier"])
@pytest.mark.parametrize("deg", [12, 5])
@pytest.mark.parametrize("antithetic", [True, False])
def test_path_kernel_lsv_degrees_match_plain(cuda_device, case, deg,
                                             antithetic):
    seed, params, run = _grid_run(case, (1 << 18) + 123, 16, antithetic,
                                  cuda_device, deg=deg)
    assert tuple(run["svi"].shape) == (16, deg + 1)
    _assert_close(tpm.path_mc(seed, params, **run),
                  tpm._path_mc_plain(seed, params, **run))


def test_path_kernel_per_path_grid_is_deterministic(cuda_device):
    seed, params, run = _grid_run("lsv_qe barrier", 1_000_000, 16, True,
                                  cuda_device)
    assert torch.equal(tpm.path_mc(seed, params, **run).clone(),
                       tpm.path_mc(seed, params, **run).clone())


def test_path_kernel_occupancy_query(cuda_device):
    for dynamics in ("gbm", "heston", "heston_qe", "sabr_cev", "lsv",
                     "lsv_qe", "lv_milstein"):
        per_sm = tpm.blocks_per_sm(dynamics, tpm.PAYOFF_IDS["barrier"],
                                   False, True)
        assert 1 <= per_sm <= 16


def test_basket_kernel_occupancy_query(cuda_device):
    # each instantiation gets at least the blocks it is compiled for
    import re
    from pathlib import Path

    src = (Path(tbk.__file__).resolve().parent.parent / "csrc"
           / "basket_mc.cu").read_text()
    budget = [int(v) for v in re.search(
        r"MIN_BLOCKS\[MAX_ASSETS \+ 1\] = \{([^}]*)\}", src)[1].split(",")]
    for a in range(1, tbk.MAX_ASSETS + 1):
        for payoff_id in tbk.PAYOFF_IDS.values():
            for antithetic in (True, False):
                per_sm = tbk.blocks_per_sm(a, payoff_id, antithetic)
                assert budget[a] <= per_sm <= 16, (a, payoff_id, antithetic)


_SINCOS_CHECK = r"""
#include <cstdint>
#include <cstdio>
// every Box-Muller angle of the path kernel, 2*pi * (i * 2^-24)
__device__ float angle(unsigned i) {
  return 6.283185307179586f * (static_cast<float>(i) * 5.9604645e-8f);
}
__global__ void separate(float *s, float *c) {
  const unsigned i = blockIdx.x * blockDim.x + threadIdx.x;
  c[i] = cosf(angle(i));
  s[i] = sinf(angle(i));
}
__global__ void together(float *s, float *c) {
  const unsigned i = blockIdx.x * blockDim.x + threadIdx.x;
  sincosf(angle(i), s + i, c + i);
}
int main() {
  const size_t n = 1u << 24;
  float *d;
  cudaMalloc(&d, 4 * n * sizeof(float));
  separate<<<n / 256, 256>>>(d, d + n);
  together<<<n / 256, 256>>>(d + 2 * n, d + 3 * n);
  uint32_t *h = new uint32_t[4 * n];
  cudaMemcpy(h, d, 4 * n * sizeof(float), cudaMemcpyDeviceToHost);
  size_t differ = 0;
  for (size_t i = 0; i < 2 * n; ++i) differ += h[i] != h[2 * n + i];
  printf("%zu %s\n", differ, cudaGetErrorString(cudaGetLastError()));
  return 0;
}
"""


def test_sincosf_is_cosf_and_sinf_on_every_box_muller_angle(cuda_device,
                                                            tmp_path):
    # the path kernel's per-path branches draw their Box-Muller pair with
    # one sincosf where the plain version (and the Dupire kernel) take cos
    # and sin: built as path_mc.cu is (no FMA contraction), it must return
    # their bits on all 2^24 angles 2*pi*u2
    import subprocess

    from optpricer_tpu_torch import _build

    src, exe = tmp_path / "sincos.cu", tmp_path / "sincos"
    src.write_text(_SINCOS_CHECK)
    subprocess.run([_build.find_nvcc(), "-gencode",
                    "arch=compute_90a,code=sm_90a", "-O3", "-fmad=false",
                    "-o", str(exe), str(src)], check=True, timeout=600)
    out = subprocess.run([str(exe)], capture_output=True, text=True,
                         check=True, timeout=600).stdout.split()
    assert out == ["0", "no", "error"], out


# ---------------------------------------------------------------------------
# the closed-form slice: every public function on the card equal to the
# same call on the CPU (float64), at the tolerances of its CPU parity test
# ---------------------------------------------------------------------------
def _both(fn, cuda_device):
    out = fn(cuda_device), fn("cpu")
    return [np.asarray(o.cpu() if isinstance(o, torch.Tensor) else o,
                       np.float64) for o in out]


_HESTON = dict(v0=0.045, kappa=1.8, theta=0.05, xi=0.45, rho=-0.55)
_KS = np.linspace(60.0, 140.0, 33)
_CLOSED = {
    "merton": lambda d: tp.merton_price(100.0, _KS, 0.75, 0.04, 0.01,
                                        sigma=0.22, lam=0.6, mJ=-0.07,
                                        sJ=0.13, device=d),
    "sabr": lambda d: tp.sabr_price_hagan(100.0, _KS, 0.75, 0.04, 0.01,
                                          alpha=0.22, beta=0.7, nu=0.5,
                                          rho=-0.4, kind="put", device=d),
    "barrier": lambda d: tp.barrier_price_bs(100.0, _KS, 1.0, 0.03, 0.01,
                                             sigma=0.25, barrier=80.0,
                                             barrier_type="down-and-out",
                                             rebate=1.5, device=d),
    "lookback": lambda d: tp.lookback_price_bs(100.0, 1.0, 0.03, 0.01,
                                               sigma=0.25, kind="put",
                                               strike_type="fixed", K=_KS,
                                               device=d),
    "double barrier": lambda d: tp.double_barrier_price_bs(
        100.0, _KS, 1.0, 0.03, 0.01, sigma=0.25, lower=70.0, upper=140.0,
        knock="in", device=d),
    "quanto": lambda d: tp.quanto_price(100.0, _KS, 1.0, 0.03, 0.01,
                                        sigma_S=0.2, sigma_fx=0.1,
                                        rho_sfx=-0.3, device=d),
    "chooser": lambda d: tp.chooser_price(100.0, _KS, 1.0, 0.03, 0.01,
                                          sigma=0.2, t_choose=0.4, device=d),
    "compound": lambda d: tp.compound_price(100.0, 8.0, 100.0, 0.5, 1.5,
                                            0.03, 0.01, sigma=0.25,
                                            underlying="put", device=d),
    "bs2002": lambda d: tp.bjerksund_stensland_price(
        100.0, _KS, 1.0, 0.05, 0.02, sigma=0.3, kind="put", device=d),
    "baw": lambda d: tp.baw_price(100.0, _KS, 1.0, 0.05, 0.08, sigma=0.3,
                                  device=d),
    "rgw": lambda d: tp.rgw_price(100.0, _KS, 1.0, 0.05, sigma=0.3, D=4.0,
                                  t_div=0.5, device=d),
}


@pytest.mark.parametrize("name", list(_CLOSED))
def test_closed_forms_on_card_match_cpu(cuda_device, name):
    got, want = _both(_CLOSED[name], cuda_device)
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-13)


def test_cev_and_gammainc_on_card_match_cpu(cuda_device):
    from optpricer_tpu_torch.models import analytic as ta

    got, want = _both(lambda d: tp.cev_price(100.0, _KS, 1.0, 0.03, 0.01,
                                             sigma=0.5, beta=0.8, device=d),
                      cuda_device)
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-10)
    a = torch.tensor(np.geomspace(0.5, 2100.0, 40), dtype=torch.float64)
    x = torch.tensor(np.geomspace(1e-3, 4000.0, 50), dtype=torch.float64)
    p = lambda d: ta._gammainc(a[:, None].to(d), x[None, :].to(d), 430)
    # the log prefactor a·ln x − x − lnΓ(a) reaches ~1e4 at a ≈ 2 000:
    # an ulp of it in the card's or the host's log/lgamma moves P by ~1e-13
    np.testing.assert_allclose(p(cuda_device).cpu().numpy(), p("cpu").numpy(),
                               rtol=0.0, atol=1e-12)


_COS = {
    "heston": lambda d: tp.heston_price_cos(100.0, _KS, 0.75, 0.04, 0.01,
                                            **_HESTON, device=d),
    "bates": lambda d: tp.bates_price_cos(100.0, _KS, 0.75, 0.04, 0.01,
                                          **_HESTON, lam=0.3, mJ=-0.1,
                                          sJ=0.15, kind="put", device=d),
    "vg": lambda d: tp.vg_price_cos(100.0, _KS, 0.5, 0.03, 0.01, sigma=0.2,
                                    theta=-0.14, nu=0.2, device=d),
    "nig": lambda d: tp.nig_price_cos(100.0, _KS, 0.5, 0.03, 0.01,
                                      alpha=8.0, beta=-4.0, delta=0.4,
                                      kind="put", device=d),
    "cgmy": lambda d: tp.cgmy_price_cos(100.0, _KS, 0.5, 0.03, 0.01, C=0.5,
                                        G=5.0, M=9.0, Y=1.5, device=d),
}


@pytest.mark.parametrize("name", list(_COS))
def test_cos_pricers_on_card_match_cpu(cuda_device, name):
    got, want = _both(_COS[name], cuda_device)
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-12)


def test_trig_kpi_float32_on_card(cuda_device):
    from optpricer_tpu_torch.models import analytic as ta

    k = torch.arange(4096, dtype=torch.float32)[None, :]
    frac = torch.rand(64, 1, generator=torch.Generator().manual_seed(3))
    assert torch.equal(ta._kpi_fixed(k.to(cuda_device),
                                     frac.to(cuda_device)).cpu(),
                       ta._kpi_fixed(k, frac))
    ulp = float(np.spacing(np.float32(1.0)))
    for a, b in zip(ta._trig_kpi(k.to(cuda_device), frac.to(cuda_device),
                                 torch.float32),
                    ta._trig_kpi(k, frac, torch.float32)):
        assert float((a.cpu() - b).abs().max()) <= 2 * ulp


def test_heston_greeks_and_fits_on_card_match_cpu(cuda_device):
    g = tp.heston_greeks_cos(100.0, 105.0, 0.75, 0.04, 0.01, **_HESTON,
                             device=cuda_device)
    ref = tp.heston_greeks_cos(100.0, 105.0, 0.75, 0.04, 0.01, **_HESTON,
                               device="cpu")
    for name, value in ref.items():
        assert g[name] == pytest.approx(value, rel=1e-9), name
    Ts = np.repeat([0.25, 1.0], 7)
    Ks = np.tile(np.linspace(85.0, 115.0, 7), 2)
    px = tp.heston_price_cos(100.0, torch.tensor(Ks), torch.tensor(Ts), 0.04,
                             0.01, **_HESTON, N=128, device="cpu")
    iv = tp.bs_implied_vol_vec(100.0, Ks, Ts, 0.04, 0.01, px, "call",
                               device="cpu").numpy()
    fits = [tp.fit_heston(Ks, Ts, iv, 100.0, 0.04, 0.01, device=d)
            for d in (cuda_device, "cpu")]
    for name in ("v0", "kappa", "theta", "xi", "rho"):
        assert abs(fits[0][name] - fits[1][name]) < 1e-8, name
    vg = [tp.fit_vg(Ks[:7], Ts[:7], iv[:7], 100.0, 0.04, 0.01, device=d)
          for d in (cuda_device, "cpu")]
    for name in ("sigma", "theta", "nu"):
        assert abs(vg[0][name] - vg[1][name]) < 1e-8, name


@pytest.mark.parametrize("engine", ["crr", "bs2002"])
def test_american_implied_vol_on_card_matches_cpu(cuda_device, engine):
    K = np.linspace(70.0, 140.0, 40)
    px = tp.crr_vec(100.0, K, 1.0, 0.03, 0.0, 0.2, "put", N=100,
                    american=True, device="cpu").numpy()
    got, want = (tp.american_implied_vol(px, 100.0, K, 1.0, 0.03, 0.0,
                                         "put", N=100, engine=engine,
                                         device=d)
                 for d in (cuda_device, "cpu"))
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got, want, rtol=0.0, atol=1e-10)


def test_levy_cores_and_samplers_on_card(cuda_device):
    from optpricer_tpu_torch.models import levy as tl

    gen = torch.Generator().manual_seed(9)
    g = tl._standard_gamma(gen, 0.05, (16, 500), torch.float64, "cpu") * 0.2
    Z = torch.randn(16, 500, generator=gen, dtype=torch.float64)
    U = torch.rand(16, 500, generator=gen, dtype=torch.float64)
    par = [torch.tensor(v, dtype=torch.float64)
           for v in (100.0, 0.8, 0.03, 0.01, 0.2, -0.14, 0.2)]
    on = lambda ts: [t.to(cuda_device) for t in ts]
    vg = [tl._vg_core(*ts[:2], *ts[2:], antithetic=True).cpu()
          for ts in (on([g, Z] + par), [g, Z] + par)]
    torch.testing.assert_close(vg[0], vg[1], rtol=1e-12, atol=0.0)
    nig = [torch.tensor(v, dtype=torch.float64) for v in (8.0, -4.0, 0.4)]
    mu, lam = tl._nig_clock(par[1], *nig, 16)
    I = [tl._ig_core(*ts) for ts in (on([Z, U, mu, lam]), [Z, U, mu, lam])]
    torch.testing.assert_close(I[0].cpu(), I[1], rtol=1e-12, atol=0.0)
    paths = [tl._nig_core(*ts[:2], *ts[2:], antithetic=False).cpu()
             for ts in (on([I[1], Z] + par[:4] + nig),
                        [I[1], Z] + par[:4] + nig)]
    torch.testing.assert_close(paths[0], paths[1], rtol=1e-12, atol=0.0)
    draws = tl._standard_gamma(torch.Generator(cuda_device).manual_seed(4),
                               0.3, (400_000,), torch.float64, cuda_device)
    assert abs(float(draws.mean()) - 0.3) < 5 * (0.3 / 400_000) ** 0.5
    P = tp.vg_paths(100.0, 1.0, 0.03, 0.0, sigma=0.2, theta=-0.14, nu=0.2,
                    n_steps=32, n_paths=100_000, seed=5, device=cuda_device)
    assert P.device == torch.device(cuda_device) and P.shape == (33, 200_000)
    ST = P[-1].cpu().numpy()
    pay = np.exp(-0.03) * 0.5 * (np.maximum(ST[:100_000] - 100.0, 0.0)
                                 + np.maximum(ST[100_000:] - 100.0, 0.0))
    cos = float(tp.vg_price_cos(100.0, 100.0, 1.0, 0.03, 0.0, sigma=0.2,
                                theta=-0.14, nu=0.2, device=cuda_device))
    assert abs(pay.mean() - cos) < 4 * pay.std() / 100_000 ** 0.5 + 1e-3


def test_validation_on_card_matches_cpu(cuda_device):
    opt = OptionSpec(S0=100.0, K=105.0, T=0.75, r=0.04, sigma=0.22, q=0.01)
    small = dict(methods=["bs", "tree", "fdm", "fem"], tree_N=200,
                 fd_N_S=120, fd_N_t=120, fem_N_S=120, fem_N_t=120)
    got, want = (tp.cross_validate(opt, "put", **small, device=d)
                 for d in (cuda_device, "cpu"))
    for name in ("bs", "tree", "fdm", "fem"):
        assert got[name] == pytest.approx(want[name], rel=1e-9), name
    cube = [tp.stress_test(opt, "call", [0.9, 1.0, 1.1], [-0.05, 0.0],
                           [0.0, 0.01], device=d)
            for d in (cuda_device, "cpu")]
    np.testing.assert_allclose(cube[0], cube[1], rtol=1e-12, atol=1e-13)
    paths = tp.gbm_paths(100.0, 0.04, 0.01, 0.22, 0.75, 21, 2_000, seed=3,
                         device="cpu")
    res = [tp.backtest_delta_hedge(opt, "call", paths, 3, device=d)
           for d in (cuda_device, "cpu")]
    np.testing.assert_allclose(res[0]["pnl"], res[1]["pnl"], rtol=0.0,
                               atol=1e-10)


def test_profiling_on_card(cuda_device, tmp_path):
    from optpricer_tpu_torch.utils import profiling

    with profiling.trace(str(tmp_path)):
        tp.euro_price_mc(OptionSpec(S0=100.0, K=100.0, T=1.0, r=0.03,
                                    sigma=0.2), "call", n_paths=1 << 20,
                         seed=1, device=cuda_device)
    assert "terminal_mc_kernel" in (tmp_path / "trace.json").read_text()
    mem = profiling.device_memory()
    assert len(mem) == torch.cuda.device_count()
    assert mem[0]["bytes_limit"] > 0 and mem[0]["bytes_in_use"] >= 0


# ---------------------------------------------------------------------------
# the mesh slice: the sharded kernel entries on a repeated-card mesh, and
# the scan engine's deterministic cores on the card against the CPU
# ---------------------------------------------------------------------------
def _shard_runs(entry, mesh):
    """[(kernel stats, plain stats)] of each shard of ``entry``'s grid on
    ``mesh``, and the entry's own result."""
    from optpricer_tpu_torch.ops.terminal_mc import _seed_pair, _shard_plan

    chol = np.linalg.cholesky(0.4 * np.eye(3) + 0.6)
    if entry == "terminal":
        n = 3 * 2 * tmc.TILE * 4 + 555
        reps, per, shards = _shard_plan(mesh, n, 2 * tmc.TILE)
        host = tmc._terminal_params(n, *MARKET, True)
        runs = [(lambda s, p: tmc.terminal_mc(s, p, n_programs=per,
                                              reps=reps, antithetic=True),
                 lambda s, p: tmc._mc_sumstats_plain(
                     s, p, n_programs=per, reps=reps, antithetic=True),
                 off, host) for _, off in shards]
        out = tmc.mc_sumstats_kernel_sharded(mesh, 7, n, *MARKET, True,
                                             antithetic=True)
    elif entry == "path":
        n = 5 * tpm.TILE + 77
        params, static = tpm._resolve_config(
            n, 8, *MARKET[:5], MARKET[5], True, "asian", True, 0.0,
            "up-and-out", 0.0, "arithmetic", "fixed", 1.0, None,
            "log_euler", 0.01, None, None, False, None)
        static.pop("svi")
        reps, per, shards = _shard_plan(mesh, n, tpm.TILE)
        kw = dict(n_programs=per, reps=reps, with_greeks=True, **static)
        runs = [(lambda s, p: tpm.path_mc(s, p, **kw),
                 lambda s, p: tpm._path_mc_plain(s, p, **kw), off, params)
                for _, off in shards]
        out = tpm.path_mc_sumstats_kernel_sharded(
            mesh, 7, n, 8, *MARKET, True, payoff="asian", antithetic=True,
            greek_stats=True)
    else:
        n = 5 * tbk.TILE + 77
        args = (n, 8, [100.0, 95.0, 105.0], [0.4, 0.3, 0.3], 100.0, 1.0,
                0.03, [0.0, 0.01, 0.02], [0.2, 0.3, 0.25], chol, True,
                "worstof_barrier", 85.0, "down-and-in", 1.0)
        params, static = tbk._entry_config(*args)
        reps, per, shards = _shard_plan(mesh, n, tbk.TILE)
        kw = dict(n_programs=per, reps=reps, antithetic=True, **static)
        runs = [(lambda s, p: tbk.basket_mc(s, p, host_params=params, **kw),
                 lambda s, p: tbk._basket_mc_plain(s, p, **kw), off, params)
                for _, off in shards]
        out = tbk.basket_path_sumstats_kernel_sharded(
            mesh, 7, *args[:11], payoff="worstof_barrier", antithetic=True,
            barrier=85.0, barrier_type="down-and-in", rebate=1.0)
    dev = mesh.device_list[0]
    pairs = []
    for kernel, plain, off, host in runs:
        seed, on_card = _seed_pair(7, dev, off), host.to(dev)
        pairs.append((kernel(seed, on_card), plain(seed, on_card)))
    return pairs, out


@pytest.mark.parametrize("entry", ["terminal", "path", "basket"])
@pytest.mark.parametrize("n_dev", [2, 4])
def test_sharded_entries_on_card_match_plain(cuda_device, entry, n_dev):
    """Each shard's kernel stats meet its plain version at 2e-5, and the
    entry's result is the shards' kernel stats added in mesh order, bit
    for bit."""
    from optpricer_tpu_torch.parallel import get_mesh

    mesh = get_mesh(devices=[str(cuda_device)] * n_dev)
    pairs, out = _shard_runs(entry, mesh)
    for kernel, plain in pairs:
        _assert_close(kernel, plain,
                      signed=(11, 13, 15, 17, 19) if entry == "path" else ())
    total = pairs[0][0]
    for kernel, _ in pairs[1:]:
        total = total + kernel
    assert torch.equal(out, total)


_SCAN_CORES = {
    "gbm-asian-geo": ("gbm", "asian", dict(sigma=0.2), dict(with_geo=True)),
    "gbm-dividends": ("gbm", "barrier", dict(sigma=0.2, barrier=125.0),
                      dict(dividends=True)),
    "lv_milstein": ("lv_milstein", "vanilla", {}, {}),
    "heston": ("heston", "vanilla",
               dict(heston=dict(v0=0.04, kappa=1.5, theta=0.05, xi=0.6,
                                rho=-0.7)), {}),
    "heston_qe": ("heston_qe", "lookback",
                  dict(heston=dict(v0=0.04, kappa=1.5, theta=0.05, xi=0.6,
                                   rho=-0.7)), {}),
    "sabr_cev": ("sabr_cev", "asian",
                 dict(sabr=dict(alpha0=2.0, beta=0.5, nu=0.4, rho=-0.3)),
                 {}),
    "merton": ("merton", "vanilla",
               dict(sigma=0.2, merton=dict(sigma=0.2, lam=0.8, mJ=-0.1,
                                           sJ=0.15)), {}),
    "vg": ("vg", "vanilla", dict(vg=dict(sigma=0.2, theta=-0.14, nu=0.2)),
           {}),
    "nig": ("nig", "digital",
            dict(nig=dict(alpha=8.0, beta=-4.0, delta=0.4)), {}),
}


def _scan_core_run(case, device, draws_host, n, n_steps):
    from optpricer_tpu_torch.models import mc_fused as tmf

    model_kind, payoff, fk, st = _SCAN_CORES[case]
    st = dict(st)
    fixed = tmf._fixed(torch.float64, device, S0=100.0, K=100.0, T=1.0,
                       r=0.03, q=0.01, **fk)
    if st.pop("dividends", False):
        fixed["div_amts"] = torch.zeros(n_steps + 1, dtype=torch.float64,
                                        device=device)
        fixed["div_amts"][n_steps // 2] = 2.0

    def sig(S, t):
        return 0.15 + 0.05 * torch.exp(-t) \
            + 0.1 * torch.tanh(torch.log(S / 100.0))

    def draws(k):
        return tuple(None if x is None else x.to(device)
                     for x in draws_host[k])

    return tmf._fused_paths(
        draws, fixed, payoff=payoff, kind="call", n_steps=n_steps,
        n_paths=n, antithetic=True, barrier_type="up-and-out",
        average_type="arithmetic", strike_type="fixed",
        model_kind=model_kind, sigma_loc=sig, dtype=torch.float64, **st)


@pytest.mark.parametrize("case", list(_SCAN_CORES))
def test_scan_cores_on_card_match_cpu(cuda_device, case):
    """The scan engine's core on the card, fed host-made draws, meets the
    same core on the CPU at rtol 1e-12 (the sums of its outputs)."""
    from optpricer_tpu_torch.models import mc_fused as tmf

    n, n_steps = 4096, 16
    model_kind = _SCAN_CORES[case][0]
    gen = torch.Generator().manual_seed(3)
    draw = tmf._scan_draws(gen, model_kind, n, T=1.0, n_steps=n_steps,
                           dtype=torch.float64, device="cpu", m_lam=0.8,
                           v_nu=0.2, with_grad=True)
    draws_host = [draw(k) for k in range(n_steps)]
    cpu = _scan_core_run(case, "cpu", draws_host, n, n_steps)
    card = _scan_core_run(case, cuda_device, draws_host, n, n_steps)
    for a, b in zip(card, cpu):
        a, b = a.double().cpu(), b.double()
        torch.testing.assert_close(torch.stack([a.sum(), (a * a).sum()]),
                                   torch.stack([b.sum(), (b * b).sum()]),
                                   rtol=1e-12, atol=0.0)


def test_other_cores_on_card_match_cpu(cuda_device):
    """The chunk scan, the exact CEV scan, the AD Jacobian sums and the
    float64 QMC route: on the card as on the CPU, rtol 1e-12, from the
    same host-made draws (the QMC route is deterministic)."""
    from optpricer_tpu_torch.models import mc_fused as tmf
    from optpricer_tpu_torch.models import monte_carlo as tmcm

    z = torch.randn(5000, generator=torch.Generator().manual_seed(1),
                    dtype=torch.float64)
    chunk = [tmcm.mc_sumstats(1, range(2), 4500, *MARKET, True,
                              chunk_size=2500, antithetic=True,
                              dtype="float64", device=d,
                              normals=lambda c: z[c * 2500:(c + 1) * 2500])
             for d in ("cpu", cuda_device)]
    torch.testing.assert_close(chunk[1].cpu(), chunk[0], rtol=1e-12,
                               atol=0.0)

    class HostCev:
        """Draws made on the host from the state handed over."""

        def __init__(self):
            self.gen = torch.Generator().manual_seed(4)

        def normal(self, k):
            return torch.randn(2000, generator=self.gen,
                               dtype=torch.float64)

        def poisson(self, k, rate):
            return torch.poisson(rate.cpu(), generator=self.gen)

        def gamma(self, k, shape):
            from optpricer_tpu_torch.models.levy import _standard_gamma

            return _standard_gamma(self.gen, shape.cpu(), (2000,),
                                   torch.float64, "cpu")

    class OnDevice:
        def __init__(self, inner, device):
            self.inner, self.device = inner, device

        def __getattr__(self, name):
            fn = getattr(self.inner, name)
            return lambda *a: fn(*a).to(self.device)

    vals = dict(S0=100.0, K=100.0, T=1.0, r=0.03, q=0.01, barrier=130.0,
                payout=1.0, s_beta=0.5, s_alpha0=2.0, s_nu=0.4, s_rho=-0.3)
    cev = []
    for d in ("cpu", cuda_device):
        f = {k: torch.tensor(v, dtype=torch.float64, device=d)
             for k, v in vals.items()}
        cev.append(tmf._cev_exact_sumstats(
            OnDevice(HostCev(), d), f, payoff="vanilla", n_steps=6,
            n_paths=2000, barrier_up=True, knock_in=False,
            dtype=torch.float64, has_vol=True).cpu())
    torch.testing.assert_close(cev[1], cev[0], rtol=1e-12, atol=0.0)

    heston = dict(v0=0.04, kappa=1.5, theta=0.05, xi=0.6, rho=-0.7)
    draw = tmf._scan_draws(torch.Generator().manual_seed(6), "heston", 2048,
                           T=1.0, n_steps=8, dtype=torch.float64,
                           device="cpu")
    draws_host = [draw(k) for k in range(8)]
    static = dict(payoff="vanilla", kind="call", n_steps=8, antithetic=True,
                  barrier_type="up-and-out", average_type="arithmetic",
                  strike_type="fixed", model_kind="heston", sigma_loc=None,
                  dtype=torch.float64)
    names = (("delta", "S0"), ("rho", "r"), ("theta", "T")) \
        + tmf._AD_PARAMS["heston"]
    ad = []
    for d in ("cpu", cuda_device):
        f = tmf._fixed(torch.float64, d, S0=100.0, K=100.0, T=1.0, r=0.03,
                       q=0.01, heston=heston)
        dl = [tuple(x.to(d) for x in step) for step in draws_host]
        ad.append(tmf._ad_local_sums(dl, f, names, 2048, static,
                                     torch.exp).cpu())
    torch.testing.assert_close(ad[1], ad[0], rtol=1e-12, atol=0.0)

    kw = dict(sigma=0.2, n_paths=4096, n_steps=16, seed=7, dtype="float64",
              backend="qmc")
    qmc = [tp.exotic_price_mc("asian", 100.0, 100.0, 1.0, 0.03, 0.01,
                              device=d, **kw) for d in ("cpu", cuda_device)]
    np.testing.assert_allclose(qmc[1], qmc[0], rtol=1e-12, atol=0.0)


# ---------------------------------------------------------------------------
# The American and multilevel Monte-Carlo slice (no kernel of its own)
# ---------------------------------------------------------------------------
def test_american_mlmc_cores_on_card_match_cpu(cuda_device):
    """Every deterministic core of ``american_mc`` and ``mlmc`` (the LSMC
    passes, the ladder, the basket, the three duals fed the same draws,
    the sharded regression, ``_level_y`` and the level stats with their
    Greek tangents) on the card equals the same core on the CPU on the
    same host-made inputs, float64, within 1e-12 of each output's scale:
    ``chip_smoke.american_mlmc_cores`` and ``compare_cores``, the runs
    ``chip_smoke.py`` phase 5 makes."""
    import chip_smoke

    chip_smoke.compare_cores(chip_smoke.american_mlmc_cores(cuda_device),
                             chip_smoke.american_mlmc_cores("cpu"))


def test_lsmc_float32_betas_ignore_tf32_on_card(cuda_device):
    """The regression's float32 products run at full precision whatever the
    process-wide TF32 setting: the card's betas are the same bit for bit
    with it on or off, and as close to the float64 betas as the CPU's."""
    from optpricer_tpu_torch.models import american_mc as tam

    paths = tp.gbm_paths(100.0, 0.05, 0.0, 0.25, 1.0, 32, 50_000, seed=8,
                         dtype="float64", device="cpu")

    def betas(device, dtype):
        s = [torch.tensor(x, dtype=dtype).to(device)
             for x in (110.0, 0.05, 1 / 32)]
        return tam._lsmc_backward_betas(paths.to(device, dtype), *s, False,
                                        basis_dim=4).double().cpu()

    truth = betas("cpu", torch.float64)
    off = betas(cuda_device, torch.float32)
    previous = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        on = betas(cuda_device, torch.float32)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = previous
    assert torch.equal(on, off)
    err = lambda b: float(((b - truth).abs().amax(1)  # noqa: E731
                           / truth.abs().amax(1)).max())
    assert err(off) <= 4 * err(betas("cpu", torch.float32)) + 1e-6


def test_lsmc_passes_make_no_host_sync(cuda_device):
    """The backward and forward passes enqueue every date with no host
    sync (``torch.linalg.solve_ex``): they run under the CUDA sync debug
    mode set to raise."""
    from optpricer_tpu_torch.models import american_mc as tam

    S, v = tp.heston_paths(100.0, 0.05, 0.0, 0.04, 1.5, 0.04, 0.5, -0.6,
                           1.0, 16, 8192, seed=2, return_variance=True,
                           dtype="float64", scheme="qe", device=cuda_device)
    s = [torch.full((), x, dtype=torch.float64, device=cuda_device)
         for x in (110.0, 0.05, 1 / 16)]
    Ks = torch.linspace(80.0, 120.0, 8, dtype=torch.float64,
                        device=cuda_device)
    kinds = torch.zeros(8, dtype=torch.bool, device=cuda_device)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        b = tam._lsmc_backward_betas(S, *s, False, basis_dim=4)
        tam._lsmc_backward(S, *s, False, basis_dim=4)
        tam._lsmc_forward_fixed_policy(S, b, *s, False, basis_dim=4)
        tam._lsmc_backward_sv(S, v, *s, False, basis_dim=6)
        tam._lsmc_backward_batch(S, Ks, s[1], s[2], kinds, basis_dim=4)
    finally:
        torch.cuda.set_sync_debug_mode("default")


def test_traced_cv_estimator_makes_no_host_sync(cuda_device):
    """``ops.stats.sumstats`` and ``cv_mean_se`` (A.17) stay on the card:
    they run under the CUDA sync debug mode set to raise, with and without
    a weight and at a constant control, EY a float and a card tensor; the
    results equal the same calls on the CPU to rtol 1e-12."""
    from optpricer_tpu_torch.ops import stats as ts

    g = torch.Generator().manual_seed(0)
    X = torch.randn(1 << 16, generator=g, dtype=torch.float64)
    Y = 1.0 + 0.3 * X + 0.1 * torch.randn(1 << 16, generator=g,
                                          dtype=torch.float64)
    w = (torch.arange(1 << 16) < 60_000).double()
    cases = [(X, Y, None), (X, Y, w), (X, torch.full_like(Y, 1.25), w)]
    on_card = [tuple(t.to(cuda_device) if t is not None else None
                     for t in case) for case in cases]
    ey = torch.tensor(1.0, dtype=torch.float64, device=cuda_device)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = []
        for x, y, wt in on_card:
            s = ts.sumstats(x, y, wt)
            got.append((s, *ts.cv_mean_se(s, 1.0), *ts.cv_mean_se(s, ey)))
    finally:
        torch.cuda.set_sync_debug_mode("default")
    for (x, y, wt), card in zip(cases, got):
        s = ts.sumstats(x, y, wt)
        want = (s, *ts.cv_mean_se(s, 1.0), *ts.cv_mean_se(s, 1.0))
        for a, b in zip(card, want):
            assert a.device.type == "cuda"
            torch.testing.assert_close(a.cpu(), b, rtol=1e-12, atol=0.0)


# ---------------------------------------------------------------------------
# The LSMC ladder's date loop (csrc/lsmc.cu) against its plain torch pass
# ---------------------------------------------------------------------------
def _lsmc_case(device, B, n_half, n_steps, seed=5):
    """A float32 ladder on the card: antithetic GBM paths, B strikes over
    70-130, every third a call."""
    paths = tp.gbm_paths(100.0, 0.03, 0.0, 0.2, 1.0, n_steps, n_half,
                         antithetic=True, seed=seed, dtype="float32",
                         device=device)
    Ks = torch.linspace(70.0, 130.0, B, dtype=torch.float32, device=device)
    calls = torch.arange(B, device=device) % 3 == 0
    r = torch.full((), 0.03, dtype=torch.float32, device=device)
    dt = torch.full((), 1.0 / n_steps, dtype=torch.float32, device=device)
    return paths, Ks, calls, r, dt


def _lsmc_state(paths, r, dt, B, calls):
    """(sign, disc, buffers) of the date loop for B strikes."""
    from optpricer_tpu_torch.ops import lsmc

    sign = torch.where(calls, 1.0, -1.0).to(torch.float32)
    return sign, torch.exp(-r * dt).reshape(1), lsmc.lsmc_buffers(paths, B)


def test_lsmc_date_pass_sums_and_exercise_against_float64(cuda_device):
    """One date pass (t = 5 of 12; 100 strikes and 2·(2^14 + 37) paths, no
    multiple of the kernel's tiles) on a given stopping date and β_{t+1}:
    the exercise is the plain version's strict rule computed in float64 on
    the same float32 inputs, equal but for near-ties of the intrinsic and
    the fit; the partial rows sum to the float64 normal equations of the
    same state (the in-the-money count exactly, the rest within 2e-5 of
    the sum of absolute terms); β_t solves them as a float64 solve does."""
    from optpricer_tpu_torch.ops import lsmc

    B, t = 100, 5
    paths, Ks, calls, r, dt = _lsmc_case(cuda_device, B, 2**14 + 37, 12)
    n_steps, n = paths.shape[0] - 1, paths.shape[1]
    sign, disc, buf = _lsmc_state(paths, r, dt, B, calls)
    S = paths.double().cpu()
    K, sg = Ks.double().cpu()[:, None], sign.double().cpu()[:, None]
    s_ref = S[0, 0]
    gen = torch.Generator().manual_seed(3)
    tau0 = torch.randint(t + 2, n_steps + 1, (B, n), generator=gen)
    # β_{t+1}: each strike's cubic least-squares fit of its intrinsic at
    # t+1, so that fit and intrinsic cross on many paths
    x1 = S[t + 1] / s_ref - 1.0
    X1 = torch.stack([x1 ** m for m in range(4)], dim=-1)
    e1 = torch.clamp(sg * (S[t + 1] - K), min=0.0)
    beta1 = torch.linalg.lstsq(X1, e1.T).solution.T.float()
    buf["tau"].copy_(pack_tau(tau0.to(torch.uint8).to(cuda_device), n_steps))
    buf["betas"][t + 1] = beta1.to(cuda_device)
    lsmc.lsmc_date(paths, Ks, sign, disc, t, **buf)
    tau1 = unpack_tau(buf["tau"], B, n).long().cpu()

    fit = (X1 @ beta1.double().T).T
    want_tau = torch.where((e1 > 0.0) & (e1 > fit), t + 1, tau0)
    tie = (e1 - fit).abs() <= 1e-5 * (1.0 + e1.abs())
    assert torch.equal(tau1[~tie], want_tau[~tie])
    assert int((tau1 == t + 1).sum()) > 0 and int((tau1 > t + 1).sum()) > 0

    d = float(disc.double())
    y = (torch.clamp(sg * (S.T.gather(1, tau1.T).T - K), min=0.0)
         * d ** (tau1 - t).double())
    w = (torch.clamp(sg * (S[t] - K), min=0.0) > 0.0).double()
    x = S[t] / s_ref - 1.0
    terms = [w * x ** m for m in range(7)] + [w * y * x ** m
                                               for m in range(4)]
    want = torch.stack([a.sum(1) for a in terms])           # (11, B)
    scale = torch.stack([a.abs().sum(1) for a in terms])
    got = buf["part"].double().sum(0).cpu()
    assert torch.equal(got[0], want[0])
    assert bool(((got - want).abs() <= 2e-5 * scale + 1e-12).all())

    inv = 1.0 / torch.clamp(got[0], min=1.0)
    A = torch.stack([torch.stack([got[i + j] * inv for j in range(4)], -1)
                     for i in range(4)], -2)
    A = A + 1e-7 * torch.eye(4, dtype=torch.float64)
    b = (got[7:11] * inv).T
    beta_t = torch.linalg.solve(A, b[..., None])[..., 0]
    err = (buf["betas"][t].double().cpu() - beta_t).abs()
    assert bool((err <= 1e-5 * beta_t.abs().amax(1, keepdim=True)
                 + 1e-12).all())


def test_lsmc_final_pass_moments_price_and_se_against_float64(cuda_device):
    """The last date pass (t = 0 of 12; 100 strikes, calls and puts mixed,
    2·(2^14 + 37) paths) on a given stopping date and β_1: its two moment
    rows sum to the float64 sums Σv and Σ(v − c)² of the same state, v =
    max(sign (S_τ − K), 0)·disc^τ after date 1's exercise by the plain
    version's strict rule, c the strike's intrinsic at t = 0, within 2e-5
    of the sums of absolute terms (a path whose intrinsic and fit tie at
    date 1 may go either way, and adds its two values' gap). β_1 is a
    constant a strike, the median of its positive intrinsic values at date
    1, so that the exercise splits its in-the-money paths: at date 1 a
    cubic fit's coefficients reach ~10^3 (x = S_1/S_0 − 1 is small), and
    its float32 sum then strays from float64 by more than a tie's width.
    Each price is max(Σv/n, c) and each standard error √((Σ(v − c)² −
    n(Σv/n − c)²) / (n − 1) / n), computed in float64 from the kernel's own
    rows, to float32 round-off."""
    from optpricer_tpu_torch.ops import lsmc

    B = 100
    paths, Ks, calls, r, dt = _lsmc_case(cuda_device, B, 2**14 + 37, 12)
    n_steps, n = paths.shape[0] - 1, paths.shape[1]
    sign, disc, buf = _lsmc_state(paths, r, dt, B, calls)
    S = paths.double().cpu()
    K, sg = Ks.double().cpu()[:, None], sign.double().cpu()[:, None]
    gen = torch.Generator().manual_seed(4)
    tau0 = torch.randint(2, n_steps + 1, (B, n), generator=gen)
    e1 = torch.clamp(sg * (S[1] - K), min=0.0)
    beta1 = torch.zeros((B, 4), dtype=torch.float32)
    for b in range(B):
        if bool((e1[b] > 0.0).any()):
            beta1[b, 0] = float(e1[b][e1[b] > 0.0].median())
    buf["tau"].copy_(pack_tau(tau0.to(torch.uint8).to(cuda_device), n_steps))
    buf["betas"][1] = beta1.to(cuda_device)
    before = lsmc.lsmc_date.launches
    lsmc.lsmc_date(paths, Ks, sign, disc, 0, **buf)
    assert lsmc.lsmc_date.launches - before == 2

    d = float(disc.double())
    hold = (torch.clamp(sg * (S.T.gather(1, tau0.T).T - K), min=0.0)
            * d ** tau0.double())
    stop = e1 * d
    fit = beta1[:, :1].double()
    ex = (e1 > 0.0) & (e1 > fit)
    tie = ((e1 > 0.0)
           & ((e1 - fit).abs() <= 1e-5 * (1.0 + e1.abs()))).double()
    assert int(ex.sum()) > 0 and int((~ex).sum()) > 0
    v, other = torch.where(ex, stop, hold), torch.where(ex, hold, stop)
    # c as the kernel forms it: sign·(S_0 − K) rounded once in float32
    c = torch.clamp(sign * (paths[0, 0] - Ks), min=0.0).double().cpu()
    want = torch.stack([v.sum(1), ((v - c[:, None]) ** 2).sum(1)])
    scale = torch.stack([v.sum(1), want[1]])
    gap = torch.stack([((other - v).abs() * tie).sum(1),
                       (((other - c[:, None]) ** 2 - (v - c[:, None]) ** 2)
                        .abs() * tie).sum(1)])
    n_pb = buf["part"].shape[0]
    got = buf["part"].reshape(-1)[:n_pb * 2 * B].view(n_pb, 2, B)
    got = got.double().sum(0).cpu()
    assert bool(((got - want).abs() <= 2e-5 * scale + gap + 1e-12).all())

    mean = got[0] / n
    var = torch.clamp((got[1] - n * (mean - c) ** 2) / (n - 1), min=0.0)
    out = buf["out"].double().cpu()
    torch.testing.assert_close(out[0], torch.maximum(mean, c), rtol=2e-7,
                               atol=1e-12)
    torch.testing.assert_close(out[1], torch.sqrt(var / n), rtol=2e-7,
                               atol=1e-12)
    assert float(out[1].max()) > 0.0


@pytest.mark.parametrize("B, n_half", [(128, 2**15), (100, 2**15 + 37)])
def test_lsmc_ladder_kernel_within_half_an_se_of_plain(cuda_device, B,
                                                       n_half):
    """The float32 ladder on the card (50 dates, calls and puts mixed) goes
    through the date loop, two launches a date, and its prices lie within
    0.5 standard errors of the plain torch pass's in float64 on the same
    paths, its standard errors within 2%. A price is a discontinuous
    function of the fitted policy: the plain pass in float32 itself lies up
    to 0.55 se from the float64 one at these sizes (0.14-0.55 over 12
    cases; the kernel 0.15-0.42)."""
    from optpricer_tpu_torch.models import american_mc as tam
    from optpricer_tpu_torch.ops import lsmc

    paths, Ks, calls, r, dt = _lsmc_case(cuda_device, B, n_half, 50)
    before = lsmc.lsmc_date.launches
    got, got_se = tam._lsmc_backward_batch(paths, Ks, r, dt, calls,
                                           basis_dim=4, return_stderr=True)
    assert lsmc.lsmc_date.launches - before == 2 * 50
    assert got.dtype == got_se.dtype == torch.float32
    want, se = tam._lsmc_backward_batch_plain(
        paths.double(), Ks.double(), r.double(), dt.double(), calls,
        basis_dim=4, return_stderr=True)
    assert float(se.min()) > 0.0
    z = float(((got.double() - want).abs() / se).max())
    assert z <= 0.5, z
    assert float((got_se.double() / se - 1.0).abs().max()) <= 0.02


def test_lsmc_strike_never_in_the_money_has_no_fit_and_no_exercise(
        cuda_device):
    """A put struck at 1 and a call struck at 10 000 among the ladder's
    strikes: no path is in the money, so every β of theirs is 0, no path
    stops before maturity, and price and standard error are 0, as in the
    plain pass; the other strikes are priced as without them."""
    from optpricer_tpu_torch.ops import lsmc

    paths, Ks, calls, r, dt = _lsmc_case(cuda_device, 40, 2**12 + 5, 16)
    Ks[7], calls[7] = 1.0, False
    Ks[9], calls[9] = 1.0e4, True
    B, n_steps, n = 40, 16, paths.shape[1]
    sign, disc, buf = _lsmc_state(paths, r, dt, B, calls)
    for t in range(n_steps - 1, -1, -1):
        lsmc.lsmc_date(paths, Ks, sign, disc, t, **buf)
    idle = [7, 9]
    assert bool((buf["betas"][1:n_steps, idle] == 0.0).all())
    assert bool((unpack_tau(buf["tau"], B, n)[idle] == n_steps).all())
    assert bool((buf["out"][:, idle] == 0.0).all())
    rest = [i for i in range(B) if i not in idle]
    sub, _, sub_buf = _lsmc_state(paths, r, dt, len(rest), calls[rest])
    for t in range(n_steps - 1, -1, -1):
        lsmc.lsmc_date(paths, Ks[rest].contiguous(), sub, disc, t, **sub_buf)
    # up to 256 strikes the paths split alike, so each strike's sums are
    # the same bits
    assert sub_buf["part"].shape[0] == buf["part"].shape[0]
    assert torch.equal(sub_buf["out"], buf["out"][:, rest])


def test_lsmc_ladder_seed_repeats_bit_for_bit_with_no_host_sync(cuda_device):
    """The float32 ladder twice on one seed gives the same bits (no
    atomics); its date loop runs under the CUDA sync debug mode set to
    raise."""
    from optpricer_tpu_torch.models import american_mc as tam

    Ks = np.linspace(70.0, 130.0, 96)
    kw = dict(n_paths=2**14, n_steps=50, seed=2**31 + 77, dtype="float32",
              device=cuda_device)
    first = tam.lsmc_ladder(99.0, Ks, 1.0, 0.03, 0.0, 0.2, "put", **kw)
    again = tam.lsmc_ladder(99.0, Ks, 1.0, 0.03, 0.0, 0.2, "put", **kw)
    for a, b in zip(first, again):
        np.testing.assert_array_equal(a, b)
    paths, Kt, calls, r, dt = _lsmc_case(cuda_device, 96, 2**14, 50)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = tam._lsmc_backward_batch(paths, Kt, r, dt, calls, basis_dim=4,
                                       return_stderr=True)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert all(bool(torch.isfinite(o).all()) for o in out)
