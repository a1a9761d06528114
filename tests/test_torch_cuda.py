"""The port's CUDA kernels against their plain torch versions, on the card.

Every test here needs a CUDA card (the kernels have no CPU mode) and skips
without one. On a machine with a card (jax not needed there):

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest \\
        -p no:cacheprovider -o addopts=""

Tolerances as in ``chip_smoke.py``: counts equal, every other stat within
rtol 2e-5 (the kernel sums per thread, then a fixed block tree; the plain
version per tile; the terminal kernel's Box-Muller angle is sincospi(2u)),
and the path kernel's signed Greek sums within 2e-5·√(n·ΣY²).
"""
import pytest
import torch

from optpricer_tpu_torch.ops import path_mc as tpm
from optpricer_tpu_torch.ops import qmc_path as tqp
from optpricer_tpu_torch.ops import terminal_mc as tmc

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
