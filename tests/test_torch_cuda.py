"""The port's CUDA kernels against their plain torch versions, on the card.

Every test here needs a CUDA card (the kernels have no CPU mode) and skips
without one. On a machine with a card (jax not needed there):

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest \\
        -p no:cacheprovider -o addopts=""

Tolerances as in ``chip_smoke.py``: counts equal, every other stat within
rtol 2e-5 (the kernel sums per thread, then a fixed block tree; the plain
version per tile; the kernel's Box-Muller angle is sincospi(2u)).
"""
import pytest
import torch

from optpricer_tpu_torch.ops import terminal_mc as tmc

pytestmark = pytest.mark.cuda

MARKET = (100.0, 110.0, 1.0, 0.03, 0.01, 0.2)
RTOL = 2e-5


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda", 0)


def _assert_close(kernel, plain):
    k, p = kernel.double().cpu(), plain.double().cpu()
    assert torch.equal(k[..., 0], p[..., 0])
    torch.testing.assert_close(k, p, rtol=RTOL, atol=0.0)


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
