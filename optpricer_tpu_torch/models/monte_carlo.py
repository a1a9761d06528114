"""Terminal-only GBM European Monte-Carlo pricer.

Counterpart of ``optpricer_tpu/models/monte_carlo.py``. Every price comes
from sufficient statistics reduced on the device — the terminal kernel
(``ops/terminal_mc.terminal_mc``) for ``backend="auto"`` and ``"pallas"``,
the randomised-QMC kernel (``ops/terminal_mc.terminal_qmc``) for
``backend="qmc"`` — and a float64 estimator on the host.

**Seed semantics.** Each backend is bit-reproducible given
``(seed, n_paths, antithetic)`` and draws exactly the JAX package's
``sw_prng`` stream (Threefry keyed by seed and global program id), so a
seed prices the same sample here as the JAX kernel does in interpret mode.

Not ported yet (ROADMAP): ``backend="xla"``, the JAX package's
``jax.random.fold_in`` chunk scan, whose draws torch cannot reproduce
(A.5), and ``mesh=`` (A.15, ``parallel/``). Both raise
``NotImplementedError``.

Returns ``(price, stderr)`` like the reference.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from ..core import CALL, OptionSpec
from ..ops.black_scholes import is_call_mask
from ..ops.terminal_mc import (mc_sumstats_kernel, mc_sumstats_qmc,
                               qmc_estimate, terminal_estimate,
                               terminal_greeks)

__all__ = ["euro_price_mc", "euro_greeks_mc", "resolve_seed"]

_BACKENDS = ("auto", "pallas", "qmc")


def resolve_seed(seed: Optional[int]) -> int:
    """None → fresh OS entropy (reference semantics of SeedSequence(None))."""
    if seed is None:
        return int(np.random.SeedSequence().entropy % (2**63))
    return int(seed)


def _check_backend(backend: str, mesh) -> None:
    if mesh is not None:
        raise NotImplementedError(
            "mesh= is not ported yet (ROADMAP A.15, parallel/)")
    if backend == "xla":
        raise NotImplementedError(
            "backend='xla' (the fold_in chunk scan) is not ported yet "
            "(ROADMAP A.5); use backend='pallas' or 'qmc'")
    if backend not in _BACKENDS:
        raise ValueError(f"backend must be one of {_BACKENDS + ('xla',)}, "
                         f"got {backend!r}")


def euro_price_mc(
    opt: OptionSpec,
    kind: str = CALL,
    *,
    n_paths: int = 100_000,
    seed: Optional[int] = None,
    chunk_size: int = 100_000,
    antithetic: bool = True,
    control_variate: bool = True,
    n_workers: int = 1,
    dtype=None,
    return_stderr: bool = True,
    mesh=None,
    backend: str = "auto",
    device=None,
):
    """European option Monte-Carlo pricer (terminal-only GBM).

    ``backend``: "auto" and "pallas" run the terminal kernel (dual control
    variate when ``control_variate``); "qmc" prices on randomised QMC
    points (scrambled van der Corput through the inverse CDF, error bar
    from the spread of 16 randomisations; ``antithetic`` is ignored).
    ``chunk_size``, ``n_workers`` and ``dtype`` are accepted for API
    parity: the kernels are float32 and size their own grid.

    Returns ``(price, stderr)`` (or just price when ``return_stderr=False``).
    """
    del n_workers, chunk_size, dtype
    _check_backend(backend, mesh)
    S0, K, T, r, sigma = opt.S0, opt.K, opt.T, opt.r, opt.sigma
    q = getattr(opt, "q", 0.0)
    is_call = bool(is_call_mask(kind))
    seed = resolve_seed(seed)

    if backend == "qmc":
        rep_stats = mc_sumstats_qmc(seed, n_paths, S0, K, T, r, q, sigma,
                                    is_call, device=device)
        price, se = qmc_estimate(rep_stats, S0, K, T, r, q, sigma, is_call,
                                 control_variate)
    else:
        stats_vec = mc_sumstats_kernel(seed, n_paths, S0, K, T, r, q, sigma,
                                       is_call, antithetic=antithetic,
                                       device=device)
        price, se = terminal_estimate(stats_vec, S0, K, T, r, q, sigma,
                                      is_call, control_variate)
    return (price, se) if return_stderr else price


def euro_greeks_mc(opt: OptionSpec, kind: str = CALL, *,
                   n_paths: int = 1_000_000, seed: Optional[int] = None,
                   chunk_size: int = 100_000, antithetic: bool = True,
                   dtype=None, backend: str = "auto", mesh=None,
                   device=None) -> dict:
    """All five Greeks + digital price from ONE terminal-kernel run.

    Under GBM every pathwise/likelihood-ratio Greek is linear in the 13
    moments the kernel accumulates (``ops.terminal_mc.terminal_greeks``).
    Returns ``{"price", "delta", "gamma", "vega", "theta", "rho",
    "digital"}``.
    """
    del chunk_size, dtype
    # the JAX package takes the fold_in chunk scan for any backend but
    # "auto"/"pallas", so "qmc" means "xla" here
    _check_backend("xla" if backend == "qmc" else backend, mesh)
    S0, K, T, r, sigma = opt.S0, opt.K, opt.T, opt.r, opt.sigma
    q = getattr(opt, "q", 0.0)
    is_call = bool(is_call_mask(kind))
    seed = resolve_seed(seed)
    stats_vec = mc_sumstats_kernel(seed, n_paths, S0, K, T, r, q, sigma,
                                   is_call, antithetic=antithetic,
                                   device=device)
    return terminal_greeks(stats_vec, S0, K, T, r, q, sigma, is_call)
