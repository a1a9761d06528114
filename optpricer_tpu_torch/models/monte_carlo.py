"""Terminal-only GBM European Monte-Carlo pricer.

Counterpart of ``optpricer_tpu/models/monte_carlo.py``. Every price comes
from sufficient statistics reduced on the device and a float64 estimator on
the host:

* ``backend="auto"`` and ``"pallas"`` run the terminal kernel
  (``ops/terminal_mc.terminal_mc``), over a mesh its sharded entry
  ``mc_sumstats_kernel_sharded``;
* ``backend="qmc"`` runs the randomised-QMC kernel
  (``ops/terminal_mc.terminal_qmc``);
* ``backend="xla"`` runs the chunk scan :func:`mc_sumstats` in the working
  dtype (float64 unless ``dtype=`` says otherwise), over a mesh
  ``parallel.mc_sumstats_sharded``. ``euro_greeks_mc`` takes the scan for
  any backend but "auto" and "pallas", as the JAX package does.

**Seed semantics.** Each backend is bit-reproducible given
``(seed, n_paths, antithetic)`` (and ``chunk_size`` for the scan). The
kernels draw exactly the JAX package's ``sw_prng`` stream (Threefry keyed
by seed and global program id), so a seed prices the same sample here as
the JAX kernel does in interpret mode. The scan draws each chunk's normals
from a ``torch.Generator`` keyed by (seed, chunk id) — the counterpart of
the reference's ``fold_in(key, chunk)`` — so the chunk order, and with it
the mesh, never changes the sample; torch does not reproduce
``jax.random``'s stream, so the sample is another than the reference's.
The scan's deterministic core :func:`_chunk_stats` takes the normals as an
argument.

Returns ``(price, stderr)`` like the reference.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..core import CALL, OptionSpec
from ..dtypes import canonical, resolve_device
from ..ops import stats as stats_ops
from ..ops.black_scholes import is_call_mask
from ..ops.swprng import jax_fold_in_path_bits
from ..ops.terminal_mc import (mc_sumstats_kernel, mc_sumstats_kernel_sharded,
                               mc_sumstats_qmc, qmc_estimate,
                               terminal_estimate, terminal_greeks)

__all__ = ["euro_price_mc", "euro_greeks_mc", "mc_sumstats", "resolve_seed"]

_BACKENDS = ("auto", "pallas", "qmc", "xla")


def resolve_seed(seed: Optional[int]) -> int:
    """None → fresh OS entropy (reference semantics of SeedSequence(None))."""
    if seed is None:
        return int(np.random.SeedSequence().entropy % (2**63))
    return int(seed)


def keyed_generator(seed: int, index, device) -> torch.Generator:
    """A ``torch.Generator`` on ``device`` seeded from (seed, index) alone:
    the 64 bits of ``jax_fold_in_bits(seed, index, 2)``, the port's
    counterpart of ``fold_in(key(seed), index)``. ``index`` may be a tuple
    of indices, folded in one after another (``fold_in(fold_in(key(seed),
    i0), i1)``…), so that (level, chunk) or (outer date, inner date) key a
    stream without packing the indices into one word; a one-entry tuple is
    the one-index form. Streams of different indices are independent of
    the order they are drawn in."""
    path = tuple(index) if isinstance(index, (tuple, list)) else (index,)
    hi, lo = jax_fold_in_path_bits(int(seed), path, 2)
    return torch.Generator(device=device).manual_seed((hi << 32) | lo)


def _chunk_stats(Z, chunk_idx, n_paths, S0, K, T, r, q, sigma, is_call,
                 *, chunk_size: int, antithetic: bool, dtype):
    """Sufficient statistics of one fixed-size chunk of terminal GBM draws
    ``Z`` (``(chunk_size,)`` standard normals).

    Exact log-Euler terminal map S_T = S0·exp((r−q−σ²/2)T + σ√T·Z),
    X = e^{−rT}·payoff, Y1 = e^{−rT}·S_T, Y2 = e^{−rT}·1{ITM}; entries past
    ``n_paths`` weigh 0. Returns the 13-stat layout (the dual-CV ten and
    ΣXz, ΣXz², ΣY2z); antithetic adds the moments of −Z.
    """
    dev = Z.device
    S0, K, T, r, q, sigma = (torch.as_tensor(v, dtype=dtype, device=dev)
                             for v in (S0, K, T, r, q, sigma))
    mu = (r - q - 0.5 * sigma * sigma) * T
    sig = sigma * torch.sqrt(T)
    df = torch.exp(-r * T)
    base = int(chunk_idx) * chunk_size + torch.arange(
        chunk_size, dtype=torch.int64, device=dev)
    w = (base < int(n_paths)).to(dtype)

    def moments(z):
        ST = S0 * torch.exp(mu + sig * z)
        itm = (ST > K) if is_call else (ST < K)
        payoff = torch.clamp(ST - K, min=0.0) if is_call \
            else torch.clamp(K - ST, min=0.0)
        X = df * payoff
        Y1 = df * ST
        Y2 = df * itm.to(dtype)
        WX, WY1, WY2 = X * w, Y1 * w, Y2 * w
        return torch.stack([
            torch.sum(w),
            torch.sum(WX), torch.sum(WX * X),
            torch.sum(WY1), torch.sum(WY1 * Y1), torch.sum(WX * Y1),
            torch.sum(WY2), torch.sum(WY2 * Y2), torch.sum(WX * Y2),
            torch.sum(WY1 * Y2),
            torch.sum(WX * z), torch.sum(WX * z * z), torch.sum(WY2 * z),
        ])

    s = moments(Z)
    if antithetic:
        s = s + moments(-Z)
    return s


def mc_sumstats(key, chunk_ids, n_paths, S0, K, T, r, q, sigma, is_call,
                *, chunk_size: int, antithetic: bool, dtype, device=None,
                normals=None):
    """Scan the given chunk ids, Kahan-accumulating the 13 stats.

    ``key`` is the run's integer seed; chunk ``c`` draws its normals from
    ``keyed_generator(key, c)`` (or ``normals(c)`` when given, the
    deterministic core's draw interface), so the same function serves the
    one-device run (``range(n_chunks)``) and each shard of a mesh (its
    slice of the padded chunk grid): ids past ``n_paths`` weigh 0. The
    loop enqueues its work with no host sync. Returns a (13,) tensor of
    ``dtype`` on ``device``.
    """
    dt = canonical(dtype)
    dev = resolve_device(device)
    chunk_size = int(chunk_size)
    acc = torch.zeros(stats_ops.STATSG_DIM, dtype=dt, device=dev)
    comp = torch.zeros_like(acc)
    for idx in chunk_ids:
        idx = int(idx)
        if normals is None:
            Z = torch.randn(chunk_size, generator=keyed_generator(key, idx,
                                                                  dev),
                            dtype=dt, device=dev)
        else:
            Z = torch.as_tensor(normals(idx), dtype=dt, device=dev)
        s = _chunk_stats(Z, idx, n_paths, S0, K, T, r, q, sigma,
                         bool(is_call), chunk_size=chunk_size,
                         antithetic=bool(antithetic), dtype=dt)
        acc, comp = stats_ops.kahan_add(acc, comp, s)
    return acc


def _estimate(stats_vec, S0, q, T, control_variate: bool):
    """(price, stderr) on the host from the scan's stats: the first six
    feed the single spot control variate, E[e^{−rT}S_T] = S0·e^{−qT}."""
    if isinstance(stats_vec, torch.Tensor):
        stats_vec = stats_vec.detach().cpu().numpy()
    stats_vec = np.asarray(stats_vec, dtype=np.float64)
    n = stats_vec[stats_ops.N]
    if n == 0:
        return float("nan"), float("nan")
    sv = stats_vec[:stats_ops.STATS_DIM]
    if control_variate:
        EY = S0 * np.exp(-q * T)
        mean, se = stats_ops.cv_mean_se_np(sv, EY)
    else:
        mean = sv[stats_ops.SX] / n
        var = max(0.0, sv[stats_ops.SX2] / n - mean * mean)
        se = float(np.sqrt(var / n))
    return float(mean), float(se)


def _scan_stats(seed, n_paths, S0, K, T, r, q, sigma, is_call, *,
                chunk_size, antithetic, dtype, mesh, device):
    n_chunks = -(-int(n_paths) // int(chunk_size))
    if mesh is not None:
        from ..parallel.mesh import mc_sumstats_sharded

        return mc_sumstats_sharded(
            mesh, seed, n_chunks, n_paths, S0, K, T, r, q, sigma, is_call,
            chunk_size=int(chunk_size), antithetic=antithetic, dtype=dtype)
    return mc_sumstats(seed, range(n_chunks), n_paths, S0, K, T, r, q,
                       sigma, is_call, chunk_size=int(chunk_size),
                       antithetic=antithetic, dtype=dtype, device=device)


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
    variate when ``control_variate``; float32, ``chunk_size`` and
    ``dtype`` unused); "qmc" prices on randomised QMC points (scrambled van
    der Corput through the inverse CDF, error bar from the spread of 16
    randomisations; ``antithetic`` and ``mesh`` are ignored); "xla" runs
    the chunk scan in ``dtype`` (float64 by default) with the spot control
    variate. ``mesh`` (a :class:`~optpricer_tpu_torch.parallel.mesh.Mesh`)
    splits the kernel's grid or the scan's chunks over its devices.
    ``n_workers`` is accepted for API parity; ``device`` is where a run
    without a mesh goes (default ``"cuda"``).

    Returns ``(price, stderr)`` (or just price when ``return_stderr=False``).
    """
    del n_workers
    if backend not in _BACKENDS:
        raise ValueError(f"backend must be one of {_BACKENDS}, got "
                         f"{backend!r}")
    S0, K, T, r, sigma = opt.S0, opt.K, opt.T, opt.r, opt.sigma
    q = getattr(opt, "q", 0.0)
    is_call = bool(is_call_mask(kind))
    seed = resolve_seed(seed)

    if backend == "qmc":
        rep_stats = mc_sumstats_qmc(seed, n_paths, S0, K, T, r, q, sigma,
                                    is_call, device=device)
        price, se = qmc_estimate(rep_stats, S0, K, T, r, q, sigma, is_call,
                                 control_variate)
    elif backend == "xla":
        stats_vec = _scan_stats(seed, n_paths, S0, K, T, r, q, sigma,
                                is_call, chunk_size=chunk_size,
                                antithetic=antithetic,
                                dtype=canonical(dtype), mesh=mesh,
                                device=device)
        price, se = _estimate(stats_vec, S0, q, T, control_variate)
    else:
        if mesh is not None:
            stats_vec = mc_sumstats_kernel_sharded(
                mesh, seed, n_paths, S0, K, T, r, q, sigma, is_call,
                antithetic=antithetic)
        else:
            stats_vec = mc_sumstats_kernel(seed, n_paths, S0, K, T, r, q,
                                           sigma, is_call,
                                           antithetic=antithetic,
                                           device=device)
        price, se = terminal_estimate(stats_vec, S0, K, T, r, q, sigma,
                                      is_call, control_variate)
    return (price, se) if return_stderr else price


def euro_greeks_mc(opt: OptionSpec, kind: str = CALL, *,
                   n_paths: int = 1_000_000, seed: Optional[int] = None,
                   chunk_size: int = 100_000, antithetic: bool = True,
                   dtype=None, backend: str = "auto", mesh=None,
                   device=None) -> dict:
    """All five Greeks + digital price from ONE run.

    Under GBM every pathwise/likelihood-ratio Greek is linear in the 13
    moments (``ops.terminal_mc.terminal_greeks``). "auto" and "pallas" run
    the terminal kernel; with ``mesh=`` its sharded entry, whatever the
    backend (as the JAX package routes it); any other backend the chunk
    scan in ``dtype``. Returns ``{"price", "delta", "gamma", "vega",
    "theta", "rho", "digital"}``.
    """
    S0, K, T, r, sigma = opt.S0, opt.K, opt.T, opt.r, opt.sigma
    q = getattr(opt, "q", 0.0)
    is_call = bool(is_call_mask(kind))
    seed = resolve_seed(seed)
    if mesh is not None:
        stats_vec = mc_sumstats_kernel_sharded(
            mesh, seed, n_paths, S0, K, T, r, q, sigma, is_call,
            antithetic=antithetic)
    elif backend in ("auto", "pallas"):
        stats_vec = mc_sumstats_kernel(seed, n_paths, S0, K, T, r, q, sigma,
                                       is_call, antithetic=antithetic,
                                       device=device)
    else:
        stats_vec = _scan_stats(seed, n_paths, S0, K, T, r, q, sigma,
                                is_call, chunk_size=chunk_size,
                                antithetic=antithetic,
                                dtype=canonical(dtype), mesh=None,
                                device=device)
    return terminal_greeks(stats_vec, S0, K, T, r, q, sigma, is_call)
