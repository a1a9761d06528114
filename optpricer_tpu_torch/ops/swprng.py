"""Counter-based Threefry-2x32-20, the generator of the Monte-Carlo kernels.

Counterpart of ``optpricer_tpu/ops/swprng.py`` (Salmon, Moraes, Dror &
Shaw, SC'11 — the PRF under JAX's own PRNG). It has two forms:

* ``threefry2x32`` below, plain torch on int64 tensors holding uint32
  values (torch has no full uint32 arithmetic, so every add and shift is
  masked back to 32 bits) — the kernels' plain versions use it;
* ``threefry2x32`` in ``csrc/threefry.cuh``, a ``__device__`` function on
  ``uint32_t`` that the CUDA kernels inline.

Both give the JAX function's bits exactly for the same (key, counter), which
is what lets the port reproduce the reference's draws.

``jax_fold_in_bits`` rebuilds, on the host, the words that
``jax.random.bits(jax.random.fold_in(jax.random.key(seed), i), (d,),
jnp.uint32)`` returns under JAX's default ``threefry2x32`` implementation
with ``jax_threefry_partitionable`` on: the path-QMC kernel's digital
shifts. ``jax_fold_in_path_bits`` does the same for a chain of folds,
``fold_in(fold_in(key(seed), i0), i1)…``, in Python integers (one key at a
time, a few microseconds): the keys of the port's generators.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["threefry2x32", "jax_fold_in_bits", "jax_fold_in_path_bits"]

_ROTATIONS = (13, 15, 26, 6, 17, 29, 16, 24)
_PARITY = 0x1BD11BDA
_MASK = 0xFFFFFFFF


def _u32(x) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(torch.int64) & _MASK
    return torch.tensor(int(x) & _MASK, dtype=torch.int64)


def _rotl(x, r: int):
    return ((x << r) & _MASK) | (x >> (32 - r))


def threefry2x32(key0, key1, ctr0, ctr1):
    """One Threefry-2x32-20 block per broadcast (key, counter) element.

    Keys and counters are Python ints or integer tensors (read modulo
    2**32); they broadcast against each other. Returns ``(x0, x1)`` as
    int64 tensors with values in [0, 2**32).
    """
    dev = next((t.device for t in (key0, key1, ctr0, ctr1)
                if isinstance(t, torch.Tensor)), torch.device("cpu"))
    k0, k1 = _u32(key0).to(dev), _u32(key1).to(dev)
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (_u32(ctr0).to(dev) + k0) & _MASK
    x1 = (_u32(ctr1).to(dev) + k1) & _MASK
    for block in range(5):
        for j in range(4):
            x0 = (x0 + x1) & _MASK
            x1 = _rotl(x1, _ROTATIONS[(block % 2) * 4 + j]) ^ x0
        x0 = (x0 + ks[(block + 1) % 3]) & _MASK
        x1 = (x1 + ks[(block + 2) % 3] + (block + 1)) & _MASK
    return x0, x1


def _threefry_int(k0: int, k1: int, x0: int, x1: int) -> tuple:
    """``threefry2x32`` on one (key, counter) in Python integers."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0, x1 = (x0 + k0) & _MASK, (x1 + k1) & _MASK
    for block in range(5):
        for j in range(4):
            r = _ROTATIONS[(block % 2) * 4 + j]
            x0 = (x0 + x1) & _MASK
            x1 = (((x1 << r) & _MASK) | (x1 >> (32 - r))) ^ x0
        x0 = (x0 + ks[(block + 1) % 3]) & _MASK
        x1 = (x1 + ks[(block + 2) % 3] + block + 1) & _MASK
    return x0, x1


def jax_fold_in_path_bits(seed: int, path, d: int) -> list:
    """The ``d`` uint32 words of ``bits(fold_in(…fold_in(key(seed), i0)…,
    i_last), (d,), uint32)`` for the tuple ``path`` = (i0, …, i_last), as
    Python integers; a one-entry path gives ``jax_fold_in_bits(seed, i0,
    d)``."""
    seed64 = int(seed) & 0xFFFFFFFFFFFFFFFF
    k0, k1 = seed64 >> 32, seed64 & _MASK
    for i in path:
        k0, k1 = _threefry_int(k0, k1, 0, int(i) & _MASK)
    return [a ^ b for a, b in (_threefry_int(k0, k1, 0, j)
                               for j in range(int(d)))]


def jax_fold_in_bits(seed: int, i, d: int) -> np.ndarray:
    """(d,) uint32: ``bits(fold_in(key(seed), i), (d,), uint32)``; for a
    1-D sequence ``i``, (len(i), d), one row per counter.

    The steps of JAX's threefry2x32 implementation, in host integers:
    ``key(seed)`` is the pair (high, low) of the seed's 64-bit word;
    ``fold_in`` hashes the counter (0, i) under that key; ``bits`` (the
    partitionable form) hashes the counters (0, j), j < d, under the new
    key and XORs the two output words. Each step is one broadcast
    ``threefry2x32`` pass, whatever the number of counters.
    """
    seed64 = int(seed) & 0xFFFFFFFFFFFFFFFF
    rows = np.ndim(i) == 1
    ctr = torch.as_tensor(np.asarray(i, np.int64).reshape(-1, 1) & _MASK)
    k0, k1 = threefry2x32(seed64 >> 32, seed64 & _MASK, 0, ctr)
    j = torch.arange(int(d), dtype=torch.int64)
    b0, b1 = threefry2x32(k0, k1, 0, j)
    out = (b0 ^ b1).numpy().astype(np.uint32)
    return out if rows else out[0]
