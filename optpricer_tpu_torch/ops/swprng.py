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
"""
from __future__ import annotations

import torch

__all__ = ["threefry2x32"]

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
