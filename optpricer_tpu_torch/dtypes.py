"""Dtype and device policy of the PyTorch port.

Counterpart of ``optpricer_tpu/dtypes.py``. The JAX package's default
depends on ``jax_enable_x64``; the port states its own policy instead:

* Black-Scholes, implied vol and CRR default to ``torch.float64`` — the
  H100 runs f64 natively, and the reference tests run JAX at x64.
* The Monte-Carlo kernels are float32, exactly as the TPU kernels are
  (``ops/terminal_mc.py``); their host estimators are f64 numpy.
* Every public engine takes ``dtype=`` (a ``torch.dtype`` or its name) to
  override the default, and ``device=`` to say where it runs. The default
  device is ``"cuda"``: the port is written for the card, and a CPU run is
  an explicit ``device="cpu"``. A CUDA request on a host without a card
  raises; nothing falls back to the CPU.
"""
from __future__ import annotations

import torch

DEFAULT_DEVICE = "cuda"
MC_DTYPE = torch.float32


def default_dtype() -> torch.dtype:
    """float64 for the closed forms and the lattice."""
    return torch.float64


def canonical(dtype) -> torch.dtype:
    """``None`` → the default; a ``torch.dtype`` or its name ("float32",
    "float64", numpy-style spellings included) → that dtype."""
    if dtype is None:
        return default_dtype()
    if isinstance(dtype, torch.dtype):
        return dtype
    name = getattr(dtype, "name", None) or getattr(dtype, "__name__", None) \
        or str(dtype)
    resolved = getattr(torch, name.removeprefix("torch."), None)
    if not isinstance(resolved, torch.dtype):
        raise ValueError(f"unknown dtype {dtype!r}")
    return resolved


def resolve_device(device) -> torch.device:
    """``torch.device`` for ``device``; raises for a CUDA device on a host
    where ``torch.cuda.is_available()`` is false."""
    dev = torch.device(DEFAULT_DEVICE if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but torch.cuda.is_available() "
            "is false; pass device='cpu' to run the plain versions")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {str(dev)!r}")
    return dev
