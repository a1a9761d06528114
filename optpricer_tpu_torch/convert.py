"""Carry state from the JAX package into the port.

The reference objects are read through their attributes and the kernels'
host vectors through ``numpy.asarray``, so this module never imports
``jax``: it accepts anything shaped like the JAX package's values.

* ``option_spec`` / ``instrument`` / ``market_data`` convert
  ``optpricer_tpu.core`` containers (scalar fields become Python floats,
  array-valued fields float64 tensors);
* ``terminal_params`` converts the f32[7] vector of
  ``optpricer_tpu.ops.pallas_mc._terminal_params`` (S0, K, μT, σ√T, df,
  n_paths, sign);
* ``seed_pair`` converts the int32[2] ``[seed % (2**31-1), offset]`` vector
  that ``mc_sumstats_pallas`` / ``mc_sumstats_qmc`` hand their kernels.
"""
from __future__ import annotations

import numpy as np
import torch

from .core import Instrument, MarketData, OptionSpec

__all__ = ["option_spec", "instrument", "market_data", "terminal_params",
           "seed_pair"]


def _field(value):
    arr = np.array(value)
    if arr.ndim == 0:
        return arr.item()
    return torch.as_tensor(arr.astype(np.float64))


def option_spec(obj) -> OptionSpec:
    return OptionSpec(**{f: _field(getattr(obj, f))
                         for f in ("S0", "K", "T", "r", "sigma", "q")})


def instrument(obj) -> Instrument:
    return Instrument(K=_field(obj.K), T=_field(obj.T), kind=str(obj.kind),
                      exercise=str(obj.exercise))


def market_data(obj) -> MarketData:
    return MarketData(spot=_field(obj.spot), rate=_field(obj.rate),
                      q=_field(obj.q), vol_surface=obj.vol_surface,
                      flat_vol=_field(obj.flat_vol))


def terminal_params(params, device="cpu") -> torch.Tensor:
    arr = np.array(params, np.float32)
    if arr.shape != (7,):
        raise ValueError(f"terminal params must have shape (7,), got {arr.shape}")
    return torch.as_tensor(arr).to(device)


def seed_pair(seed, device="cpu") -> torch.Tensor:
    arr = np.array(seed, np.int32)
    if arr.shape != (2,):
        raise ValueError(f"seed pair must have shape (2,), got {arr.shape}")
    return torch.as_tensor(arr).to(device)
