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
  that ``mc_sumstats_pallas`` / ``mc_sumstats_qmc`` /
  ``path_mc_sumstats_pallas`` hand their kernels, and the
  ``[seed, n_points - 1]`` pair of ``path_qmc_sumstats_pallas``;
* ``path_params`` converts the f32[24] vector of
  ``optpricer_tpu.ops.pallas_path_mc._common_params``;
* ``qmc_path_params`` converts the f32[6] vector (S0, K, df, barrier,
  rebate, payout) of ``path_qmc_sumstats_pallas``;
* ``int32_table`` / ``float32_table`` convert the 2-D kernel operands: the
  path-QMC kernel's direction numbers ``V`` and digital shifts (int32 views
  of uint32 words), bridge matrix ``B`` and drift row (f32). The path
  kernel's ``svi`` table (f32) converts the same way;
* ``fd_lv_params``, ``fd_lv_lanes`` and ``fd_lv_sigma_table`` convert the
  operands of ``optpricer_tpu.ops.pallas_fd_lv._run_fd_lv`` into the
  layout of ``ops/fd_lv.fd_lv``: the f32[6] (x_min, dx, dt, r, q, T), the
  (1, B_pad) ``K_pad`` / ``sign_pad`` lane rows as f32[B_pad], and the
  (m_pad, n_t_pad) σ table as the port's (n_t, m_pad);
* ``vol_surface`` rebuilds an ``optpricer_tpu.models.calibration.
  VolSurface`` as the port's, from its ``.slices`` (every SVI field read as
  a float) and its ``._forward_curve``;
* ``mc_batch_kparams`` converts the (n_ktiles, 8, 128) f32 contract tiles
  of ``optpricer_tpu.ops.pallas_mc_batch`` (K, sign, S0, μT, σ√T, df);
* ``basket_params`` converts the f32[7 + 4a + a²] operand of
  ``optpricer_tpu.ops.pallas_basket_mc._build_params`` into the basket
  kernel's params (``ops/basket_mc``);
* ``lsv_model`` rebuilds an ``optpricer_tpu.models.lsv.LSVModel`` as the
  port's, its ``x_bins`` and ``leverage`` read through numpy in their own
  float dtype.
"""
from __future__ import annotations

import numpy as np
import torch

from .core import Instrument, MarketData, OptionSpec

__all__ = ["option_spec", "instrument", "market_data", "terminal_params",
           "seed_pair", "path_params", "qmc_path_params", "int32_table",
           "float32_table", "fd_lv_params", "fd_lv_lanes",
           "fd_lv_sigma_table", "vol_surface", "mc_batch_kparams",
           "basket_params", "lsv_model"]


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


def _vector(params, n: int, what: str, device) -> torch.Tensor:
    arr = np.array(params, np.float32)
    if arr.shape != (n,):
        raise ValueError(f"{what} params must have shape ({n},), got "
                         f"{arr.shape}")
    return torch.as_tensor(arr).to(device)


def terminal_params(params, device="cpu") -> torch.Tensor:
    return _vector(params, 7, "terminal", device)


def path_params(params, device="cpu") -> torch.Tensor:
    return _vector(params, 24, "path", device)


def qmc_path_params(params, device="cpu") -> torch.Tensor:
    return _vector(params, 6, "path-QMC", device)


def _table(arr, dtype, device) -> torch.Tensor:
    arr = np.ascontiguousarray(np.array(arr))
    if arr.ndim != 2:
        raise ValueError(f"kernel tables are 2-D, got shape {arr.shape}")
    if np.dtype(dtype).kind == "i":
        if arr.dtype.kind not in "iu" or arr.dtype.itemsize != 4:
            raise ValueError(f"expected 32-bit integer words, got {arr.dtype}")
        arr = arr.view(dtype)      # uint32 words keep their bits
    else:
        arr = arr.astype(dtype)
    return torch.as_tensor(arr).to(device)


def int32_table(arr, device="cpu") -> torch.Tensor:
    return _table(arr, np.int32, device)


def float32_table(arr, device="cpu") -> torch.Tensor:
    return _table(arr, np.float32, device)


def seed_pair(seed, device="cpu") -> torch.Tensor:
    arr = np.array(seed, np.int32)
    if arr.shape != (2,):
        raise ValueError(f"seed pair must have shape (2,), got {arr.shape}")
    return torch.as_tensor(arr).to(device)


def vol_surface(obj, device="cpu"):
    """The port's ``VolSurface`` with the slices and forward curve of a
    JAX one."""
    from .models.calibration import SVIParams, VolSurface

    slices = {float(T): SVIParams(**{f: float(getattr(p, f))
                                     for f in ("a", "b", "rho", "m", "sigma",
                                               "expiry")})
              for T, p in obj.slices.items()}
    forwards = {float(T): float(F)
                for T, F in (obj._forward_curve or {}).items()}
    return VolSurface(slices, forward_curve=forwards or None, device=device)


def mc_batch_kparams(kparams, device="cpu") -> torch.Tensor:
    """The book kernel's (n_ktiles, 8, 128) contract tiles as f32."""
    arr = np.array(kparams, np.float32)
    if arr.ndim != 3 or arr.shape[1:] != (8, 128):
        raise ValueError(f"kparams must be (n_ktiles, 8, 128), got "
                         f"{arr.shape}")
    return torch.as_tensor(arr).to(device)


def fd_lv_params(params, device="cpu") -> torch.Tensor:
    return _vector(params, 6, "fd_lv", device)


def fd_lv_lanes(row, device="cpu") -> torch.Tensor:
    """A (1, B_pad) lane row (``K_pad``, ``sign_pad``) as f32[B_pad]."""
    arr = np.array(row, np.float32)
    if arr.ndim != 2 or arr.shape[0] != 1:
        raise ValueError(f"lane rows are (1, B), got shape {arr.shape}")
    return torch.as_tensor(arr[0].copy()).to(device)


def fd_lv_sigma_table(sig_tab, n_t: int, device="cpu") -> torch.Tensor:
    """The (m_pad, n_t_pad) σ table as f32[n_t, m_pad], row n the σ column
    of step n."""
    arr = np.array(sig_tab, np.float32)
    if arr.ndim != 2 or arr.shape[1] < n_t:
        raise ValueError(f"sigma table must be (m_pad, >= {n_t}), got "
                         f"{arr.shape}")
    return torch.as_tensor(np.ascontiguousarray(arr[:, :n_t].T)).to(device)


def basket_params(params, device="cpu") -> torch.Tensor:
    """The basket kernel's f32[7 + 4a + a²] params (K, df, n_paths, sign,
    barrier, rebate, crossed0, then S0, drift, voldt, w per asset, then the
    Cholesky factor row-major)."""
    arr = np.array(params, np.float32)
    a = int(round((-4 + np.sqrt(16 + 4 * max(arr.size - 7, 0))) / 2))
    if arr.ndim != 1 or a < 1 or arr.size != 7 + 4 * a + a * a:
        raise ValueError(f"basket params must have 7 + 4a + a^2 entries, "
                         f"got shape {arr.shape}")
    return torch.as_tensor(arr).to(device)


def lsv_model(obj, device="cpu"):
    """The port's ``LSVModel`` with the fields of a JAX one."""
    from .models.lsv import LSVModel

    def table(values):
        return torch.as_tensor(np.array(values)).to(device)

    return LSVModel(S0=float(obj.S0), r=float(obj.r), q=float(obj.q),
                    T=float(obj.T), v0=float(obj.v0),
                    kappa=float(obj.kappa), theta=float(obj.theta),
                    xi=float(obj.xi), rho=float(obj.rho),
                    x_bins=table(obj.x_bins), leverage=table(obj.leverage),
                    scheme=str(obj.scheme))
