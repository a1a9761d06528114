"""JSON persistence for calibration artifacts: SVI slices and surfaces,
Heston fits, multi-asset specs and calibrated LSV models.

Counterpart of ``optpricer_tpu/utils/serialization.py``, with the same
payloads key for key, so a file written by either package loads in the
other. Floats are written by ``json`` at full repr precision, so a round
trip is bit-exact in float64. Loaded surfaces and LSV tables live on
``device`` (default ``"cuda"``, as every entry point of the port).
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Union

import numpy as np
import torch

from ..dtypes import default_dtype, resolve_device
from ..models.calibration import SVIParams, VolSurface

__all__ = [
    "svi_to_dict", "svi_from_dict",
    "surface_to_json", "surface_from_json",
    "save_surface", "load_surface",
    "heston_to_dict", "heston_from_dict", "save_heston", "load_heston",
    "basket_to_dict", "basket_from_dict", "save_basket", "load_basket",
    "lsv_to_dict", "lsv_from_dict", "save_lsv", "load_lsv",
]


def svi_to_dict(p: SVIParams) -> dict:
    return {"a": float(p.a), "b": float(p.b), "rho": float(p.rho),
            "m": float(p.m), "sigma": float(p.sigma),
            "expiry": float(p.expiry)}


def svi_from_dict(d: dict) -> SVIParams:
    return SVIParams(a=float(d["a"]), b=float(d["b"]), rho=float(d["rho"]),
                     m=float(d["m"]), sigma=float(d["sigma"]),
                     expiry=float(d["expiry"]))


def surface_to_json(surface: VolSurface) -> str:
    payload = {
        "slices": {str(T): svi_to_dict(p)
                   for T, p in surface.slices.items()},
        "forward_curve": {str(T): float(F)
                          for T, F in surface._forward_curve.items()},
    }
    return json.dumps(payload, indent=2, sort_keys=True)


def surface_from_json(text: str, device=None) -> VolSurface:
    payload = json.loads(text)
    slices = {float(T): svi_from_dict(d)
              for T, d in payload["slices"].items()}
    fwd = {float(T): float(F)
           for T, F in payload.get("forward_curve", {}).items()}
    return VolSurface(slices, forward_curve=fwd or None, device=device)


def save_surface(surface: VolSurface, path: Union[str, Path]) -> None:
    Path(path).write_text(surface_to_json(surface))


def load_surface(path: Union[str, Path], device=None) -> VolSurface:
    return surface_from_json(Path(path).read_text(), device=device)


# ---------------------------------------------------------------------------
# Model-parameter round trips (Heston fits, multi-asset specs)
# ---------------------------------------------------------------------------
_HESTON_KEYS = ("v0", "kappa", "theta", "xi", "rho")


def heston_to_dict(fit: dict) -> dict:
    """Normalise a Heston fit (or raw parameter dict) for JSON."""
    out = {k: float(fit[k]) for k in _HESTON_KEYS}
    for extra in ("rmse", "S0", "r", "q"):
        if extra in fit:
            out[extra] = float(fit[extra])
    return out


def heston_from_dict(d: dict) -> dict:
    """The ``heston=`` kwargs dict; missing keys raise early."""
    missing = [k for k in _HESTON_KEYS if k not in d]
    if missing:
        raise KeyError(f"heston params missing {missing}")
    return {k: float(d[k]) for k in _HESTON_KEYS}


def save_heston(fit: dict, path: Union[str, Path]) -> None:
    Path(path).write_text(json.dumps(heston_to_dict(fit), indent=2,
                                     sort_keys=True))


def load_heston(path: Union[str, Path]) -> dict:
    return heston_from_dict(json.loads(Path(path).read_text()))


def basket_to_dict(*, S0s, weights, sigmas, corr, qs=None) -> dict:
    """JSON payload for a multi-asset spec (``models.basket`` inputs)."""
    a = len(list(S0s))
    qs = [0.0] * a if qs is None else list(map(float, qs))
    return {"S0s": list(map(float, S0s)),
            "weights": list(map(float, weights)),
            "sigmas": list(map(float, sigmas)), "qs": qs,
            "corr": np.asarray(corr, float).tolist()}


def basket_from_dict(d: dict) -> dict:
    out = {k: list(map(float, d[k]))
           for k in ("S0s", "weights", "sigmas", "qs")}
    out["corr"] = np.asarray(d["corr"], float)
    a = len(out["S0s"])
    if out["corr"].shape != (a, a):
        raise ValueError(f"corr must be ({a}, {a})")
    return out


def save_basket(path: Union[str, Path], **spec) -> None:
    Path(path).write_text(json.dumps(basket_to_dict(**spec), indent=2,
                                     sort_keys=True))


def load_basket(path: Union[str, Path]) -> dict:
    return basket_from_dict(json.loads(Path(path).read_text()))


def _floats(values) -> list:
    arr = values.detach().cpu().numpy() if isinstance(values, torch.Tensor) \
        else np.asarray(values)
    return np.asarray(arr, float).tolist()


def lsv_to_dict(model) -> dict:
    """JSON payload for a calibrated :class:`~optpricer_tpu_torch.models.
    lsv.LSVModel`: the Heston parameters and the (n_steps, n_bins)
    leverage table, the expensive artifact of a particle calibration."""
    return {
        "S0": float(model.S0), "r": float(model.r), "q": float(model.q),
        "T": float(model.T), "v0": float(model.v0),
        "kappa": float(model.kappa), "theta": float(model.theta),
        "xi": float(model.xi), "rho": float(model.rho),
        "x_bins": _floats(model.x_bins),
        "leverage": _floats(model.leverage),
        "scheme": model.scheme,
    }


def lsv_from_dict(d: dict, device=None):
    from ..models.lsv import LSVModel

    dev = resolve_device(device)
    # JSON floats are repr-exact, so the float64 round trip is bit-exact
    dt = default_dtype()
    x_bins = torch.as_tensor(np.asarray(d["x_bins"], np.float64), dtype=dt,
                             device=dev)
    lev = torch.as_tensor(np.asarray(d["leverage"], np.float64), dtype=dt,
                          device=dev)
    if lev.ndim != 2 or lev.shape[1] != x_bins.shape[0]:
        raise ValueError(f"leverage {tuple(lev.shape)} inconsistent with "
                         f"{x_bins.shape[0]} x-bins")
    return LSVModel(S0=float(d["S0"]), r=float(d["r"]), q=float(d["q"]),
                    T=float(d["T"]), v0=float(d["v0"]),
                    kappa=float(d["kappa"]), theta=float(d["theta"]),
                    xi=float(d["xi"]), rho=float(d["rho"]),
                    x_bins=x_bins, leverage=lev,
                    scheme=str(d.get("scheme", "euler")))


def save_lsv(model, path: Union[str, Path]) -> None:
    Path(path).write_text(json.dumps(lsv_to_dict(model), sort_keys=True))


def load_lsv(path: Union[str, Path], device=None):
    return lsv_from_dict(json.loads(Path(path).read_text()), device=device)
