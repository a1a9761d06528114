"""Estimators and gaps shared by the references, plain torch at float64."""
from __future__ import annotations

import math

import numpy as np
import torch

F64 = torch.float64
# the stated floor of a Monte Carlo standard error: f32 moment round-off
SE_FLOOR = 2e-6


def ncdf(x: torch.Tensor) -> torch.Tensor:
    return 0.5 * torch.erfc(-x / math.sqrt(2.0))


def black(F, K, df, sd, is_call):
    """Undiscounted-forward Black price df·E[(±(F e^{sd Z − sd²/2} − K))+]
    (tensors of one shape; ``is_call`` boolean)."""
    d1 = (torch.log(F / K) + 0.5 * sd * sd) / sd
    d2 = d1 - sd
    call = df * (F * ncdf(d1) - K * ncdf(d2))
    put = df * (K * ncdf(-d2) - F * ncdf(-d1))
    return torch.where(is_call, call, put)


def cv_estimate(X: torch.Tensor, Y: torch.Tensor, EY: torch.Tensor):
    """(mean, residual variance a sample) of the control-variate estimator
    over the leading axis: ``X`` (n, ...), ``Y`` (n, ..., k) controls with
    known means ``EY`` (..., k); b = Cov(Y)⁻¹Cov(Y, X) from the sample,
    mean = X̄ − b·(Ȳ − EY), variance Var(X) − Cov(X, Y)·b. A control whose
    variance vanishes is dropped (b = 0)."""
    X, Y = X.to(F64), Y.to(F64)
    n = X.shape[0]
    mX, mY = X.mean(0), Y.mean(0)
    dX, dY = X - mX, Y - mY
    vX = (dX * dX).sum(0) / n
    c = (dY * dX[..., None]).sum(0) / n                      # (..., k)
    C = torch.einsum("n...i,n...j->...ij", dY, dY) / n        # (..., k, k)
    scale = torch.diagonal(C, dim1=-2, dim2=-1)
    keep = scale > 1e-14 * (1.0 + vX[..., None])
    eye = torch.eye(C.shape[-1], dtype=F64, device=C.device)
    mask = keep[..., :, None] & keep[..., None, :]
    Cs = torch.where(mask, C, eye.expand_as(C))
    b = torch.linalg.solve(Cs, torch.where(keep, c, 0.0)[..., None])[..., 0]
    mean = mX - (b * (mY - EY)).sum(-1)
    var = torch.clamp(vX - (c * b).sum(-1), min=0.0)
    return mean, var


def stated_se(var_a_sample, n: float, price):
    """The standard error a call of ``n`` base draws states: the sample's
    residual deviation over √n, floored at ``SE_FLOOR``·(1 + |price|)."""
    return np.maximum(np.sqrt(np.asarray(var_a_sample, np.float64) / n),
                      SE_FLOOR * (1.0 + np.abs(price)))


def price_z(price, se, ref, se_ref) -> float:
    """The widest gap of a price from the reference's, in standard errors
    of their difference."""
    price, se, ref, se_ref = (np.asarray(v, np.float64)
                              for v in (price, se, ref, se_ref))
    z = np.abs(price - ref) / np.hypot(se, se_ref)
    return float(np.nan_to_num(z, nan=np.inf).max())


def se_gap(se, se_expected) -> float:
    """The widest relative gap of a stated standard error from the one
    the reference expects at the same number of draws."""
    se, se_expected = (np.asarray(v, np.float64) for v in (se, se_expected))
    g = np.abs(se / se_expected - 1.0)
    return float(np.nan_to_num(g, nan=np.inf).max())


def generator(device, seed: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(int(seed) % 2**63)
