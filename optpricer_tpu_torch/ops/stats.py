"""Sufficient-statistics layouts, compensated reductions and host estimators.

Counterpart of ``optpricer_tpu/ops/stats.py``. Every Monte-Carlo engine
returns only sufficient statistics, so aggregation is exact, associative
and layout-independent; cross-chunk sums are Kahan-compensated so float32
holds the 1e-4 price gate at billions of paths. The host estimators are
float64 numpy, as in the JAX package; ``sumstats`` and ``cv_mean_se`` are
their traced counterparts, tensors in and out on the caller's device with
no host sync.
"""
from __future__ import annotations

import numpy as np
import torch

# Layout of the single-CV stats vector (n, ΣX, ΣX², ΣY, ΣY², ΣXY)
N, SX, SX2, SY, SY2, SXY = range(6)
STATS_DIM = 6

# Dual-control-variate layout:
# (n, ΣX, ΣX², ΣY1, ΣY1², ΣXY1, ΣY2, ΣY2², ΣXY2, ΣY1Y2)
STATS2_DIM = 10

# Greek-moment extension: (ΣXz, ΣXz², ΣY2z) appended to the dual-CV layout;
# with it every first-order GBM Greek and the LR gamma are linear in the 13
# expectations (ops.terminal_mc.terminal_greeks).
SXZ, SXZ2, SY2Z = 10, 11, 12
STATSG_DIM = 13


def sumstats(X: torch.Tensor, Y: torch.Tensor,
             weight: torch.Tensor | None = None) -> torch.Tensor:
    """Sufficient statistics (6,) of payoff X and control variate Y, on X's
    device and in X's dtype.

    ``weight`` is an optional 0/1 mask (tail-chunk masking) broadcast to X:
    n is its sum, and X and Y enter weighted.
    """
    Y = Y.to(X.dtype)
    if weight is None:
        n = torch.full((), X.numel(), dtype=X.dtype, device=X.device)
        WX, WY = X, Y
    else:
        w = weight.to(X.dtype)
        n = w.sum()
        WX, WY = X * w, Y * w
    return torch.stack([n, WX.sum(), (WX * X).sum(), WY.sum(),
                        (WY * Y).sum(), (WX * Y).sum()])


def kahan_add(acc, comp, x):
    """One compensated (Kahan) accumulation step; acc/comp/x broadcast."""
    y = x - comp
    t = acc + y
    comp = (t - acc) - y
    return t, comp


def combine_scan(stats_seq: torch.Tensor) -> torch.Tensor:
    """Deterministic compensated reduction of an (n_chunks, d) stats tensor:
    a Kahan loop over the rows in their fixed order, in the rows' dtype, so
    the result does not depend on how the chunks were produced."""
    acc = torch.zeros(stats_seq.shape[-1], dtype=stats_seq.dtype,
                      device=stats_seq.device)
    comp = torch.zeros_like(acc)
    for row in stats_seq:
        acc, comp = kahan_add(acc, comp, row)
    return acc


def mean_se(stats):
    """Plain estimator: (mean, stderr) from a stats vector, host float64."""
    s = np.asarray(stats, np.float64)
    n = s[N]
    mean = s[SX] / n
    var = max(0.0, s[SX2] / n - mean * mean)
    return float(mean), float(np.sqrt(var / n))


def cv2_mean_se(stats, EY1: float, EY2: float):
    """Two-variable control-variate estimator with known means.

    β = Cov(Y,Y)⁻¹ Cov(Y,X); mean = m_X − βᵀ(m_Y − EY);
    Var = Var(X) − Cov(Y,X)ᵀβ (optimal-β variance). Host-side float64.
    """
    s = np.asarray(stats, np.float64)
    n = s[0]
    mX = s[1] / n
    vX = max(0.0, s[2] / n - mX * mX)
    m1, m2 = s[3] / n, s[6] / n
    v11 = max(0.0, s[4] / n - m1 * m1)
    v22 = max(0.0, s[7] / n - m2 * m2)
    c1X = s[5] / n - m1 * mX
    c2X = s[8] / n - m2 * mX
    c12 = s[9] / n - m1 * m2
    C = np.array([[v11, c12], [c12, v22]])
    b = np.array([c1X, c2X])
    try:
        beta = np.linalg.solve(C + 1e-18 * np.eye(2), b)
    except np.linalg.LinAlgError:
        beta = np.zeros(2)
    mean = mX - beta[0] * (m1 - EY1) - beta[1] * (m2 - EY2)
    var = max(0.0, vX - float(b @ beta))
    return float(mean), float(np.sqrt(var / n))


def cv_mean_se_np(stats, EY: float):
    """Host float64 single-CV estimator."""
    s = np.asarray(stats, np.float64)
    n = s[N]
    meanX = s[SX] / n
    varX = max(0.0, s[SX2] / n - meanX * meanX)
    meanY = s[SY] / n
    varY = max(0.0, s[SY2] / n - meanY * meanY)
    covXY = s[SXY] / n - meanX * meanY
    c_hat = 0.0 if varY == 0.0 else covXY / varY
    mean = meanX - c_hat * (meanY - float(EY))
    var = max(0.0, varX - 2.0 * c_hat * covXY + c_hat * c_hat * varY)
    return float(mean), float(np.sqrt(var / n))


def cv_mean_se(stats: torch.Tensor, EY):
    """Control-variate estimator with known E[Y], traced: (mean, stderr) as
    0-d tensors on the stats' device.

    ĉ = Cov(X,Y)/Var(Y); mean_cv = mean(X) − ĉ(mean(Y) − EY);
    Var_cv = Var(X) − 2ĉCov + ĉ²Var(Y). At Var(Y) = 0 the double ``where``
    gives ĉ = 0 exactly and a finite tangent. ``EY`` is a float or a tensor.
    """
    if isinstance(EY, torch.Tensor):
        EY = EY.to(stats.dtype)
    zero = torch.zeros((), dtype=stats.dtype, device=stats.device)
    n = stats[N]
    meanX = stats[SX] / n
    varX = torch.maximum(zero, stats[SX2] / n - meanX * meanX)
    meanY = stats[SY] / n
    varY = torch.maximum(zero, stats[SY2] / n - meanY * meanY)
    covXY = stats[SXY] / n - meanX * meanY
    flat = varY == 0.0
    c_hat = torch.where(flat, 0.0, covXY / torch.where(flat, 1.0, varY))
    mean_cv = meanX - c_hat * (meanY - EY)
    var_cv = torch.maximum(zero, varX - 2.0 * c_hat * covXY
                           + c_hat * c_hat * varY)
    return mean_cv, torch.sqrt(var_cv / n)
