"""Path-dependent exotic payoffs over pre-generated paths.

Counterpart of ``optpricer_tpu/models/exotics.py``: every function takes a
path tensor of shape ``(n_steps+1, n_paths_eff)`` with its t=0 row (from
``models/processes.py``, on any device) and returns ``(price, stderr)``
with the ddof=1 convention. The payoff is a reduction over the path matrix
on the matrix's device; only the two results come back to the host.
"""
from __future__ import annotations

import math

import torch

__all__ = ["barrier_price", "asian_price", "digital_price", "lookback_price",
           "double_barrier_price"]

_VALID_BARRIERS = {"up-and-out", "up-and-in", "down-and-out", "down-and-in"}


def _check_kind(kind: str):
    if kind not in ("call", "put"):
        raise ValueError("kind must be 'call' or 'put'")


def _paths(paths) -> torch.Tensor:
    if isinstance(paths, torch.Tensor):
        return paths
    return torch.as_tensor(paths, dtype=torch.float64)


def _mean_se(X: torch.Tensor):
    """(mean, stderr) with ddof=1."""
    n = X.numel()
    mean = torch.mean(X)
    var = torch.sum((X - mean) ** 2) / (n - 1)
    return mean, torch.sqrt(var / n)


def _price_from_payoff(payoff: torch.Tensor, r, T):
    X = math.exp(-float(r) * float(T)) * payoff
    mean, se = _mean_se(X)
    return float(mean), float(se)


def _vanilla(ST, K, kind):
    return torch.clamp(ST - K, min=0.0) if kind == "call" \
        else torch.clamp(K - ST, min=0.0)


def _where(cond, a, b, like):
    """``where`` with float branches broadcast to ``like``'s dtype."""
    a = torch.as_tensor(a, dtype=like.dtype, device=like.device)
    b = torch.as_tensor(b, dtype=like.dtype, device=like.device)
    return torch.where(cond, a, b)


def barrier_price(paths, K, r, T, kind, barrier, barrier_type,
                  rebate: float = 0.0):
    """European barrier option, discrete monitoring over the paths."""
    if barrier_type not in _VALID_BARRIERS:
        raise ValueError(
            f"barrier_type must be one of {_VALID_BARRIERS}, got "
            f"{barrier_type!r}")
    _check_kind(kind)
    paths = _paths(paths)
    ST = paths[-1, :]
    if barrier_type.startswith("up"):
        crossed = torch.any(paths >= barrier, dim=0)
    else:
        crossed = torch.any(paths <= barrier, dim=0)
    vanilla = _vanilla(ST, K, kind)
    if barrier_type.endswith("out"):
        payoff = _where(crossed, rebate, vanilla, ST)
    else:
        payoff = _where(crossed, vanilla, rebate, ST)
    return _price_from_payoff(payoff, r, T)


def asian_price(paths, K, r, T, kind, average_type: str = "arithmetic",
                strike_type: str = "fixed"):
    """European Asian option; the t=0 row is left out of the average."""
    _check_kind(kind)
    if average_type not in ("arithmetic", "geometric"):
        raise ValueError("average_type must be 'arithmetic' or 'geometric'")
    if strike_type not in ("fixed", "floating"):
        raise ValueError("strike_type must be 'fixed' or 'floating'")
    paths = _paths(paths)
    monitoring = paths[1:, :]
    ST = paths[-1, :]
    if average_type == "arithmetic":
        avg = torch.mean(monitoring, dim=0)
    else:
        avg = torch.exp(torch.mean(torch.log(monitoring), dim=0))
    if strike_type == "fixed":
        payoff = _vanilla(avg, K, kind)
    else:
        payoff = (torch.clamp(ST - avg, min=0.0) if kind == "call"
                  else torch.clamp(avg - ST, min=0.0))
    return _price_from_payoff(payoff, r, T)


def digital_price(paths, K, r, T, kind, payout: float = 1.0):
    """Cash-or-nothing digital."""
    _check_kind(kind)
    paths = _paths(paths)
    ST = paths[-1, :]
    itm = (ST > K) if kind == "call" else (ST < K)
    return _price_from_payoff(_where(itm, payout, 0.0, ST), r, T)


def lookback_price(paths, r, T, kind, K: float = 0.0,
                   strike_type: str = "floating"):
    """Lookback option via path max/min. Floating call: S_T − S_min;
    floating put: S_max − S_T; fixed call: max(S_max − K, 0); fixed put:
    max(K − S_min, 0)."""
    _check_kind(kind)
    if strike_type not in ("floating", "fixed"):
        raise ValueError("strike_type must be 'floating' or 'fixed'")
    paths = _paths(paths)
    S_max = torch.amax(paths, dim=0)
    S_min = torch.amin(paths, dim=0)
    ST = paths[-1, :]
    if strike_type == "floating":
        payoff = (ST - S_min) if kind == "call" else (S_max - ST)
    else:
        payoff = (torch.clamp(S_max - K, min=0.0) if kind == "call"
                  else torch.clamp(K - S_min, min=0.0))
    return _price_from_payoff(payoff, r, T)


def double_barrier_price(paths, K, r, T, kind, lower, upper,
                         knock: str = "out", rebate: float = 0.0):
    """European double-barrier option, discrete monitoring: knocked if the
    path ever leaves the corridor ``(lower, upper)``; ``knock="out"`` pays
    the vanilla on surviving paths (the rebate otherwise), ``"in"`` the
    reverse."""
    _check_kind(kind)
    if knock not in ("in", "out"):
        raise ValueError("knock must be 'in' or 'out'")
    if not lower < upper:
        raise ValueError("need lower < upper")
    paths = _paths(paths)
    ST = paths[-1, :]
    crossed = torch.any((paths >= upper) | (paths <= lower), dim=0)
    vanilla = _vanilla(ST, K, kind)
    if knock == "out":
        payoff = _where(crossed, rebate, vanilla, ST)
    else:
        payoff = _where(crossed, vanilla, rebate, ST)
    return _price_from_payoff(payoff, r, T)
