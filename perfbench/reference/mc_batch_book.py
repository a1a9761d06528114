"""Plain reference of a European book by terminal Monte Carlo with
antithetic pairs and the dual control variate (``entries/mc_batch_book.py``).

Each contract's price is Black-Scholes. The standard error a call states
is that of the dual-CV estimator on n pair averages: X = e^{−rT}·½(f(S(z))
+ f(S(−z))), controls Y1 = e^{−rT}·½(S(z) + S(−z)) and Y2 the discounted
pair average of the in-the-money indicator, S(z) = S0·e^{(r−q−σ²/2)T +
σ√T z}. Its residual variance Var(X) − Cov(X, Y)ᵀCov(Y)⁻¹Cov(X, Y) is a
one-dimensional Gaussian integral in z, taken here by the trapezoid rule
on ``GRID`` points over |z| ≤ ``Z_MAX``.

The standard errors are compared by the widest gap over the contracts
whose in-the-money indicator the n draws resolve: p(1 − p)·n of at least
``min_itm_draws`` (a judge setting), p the reference's probability of
finishing in the money. Where fewer draws land on one side, the digital
control and the payoff's variance rest on a handful of draws, and the
stated standard error swings from seed to seed by its own sampling error,
not by a fault. Every contract's price counts.
"""
from __future__ import annotations


import numpy as np
import torch

from .common import (F64, black, cv_estimate, generator, ncdf, price_z,
                     se_gap, stated_se)

Z_MAX = 9.0
GRID = 36001


def _columns(req, device):
    c = {k: torch.as_tensor(np.broadcast_to(np.asarray(req[k], np.float64),
                                            np.shape(req["K"])).copy(),
                            dtype=F64, device=device)
         for k in ("S0", "K", "T", "r", "q", "sigma")}
    c["is_call"] = torch.as_tensor(np.asarray(req["kind"]) == "call",
                                   device=device)
    return c


def bs_prices(c):
    F = c["S0"] * torch.exp((c["r"] - c["q"]) * c["T"])
    return black(F, c["K"], torch.exp(-c["r"] * c["T"]),
                 c["sigma"] * torch.sqrt(c["T"]), c["is_call"])


def _pair_values(c, z, dtype):
    """X, Y (…, k = 2) of the pair average at base draws ``z`` (broadcast
    against the contracts on the last axis), in ``dtype``."""
    col = {k: v.to(dtype) for k, v in c.items() if k != "is_call"}
    sign = torch.where(c["is_call"], 1.0, -1.0).to(dtype)
    df = torch.exp(-col["r"] * col["T"])
    mu = (col["r"] - col["q"] - 0.5 * col["sigma"] ** 2) * col["T"]
    sd = col["sigma"] * torch.sqrt(col["T"])
    X = Y1 = Y2 = 0.0
    for leg in (z, -z):
        S = col["S0"] * torch.exp(mu + sd * leg)
        X = X + torch.clamp(sign * (S - col["K"]), min=0.0)
        Y1 = Y1 + S
        Y2 = Y2 + (sign * (S - col["K"]) > 0.0).to(dtype)
    half = 0.5 * df
    return half * X, torch.stack([half * Y1, half * Y2], dim=-1)


def residual_variance(c, block: int = 64):
    """Each contract's dual-CV residual variance a pair, by quadrature."""
    dev = c["K"].device
    z = torch.linspace(-Z_MAX, Z_MAX, GRID, dtype=F64, device=dev)
    w = torch.exp(-0.5 * z * z)
    w = (w / w.sum())[:, None]
    out = []
    for lo in range(0, c["K"].shape[0], block):
        sub = {k: v[lo:lo + block] for k, v in c.items()}
        X, Y = _pair_values(sub, z[:, None], F64)
        mX, mY = (w * X).sum(0), (w[..., None] * Y).sum(0)
        dX, dY = X - mX, Y - mY
        vX = (w * dX * dX).sum(0)
        cv = (w[..., None] * dY * dX[..., None]).sum(0)
        C = torch.einsum("n,nbi,nbj->bij", w[:, 0], dY, dY)
        # an indicator with no variance left out: the spot control alone
        one = torch.clamp(vX - cv[:, 0] ** 2 / C[:, 0, 0], min=0.0)
        ok = C[:, 1, 1] > 0.0
        Cs = torch.where(ok[:, None, None], C,
                         torch.eye(2, dtype=F64, device=dev))
        b = torch.linalg.solve(Cs, cv[..., None])[..., 0]
        two = torch.clamp(vX - (cv * b).sum(-1), min=0.0)
        out.append(torch.where(ok, two, one))
    return torch.cat(out).cpu().numpy()


def resolved(c, n: float, min_itm_draws: float):
    """The contracts whose in-the-money indicator n draws resolve:
    p(1 − p)·n ≥ ``min_itm_draws``."""
    sd = c["sigma"] * torch.sqrt(c["T"])
    d2 = (torch.log(c["S0"] / c["K"]) + (c["r"] - c["q"]) * c["T"]) / sd \
        - 0.5 * sd
    p = ncdf(torch.where(c["is_call"], d2, -d2))
    return (p * (1.0 - p) * n >= min_itm_draws).cpu().numpy()


def judge(config, traffic, samples, *, device, min_itm_draws, **_):
    n = traffic["sizes"]["n_paths"]
    price, se, ref, se_exp, keep = [], [], [], [], []
    for req, out in samples:
        c = _columns(req, device)
        r = bs_prices(c).cpu().numpy()
        price.append(out["price"])
        se.append(out["se"])
        ref.append(r)
        se_exp.append(stated_se(residual_variance(c), n, r))
        keep.append(resolved(c, n, min_itm_draws))
    price, se, ref, se_exp, keep = map(np.concatenate,
                                       (price, se, ref, se_exp, keep))
    return {"price_z": price_z(price, se, ref, np.zeros_like(ref)),
            "se_gap": se_gap(se[keep], se_exp[keep])}


def control(config, traffic, requests, *, device, seed, dtype,
            block: int = 8):
    n = traffic["sizes"]["n_paths"]
    out = []
    for i, req in enumerate(requests):
        c = _columns(req, device)
        gen = generator(device, seed + i)
        price, var = [], []
        for lo in range(0, c["K"].shape[0], block):
            sub = {k: v[lo:lo + block] for k, v in c.items()}
            z = torch.randn((n, 1), generator=gen, dtype=dtype, device=device)
            X, Y = _pair_values(sub, z, dtype)
            EY = torch.stack([sub["S0"] * torch.exp(-sub["q"] * sub["T"]),
                              bs_digital(sub)], dim=-1)
            p, v = cv_estimate(X, Y, EY)
            price.append(p.cpu().numpy())
            var.append(v.cpu().numpy())
        price = np.concatenate(price)
        out.append({"price": price,
                    "se": stated_se(np.concatenate(var), n, price)})
    return out


def bs_digital(c):
    """Discounted probability of finishing in the money."""
    sd = c["sigma"] * torch.sqrt(c["T"])
    d2 = (torch.log(c["S0"] / c["K"]) + (c["r"] - c["q"]) * c["T"]) / sd \
        - 0.5 * sd
    return torch.exp(-c["r"] * c["T"]) * torch.special.ndtr(
        torch.where(c["is_call"], d2, -d2))
