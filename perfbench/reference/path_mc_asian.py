"""Plain reference of the fixed-strike arithmetic Asian under GBM with the
geometric-Asian control variate (``entries/path_mc_asian.py``).

Paths are exact GBM steps on the n_steps grid t_i = i·T/n (i = 1..n, t = 0
not averaged), drawn in antithetic pairs by ``torch.randn``; the discount
is e^{−rT}. The control is the geometric average's payoff, whose mean is
the closed form: ln G is normal with mean ln S0 + c·T(n+1)/(2n), c = r −
q − σ²/2, and variance σ²T(n+1)(2n+1)/(6n²).

The judge prices every sampled strike on one set of ``ref_factor`` times
the request's paths and compares each request's price with it in
standard errors of the difference, and each stated standard error with
the one the reference's residual variance gives at the request's paths.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from .common import (F64, black, cv_estimate, generator, price_z, se_gap,
                     stated_se)

CHUNK = 1 << 17          # pairs a block of draws


def _market(req):
    return {k: float(req[k]) for k in ("S0", "T", "r", "q", "sigma")}


def averages(m: dict, n_steps: int, n_pairs: int, gen, dtype, device):
    """(A, G): (2, n_pairs) float64 arithmetic and geometric averages of
    the two legs of each antithetic pair, the paths in ``dtype``."""
    dt = m["T"] / n_steps
    mu = (m["r"] - m["q"] - 0.5 * m["sigma"] ** 2) * dt
    sig = m["sigma"] * math.sqrt(dt)
    A = torch.empty((2, n_pairs), dtype=F64, device=device)
    G = torch.empty_like(A)
    for lo in range(0, n_pairs, CHUNK):
        n = min(CHUNK, n_pairs - lo)
        z = torch.randn((n, n_steps), generator=gen, dtype=dtype,
                        device=device)
        for leg, sign in enumerate((1.0, -1.0)):
            log_s = math.log(m["S0"]) + torch.cumsum(mu + (sign * sig) * z,
                                                     dim=1)
            A[leg, lo:lo + n] = torch.exp(log_s).mean(dim=1).to(F64)
            G[leg, lo:lo + n] = torch.exp(log_s.mean(dim=1)).to(F64)
    return A, G


def geometric_price(m: dict, n_steps: int, K):
    """Closed-form fixed-strike geometric Asian call price at strikes K."""
    n = float(n_steps)
    c = m["r"] - m["q"] - 0.5 * m["sigma"] ** 2
    mu_g = math.log(m["S0"]) + c * m["T"] * (n + 1.0) / (2.0 * n)
    sd = m["sigma"] * math.sqrt(m["T"] * (n + 1.0) * (2.0 * n + 1.0)
                                / (6.0 * n * n))
    K = torch.as_tensor(K, dtype=F64)
    F = torch.full_like(K, math.exp(mu_g + 0.5 * sd * sd))
    return black(F, K, math.exp(-m["r"] * m["T"]), torch.full_like(K, sd),
                 torch.ones_like(K, dtype=torch.bool))


def price_strikes(m: dict, n_steps: int, A, G, K, block: int = 16):
    """(price, residual variance a pair) of the CV estimator at each strike
    of ``K`` on the averages ``A``, ``G``."""
    df = math.exp(-m["r"] * m["T"])
    EY = geometric_price(m, n_steps, K).to(A.device)
    K = torch.as_tensor(np.asarray(K, np.float64), device=A.device)
    means, varis = [], []
    for lo in range(0, len(K), block):
        k = K[lo:lo + block]
        X = 0.5 * df * torch.clamp(A[:, :, None] - k, min=0.0).sum(0)
        Y = 0.5 * df * torch.clamp(G[:, :, None] - k, min=0.0).sum(0)
        mean, var = cv_estimate(X, Y[..., None], EY[lo:lo + block, None])
        means.append(mean)
        varis.append(var)
    return torch.cat(means).cpu().numpy(), torch.cat(varis).cpu().numpy()


def judge(config, traffic, samples, *, device, seed, ref_factor=2, **_):
    s = traffic["sizes"]
    m = _market(samples[0][0])
    n = s["n_paths"]
    A, G = averages(m, s["n_steps"], ref_factor * n,
                    generator(device, seed), F64, device)
    K = [req["K"] for req, _ in samples]
    ref, var = price_strikes(m, s["n_steps"], A, G, K)
    price = np.concatenate([out["price"] for _, out in samples])
    se = np.concatenate([out["se"] for _, out in samples])
    return {"price_z": price_z(price, se, ref,
                               np.sqrt(var / (ref_factor * n))),
            "se_gap": se_gap(se, stated_se(var, n, ref))}


def control(config, traffic, requests, *, device, seed, dtype):
    s = traffic["sizes"]
    out = []
    for i, req in enumerate(requests):
        m = _market(req)
        A, G = averages(m, s["n_steps"], s["n_paths"],
                        generator(device, seed + i), dtype, device)
        price, var = price_strikes(m, s["n_steps"], A, G, [req["K"]])
        out.append({"price": price, "se": stated_se(var, s["n_paths"],
                                                    price)})
    return out
