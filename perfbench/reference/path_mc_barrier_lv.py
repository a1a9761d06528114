"""Plain reference of the up-and-out barrier under Dupire local vol by
Milstein (``entries/path_mc_barrier_lv.py``).

Each step from t_j = j·T/n: σ = clip(σ_loc(S, t_j), 1e-8, 10); a(S) =
σ_loc(S, t_j)·S with a′ the central difference at S(1 ± bump) (the lower
point floored at 1e-10); S ← S + (r − q)S·dt + σS√dt·z + ½σS·a′(z² −
1)dt, floored at 1e-10. The barrier is monitored after every step; the
payoff is e^{−rT}(S_T − K)⁺ on paths that never reached it; antithetic
pairs; the control is e^{−rT}S_T with mean S0·e^{−qT}.

The judge prices every sampled (strike, barrier) on one set of
``ref_factor`` times the request's paths.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from .common import (F64, cv_estimate, generator, price_z, se_gap,
                     stated_se)
from .local_vol import LocalVol

CHUNK = 1 << 18          # pairs a block


def _market(req):
    return {k: float(req[k]) for k in ("S0", "T", "r", "q")}


def terminal(config, traffic, m, n_pairs, gen, dtype, device):
    """(S_T, M): (2, n_pairs) float64 terminal spots and running maxima of
    both legs, the paths in ``dtype``."""
    s = traffic["sizes"]
    n_steps, bump = s["n_steps"], s["dS_bump"]
    lv = LocalVol(config)
    dt = m["T"] / n_steps
    sq = math.sqrt(dt)
    rq = m["r"] - m["q"]
    ST = torch.empty((2, n_pairs), dtype=F64, device=device)
    M = torch.empty_like(ST)
    for lo in range(0, n_pairs, CHUNK):
        n = min(CHUNK, n_pairs - lo)
        S = torch.full((2, n), m["S0"], dtype=dtype, device=device)
        top = S.clone()
        for j in range(n_steps):
            z = torch.randn((n,), generator=gen, dtype=dtype, device=device)
            z = torch.stack([z, -z])
            up = S + bump * S
            dn = torch.clamp(S - bump * S, min=1e-10)
            sig, s_up, s_dn = lv.sigma(torch.stack([S, up, dn]), j * dt)
            da = (s_up * up - s_dn * dn) / (up - dn)
            a = torch.clamp(sig, 1e-8, 10.0) * S
            S = torch.clamp(S + rq * S * dt + a * sq * z
                            + 0.5 * a * da * (z * z - 1.0) * dt, min=1e-10)
            top = torch.maximum(top, S)
        ST[:, lo:lo + n] = S.to(F64)
        M[:, lo:lo + n] = top.to(F64)
    return ST, M


def price_contracts(m, ST, M, K, B, block: int = 16):
    """(price, residual variance a pair) at each (strike, barrier)."""
    df = math.exp(-m["r"] * m["T"])
    dev = ST.device
    K = torch.as_tensor(np.asarray(K, np.float64), device=dev)
    B = torch.as_tensor(np.asarray(B, np.float64), device=dev)
    Y = 0.5 * df * ST.sum(0)
    EY = torch.tensor([m["S0"] * math.exp(-m["q"] * m["T"])], dtype=F64,
                      device=dev)
    means, varis = [], []
    for lo in range(0, len(K), block):
        k, b = K[lo:lo + block], B[lo:lo + block]
        alive = (M[:, :, None] < b).to(F64)
        X = 0.5 * df * (torch.clamp(ST[:, :, None] - k, min=0.0)
                        * alive).sum(0)
        Yb = Y[:, None, None].expand(-1, len(k), 1)
        mean, var = cv_estimate(X, Yb, EY.expand(len(k), 1))
        means.append(mean)
        varis.append(var)
    return torch.cat(means).cpu().numpy(), torch.cat(varis).cpu().numpy()


def judge(config, traffic, samples, *, device, seed, ref_factor=4, **_):
    n = traffic["sizes"]["n_paths"]
    m = _market(samples[0][0])
    ST, M = terminal(config, traffic, m, ref_factor * n,
                     generator(device, seed), F64, device)
    ref, var = price_contracts(m, ST, M, [r["K"] for r, _ in samples],
                               [r["barrier"] for r, _ in samples])
    price = np.concatenate([out["price"] for _, out in samples])
    se = np.concatenate([out["se"] for _, out in samples])
    return {"price_z": price_z(price, se, ref,
                               np.sqrt(var / (ref_factor * n))),
            "se_gap": se_gap(se, stated_se(var, n, ref))}


def control(config, traffic, requests, *, device, seed, dtype):
    n = traffic["sizes"]["n_paths"]
    out = []
    for i, req in enumerate(requests):
        m = _market(req)
        ST, M = terminal(config, traffic, m, n, generator(device, seed + i),
                         dtype, device)
        price, var = price_contracts(m, ST, M, [req["K"]], [req["barrier"]])
        out.append({"price": price, "se": stated_se(var, n, price)})
    return out
