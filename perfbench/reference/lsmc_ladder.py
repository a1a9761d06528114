"""Plain reference of the American put ladder by Longstaff-Schwartz
(``entries/lsmc_ladder.py``), as Longstaff and Schwartz (2001, §3) price
the American put.

Paths are exact GBM steps on the n_steps grid t_i = i·T/n, drawn in
antithetic pairs by ``torch.randn`` from the reference's own seed, from a
unit spot: S = S0·P, so one path set serves every request's spot. Going
back from maturity, at each date t_i (i = n − 1 … 1) the discounted
cashflow y = e^{−rΔt}·c is regressed, over the paths where the put is in
the money, on the basis [1, x, x², x³], x = S_t/S0 − 1; the normal
equations are normalised by the in-the-money count, with a ridge of 1e-7
on their diagonal; a path where the intrinsic value beats the fitted
continuation exercises (c = intrinsic), the others carry y. The price is
max(mean of e^{−rΔt}·c over the paths, intrinsic at t = 0), and the
cashflow's deviation a path is the sample deviation of the same values.

The judge prices each sampled request's strikes at its spot on one path
set of ``ref_factor`` times the request's paths, in float64, ``CHUNK``
strikes at a time (each strike's regressions are its own, so the chunks
change nothing), and compares

* ``price_z``: each price with the reference's, in standard errors of
  their difference, over every strike;
* ``se_gap``: each stated standard error with the reference's cashflow
  deviation over √n at the request's n paths, over the strikes whose
  price is above the immediate-exercise floor (by the reference) and on
  which at least ``min_itm_draws`` of the request's n paths pay (a judge
  setting, by the reference's share of paths that pay). A floored price
  is the intrinsic value and has no error; a cashflow that a handful of
  paths carry has a deviation that swings from seed to seed by its own
  sampling error, not by a fault.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from .common import F64, generator, price_z, se_gap

RIDGE = 1e-7
CHUNK = 64        # strikes a backward pass


def _market(req) -> dict:
    return {k: float(req[k]) for k in ("T", "r", "q", "sigma")}


def n_of(sizes) -> int:
    """Paths a call of these sizes runs: its base draws, doubled by the
    antithetic mirror."""
    return int(sizes["n_paths"]) * (2 if sizes["antithetic"] else 1)


def unit_paths(m: dict, n_steps: int, n_base: int, gen, dtype, device,
               antithetic: bool = True):
    """(n_steps + 1, paths) exact GBM paths from a spot of 1: ``n_base``
    draws a step, followed by their mirrors where ``antithetic``."""
    dt = m["T"] / n_steps
    z = torch.randn((n_steps, n_base), generator=gen, dtype=dtype,
                    device=device)
    if antithetic:
        z = torch.cat([z, -z], dim=1)
    drift = torch.tensor((m["r"] - m["q"] - 0.5 * m["sigma"] ** 2) * dt,
                         dtype=dtype, device=device)
    vol = torch.tensor(m["sigma"] * math.sqrt(dt), dtype=dtype,
                       device=device)
    P = torch.exp(torch.cumsum(drift + vol * z, dim=0))
    return torch.cat([torch.ones_like(P[:1]), P], dim=0)


def _solve(A, b):
    """β of the ridge-regularised normal equations; a dtype with no
    solver (bfloat16) is solved in float32."""
    work = A.dtype if A.dtype in (torch.float32, F64) else torch.float32
    eye = torch.eye(A.shape[-1], dtype=work, device=A.device)
    beta = torch.linalg.solve(A.to(work) + RIDGE * eye,
                              b.to(work)[..., None])[..., 0]
    return beta.to(A.dtype)


def lsmc(P, S0: float, K, m: dict, basis_dim: int):
    """(price, cashflow deviation a path, share of paths that pay) of the
    puts at strikes ``K`` (1-d tensor, ``P``'s dtype) on unit paths ``P``
    at spot ``S0``, in ``P``'s dtype."""
    dtype, dev = P.dtype, P.device
    n_dates = P.shape[0] - 1
    n = P.shape[1]
    disc = torch.exp(torch.tensor(-m["r"] * m["T"] / n_dates, dtype=dtype,
                                  device=dev))
    S = S0 * P
    X = [torch.stack([(P[t] - 1.0) ** p for p in range(basis_dim)], dim=-1)
         for t in range(n_dates)]
    k = basis_dim
    out = []
    for lo in range(0, K.shape[0], CHUNK):
        Kc = K[lo:lo + CHUNK, None]
        cash = torch.clamp(Kc - S[-1], min=0.0)
        for t in range(n_dates - 1, 0, -1):
            y = disc * cash
            ex = torch.clamp(Kc - S[t], min=0.0)
            itm = ex > 0.0
            w = itm.to(dtype)
            count = torch.clamp(w.sum(1), min=1.0)
            XX = (X[t][:, :, None] * X[t][:, None, :]).reshape(n, k * k)
            A = (w @ XX).reshape(-1, k, k) / count[:, None, None]
            b = ((w * y) @ X[t]) / count[:, None]
            fitted = _solve(A, b) @ X[t].T
            cash = torch.where(itm & (ex > fitted), ex, y)
        value = disc * cash
        mean = value.mean(1)
        dev_ = torch.sqrt(((value - mean[:, None]) ** 2).sum(1) / (n - 1))
        pays = (value > 0.0).to(dtype).mean(1)
        floor = torch.clamp(Kc[:, 0] - S0, min=0.0)
        out.append(torch.stack([torch.maximum(mean, floor), dev_, pays]))
    return torch.cat(out, dim=1).to(F64).cpu().numpy()


def judge(config, traffic, samples, *, device, seed, ref_factor=2,
          min_itm_draws=3000, **_):
    s = traffic["sizes"]
    m = _market(samples[0][0])
    n = n_of(s)
    P = unit_paths(m, s["n_steps"], ref_factor * s["n_paths"],
                   generator(device, seed), F64, device, s["antithetic"])
    n_ref = P.shape[1]
    price, se, ref, se_ref, se_exp, keep = ([] for _ in range(6))
    for req, out in samples:
        K = torch.as_tensor(np.asarray(req["K"], np.float64), dtype=F64,
                            device=device)
        r_price, r_dev, r_pays = lsmc(P, float(req["S0"]), K, m,
                                      s["basis_dim"])
        floor = np.maximum(np.asarray(req["K"], np.float64) - req["S0"], 0.0)
        price.append(out["price"])
        se.append(out["se"])
        ref.append(r_price)
        se_ref.append(r_dev / math.sqrt(n_ref))
        se_exp.append(r_dev / math.sqrt(n))
        keep.append((r_price > floor) & (r_pays * n >= min_itm_draws))
    price, se, ref, se_ref, se_exp, keep = map(
        np.concatenate, (price, se, ref, se_ref, se_exp, keep))
    return {"price_z": price_z(price, se, ref, se_ref),
            "se_gap": se_gap(se[keep], se_exp[keep]) if keep.any()
            else float("inf")}


def control(config, traffic, requests, *, device, seed, dtype):
    s = traffic["sizes"]
    out = []
    for i, req in enumerate(requests):
        m = _market(req)
        P = unit_paths(m, s["n_steps"], s["n_paths"],
                       generator(device, seed + i), dtype, device,
                       s["antithetic"])
        K = torch.as_tensor(np.asarray(req["K"], np.float64), dtype=dtype,
                            device=device)
        price, dev_, _ = lsmc(P, float(req["S0"]), K, m, s["basis_dim"])
        out.append({"price": price, "se": dev_ / math.sqrt(P.shape[1])})
    return out
