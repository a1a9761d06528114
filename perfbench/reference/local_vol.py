"""Dupire local vol of a configuration's raw SVI slices, plain torch.

w_i(k) = a + b(ρ(k − m) + √((k − m)² + σ²)) per slice, k = ln(S/F(t)),
F(t) = S0·e^{(r−q)t}; total variance linear in T between slices and
w_0·t/T_0, w_n·t/T_n (flat vol) beyond the ends, with ∂w/∂k and ∂²w/∂k²
blended alike. σ_loc follows the configuration's ``local_vol`` statement:
Gatheral's formula with ∂w/∂T a centred difference at dT (t − dT floored
at 1e-8), w floored at 1e-12, numerator 1e-12, denominator 1e-8, σ
clipped to [0.01, 5].

The slices are held to the configuration's market quotes before they are
used: each quote's implied vol √(w(k)/T) at k = ln(K/F(T)) lies within the
surface's ``fit_iv_gap`` of the quoted one.
"""
from __future__ import annotations

import math

import torch


class LocalVol:
    def __init__(self, config: dict):
        m = config["market"]
        sl = sorted(config["surface"]["slices"], key=lambda s: s["T"])
        self.Ts = [float(s["T"]) for s in sl]
        self.P = [tuple(float(s[k]) for k in ("a", "b", "rho", "m", "sigma"))
                  for s in sl]
        self.S0, self.rq = float(m["S0"]), float(m["r"]) - float(m["q"])
        self.dT = float(config["local_vol"]["dT"])
        gap = self.quote_gap(config["quotes"]["slices"])
        if not gap <= config["surface"]["fit_iv_gap"]:
            raise ValueError(f"the SVI slices miss the quotes by {gap!r} "
                             "in implied vol")

    def quote_gap(self, quotes) -> float:
        """The widest gap between a quote's implied vol and the one its
        expiry's slice gives."""
        gap = 0.0
        for qs in quotes:
            T = float(qs["T"])
            i = self.Ts.index(T)
            K = torch.tensor(qs["K"], dtype=torch.float64)
            k = torch.log(K / (self.S0 * math.exp(self.rq * T)))
            iv = torch.sqrt(self._slice(i, k)[0] / T)
            quoted = torch.tensor(qs["iv"], dtype=torch.float64)
            gap = max(gap, float((iv - quoted).abs().max()))
        return gap

    def weights(self, t: float):
        """[(slice, weight)] of the total variance at time t."""
        Ts = self.Ts
        if t <= Ts[0]:
            return [(0, t / Ts[0])]
        if t >= Ts[-1]:
            return [(len(Ts) - 1, t / Ts[-1])]
        i = next(j for j in range(1, len(Ts)) if t <= Ts[j])
        alpha = (t - Ts[i - 1]) / (Ts[i] - Ts[i - 1])
        return [(i - 1, 1.0 - alpha), (i, alpha)]

    def _slice(self, i, k):
        """w, ∂w/∂k, ∂²w/∂k² of slice i at k."""
        a, b, rho, m, sig = self.P[i]
        km = k - m
        root = torch.sqrt(km * km + sig * sig)
        return (a + b * (rho * km + root), b * (rho + km / root),
                b * sig * sig / root ** 3)

    def sigma(self, S: torch.Tensor, t: float) -> torch.Tensor:
        """σ_loc(S, t), in S's dtype."""
        t = max(float(t), 1e-8)
        k = torch.log(S / (self.S0 * math.exp(self.rq * t)))
        slices = {}

        def sl(i):
            if i not in slices:
                slices[i] = self._slice(i, k)
            return slices[i]

        w = dw = d2w = 0.0
        for i, wt in self.weights(t):
            wi, dwi, d2wi = sl(i)
            w, dw, d2w = w + wt * wi, dw + wt * dwi, d2w + wt * d2wi
        w = torch.clamp(w, min=1e-12)
        t_up, t_dn = t + self.dT, max(t - self.dT, 1e-8)
        w_up = sum(wt * sl(i)[0] for i, wt in self.weights(t_up))
        w_dn = sum(wt * sl(i)[0] for i, wt in self.weights(t_dn))
        dwdT = (w_up - w_dn) / (t_up - t_dn)
        kw = k / w
        denom = (1.0 - kw * dw + 0.25 * (-0.25 - 1.0 / w + kw * kw) * dw * dw
                 + 0.5 * d2w)
        s2 = torch.clamp(dwdT, min=1e-12) / torch.clamp(denom, min=1e-8)
        return torch.clamp(torch.sqrt(torch.clamp(s2, min=0.0)), 0.01, 5.0)
