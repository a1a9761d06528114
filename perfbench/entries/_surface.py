"""The program's local-vol surface built from a configuration's stated
SVI slices and forward curve."""
from __future__ import annotations

import math


def program_surface(config: dict, device):
    from optpricer_tpu_torch.models.calibration import SVIParams, VolSurface

    m = config["market"]
    slices, forwards = {}, {}
    for s in config["surface"]["slices"]:
        T = float(s["T"])
        slices[T] = SVIParams(a=s["a"], b=s["b"], rho=s["rho"], m=s["m"],
                              sigma=s["sigma"], expiry=T)
        forwards[T] = m["S0"] * math.exp((m["r"] - m["q"]) * T)
    return VolSurface(slices, forward_curve=forwards, device=device)
