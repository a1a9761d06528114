"""``models.mc_fused.exotic_price_mc_dupire``: an up-and-out barrier on the
configuration's SVI surface by Milstein (the path kernel's lv_milstein
branch, K4)."""
from __future__ import annotations

import numpy as np

from ._surface import program_surface


def setup(config: dict, traffic: dict, device):
    from optpricer_tpu_torch.models.mc_fused import exotic_price_mc_dupire

    s = traffic["sizes"]
    surface = program_surface(config, device)

    def call(req):
        price, se = exotic_price_mc_dupire(
            "barrier", surface, req["S0"], req["K"], req["T"], req["r"],
            req["q"], scheme=s["scheme"], control_variate=s["control_variate"],
            kind=req["kind"], n_steps=s["n_steps"], n_paths=s["n_paths"],
            antithetic=s["antithetic"], barrier=req["barrier"],
            barrier_type=req["barrier_type"], dS_bump=s["dS_bump"],
            seed=req["mc_seed"], device=device)
        return {"price": np.array([price]), "se": np.array([se])}

    return call
