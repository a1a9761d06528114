"""``models.mc_fused.exotic_price_mc``: the fixed-strike arithmetic Asian
under GBM with the geometric control variate (the path kernel, K4)."""
from __future__ import annotations

import numpy as np


def setup(config: dict, traffic: dict, device):
    from optpricer_tpu_torch.models.mc_fused import exotic_price_mc

    s = traffic["sizes"]

    def call(req):
        price, se = exotic_price_mc(
            "asian", req["S0"], req["K"], req["T"], req["r"], req["q"],
            sigma=req["sigma"], kind=req["kind"], n_steps=s["n_steps"],
            n_paths=s["n_paths"], antithetic=s["antithetic"],
            control_variate=s["control_variate"], average_type="arithmetic",
            strike_type="fixed", seed=req["mc_seed"], device=device)
        return {"price": np.array([price]), "se": np.array([se])}

    return call
