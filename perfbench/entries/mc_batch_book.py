"""``ops.mc_batch.euro_price_mc_batch``: a heterogeneous European book by
terminal Monte Carlo with the dual control variate (the book kernel,
K3)."""
from __future__ import annotations

import numpy as np


def setup(config: dict, traffic: dict, device):
    from optpricer_tpu_torch.ops.mc_batch import euro_price_mc_batch

    s = traffic["sizes"]

    def call(req):
        price, se = euro_price_mc_batch(
            req["S0"], req["K"], req["T"], req["r"], req["q"], req["sigma"],
            list(req["kind"]), n_paths=s["n_paths"], seed=req["mc_seed"],
            antithetic=s["antithetic"], control_variate=s["control_variate"],
            device=device)
        return {"price": np.asarray(price, np.float64),
                "se": np.asarray(se, np.float64)}

    return call
