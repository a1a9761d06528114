"""``models.american_mc.lsmc_ladder``: an American put ladder by
Longstaff-Schwartz on one path matrix, each strike's price with its
standard error (the LSMC date loop: matmuls, a batched solve and
elementwise passes a date)."""
from __future__ import annotations


def setup(config: dict, traffic: dict, device):
    from optpricer_tpu_torch.models.american_mc import lsmc_ladder

    s = traffic["sizes"]

    def call(req):
        price, se = lsmc_ladder(
            req["S0"], req["K"], req["T"], req["r"], req["q"], req["sigma"],
            list(req["kind"]), n_paths=s["n_paths"], n_steps=s["n_steps"],
            basis_dim=s["basis_dim"], antithetic=s["antithetic"],
            seed=req["mc_seed"], dtype=s["dtype"], device=device)
        return {"price": price, "se": se}

    return call
