"""Least work of the GBM path Monte Carlo (the fixed-strike arithmetic
Asian with the geometric control variate). A frozen copy of
``chip_smoke.py``'s ``ops_k4_path_step``."""


def ops_k4_path_step(antithetic: bool, greeks: bool) -> float:
    """Per path and step: half a Threefry block (40) and half a Box-Muller
    pair (25) per step, and per state the log-spot step (an FMA and an add,
    3), an exp32 for the arithmetic sum (22), the running sum and the
    running log-sum (one add each, 2) and, with Greek moments, the Brownian
    path and two accumulators (an FMA each, 6)."""
    per_state = 3 + 22 + 2 + (6 if greeks else 0)
    return 65 + per_state * (2 if antithetic else 1)


def least_work(config: dict, traffic: dict, request: dict):
    """(operations, bytes) of one request: every path and step; the seed,
    the parameters and the 21 sums (8 + 96 + 84 bytes)."""
    s = traffic["sizes"]
    ops = s["n_paths"] * s["n_steps"] * ops_k4_path_step(
        bool(s["antithetic"]), False)
    return ops, 8 + 96 + 84
