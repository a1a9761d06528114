"""Least work of the Dupire local-vol Milstein path Monte Carlo. A frozen
copy of ``chip_smoke.py``'s ``ops_k4_lv_path`` with the step plan it reads
(``optpricer_tpu_torch/ops/path_mc.py``'s ``_blend_plan``), so that no
change to the program moves the count."""
import numpy as np


def blend_plan(Ts, tau):
    """The branch of the select chain over the SVI slices at time ``tau``
    (f32): ``(lo, hi, alpha)`` between slices lo and hi, ``(lo, lo, None)``
    for slice lo scaled by tau/T."""
    n = len(Ts)
    lo = hi = 0
    mid = False
    for i in range(1, n):
        if tau > Ts[i - 1]:
            lo, hi, mid = i - 1, i, True
    if tau >= Ts[n - 1]:
        lo = hi = n - 1
        mid = False
    if not mid:
        return lo, lo, None
    return lo, hi, (tau - Ts[lo]) / (Ts[hi] - Ts[lo])


def ops_k4_lv_path(expiries, dt: float, n_steps: int) -> float:
    """Per antithetic path over its ``n_steps`` steps. Per step: half a
    Threefry block and half a Box-Muller pair (65); per state three σ_loc
    evaluations, each the log-moneyness (a division and a log32, 21), the
    blends in T (15), Gatheral's formula with its floors and clip (15) and
    the SVI slices this step reads: the select chain picks one slice or two
    for each of t, t + dT and t − dT, a slice's w at k does not depend on
    t, so each slice read is counted once, with ∂w/∂k and ∂²w/∂k² for
    those of t (a sqrt and two divisions among 14 operations) and w alone
    for the others (7); then the bump, the difference quotient of σ·S and
    the Milstein update with its floor (21) and the barrier compare (2)."""
    f32 = np.float32
    Ts = [f32(T) for T in expiries]
    dt, dT, t_min = f32(dt), f32(1e-4), f32(1e-8)
    total = 0.0
    for step in range(n_steps):
        t = f32(f32(2 * (step // 2)) * dt)
        if step % 2:
            t = f32(t + dt)
        t = max(t, t_min)
        centre = set(blend_plan(Ts, t)[:2])
        read = centre.union(blend_plan(Ts, f32(t + dT))[:2],
                            blend_plan(Ts, max(f32(t - dT), t_min))[:2])
        sigma = 21 + 15 + 15 + 14 * len(centre) + 7 * len(read - centre)
        total += 65 + 2 * (3 * sigma + 23)
    return total


def least_work(config: dict, traffic: dict, request: dict):
    """(operations, bytes) of one request: every path; the seed, the
    parameters, the (6, n_slices) f32 table and the 21 sums."""
    s = traffic["sizes"]
    expiries = [sl["T"] for sl in config["surface"]["slices"]]
    dt = np.float32(request["T"] / s["n_steps"])
    ops = s["n_paths"] * ops_k4_lv_path(expiries, float(dt), s["n_steps"])
    return ops, 8 + 96 + 4 * 6 * len(expiries) + 84
