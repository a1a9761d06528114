#!/usr/bin/env python3
"""Drive the PyTorch port's main paths once on one CUDA card.

    python3 chip_smoke.py

Phases (each prints its own lines; any failure raises, nothing is caught):

1. device — require ``torch.cuda.is_available()``; print the card's name
   and power limit as ``nvidia-smi`` reports them.
2. build — compile the CUDA kernels from ``optpricer_tpu_torch/csrc`` (one
   nvcc per source, all started together) and print the build seconds and
   ptxas' registers and spills for every kernel instantiation.
3. kernel vs plain — each kernel's wrapper against its plain torch version
   on the same card and inputs:
   * the terminal kernel (K1) at 2^20 and a ragged 1 000 003 draws for
     call/put x antithetic x invcdf, and at the main path's 1M and 2^30;
   * the terminal QMC kernel (K2) at 2^20 (call/put) and 2^22 points x 16
     replicates;
   * the path kernel (K4) at 2^18 + 123 paths x 16 steps for every payoff
     variant x antithetic on/off x Greek moments on/off under GBM, for
     vanilla and barrier under Heston Euler / Heston QE / SABR β=1 /
     SABR β<1, and at the shape and market of every K4 call of phase 5:
     the asian with and without the geometric CV, with Greek moments and
     geometric at 1 000 000 paths x 252 steps; the vanilla, digital,
     up-and-in and up-and-out there; the vanilla with Greek moments at
     1M x 8; the Heston Euler and SABR β=1 call and put at 1M x 64;
   * the path-QMC kernel (K5) for the five payoffs at 65 536 points x 8
     replicates x 64 steps (the main path's shape) and x 252 steps.
   Counts must be equal; every unsigned sum within rtol 2e-5 (f32 sums in
   another order; K1/K2 also sincospi against cos), every signed Greek sum
   of K4 within 2e-5·√(n·ΣY²).
4. determinism — the terminal kernel at 2^24 and the path kernel at the
   main path's shape, each twice on one seed: bitwise equal.
5. main path — the public API on ``device="cuda"`` with the launch counts
   set to 0 just before and read just after:
   * euro_price_mc at 1M paths and at 2^30 base draws, the QMC backend at
     2^22, euro_greeks_mc at 1M, crr_vec over 1 000 strikes at N=500, and
     the CLI's bs / binomial / mc / greeks as subprocesses; every MC price
     within 4 se + 1e-4 of Black-Scholes;
   * exotic_price_mc: config 3's arithmetic Asian (1 000 000 paths, 252
     steps, antithetic, geometric-Asian CV) finite and within 4 se of the
     same call without CV; the geometric Asian, the vanilla and the
     digital within 4 se + 1e-4 of their closed forms; up-and-in plus
     up-and-out equal to the vanilla on one seed; the QMC backend's
     vanilla and geometric Asian against the closed forms; Heston Euler
     and SABR β=1 vanillas with the spot CV within 4 se of the same call
     without it, their call − put equal to S0e^{−qT} − Ke^{−rT} to 1e-4,
     and their spot means within 4 se of S0·e^{−qT};
   * exotic_greeks_mc: the vanilla within the bands of the Black-Scholes
     Greeks, the Asian finite;
   * the CLI's qmc as a subprocess, equal to the same call in-process.
   Each of the four kernels must have been launched.
6. time — CUDA events, median of 5 after a warm-up (3 for the slowest
   plain version): K1 at 2^30 and 2^24 base draws and its plain version at
   2^24; K2 and its plain version at 2^22 points; K4 and its plain version
   at the main path's shape, and K4 with Greek moments there; K5 and its
   plain version at 65 536 x 8 x 64 and at 2^20 x 8 x 252.

The line before the last is ``{"kernels": [...]}``: per kernel its
launches in phase 5, ``max_abs_err`` (the largest |price from the kernel's
stats − price from the plain version's| in phase 3, in price units),
``ms`` / ``plain_ms`` at the shape given, ``bound_ms`` / ``bound_by`` (the
least time the card could take for that work: the operations on these
inputs over the H100's float32 peak, or the bytes over the memory rate,
whichever is larger; K1/K2 count their source's operations, K4/K5 the
least their function needs) and ``library_ms`` (null: no single PyTorch
call computes these functions). The last line is
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import io
import json
import math
import statistics
import subprocess
import sys
import time
from contextlib import redirect_stdout
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
SPEC = dict(S0=100.0, K=110.0, T=1.0, r=0.03, sigma=0.2, q=0.0)
RTOL = 2e-5
K4_SIGNED = (11, 13, 15, 17, 19)

# H100 SXM peaks (NVIDIA's data sheet): float32 outside the tensor cores and
# the HBM3 rate. Integer operations are counted at the float32 rate.
PEAK_OPS = 67e12
PEAK_BYTES = 3.35e12
# Arithmetic of each kernel's source, counted per unit of work (an FMA or a
# separate multiply and add is 2, every other float or integer op 1):
# * K1, per base draw, antithetic: half a Threefry block (40), Box-Muller
#   (a log32, a sqrt, a sincospi: 45 for two draws), two exp32 (44) and two
#   payoffs with their 13 moments and Kahan steps (~80);
OPS_K1_DRAW = 165
# * K2, per point: bit reversal and shift (6), norminv32 (~45), one exp32
#   (22), the payoff, 13 moments and a Kahan step (~40);
OPS_K2_POINT = 113


# The two path kernels are counted by the least work their function needs,
# not by what their source does:
def ops_k4_path_step(antithetic: bool, greeks: bool) -> float:
    """K4 under GBM, asian with the geometric CV, per path and step: half a
    Threefry block (40) and half a Box-Muller pair (25) per step, and per
    state the log-spot step (an FMA and an add, 3), an exp32 for the
    arithmetic sum (22), the running sum and the running log-sum (one add
    each, 2) and, with Greek moments, the Brownian path and two
    accumulators (an FMA each, 6)."""
    per_state = 3 + 22 + 2 + (6 if greeks else 0)
    return 65 + per_state * (2 if antithetic else 1)


def ops_k5_point(n_steps: int) -> float:
    """K5 per point, for the geometric Asian that phase 6 times: per step
    the Sobol word by one Gray-code XOR (1), the cell-centred uniform (4),
    norminv32 (45), one step of the Brownian-bridge recursion (a multiply
    and two FMAs, 5), the drift (an FMA, 2) and the running log-sum (1);
    per point the Gray-code bit (1), the two closing exp32 (44), the payoff
    and its 6 moments (~20). The geometric average needs no exp32 per step."""
    return 58 * n_steps + 65


def bound(ops: float, n_bytes: float):
    """(bound_ms, bound_by): the larger of ops/peak and bytes/rate."""
    t_ops, t_bytes = ops / PEAK_OPS, n_bytes / PEAK_BYTES
    if t_ops >= t_bytes:
        return t_ops * 1e3, "operations"
    return t_bytes * 1e3, "bytes"


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def compare(kernel: torch.Tensor, plain: torch.Tensor, what: str,
            signed=()) -> float:
    """Counts equal, unsigned stats within RTOL, signed stats within
    RTOL·√(n·ΣY²); returns the max rel err of the unsigned stats."""
    k = kernel.double().cpu()
    p = plain.double().cpu()
    if not torch.equal(k[..., 0], p[..., 0]):
        raise AssertionError(f"{what}: counts differ {k[..., 0]} vs {p[..., 0]}")
    if not torch.isfinite(k).all():
        raise AssertionError(f"{what}: non-finite kernel stats")
    unsigned = [i for i in range(k.shape[-1]) if i not in signed]
    rel = ((k[..., unsigned] - p[..., unsigned]).abs()
           / p[..., unsigned].abs().clamp_min(1e-30)).max().item()
    if rel > RTOL:
        raise AssertionError(f"{what}: max rel err {rel:.3e} > {RTOL}")
    for i in signed:
        scale = math.sqrt(float(p[0]) * float(p[i + 1]))
        if abs(float(k[i] - p[i])) > RTOL * scale:
            raise AssertionError(f"{what}: signed stat {i} {float(k[i])} vs "
                                 f"{float(p[i])} (scale {scale:.3e})")
    return rel


def cuda_ms(fn, reps: int = 5) -> float:
    """Median milliseconds of ``fn`` over ``reps`` runs after a warm-up."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def timed(fn):
    """(fn(), wall seconds) on the host clock, ending in a synchronize."""
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def check_price(label, price, se, ref, seconds=None, slack=1e-4,
                what="BS"):
    err = abs(price - ref)
    ok = math.isfinite(price) and err <= 4.0 * se + slack
    wall = "" if seconds is None else f" ({seconds * 1e3:.3f} ms wall)"
    print(f"  {label}: price {price:.10f} se {se:.3e} {what} {ref:.10f} "
          f"|err| {err:.3e} -> {'ok' if ok else 'FAIL'}{wall}")
    if not ok:
        raise AssertionError(f"{label}: |price - {what}| {err:.3e} > "
                             f"4 se + {slack}")


def run_cli(args):
    cmd = [sys.executable, "-m", "optpricer_tpu_torch.cli", *args]
    out = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                         check=True, timeout=600)
    return out.stdout.strip()


def main():
    # phase 1: device
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; "
                         "this check needs a CUDA card")
    from optpricer_tpu_torch import _build
    import optpricer_tpu_torch as tp
    from optpricer_tpu_torch.models import mc_fused
    from optpricer_tpu_torch.models.analytic import geometric_asian_price_f64
    from optpricer_tpu_torch.ops import path_mc as pmc
    from optpricer_tpu_torch.ops import qmc_path as qmp
    from optpricer_tpu_torch.ops import terminal_mc as tmc

    dev = torch.device("cuda", 0)
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"phase 1 device: {kind} (count {torch.cuda.device_count()}); "
          f"nvidia-smi: {card}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}")

    # phase 2: build
    t0 = time.perf_counter()
    report = io.StringIO()
    with redirect_stdout(report):
        lib = _build.build(verbose=True)
    _build.load()
    print(f"phase 2 build: {time.perf_counter() - t0:.2f} s -> "
          f"{lib.relative_to(ROOT)}")
    for line in report.getvalue().splitlines():  # empty if already built
        if "Function properties" in line or "spill" in line or "Used" in line:
            print("  " + line.strip())

    # phase 3: kernels against their plain versions, on the card
    market = (SPEC["S0"], SPEC["K"], SPEC["T"], SPEC["r"], SPEC["q"],
              SPEC["sigma"])
    # worst[name] = [max rel err of the stats, max |price difference|]
    worst = {k: [0.0, 0.0] for k in ("terminal", "qmc", "path", "qmc_path")}

    def record(name, rel, price_k, price_p):
        worst[name] = [max(worst[name][0], rel),
                       max(worst[name][1], abs(price_k - price_p))]

    cases = [(n, is_call, anti, inv) for n in (1 << 20, 1_000_003)
             for is_call in (True, False) for anti in (True, False)
             for inv in (False, True)]
    # and the exact shapes the main path (phase 5) gives the kernel
    cases += [(1_000_000, True, True, False), (1 << 30, True, True, False)]
    for n, is_call, anti, inv in cases:
        reps, n_prog = tmc._plan_grid(n, 2 * tmc.TILE)
        params = tmc._terminal_params(n, *market, is_call).to(dev)
        seed = tmc._seed_pair(20 + n % 97, dev)
        kw = dict(n_programs=n_prog, reps=reps, antithetic=anti, invcdf=inv)
        k = tmc.terminal_mc(seed, params, **kw)
        p = tmc._mc_sumstats_plain(seed, params, **kw)
        rel = compare(k, p, f"terminal n={n} call={is_call} anti={anti} "
                            f"invcdf={inv}")
        record("terminal", rel, *(tmc.terminal_estimate(
            s, *market, is_call, True)[0] for s in (k, p)))
    for (n, R), is_call in [((1 << 20, 16), True), ((1 << 20, 16), False),
                            ((1 << 22, 16), True)]:
        n_rep, reps, ppr = tmc._plan_qmc(n, R)
        params = tmc._terminal_params(n_rep, *market, is_call).to(dev)
        seed = tmc._seed_pair(5, dev)
        kw = dict(n_programs=R * ppr, reps=reps, progs_per_rep=ppr)
        k = tmc.terminal_qmc(seed, params, **kw)
        p = tmc._mc_qmc_plain(seed, params, **kw)
        rel = compare(k, p, f"qmc n={n} R={R} call={is_call}")
        record("qmc", rel, *(tmc.qmc_estimate(
            rows.double().cpu().numpy().reshape(R, ppr, tmc.NSTAT).sum(1),
            *market, is_call)[0] for rows in (k, p)))

    def k4_setup(n, n_steps, pay, dyn, anti, greeks, mkt=market):
        """(seed, params, run kwargs, dynamics, geo_ey, market) for K4."""
        params, static = pmc._resolve_config(
            n, n_steps, *mkt, pay.get("is_call", True), pay["payoff"],
            anti, pay.get("barrier", 0.0),
            pay.get("barrier_type", "up-and-out"), pay.get("rebate", 0.0),
            pay.get("average_type", "arithmetic"),
            pay.get("strike_type", "fixed"), 1.0, None,
            dyn.get("scheme", "log_euler"), 0.01, dyn.get("heston"),
            dyn.get("sabr"), pay.get("geo_cv", False))
        reps, n_prog = tmc._plan_grid(n, pmc.TILE)
        run = dict(n_programs=n_prog, reps=reps, with_greeks=greeks,
                   **static)
        geo = geometric_asian_price_f64(*mkt, n_steps=n_steps) \
            if pay.get("geo_cv") else None
        return (tmc._seed_pair(11, dev), params.to(dev), run,
                "gbm" if not dyn else "sv", geo, mkt)

    def k4_check(what, setup, pay, signed=()):
        """The kernel against its plain version on one K4 setup."""
        seed, params, run, dynamics, geo, mkt = setup
        k = pmc.path_mc(seed, params, **run)
        p = pmc._path_mc_plain(seed, params, **run)
        rel = compare(k, p, what, signed=signed)
        record("path", rel, *(mc_fused._estimate_from_stats(
            s, *mkt, pay.get("is_call", True), dynamics, True,
            geo_ey=geo)[0] for s in (k, p)))

    heston = dict(v0=0.04, kappa=1.5, theta=0.05, xi=0.6, rho=-0.7)
    sabr = dict(alpha0=0.2, beta=0.6, nu=0.4, rho=-0.3)
    payoffs = {
        "vanilla": dict(payoff="vanilla"),
        "up-and-out": dict(payoff="barrier", barrier=130.0),
        "down-and-in": dict(payoff="barrier", barrier=90.0, rebate=1.5,
                            barrier_type="down-and-in", is_call=False),
        "asian-geo_cv": dict(payoff="asian", geo_cv=True),
        "asian-geometric-floating": dict(payoff="asian",
                                         average_type="geometric",
                                         strike_type="floating"),
        "digital": dict(payoff="digital"),
        "lookback-fixed": dict(payoff="lookback"),
        "lookback-floating": dict(payoff="lookback", strike_type="floating",
                                  is_call=False),
    }
    k4_shape = ((1 << 18) + 123, 16)  # paths (a ragged count), steps
    k4_runs = [(name, {}, anti, greeks) for name in payoffs
               for anti in (True, False) for greeks in (False, True)]
    k4_runs += [(name, dyn, anti, False) for name in ("vanilla", "up-and-out")
                for dyn in (dict(heston=heston),
                            dict(heston=heston, scheme="qe"),
                            dict(sabr=dict(sabr, beta=1.0)), dict(sabr=sabr))
                for anti in (True, False)]
    for name, dyn, anti, greeks in k4_runs:
        k4_check(f"path {name} {list(dyn.values())} anti={anti} "
                 f"greeks={greeks}",
                 k4_setup(*k4_shape, payoffs[name], dyn, anti, greeks),
                 payoffs[name], signed=K4_SIGNED)
    # every K4 configuration that phase 5 runs, at its shape and market
    main_k4 = k4_setup(1_000_000, 252, payoffs["asian-geo_cv"], {}, True,
                       False, mkt=(100.0, 100.0, *market[2:]))
    k4_check("path main shape 1M x 252 asian geo_cv", main_k4,
             payoffs["asian-geo_cv"])
    sv_phase5 = (dict(heston=dict(v0=0.04, kappa=1.5, theta=0.04, xi=0.4,
                                  rho=-0.6)),
                 dict(sabr=dict(alpha0=0.25, beta=1.0, nu=0.5, rho=-0.4)))
    phase5_k4 = [
        ("asian", dict(payoff="asian"), {}, 252, False,
         (100.0, 100.0, *market[2:])),
        ("asian greeks", dict(payoff="asian"), {}, 252, True, market),
        ("geometric asian", dict(payoff="asian", average_type="geometric"),
         {}, 252, False, market),
        ("vanilla", dict(payoff="vanilla"), {}, 252, False, market),
        ("digital", dict(payoff="digital"), {}, 252, False, market),
        ("up-and-in", dict(payoff="barrier", barrier=130.0,
                           barrier_type="up-and-in"), {}, 252, False, market),
        ("up-and-out", dict(payoff="barrier", barrier=130.0), {}, 252, False,
         market),
        ("vanilla greeks", dict(payoff="vanilla"), {}, 8, True, market),
    ] + [(f"{kind} vanilla", dict(payoff="vanilla", is_call=is_call), dyn,
          64, False, market)
         for dyn in sv_phase5 for is_call, kind in ((True, "call"),
                                                     (False, "put"))]
    for label, pay, dyn, n_steps, greeks, mkt in phase5_k4:
        k4_check(f"path phase-5 shape 1M x {n_steps} {label} "
                 f"{list(dyn.values())}",
                 k4_setup(1_000_000, n_steps, pay, dyn, True, greeks,
                          mkt=mkt), pay, signed=K4_SIGNED)

    def k5_setup(payoff, n, d, R=8):
        m_bits, d_pad, reps, ppr = qmp._plan(n, d, R)
        arrays = qmp._kernel_inputs(3, n, d, *market, n_replicates=R,
                                    barrier=130.0, rebate=0.0, payout=1.0)
        tensors = [torch.from_numpy(a).to(dev) for a in arrays]
        kw = dict(n_programs=R * ppr, reps=reps, progs_per_rep=ppr,
                  n_steps=d, d_pad=d_pad, m_bits=m_bits,
                  payoff_id=qmp.PAYOFF_IDS[payoff], barrier_up=True,
                  knock_in=False, is_call=True,
                  arithmetic=payoff != "asian", fixed_strike=True)
        return tensors, kw, (R, ppr, m_bits)

    def k5_price(rows, R, ppr):
        reps_stats = rows.double().cpu().numpy().reshape(R, ppr, 6).sum(1)
        return qmp.qmc_path_estimate(reps_stats, SPEC["S0"], SPEC["q"],
                                     SPEC["T"])[0]

    for payoff, n, d in [(p_, 65_536, 64) for p_ in qmp.PAYOFF_IDS] + \
            [("asian", 65_536, 252), ("vanilla", 65_536, 252)]:
        tensors, kw, (R, ppr, _) = k5_setup(payoff, n, d)
        k = qmp.qmc_path(*tensors, **kw)
        p = qmp._qmc_path_plain(*tensors, **kw)
        rel = compare(k, p, f"qmc_path {payoff} {n} x 8 x {d}")
        record("qmc_path", rel, k5_price(k, R, ppr), k5_price(p, R, ppr))
    for name, (rel, dprice) in worst.items():
        print(f"phase 3 {name} kernel vs plain: counts equal, max rel err "
              f"of the unsigned stats {rel:.3e} (rtol {RTOL}), max |price "
              f"difference| {dprice:.3e}")

    # phase 4: determinism
    reps, n_prog = tmc._plan_grid(1 << 24, 2 * tmc.TILE)
    params = tmc._terminal_params(1 << 24, *market, True).to(dev)
    seed = tmc._seed_pair(7, dev)
    kw = dict(n_programs=n_prog, reps=reps, antithetic=True)
    a = tmc.terminal_mc(seed, params, **kw).clone()
    b = tmc.terminal_mc(seed, params, **kw).clone()
    if not torch.equal(a, b):
        raise AssertionError("terminal kernel is not bitwise reproducible")
    a = pmc.path_mc(*main_k4[:2], **main_k4[2]).clone()
    b = pmc.path_mc(*main_k4[:2], **main_k4[2]).clone()
    if not torch.equal(a, b):
        raise AssertionError("path kernel is not bitwise reproducible")
    print("phase 4 determinism: terminal kernel at 2^24 and path kernel at "
          "1M x 252, two runs on one seed each: bitwise equal")

    # phase 5: the main path through the public API
    spec = tp.OptionSpec(**SPEC)
    bs = tp.bs_price(spec, "call", device=dev)
    launch_fns = {"terminal_mc_kernel": tmc.terminal_mc,
                  "terminal_qmc_kernel": tmc.terminal_qmc,
                  "path_mc_kernel": pmc.path_mc,
                  "qmc_path_kernel": qmp.qmc_path}
    for fn in launch_fns.values():
        fn.launches = 0
    print("phase 5 main path:")
    t0 = time.perf_counter()
    (px_1m, se), secs = timed(lambda: tp.euro_price_mc(
        spec, "call", n_paths=1_000_000, seed=7, device=dev))
    check_price("euro_price_mc 1M seed 7", px_1m, se, bs, secs)
    (px, se), secs = timed(lambda: tp.euro_price_mc(
        spec, "call", n_paths=1 << 30, seed=7, device=dev))
    check_price("euro_price_mc 2^30 base draws", px, se, bs, secs)
    (px, se), secs = timed(lambda: tp.euro_price_mc(
        spec, "call", n_paths=1 << 22, seed=7, backend="qmc", device=dev))
    check_price("euro_price_mc qmc 2^22", px, se, bs, secs)
    g, secs = timed(lambda: tp.euro_greeks_mc(
        spec, "call", n_paths=1_000_000, seed=7, device=dev))
    ref = {k: float(v) for k, v in tp.bs_greeks_vec(
        *market, "call", device=dev).items()}
    bands = dict(delta=3e-3, gamma=1.5e-3, vega=0.3, theta=0.08, rho=0.3)
    for name, band in bands.items():
        if abs(g[name] - ref[name]) > band:
            raise AssertionError(f"greeks {name}: {g[name]} vs BS {ref[name]}")
    if g["price"] != px_1m:
        raise AssertionError("euro_greeks_mc price differs from euro_price_mc "
                             "on the same draws")
    print("  euro_greeks_mc 1M (price equals euro_price_mc's): " + ", ".join(
        f"{k} {g[k]:.6f} (BS {ref[k]:.6f})" for k in bands)
        + f" ({secs * 1e3:.3f} ms wall)")
    strikes = torch.linspace(50.0, 150.0, 1000).double().numpy()
    amer, secs = timed(lambda: tp.crr_vec(
        100.0, strikes, 1.0, 0.03, 0.0, 0.2, "put", N=500, american=True,
        device=dev).cpu())
    if amer.shape != (1000,) or not torch.isfinite(amer).all():
        raise AssertionError("crr_vec: bad output")
    for i in (0, 333, 500, 999):
        cpu = tp.crr(tp.OptionSpec(100.0, float(strikes[i]), 1.0, 0.03, 0.2),
                     "put", N=500, american=True, device="cpu")
        if abs(float(amer[i]) - cpu) > 1e-10 * max(1.0, abs(cpu)):
            raise AssertionError(f"crr_vec[{i}] {float(amer[i])} vs CPU {cpu}")
    print(f"  crr_vec 1000 American puts N=500 on {kind}: match CPU f64 crr "
          f"at 4 strikes (rtol 1e-10); K={strikes[500]:.4f} -> "
          f"{float(amer[500]):.10f} ({secs * 1e3:.3f} ms wall)")

    # exotic_price_mc: BASELINE config 3's arithmetic Asian at full size
    asian = dict(sigma=0.2, n_steps=252, n_paths=1_000_000, seed=7,
                 device=dev)
    (px_cv, se_cv), secs = timed(lambda: tp.exotic_price_mc(
        "asian", 100.0, 100.0, 1.0, 0.03, control_variate=True, **asian))
    (px_raw, se_raw), secs_raw = timed(lambda: tp.exotic_price_mc(
        "asian", 100.0, 100.0, 1.0, 0.03, **asian))
    check_price("exotic_price_mc asian 1M x 252 geo CV (config 3)", px_cv,
                se_raw, px_raw, secs, slack=0.0, what="no-CV")
    print(f"    (no-CV run: se {se_raw:.3e}, {secs_raw * 1e3:.3f} ms wall; "
          f"CV se {se_cv:.3e}, {se_raw / se_cv:.1f}x smaller)")
    exotic = dict(sigma=0.2, n_steps=252, n_paths=1_000_000, seed=8,
                  device=dev)
    px, se = tp.exotic_price_mc("asian", *market[:5],
                                average_type="geometric", **exotic)
    geo_ref = float(tp.geometric_asian_price(*market, n_steps=252,
                                             device=dev))
    check_price("exotic_price_mc geometric asian 1M x 252", px, se, geo_ref,
                what="closed form")
    px, se = tp.exotic_price_mc("vanilla", *market[:5],
                                control_variate=True, **exotic)
    check_price("exotic_price_mc vanilla 1M x 252 (dual CV)", px, se, bs)
    d2 = (math.log(SPEC["S0"] / SPEC["K"]) + (SPEC["r"] - SPEC["q"]
          - 0.5 * SPEC["sigma"] ** 2) * SPEC["T"]) / (
        SPEC["sigma"] * math.sqrt(SPEC["T"]))
    digital_ref = math.exp(-SPEC["r"] * SPEC["T"]) * 0.5 * (
        1.0 + math.erf(d2 / math.sqrt(2.0)))
    px, se = tp.exotic_price_mc("digital", *market[:5], **exotic)
    check_price("exotic_price_mc digital 1M x 252", px, se, digital_ref,
                what="df N(d2)")
    barrier = dict(exotic, barrier=130.0)
    p_in, _ = tp.exotic_price_mc("barrier", *market[:5],
                                 barrier_type="up-and-in", **barrier)
    p_out, _ = tp.exotic_price_mc("barrier", *market[:5],
                                  barrier_type="up-and-out", **barrier)
    p_van, _ = tp.exotic_price_mc("vanilla", *market[:5], **exotic)
    if abs(p_in + p_out - p_van) > RTOL * p_van:
        raise AssertionError(f"in {p_in} + out {p_out} != vanilla {p_van}")
    print(f"  up-and-in {p_in:.10f} + up-and-out {p_out:.10f} = "
          f"{p_in + p_out:.10f} vs vanilla {p_van:.10f} "
          f"(|diff| {abs(p_in + p_out - p_van):.3e}, one seed)")
    g = tp.exotic_greeks_mc("vanilla", *market[:5], sigma=0.2, n_steps=8,
                            n_paths=1_000_000, seed=7, device=dev)
    for name, band in bands.items():
        if abs(g[name] - ref[name]) > band:
            raise AssertionError(f"exotic greeks {name}: {g[name]} vs BS "
                                 f"{ref[name]}")
    print("  exotic_greeks_mc vanilla 1M x 8: " + ", ".join(
        f"{k} {g[k]:.6f} (BS {ref[k]:.6f})" for k in bands))
    ga = tp.exotic_greeks_mc("asian", *market[:5], sigma=0.2, n_steps=252,
                             n_paths=1_000_000, seed=7, device=dev)
    if not all(math.isfinite(v) for v in ga.values()):
        raise AssertionError(f"exotic_greeks_mc asian not finite: {ga}")
    print("  exotic_greeks_mc asian 1M x 252: " + ", ".join(
        f"{k} {ga[k]:.6f}" for k in ("price", "delta", "gamma", "vega",
                                     "theta", "rho")))
    qmc = dict(sigma=0.2, n_steps=64, n_paths=65_536, seed=0,
               backend="qmc", device=dev)
    px, se = tp.exotic_price_mc("vanilla", *market[:5], **qmc)
    check_price("exotic_price_mc qmc vanilla 65536 x 8 x 64", px, se, bs)
    px, se = tp.exotic_price_mc("asian", *market[:5],
                                average_type="geometric", **qmc)
    geo64 = float(tp.geometric_asian_price(*market, n_steps=64, device=dev))
    check_price("exotic_price_mc qmc geometric asian 65536 x 8 x 64", px, se,
                geo64, what="closed form")
    parity = SPEC["S0"] * math.exp(-SPEC["q"] * SPEC["T"]) \
        - SPEC["K"] * math.exp(-SPEC["r"] * SPEC["T"])
    for label, dyn in zip(("heston euler", "sabr beta=1"), sv_phase5):
        sv = dict(n_steps=64, n_paths=1_000_000, seed=9, device=dev, **dyn)
        call_cv, se_cv = tp.exotic_price_mc("vanilla", *market[:5],
                                            control_variate=True, **sv)
        call_raw, se_raw = tp.exotic_price_mc("vanilla", *market[:5], **sv)
        put_cv, _ = tp.exotic_price_mc("vanilla", *market[:5], kind="put",
                                       control_variate=True, **sv)
        check_price(f"exotic_price_mc {label} call 1M x 64 spot CV", call_cv,
                    se_raw, call_raw, slack=0.0, what="no-CV")
        # with the spot CV, call − put is S0e^{−qT} − Ke^{−rT} on every
        # seed: the payoffs differ by the control Y1 − e^{−rT}K path by path
        # and the two regression slopes by exactly 1
        gap = abs(call_cv - put_cv - parity)
        print(f"    {label}: CV se {se_cv:.3e} (no CV {se_raw:.3e}); call − "
              f"put {call_cv - put_cv:.10f} vs parity {parity:.10f}, |diff| "
              f"{gap:.3e}")
        if not gap <= 1e-4:  # f32 sums of ~1e8; se is ~1e-2
            raise AssertionError(f"{label}: put-call parity off by {gap}")
        s = pmc.path_mc_sumstats_kernel(
            9, 1_000_000, 64, *market[:5], None, True, payoff="vanilla",
            antithetic=True, device=dev, **dyn).double().cpu()
        n = float(s[0])
        m1 = float(s[3]) / n
        se1 = math.sqrt(max(0.0, float(s[4]) / n - m1 * m1) / n)
        check_price(f"path_mc_sumstats_kernel {label} 1M x 64 spot mean",
                    m1, se1, SPEC["S0"] * math.exp(-SPEC["q"] * SPEC["T"]),
                    slack=0.0, what="S0 e^-qT")
    flags = ["--S0", "100", "--K", "110", "--T", "1", "--r", "0.03",
             "--sigma", "0.2"]
    out_bs = run_cli(["bs", *flags])
    if out_bs != f"{bs:.10f}":
        raise AssertionError(f"cli bs {out_bs!r} vs {bs:.10f}")
    out_bin = run_cli(["binomial", *flags, "--N", "500", "--american",
                       "--kind", "put"])
    amer_put = tp.crr(spec, "put", N=500, american=True, device=dev)
    if out_bin != f"{amer_put:.10f}":
        raise AssertionError(f"cli binomial {out_bin!r} vs {amer_put:.10f}")
    out_mc = run_cli(["mc", *flags, "--n-paths", "1000000", "--seed", "7"])
    value, rest = out_mc.split("  (stderr ")
    check_price("cli mc 1M", float(value), float(rest.rstrip(")")), bs)
    out_greeks = run_cli(["greeks", *flags, "--seed", "7"])
    if len(out_greeks.splitlines()) != 6:
        raise AssertionError(f"cli greeks output {out_greeks!r}")
    out_qmc = run_cli(["qmc", *flags, "--payoff", "asian"])
    px, se = tp.exotic_price_mc("asian", *market[:5], **dict(
        qmc, n_steps=64, n_paths=65_536, seed=0))
    if out_qmc != f"{px:.10f}  (stderr {se:.10f})":
        raise AssertionError(f"cli qmc {out_qmc!r} vs {px:.10f} {se:.10f}")
    print(f"  cli bs {out_bs} | binomial (American put) {out_bin} | "
          f"mc {out_mc} | greeks {' '.join(out_greeks.split())} | "
          f"qmc asian {out_qmc}")
    launches = {name: fn.launches for name, fn in launch_fns.items()}
    print(f"  main path {time.perf_counter() - t0:.2f} s; launches in this "
          f"process: {launches}")
    for name, count in launches.items():
        if count == 0:
            raise AssertionError(f"{name} was not launched on the main path")

    # phase 6: time
    times = {}
    for n in (1 << 30, 1 << 24):
        reps, n_prog = tmc._plan_grid(n, 2 * tmc.TILE)
        params = tmc._terminal_params(n, *market, True).to(dev)
        kw = dict(n_programs=n_prog, reps=reps, antithetic=True)
        times[("k1", n)] = cuda_ms(lambda: tmc.terminal_mc(seed, params, **kw))
    times[("k1plain", 1 << 24)] = cuda_ms(
        lambda: tmc._mc_sumstats_plain(seed, params, **kw))
    R, n = 16, 1 << 22
    n_rep, reps, ppr = tmc._plan_qmc(n, R)
    params = tmc._terminal_params(n_rep, *market, True).to(dev)
    kw = dict(n_programs=R * ppr, reps=reps, progs_per_rep=ppr)
    times[("k2", n)] = cuda_ms(lambda: tmc.terminal_qmc(seed, params, **kw))
    times[("k2plain", n)] = cuda_ms(
        lambda: tmc._mc_qmc_plain(seed, params, **kw))
    seed4, params4, run4 = main_k4[:3]
    times[("k4", "1M x 252")] = cuda_ms(
        lambda: pmc.path_mc(seed4, params4, **run4))
    times[("k4plain", "1M x 252")] = cuda_ms(
        lambda: pmc._path_mc_plain(seed4, params4, **run4))
    run4g = dict(run4, with_greeks=True)
    times[("k4greeks", "1M x 252")] = cuda_ms(
        lambda: pmc.path_mc(seed4, params4, **run4g))
    k5_bounds = {}
    for n, d in ((65_536, 64), (1 << 20, 252)):
        tensors, kw5, (R5, _, _) = k5_setup("asian", n, d)
        shape = f"{n} x 8 x {d}"
        times[("k5", shape)] = cuda_ms(lambda: qmp.qmc_path(*tensors, **kw5))
        times[("k5plain", shape)] = cuda_ms(
            lambda: qmp._qmc_path_plain(*tensors, **kw5),
            reps=3 if d > 64 else 5)
        in_bytes = sum(t.numel() * t.element_size() for t in tensors)
        k5_bounds[shape] = bound(n * R5 * ops_k5_point(d),
                                 in_bytes + kw5["n_programs"] * 6 * 4)
    for (what, n), ms in times.items():
        print(f"phase 6 time {what} {n}: {ms:.4f} ms [{card}]")

    k4_ops = 1_000_000 * 252 * ops_k4_path_step(True, False)
    kernels = [
        {"name": "terminal_mc_kernel", "route": "cuda",
         "source": "optpricer_tpu_torch/csrc/terminal_mc.cu",
         "replaces": "optpricer_tpu/ops/pallas_mc.py:39",
         "launches": launches["terminal_mc_kernel"],
         "max_abs_err": worst["terminal"][1],
         "ms": times[("k1", 1 << 24)], "plain_ms": times[("k1plain", 1 << 24)],
         **dict(zip(("bound_ms", "bound_by"),
                    bound((1 << 24) * OPS_K1_DRAW, 36))),
         "library_ms": None, "shape": "2^24 base draws, antithetic",
         "ms_2p30": times[("k1", 1 << 30)],
         "bound_ms_2p30": bound((1 << 30) * OPS_K1_DRAW, 36)[0]},
        {"name": "terminal_qmc_kernel", "route": "cuda",
         "source": "optpricer_tpu_torch/csrc/terminal_mc.cu",
         "replaces": "optpricer_tpu/ops/pallas_mc.py:214",
         "launches": launches["terminal_qmc_kernel"],
         "max_abs_err": worst["qmc"][1],
         "ms": times[("k2", 1 << 22)], "plain_ms": times[("k2plain", 1 << 22)],
         **dict(zip(("bound_ms", "bound_by"),
                    bound((1 << 22) * OPS_K2_POINT, 36 + 64 * 13 * 4))),
         "library_ms": None, "shape": "2^22 points x 16 replicates"},
        {"name": "path_mc_kernel", "route": "cuda",
         "source": "optpricer_tpu_torch/csrc/path_mc.cu",
         "replaces": "optpricer_tpu/ops/pallas_path_mc.py:68",
         "launches": launches["path_mc_kernel"],
         "max_abs_err": worst["path"][1],
         "ms": times[("k4", "1M x 252")],
         "plain_ms": times[("k4plain", "1M x 252")],
         **dict(zip(("bound_ms", "bound_by"), bound(k4_ops, 8 + 96 + 84))),
         "library_ms": None,
         "shape": "asian + geometric CV, 1M paths x 252 steps, antithetic",
         "ms_greeks": times[("k4greeks", "1M x 252")],
         "bound_ms_greeks": bound(1_000_000 * 252 * ops_k4_path_step(
             True, True), 188)[0]},
        {"name": "qmc_path_kernel", "route": "cuda",
         "source": "optpricer_tpu_torch/csrc/qmc_path.cu",
         "replaces": "optpricer_tpu/ops/pallas_qmc_path.py:113",
         "launches": launches["qmc_path_kernel"],
         "max_abs_err": worst["qmc_path"][1],
         "ms": times[("k5", "65536 x 8 x 64")],
         "plain_ms": times[("k5plain", "65536 x 8 x 64")],
         **dict(zip(("bound_ms", "bound_by"),
                    k5_bounds["65536 x 8 x 64"])),
         "library_ms": None, "shape": "asian, 65536 points x 8 x 64 steps",
         "ms_2p20x252": times[("k5", "1048576 x 8 x 252")],
         "plain_ms_2p20x252": times[("k5plain", "1048576 x 8 x 252")],
         "bound_ms_2p20x252": k5_bounds["1048576 x 8 x 252"][0]},
    ]
    print(f"card: {card}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
