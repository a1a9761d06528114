#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one CUDA card.

    python3 chip_smoke.py

Phases (each prints its own lines; any failure raises, nothing is caught):

1. device — require ``torch.cuda.is_available()``; print the card's name
   and power limit as ``nvidia-smi`` reports them.
2. build — compile the CUDA kernels from ``optpricer_tpu_torch/csrc`` with
   nvcc and print the build seconds and ptxas' register report.
3. kernel vs plain — each kernel's wrapper against its plain torch version
   on the same card and inputs: the terminal kernel at 2^20 and a ragged
   1 000 003 draws for call/put x antithetic x invcdf, and at the main
   path's 1M and 2^30; the QMC kernel at 2^20 (call/put) and 2^22 points
   x 16 replicates. Counts must be equal; every other stat within rtol
   2e-5 (f32 sums in another order, sincospi against cos).
4. determinism — the terminal kernel twice on one seed, bitwise equal.
5. main path — the public API on ``device="cuda"`` with the launch counts
   set to 0 just before and read just after: euro_price_mc at 1M paths and
   at 2^30 base draws, the QMC backend at 2^22, euro_greeks_mc at 1M,
   crr_vec over 1 000 strikes at N=500, and the CLI's bs / binomial / mc /
   greeks as subprocesses. Every MC price must sit within 4 se + 1e-4 of
   Black-Scholes, and each kernel must have been launched.
6. time — CUDA events, median of 5 after a warm-up: the terminal kernel at
   2^30 and at 2^24 base draws and its plain version at 2^24, the QMC
   kernel and its plain version at 2^22 points.

The line before the last is ``{"kernels": [...]}``: per kernel its
launches in phase 5, ``max_abs_err`` (the largest |price from the
kernel's stats - price from the plain version's| in phase 3, in price
units) and ``ms`` / ``plain_ms`` at the ``n_paths`` given. The last line is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
SPEC = dict(S0=100.0, K=110.0, T=1.0, r=0.03, sigma=0.2, q=0.0)
RTOL = 2e-5


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def compare(kernel: torch.Tensor, plain: torch.Tensor, what: str) -> float:
    """Counts equal and stats within RTOL; returns the max rel err."""
    k = kernel.double().cpu()
    p = plain.double().cpu()
    if not torch.equal(k[..., 0], p[..., 0]):
        raise AssertionError(f"{what}: counts differ {k[..., 0]} vs {p[..., 0]}")
    if not torch.isfinite(k).all():
        raise AssertionError(f"{what}: non-finite kernel stats")
    rel = ((k - p).abs() / p.abs().clamp_min(1e-30)).max().item()
    if rel > RTOL:
        raise AssertionError(f"{what}: max rel err {rel:.3e} > {RTOL}")
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


def check_price(label, price, se, bs, seconds=None):
    err = abs(price - bs)
    ok = err <= 4.0 * se + 1e-4
    wall = "" if seconds is None else f" ({seconds * 1e3:.3f} ms wall)"
    print(f"  {label}: price {price:.10f} se {se:.3e} BS {bs:.10f} "
          f"|err| {err:.3e} -> {'ok' if ok else 'FAIL'}{wall}")
    if not ok:
        raise AssertionError(f"{label}: |price - BS| {err:.3e} > 4 se + 1e-4")


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
    from optpricer_tpu_torch.ops import terminal_mc as tmc

    dev = torch.device("cuda", 0)
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"phase 1 device: {kind} (count {torch.cuda.device_count()}); "
          f"nvidia-smi: {card}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}")

    # phase 2: build
    t0 = time.perf_counter()
    lib = _build.build(verbose=True)
    _build.load()
    print(f"phase 2 build: {time.perf_counter() - t0:.2f} s -> "
          f"{lib.relative_to(ROOT)}")

    # phase 3: kernels against their plain versions, on the card
    market = (SPEC["S0"], SPEC["K"], SPEC["T"], SPEC["r"], SPEC["q"],
              SPEC["sigma"])
    # worst[name] = [max rel err of the stats, max |price difference|]
    worst = {"terminal": [0.0, 0.0], "qmc": [0.0, 0.0]}

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
    for name, (rel, dprice) in worst.items():
        print(f"phase 3 {name} kernel vs plain: counts equal, max rel err "
              f"of the stats {rel:.3e} (rtol {RTOL}), max |price difference| "
              f"{dprice:.3e}")

    # phase 4: determinism
    reps, n_prog = tmc._plan_grid(1 << 24, 2 * tmc.TILE)
    params = tmc._terminal_params(1 << 24, *market, True).to(dev)
    seed = tmc._seed_pair(7, dev)
    kw = dict(n_programs=n_prog, reps=reps, antithetic=True)
    a = tmc.terminal_mc(seed, params, **kw).clone()
    b = tmc.terminal_mc(seed, params, **kw).clone()
    if not torch.equal(a, b):
        raise AssertionError("terminal kernel is not bitwise reproducible")
    print("phase 4 determinism: two runs at 2^24, one seed: bitwise equal")

    # phase 5: the main path through the public API
    spec = tp.OptionSpec(**SPEC)
    bs = tp.bs_price(spec, "call", device=dev)
    tmc.terminal_mc.launches = 0
    tmc.terminal_qmc.launches = 0
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
    print(f"  cli bs {out_bs} | binomial (American put) {out_bin} | "
          f"mc {out_mc} | greeks {' '.join(out_greeks.split())}")
    launches = {"terminal_mc_kernel": tmc.terminal_mc.launches,
                "terminal_qmc_kernel": tmc.terminal_qmc.launches}
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
    for (what, n), ms in times.items():
        print(f"phase 6 time {what} n={n}: {ms:.4f} ms -> "
              f"{n / (ms * 1e-3):.4e} paths/s [{card}]")

    kernels = [
        {"name": "terminal_mc_kernel", "route": "cuda",
         "source": "optpricer_tpu_torch/csrc/terminal_mc.cu",
         "replaces": "optpricer_tpu/ops/pallas_mc.py:39",
         "launches": launches["terminal_mc_kernel"],
         "max_abs_err": worst["terminal"][1],
         "ms": times[("k1", 1 << 24)], "plain_ms": times[("k1plain", 1 << 24)],
         "n_paths": 1 << 24},
        {"name": "terminal_qmc_kernel", "route": "cuda",
         "source": "optpricer_tpu_torch/csrc/terminal_mc.cu",
         "replaces": "optpricer_tpu/ops/pallas_mc.py:214",
         "launches": launches["terminal_qmc_kernel"],
         "max_abs_err": worst["qmc"][1],
         "ms": times[("k2", 1 << 22)], "plain_ms": times[("k2plain", 1 << 22)],
         "n_paths": 1 << 22},
    ]
    print(f"card: {card}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
