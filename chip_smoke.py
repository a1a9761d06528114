#!/usr/bin/env python3
"""Drive the PyTorch port's main paths once on one CUDA card.

    python3 chip_smoke.py

Phases (each prints its own lines; any failure raises, nothing is caught):

1. device — require ``torch.cuda.is_available()``; print the card's name
   and power limit as ``nvidia-smi`` reports them.
2. build — compile the CUDA kernels from ``optpricer_tpu_torch/csrc`` (one
   nvcc per source, all started together) and print the build seconds,
   ptxas' registers and spills for every kernel instantiation, and the
   resident blocks per SM (the CUDA runtime's occupancy) and waves of K4's
   timed instantiations (``K4_TIMED``), of K6 at its three phase-5
   shapes (``K6_SHAPES``), of K1 at 2^30 and of K5 at its two timed
   shapes.
3. kernel vs plain — each kernel's wrapper against its plain torch version
   on the same card and inputs:
   * the terminal kernel (K1) at 2^20 and a ragged 1 000 003 draws for
     call/put x antithetic x invcdf, and at the main path's 1M and 2^30;
   * the terminal QMC kernel (K2) at 2^20 (call/put) and 2^22 points x 16
     replicates, seed 5, each also held bit for bit to the rows that the
     kernel of commit 4bc6091 gave (``K2_SUMS``, by SHA-256);
   * the path kernel (K4) at 2^18 + 123 paths x 16 steps for every payoff
     variant x antithetic on/off x Greek moments on/off under GBM, for
     vanilla and barrier under Heston Euler / Heston QE / SABR β=1 /
     SABR β<1, and at the shape and market of every K4 call of phase 5:
     the asian with and without the geometric CV, with Greek moments and
     geometric at 1 000 000 paths x 252 steps; the vanilla, digital,
     up-and-in and up-and-out there; the vanilla with Greek moments at
     1M x 8; the Heston Euler and SABR β=1 call and put at 1M x 64;
   * the path-QMC kernel (K5) for the five payoffs at 65 536 points x 8
     replicates x 64 steps (the main path's shape) and the Asian and the
     vanilla at 252 steps, each also held bit for bit to the sums that
     the kernel of commit 95d2791 gave (``QMC_PATH_SUMS``, by SHA-256);
     and the arithmetic Asian at 4 096 points x 2 replicates x 2 048
     steps, σ = 0.2 and σ = 0, against the plain mirror that sums the
     steps in step order (``_qmc_path_plain(step_order=True)``);
   * the batched tridiagonal kernel (K7, PCR) against the plain Thomas
     solve at (511, 1024) in f64 and f32, at the propagator build's 511 x
     511 in f64 with one coefficient column for every system, at the
     marches' single systems (511, 1) and (199, 1) in f64 and (199, 1) in
     f32, at n = 1, 2, 3 (5 systems), at (4095, 8) in f64 and f32 (the
     partitioned kernel), at the "auto" ladder's call (one coefficient row
     for 1 024 right-hand sides of 511, through the last-axis adapter) in
     f64 and f32, on a ragged (3, 37) last-axis case, and on the ladder's
     θ-scheme rows with the nodes above 130 knocked out into identity rows
     (f64, f32), every case with garbage in a[0] and c[n-1];
   * the fused local-vol march (K8) on the full ladder (1 024 strikes x 511
     rows x 512 steps): PCR for calls and puts, with and without the
     American projection; Thomas for a call and an American put (the plain
     Thomas march, ~5·10^6 small launches, is timed once here); PCR on a
     ragged ladder (1 025 strikes, calls and puts mixed, American) and on
     1 024 rows (N_S = 1 025) at 512 steps, Thomas on the ragged ladder at
     32 steps; the pre-kernel's plan of both forms at the ladder's shape
     equal to its plain version (``fd_lv_plan``);
   * K4's Dupire branches (lv_euler, lv_milstein) at 2^18 + 123 paths x 16
     steps on a 3-slice SVI table for every payoff variant x antithetic
     on/off, and at the desk workflow's fused call (its calibrated surface,
     Milstein, up-and-out 130, 200 000 x 500);
   * the book kernel (K3) on a 1 000-contract book (calls and puts, K
     70..130, S0 95..105, T 0.5..2, σ 0.2..0.4) at 2^20 and 1 000 003 paths
     per contract, antithetic on/off;
   * the basket kernel (K6) at the `[basket-path]` shape (10 assets, 2^18
     pairs x 64 steps, Asian) and for 1, 3 and 16 assets x the Asian, the
     worst-of and basket barriers up/down x in/out (with a rebate) at
     2^16 + 123 pairs x 16 steps, antithetic on and off for 3 assets; and
     every asset count 1-16 (each its own instantiation) with a payoff
     each at 1, 2 and 4 reps (``K6_REPS``: 2^16, 2^18 and 3·2^18 pairs +
     123 x 16 steps), antithetic for the even counts;
   * K4's lsv and lsv_qe branches on the calibrated tables at 2^20 x 96
     (up-and-out 130), on a fixed 16-step table for the five payoffs x
     antithetic on/off at 2^16 + 123 paths, and up-and-out 125 there on a
     degree-5 table (the Horner loop over a shared row) and a 130-step
     degree-12 table (past one staged window of leverage rows).
   Counts must be equal; every unsigned sum within rtol 2e-5 (f32 sums in
   another order; K1/K2 also sincospi against cos), every signed Greek sum
   of K4 within 2e-5·√(n·ΣY²); K7's solution within rtol 1e-10 (f64) or
   2e-5 (f32) norm-wise (max |Δx| / max |x|: PCR and Thomas round
   differently); K8's ladder prices within 2e-5. Each kernel's line names the
   case that carries its largest price (K7: solution) difference.
4. determinism — the terminal kernel at 2^24, the path kernel at the main
   path's shape and at the desk's lv_milstein call, K8 (PCR and Thomas at
   512 steps), K3 on the book at 2^20, K6 at 16 assets x 2^18 x 64 and
   K4-lsv / lsv_qe at 2^20 x 96, each twice on one input: bitwise equal;
   the LSV calibration twice on one seed: equal leverage tables (its binned
   sums are sequential per bin, no float atomics); the desk's K4 call
   (lv_milstein and lv_euler) on the SVI table recorded from commit
   1eec4fa's run: the 21 sums that run gave (``DESK_SUMS``), bit for bit.
5. main paths — the public API on ``device="cuda"``; each path's launch
   counts are set to 0 just before it and read just after.
   The Monte-Carlo path:
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
   The PDE path (BASELINE config 4 and the local-vol ladders):
   * config 4 on a 512-node grid, N_t = 256: the European call within 1e-3
     relative of Black-Scholes; the American put by PSOR above the European
     put and within 0.003 relative of crr(N=4000, american); the up-and-out
     call at 130 between 0 and the European, up-and-in + up-and-out equal
     to the vanilla; fd_greeks' delta within 0.005 of Black-Scholes;
     fem_price within 2e-3 relative; each equal to the same call on
     device="cpu" to rtol 1e-9;
   * fd_price_local_vol with σ ≡ 0.2 within 0.002 of Black-Scholes, and
     with σ(t)² = 0.03 + 0.02t within 0.005 of Black-Scholes at the RMS vol;
   * the local-vol ladder, 1 024 strikes 70..130 x N_S = 512 x N_t = 512
     under the smile 0.2 + 0.1·exp(-ln²(S/100)) + 0.05·t, by
     solver="auto" (K7 each step) in float64 and in float32, "fused" (K8
     PCR) and "fused_thomas" (K8 Thomas, both float32): the three float32
     ladders agree within atol 2e-4 and rtol 2e-5, and each with the
     float64 one within rtol 1e-4 (a float32 march's round-off over 512
     steps);
   * the CLI's fd as a subprocess, equal to the same call in-process.
   K7 and K8 must have been launched; K7's launches are tallied by shape.
   Config 5 (the desk workflow, ``optpricer_tpu_torch/scripts/
   desk_workflow_localvol_barrier.py``):
   * fit_svi_surface on the desk market equal to the same call on
     device="cpu" (fitted w at rtol 1e-8); dupire_local_vol_func on the
     golden surface against the six ``dupire_probe`` values of
     tests/goldens.json at rtol 1e-6;
   * tests/test_baseline_configs.py:64-91 on the card (Milstein, 50 000 x
     100, seeds 21 and 22): |fd_lv − mc_lv| < 5 se + 0.15, 0 < KO < fd_lv;
   * the desk workflow end to end at 200 000 x 500: the fused barrier on K4
     within 5·hypot(se_fused, se_matrix) + 1e-3 of the path-matrix barrier,
     fd_greeks' delta within 0.005 of numerical_greeks'; every stage-4
     number printed;
   * exotic_price_mc_dupire on a flat 0.2 SVI surface, log-Euler, 1M x 100,
     within 4 se + 0.01 of Black-Scholes.
   K4 must have been launched on it. The book: euro_price_mc_batch on the
   1 000 contracts at 1M paths each with the dual CV, every price within
   5 se + 1e-4 of Black-Scholes; K3 must have been launched.
   The multi-asset path: the `[basket-path]` book on K6 within 5·(se + se)
   + 1e-3 of the float64 torch scan; a 16-asset basket barrier's up-in +
   up-out ΣX equal to the no-barrier ΣX to 1e-3; a 1-asset worst-of barrier
   within 5·hypot + 1e-3 of exotic_price_mc; the 100-asset basket_price_mc
   with the geometric CV within 4 se of no CV; the (1, −1) spread at K = 0
   and the 2-asset min/max rainbow calls within 4 se + 1e-4 of Margrabe and
   Stulz; basket_greeks_mc's 1-asset delta/vega within the BS bands; the
   CLI's basket as a subprocess equal to the same call. K6 must have been
   launched. The LSV path: lsv_calibrate (euler and qe, f32, 96 x 128 x
   131 072) equal to phase 3's; up-and-out 130 and the ATM vanilla at 2^20
   x 96 on K4-lsv within 4·(se + se) of the float64 scan on the kernel's
   own leverage polynomials (the scan on the raw table printed beside);
   the ATM vanilla within max(4 se, 0.25) of the surface's Black-Scholes;
   lsv_greeks_mc's delta within 2% + 4 se of a CRN bump; the CLI's lsv
   (surface file, saved model) equal to the same calls. K4 must have been
   launched on it.
   The closed-form path (``ClosedFormSlice``; it has no kernel of its own):
   * a Heston board of 8 expiries (0.1-3 y) x 1 024 strikes (60-140) at
     N = 256 with the ``heston_cos`` golden's parameters, calls and puts,
     equal to device="cpu" within atol 1e-12 + rtol 1e-10; the golden at
     rtol 1e-9; put-call parity to 1e-10·S0; bates_price_cos at λ = 0
     equal to heston_price_cos; heston_greeks_cos' delta and gamma within
     rtol 1e-5 of central differences (h 0.05) of heston_price_cos;
     fit_heston on a synthetic 8 x 21 surface (n_cos 128) with rmse < 1e-6
     and its parameters within 1e-8 of the device="cpu" fit;
   * config 2's 1 000 American puts (crr_vec, N = 500) inverted by
     american_implied_vol (crr, N = 500) to σ within 1e-8, NaN only at
     intrinsic; the same strikes priced at N = 2 000 with r 0.05, q 0.02
     (tests/test_binomial.py:160-165's market) and inverted through
     BS2002 within 2e-3 on K 90..110 (the chain's worst printed);
     bjerksund_stensland_price on the chain equal to device="cpu";
   * vg/nig/cgmy_price_cos on 1 024 strikes equal to device="cpu" within
     atol 1e-12 + rtol 1e-10; vg_paths and nig_paths at 200 000 x 252 f64
     antithetic: e^{−rT}E[S_T] within 4 se of S0 and the ATM call within
     4 se + 1e-3 of its COS price;
   * cross_validate at its defaults (max_discrepancy < 0.5) and ["bs",
     "fdm"] (< 0.1); convergence_analysis (tree order > 0, fdm errors
     falling); stress_test on an 11 x 11 spot x vol grid equal to
     device="cpu", its centre the Black-Scholes price; backtest_delta_hedge
     on gbm_paths 200 000 x 252 rebalancing every step and every 4 steps:
     mean P&L within 4 se + 0.01 of 0, the P&L's std larger at 4;
   * profiling.trace around euro_price_mc 1M names terminal_mc_kernel;
     device_memory reports the card;
   * the CLI's heston (Bates), american, barrier (fd, double), lookback
     and levy (nig) as subprocesses started together, each equal to the
     same call in-process.
   K1 and K7 must have been launched on it; their counts are the
   ``launches_closed_form`` of their kernel entries.
6. time — CUDA events, median of 5 after a warm-up (3 for the slowest
   plain version and the dense solve): K1 at 2^30, 2^24 and 1 000 000 base
   draws and its plain version at 2^24 and 1 000 000; K2 and its plain
   version at 2^22 and 2^20 points x 16 (seed 7, the main path's call; the
   rows at 2^22 held to ``K2_SUMS``), K2 also with the start event behind
   a queued device sleep, its block size and waves and its static SASS
   (``k2_issue_lines``); K4
   and its plain version at the main path's shape, K4 with Greek moments
   there, and K4's Heston Euler and SABR β=1 vanillas at 1M x 64; K5 and
   its plain version at 65 536 x 8 x 64 and at 2^20 x 8 x 252 (median of
   3 there; the kernel's sums there held to ``QMC_PATH_SUMS``), also with
   the start event behind a queued device sleep (the device's time
   alone); K1's and
   K5's registers and local memory (``cuobjdump -res-usage``) and the
   static SASS counts of K1's rep loops and K5's loops by class with the
   issue time they give (``k1_k5_sass_lines``); K7 at (511, 1024) in f64
   and f32 with its plain version and
   torch.linalg.solve on the dense (1024, 511, 511) f64 matrices, with
   shared columns, at the ladder's last-axis call, and at (511, 1) and
   (199, 1), median of 21, each twice: like every kernel (the host's launch
   latency in) and with the start event behind a queued device sleep (the
   device's time alone, ``device_ms``); K8 PCR and Thomas on the full
   ladder, European calls and American puts, with the plain PCR (the plain
   Thomas is phase 3's one run) and the pre-kernel alone; the "auto",
   "fused" and "fused_thomas" ladder calls; the host-clock wall time of
   each config-4 call; and, under torch.profiler, the device-busy share of
   the PSOR put, the European call and the "auto", "fused" and
   "fused_thomas" ladders; K4 lv_milstein at the desk's call and its plain
   version (median of 3), and lv_euler at the same call; K3 at 1 000
   contracts x 2^20 and its plain version (median of 3); the host-clock
   wall of fit_svi_surface and of each desk stage; K6 at the
   `[basket-path]` shape and K4-lsv / lsv_qe at 2^20 x 96 (their plain
   versions timed once, in phase 3), K6 also at phase 5's 16-asset basket
   barrier (2^18 x 64) and 1-asset worst-of (2^20 x 64); the wall of
   lsv_calibrate, of the 100-asset basket_price_mc and of lsv_greeks_mc
   (phase 5's runs); the walls (median of 21) of the user calls around K6
   and K3: basket_exotic_mc on the `[basket-path]` book and on the
   16-asset basket barrier, and euro_price_mc_batch on 1 000 contracts x
   1M; each closed-form call of phase 5 (median of 3, or one run for a
   call of more than a second) with its device-busy share under
   torch.profiler (the CUDA activity alone, its raw events summed).

The line before the last is ``{"kernels": [...]}``: per kernel its
launches in phase 5, ``max_abs_err`` (the largest |price from the kernel's
stats − price from the plain version's| in phase 3, in price units),
``ms`` / ``plain_ms`` at the shape given, ``bound_ms`` / ``bound_by`` (the
least time the card could take for that work: the operations on these
inputs over the H100's float32 peak, or the bytes over the memory rate,
whichever is larger; K1/K2 count their source's operations, K4/K5/K8 the
least their function needs, K7 its bytes; K3 like K1, per base draw;
K4 lv_milstein three σ evaluations a step over every SVI slice with their
derivatives and the two w of ∂w/∂T; K6 and K4-lsv per path-step by
``ops_k6_path_step`` / ``ops_k4_lsv_path_step``) and ``library_ms`` (K7:
the dense batched ``torch.linalg.solve``; null for the others, which no
single PyTorch call computes). K7's ``max_abs_err`` is in solution units,
K8's in price units, K3's the largest over the book's contracts. K7's
entry also has its launches by (rows, systems) on the PDE path, K8's its
launches by method, both forms' times for calls and American puts and the
pre-kernel's; K6's its resident blocks per SM at each shape. The last line
is ``{"ok": true, "device": {...}}``.

    python3 chip_smoke.py --ab OTHER_TREE [GROUP,...]

compares this tree with another checkout of the repository (the parent
commit unpacked with ``git archive``, say) instead: one process per turn,
in the order other, this, this, other, twice (``AB_TURNS``), each
importing and building its own tree's package and timing it by this
script's rules (``ab_turn``), for the kernel groups named (``AB_GROUPS``,
all by default): K1 (antithetic Box-Muller) at 2^30 and 1 000 000 draws
and K5 (the geometric Asian) at 65 536 x 8 x 64 and 2^20 x 8 x 252 with
their sums by SHA-256 (K5's at every ``K5_CASES`` case, against
``QMC_PATH_SUMS`` too), the walls (median of 21) of euro_price_mc at 2^30
and exotic_price_mc(backend="qmc") at 65 536 x 8 x 64 (also with a fresh
seed a call, and K5's ``_kernel_inputs`` host time both ways), their
resident blocks per SM and ``cuobjdump -res-usage`` (``ab_k1_k5``); K2 at
2^22 and 2^20 points x 16 (``ms``, ``device ms``, its rows by SHA-256 at
``K2_CASES`` against ``K2_SUMS``), the host time of each part of its call
(``k2_host_us``), the walls of mc_sumstats_qmc and
euro_price_mc(backend="qmc") at 2^22, its block size and waves
(``ab_k2``); K4's timed
instantiations (``K4_TIMED``:
config 3's asian with the geometric CV at 1M x 252 with and without Greek
moments, lsv and lsv_qe up-and-out 130 at 2^20 x 96 on the calibrated
tables, the Heston Euler and QE and the SABR β=1 and β=0.5 vanillas at
1M x 64), their 21 sums at 2^18 paths (one rep) compared bit for bit
across the turns and at the timed shape within rtol 2e-5; the host-clock
walls (median of 21) of config 3's ``exotic_price_mc`` and of
``lsv_price_mc``'s up-and-out calls; K4 lv_milstein and lv_euler at the
desk's call on ``DESK_SVI`` (its 21 sums compared bit for bit across the
turns), K7 at the shapes phase 6 times and the propagator build's (with
the host's launch latency, the device's time alone, and the host's µs a
call), and the host-clock wall and device-busy time (K7's share under
torch.profiler) of the "auto" ladder, the PSOR put, the European call and
``fd_price_local_vol`` at 200 x 200; K8 PCR and Thomas on the ladder
(1 024 strikes x 511 rows x 512 steps) for European calls and American
puts, each form's layer compared bit for bit across the turns (a SHA-256
of its bytes), and the host-clock walls (median of 21) of the "fused" and
"fused_thomas" ladders; K6 at ``K6_SHAPES`` and K3 at 1 000 contracts x
2^20 (``ab_k3_k6``), each ``ms``, K6's 6 sums at the two one-rep shapes
compared bit for bit across the turns and at the 4-rep shape this vs
other, K3's (n_ktiles, 10, 128) sums by SHA-256 across the turns, and the
walls (median of 21) of basket_exotic_mc at ``[basket-path]`` and the
16-asset barrier and of euro_price_mc_batch at 1 000 x 1M; the resident
blocks per SM and waves of ``K4_TIMED`` and of K6 at ``K6_SHAPES`` (none
for a tree without the kernel's occupancy query); and, from each turn
that builds its tree's library, ptxas' registers and spills of K7, K8, K4
``LV_MILSTEIN`` and ``K4_TIMED`` and of every K3 and K6 instantiation, and
the static SASS instruction count of ``K4_TIMED``'s step-pair loop, of
K6's step loop at ``K6_SHAPES``, of K3's and K1's rep loops (full and
tail), of K2's loops (``sass_k2``) and of K5's loops (the Sobol words
and normals, the bridge) by class (``cuobjdump -sass``), with the ALU-pipe
ops among them. The
static count holds code a step pair seldom runs (the division and
sin/cos slow paths), so it is not the count of instructions issued, and
the time it gives at one instruction per lane and cycle is no bound on
the kernel's.
"""
from __future__ import annotations

import hashlib
import inspect
import io
import json
import math
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time
from contextlib import redirect_stdout
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
SPEC = dict(S0=100.0, K=110.0, T=1.0, r=0.03, sigma=0.2, q=0.0)
MARKET = (SPEC["S0"], SPEC["K"], SPEC["T"], SPEC["r"], SPEC["q"],
          SPEC["sigma"])
RTOL = 2e-5
K4_SIGNED = (11, 13, 15, 17, 19)
K4_PAYOFFS = {
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
# the stochastic-volatility dynamics of phase 5's K4 calls
SV_PHASE5 = (dict(heston=dict(v0=0.04, kappa=1.5, theta=0.04, xi=0.4,
                              rho=-0.6)),
             dict(sabr=dict(alpha0=0.25, beta=1.0, nu=0.5, rho=-0.4)))
# the dynamics dict of each stochastic-volatility K4_TIMED call: phase 5's,
# and its Andersen QE and β = 0.5 variants
SV_TIMED = {"heston": SV_PHASE5[0],
            "heston_qe": dict(SV_PHASE5[0], scheme="qe"),
            "sabr_ln": SV_PHASE5[1],
            "sabr_cev": dict(sabr=dict(SV_PHASE5[1]["sabr"], beta=0.5))}
# K4's timed instantiations (all antithetic): label -> (dynamics, payoff,
# Greek moments, paths, steps) of the main-path call each times
K4_TIMED = {
    "gbm asian": ("gbm", "asian", False, 1_000_000, 252),
    "gbm asian greeks": ("gbm", "asian", True, 1_000_000, 252),
    "lsv barrier": ("lsv", "barrier", False, 1 << 20, 96),
    "lsv_qe barrier": ("lsv_qe", "barrier", False, 1 << 20, 96),
    "heston vanilla": ("heston", "vanilla", False, 1_000_000, 64),
    "sabr_ln vanilla": ("sabr_ln", "vanilla", False, 1_000_000, 64),
    "heston_qe vanilla": ("heston_qe", "vanilla", False, 1_000_000, 64),
    "sabr_cev vanilla": ("sabr_cev", "vanilla", False, 1_000_000, 64),
}

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


def ops_k8_ladder(n_strikes: int, m: int, n_t: int,
                  american: bool = False) -> float:
    """K8's least work for a ladder: per strike, row and step the rhs
    (three products of the layer with the row's coefficients and two adds,
    5), the forward elimination (d' = (d − a·d'_prev)·rcp, 3), the back
    substitution (2) and, American, the projection against the intrinsic
    value (1); per row and step, shared by every strike, σ's operator
    coefficients, the pivot c' and its reciprocal (~25)."""
    return ((10 + american) * n_strikes + 25) * m * n_t


def ops_k5_point(n_steps: int) -> float:
    """K5 per point, for the geometric Asian that phase 6 times: per step
    the Sobol word by one Gray-code XOR (1), the cell-centred uniform (4),
    norminv32 (45), one step of the Brownian-bridge recursion (a multiply
    and two FMAs, 5), the drift (an FMA, 2) and the running log-sum (1);
    per point the Gray-code bit (1), the two closing exp32 (44), the payoff
    and its 6 moments (~20). The geometric average needs no exp32 per step."""
    return 58 * n_steps + 65


# K5's cases: phase 3's (the five payoffs at 65 536 points x 8 replicates x
# 64 steps, the Asian and the vanilla at 252 steps) and phase 6's Asian at
# 2^20 x 8 x 252; "payoff points steps"
K5_CASES = ([f"{p} 65536 64" for p in ("vanilla", "barrier", "asian",
                                       "digital", "lookback")]
            + ["asian 65536 252", "vanilla 65536 252", "asian 1048576 252"])
# K5's (n_programs, 6) sums at ``K5_CASES`` as the kernel of commit 95d2791
# (the dense bridge product over a slab of B, the full Sobol ladder a
# thread) gave them on an NVIDIA H100 80GB HBM3, by SHA-256 of their f32
# bytes. Any later kernel must give them bit for bit.
QMC_PATH_SUMS = {
    "vanilla 65536 64":
        "891d870dd3e92158cc85dc304308d8840518e762052627316cb06f6979bb18fa",
    "barrier 65536 64":
        "445e9e42afd753643d92e5803394da8a98afeabbbb57a27e934f6127a3d521aa",
    "asian 65536 64":
        "41e0c4e03854ad262d198dfe2ddb614ca5598789724a413976b83204f3f799fc",
    "digital 65536 64":
        "da60608d60c335a45320c99361e5b0eb02c7eacd3fb4c7eeb796728e728df8df",
    "lookback 65536 64":
        "ce6670c0400ab04e301ba04ad9ff01eb012c91eb6dafd5fb9bea77fb5a5c1249",
    "asian 65536 252":
        "e215d071f5fce1b80c16c367eee975d0acadfe7b74b102900d049d7c98eb7ea8",
    "vanilla 65536 252":
        "891d870dd3e92158cc85dc304308d8840518e762052627316cb06f6979bb18fa",
    "asian 1048576 252":
        "fbdfd7084212c7ec22695357b7042bfba4d2f4c6acd256b81d3ff886cbea26b9",
}
# K2's cases: phase 3's (seed 5: the call and the put at 2^20 points x 16
# replicates, the call at 2^22 x 16) and the main path's call (seed 7,
# euro_price_mc(backend="qmc") at 2^22 x 16); "seed kind points replicates"
K2_CASES = ("5 call 1048576 16", "5 put 1048576 16", "5 call 4194304 16",
            "7 call 4194304 16")
# K2's (n_programs, 13) rows at ``K2_CASES`` as the kernel of commit
# 4bc6091 (one thread per element, a block tree and a combine pass) gave
# them on an NVIDIA H100 80GB HBM3, by SHA-256 of their f32 bytes.
K2_SUMS = {
    "5 call 1048576 16":
        "4473a6fd6d69fbb2353b3cd4a47868378eadbdeb3fd38679daac183de8dc610d",
    "5 put 1048576 16":
        "d54f1ad47d2d658cfd571018085e33904fcf9a9459c130ac1ed5c8de7b9e58be",
    "5 call 4194304 16":
        "cea23402e1917cf4291bd548c76f93bd23f34fe9f8859dca060905311e44c7c2",
    "7 call 4194304 16":
        "55e0342e094411742b9e1b387a94a0d9044951533232fa69af18cb3e8d413d85",
}
# a terminal_mc_kernel instantiation's mangled template arguments:
# antithetic, invcdf
K1_KERNEL = re.compile(r"terminal_mc_kernelILb([01])ELb([01])EE")
# a qmc_path_kernel instantiation's: the payoff (2 is the Asian)
K5_KERNEL = re.compile(r"qmc_path_kernelILi(\d)EE")


def k5_setup(qmp, dev, payoff, n, d, R=8):
    """(tensors, kwargs, (R, programs per replicate)) of a K5 call: seed 3,
    ``MARKET``, barrier 130 up-and-out, 8 replicates; the Asian geometric,
    driven through ``_kernel_inputs`` and ``qmc_path``, which every tree of
    the port has."""
    m_bits, d_pad, reps, ppr = qmp._plan(n, d, R)
    arrays = qmp._kernel_inputs(3, n, d, *MARKET, n_replicates=R,
                                barrier=130.0, rebate=0.0, payout=1.0)
    tensors = [torch.from_numpy(a).to(dev) for a in arrays]
    kw = dict(n_programs=R * ppr, reps=reps, progs_per_rep=ppr,
              n_steps=d, d_pad=d_pad, m_bits=m_bits,
              payoff_id=qmp.PAYOFF_IDS[payoff], barrier_up=True,
              knock_in=False, is_call=True,
              arithmetic=payoff != "asian", fixed_strike=True)
    return tensors, kw, (R, ppr)


def k2_setup(dev, case: str):
    """(seed, params, kwargs, R) of the K2 call a ``K2_CASES`` case names,
    ``MARKET`` and the grid of ``mc_sumstats_qmc``: seed and params on the
    card, or, for a tree whose ``terminal_qmc`` takes ``device=``, on the
    host with ``device`` in kwargs, as its ``mc_sumstats_qmc`` passes
    them."""
    from optpricer_tpu_torch.ops import terminal_mc as tmc

    seed, kind, n, R = case.split()
    n_rep, reps, ppr = tmc._plan_qmc(int(n), int(R))
    kw = dict(n_programs=int(R) * ppr, reps=reps, progs_per_rep=ppr)
    where = dev
    if "device" in inspect.signature(tmc.terminal_qmc).parameters:
        where, kw["device"] = "cpu", dev
    params = tmc._terminal_params(n_rep, *MARKET, kind == "call").to(where)
    return tmc._seed_pair(int(seed), where), params, kw, int(R)


def sha256(t: torch.Tensor) -> str:
    return hashlib.sha256(t.cpu().numpy().tobytes()).hexdigest()


def k4_call(dev, n, n_steps, pay, dyn, anti, greeks, mkt=MARKET):
    """(seed, params, run kwargs, dynamics, geo_ey, market) of one K4 call
    under GBM (``dyn`` empty) or a ``SV_PHASE5``-like dynamics dict."""
    from optpricer_tpu_torch.models.analytic import geometric_asian_price_f64
    from optpricer_tpu_torch.ops import path_mc as pmc
    from optpricer_tpu_torch.ops import terminal_mc as tmc

    params, static = pmc._resolve_config(
        n, n_steps, *mkt, pay.get("is_call", True), pay["payoff"],
        anti, pay.get("barrier", 0.0),
        pay.get("barrier_type", "up-and-out"), pay.get("rebate", 0.0),
        pay.get("average_type", "arithmetic"),
        pay.get("strike_type", "fixed"), 1.0, None,
        dyn.get("scheme", "log_euler"), 0.01, dyn.get("heston"),
        dyn.get("sabr"), pay.get("geo_cv", False))
    reps, n_prog = tmc._plan_grid(n, pmc.TILE)
    run = dict(n_programs=n_prog, reps=reps, with_greeks=greeks, **static)
    geo = geometric_asian_price_f64(*mkt, n_steps=n_steps) \
        if pay.get("geo_cv") else None
    return (tmc._seed_pair(11, dev), params.to(dev), run,
            "gbm" if not dyn else "sv", geo, mkt)


def k4_timed_calls(dev, multi, n=None) -> dict:
    """label -> (seed, params, run kwargs) of each ``K4_TIMED`` call at its
    main-path shape, or at ``n`` paths: config 3's asian with the
    geometric CV (K = 100, 1M x 252), with and without Greek moments; the
    Heston Euler and SABR β=1 calls of phase 5 and their QE and β = 0.5
    variants (``SV_TIMED``, 1M x 64); lsv and lsv_qe up-and-out 130 on
    ``multi``'s calibrated tables (2^20 x 96)."""
    calls = {}
    for label, (dynamics, payoff, greeks, n_full, n_steps) in \
            K4_TIMED.items():
        if dynamics in ("lsv", "lsv_qe"):
            scheme = "qe" if dynamics == "lsv_qe" else "euler"
            if scheme not in multi.models:
                multi.models[scheme] = multi.calibrate(scheme)
            calls[label] = multi.k4_lsv(multi.models[scheme], n or n_full,
                                        dict(payoff="barrier", barrier=130.0))
            continue
        if dynamics == "gbm":
            pay, dyn, mkt = K4_PAYOFFS["asian-geo_cv"], {}, \
                (100.0, 100.0, *MARKET[2:])
        else:
            pay, mkt, dyn = K4_PAYOFFS["vanilla"], MARKET, \
                SV_TIMED[dynamics]
        calls[label] = k4_call(dev, n or n_full, n_steps, pay, dyn, True,
                               greeks, mkt)[:3]
    return calls


def k4_waves(dev) -> dict:
    """label -> (resident blocks per SM, grid blocks, waves, paths priced)
    of each ``K4_TIMED`` instantiation at its shape on this card."""
    from optpricer_tpu_torch.ops import path_mc as pmc
    from optpricer_tpu_torch.ops import terminal_mc as tmc

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    out = {}
    for label, (dynamics, payoff, greeks, n, _) in K4_TIMED.items():
        per_sm = pmc.blocks_per_sm(dynamics, pmc.PAYOFF_IDS[payoff], greeks,
                                   True)
        reps, n_prog = tmc._plan_grid(n, pmc.TILE)
        blocks, _ = pmc._launch_plan(dynamics, n_prog, reps)
        out[label] = (per_sm, blocks, blocks / (per_sm * sms),
                      n_prog * reps * pmc.TILE)
    return out


def k1_k5_waves(dev) -> dict:
    """label -> (resident blocks per SM, grid blocks, waves) of K1
    (antithetic Box-Muller) at 2^30 draws and of K5's Asian at its two
    timed shapes on this card."""
    from optpricer_tpu_torch.ops import qmc_path as qmp
    from optpricer_tpu_torch.ops import terminal_mc as tmc

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    reps, n_prog = tmc._plan_grid(1 << 30, 2 * tmc.TILE)
    per_sm = tmc.blocks_per_sm(True, False)
    blocks = n_prog * tmc._BLOCKS_PER_PROGRAM
    out = {"K1 anti box-muller 2^30": (per_sm, blocks,
                                       blocks / (per_sm * sms))}
    for n, d in ((65_536, 64), (1 << 20, 252)):
        _, _, reps, ppr = qmp._plan(n, d, 8)
        per_sm = qmp.blocks_per_sm(qmp.PAYOFF_IDS["asian"], d)
        blocks = 8 * ppr * reps * qmp._BLOCKS_PER_TILE
        out[f"K5 asian {n} x 8 x {d}"] = (per_sm, blocks,
                                          blocks / (per_sm * sms))
    return out


def bound(ops: float, n_bytes: float):
    """(bound_ms, bound_by): the larger of ops/peak and bytes/rate."""
    t_ops, t_bytes = ops / PEAK_OPS, n_bytes / PEAK_BYTES
    if t_ops >= t_bytes:
        return t_ops * 1e3, "operations"
    return t_bytes * 1e3, "bytes"


def smile(S, t):
    """The local-vol smile of tests/test_pallas_tridiag.py:53-54."""
    return 0.2 + 0.1 * torch.exp(-(torch.log(S / 100.0)) ** 2) + 0.05 * t


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


def cuda_ms(fn, reps: int = 5, queued: bool = False) -> float:
    """Median milliseconds of ``fn`` over ``reps`` runs after a warm-up.
    ``queued``: the start event waits behind a ~2 ms device sleep, so the
    host has enqueued ``fn``'s launches before the device reaches them and
    the time is the device's alone, not the host's launch latency (a
    kernel of a few µs otherwise measures the Python wrapper)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        if queued:
            torch.cuda._sleep(4_000_000)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def event_ms(fn):
    """(fn(), milliseconds of that one call) by CUDA events."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def timed(fn):
    """(fn(), wall seconds) on the host clock, ending in a synchronize."""
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def wall_ms(fn, reps: int = 21) -> float:
    """Median host-clock milliseconds of ``fn`` over ``reps`` calls after a
    warm-up, each ending in a synchronize."""
    fn()
    return statistics.median(timed(fn)[1] * 1e3 for _ in range(reps))


def device_busy(fn, names=None):
    """(wall ms, device-busy ms, kernels, busy ms of the kernels whose name
    ``names`` matches) of one call of ``fn`` under torch.profiler: the
    summed durations of the kernels it ran (one stream, so they do not
    overlap) against the host clock."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, wall = timed(fn)
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
    matched = sum(e.time_range.elapsed_us() for e in kernels
                  if names is not None and names.search(e.name)) / 1e3
    return wall * 1e3, busy, len(kernels), matched


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


class PdeSlice:
    """The PDE slice (K7, K8; BASELINE config 4 and the local-vol ladders):
    its kernel checks, determinism, main path and timings at the main
    path's sizes."""

    LV_MARKET = (100.0, 1.0, 0.04, 0.01)  # S0, T, r, q
    N_STRIKES = 1024      # the ladder: strikes 70..130 x N_S x N_T
    N_S = 512
    N_T = 512
    K7_SHAPE = (511, 1024)
    GRID4 = dict(N_S=512, N_t=256)  # BASELINE config 4
    CRR_STEPS = 4000

    def __init__(self, dev, card):
        self.dev, self.card = dev, card
        self.strikes = torch.linspace(70.0, 130.0,
                                      self.N_STRIKES).double().numpy()
        self.wall = {}
        self.k7_bytes = {}
        self.plain_thomas_ms = None

    # -- inputs ----------------------------------------------------------
    def k7_system(self, n, batch, dtype, shared=False, seed=0,
                  garbage=True):
        """Diagonally dominant (n, batch) systems; ``shared``: one
        coefficient column for every system; ``garbage`` in a[0], c[n-1]."""
        g = torch.Generator().manual_seed(seed)
        a, b, c, d = (torch.randn(n, batch, generator=g, dtype=torch.float64)
                      for _ in range(4))
        b = b + 4.0
        if shared:
            a, b, c = a[:, :1], b[:, :1], c[:, :1]
        if garbage:
            a[0] = 1e30
            c[-1] = float("nan")
        return [t.to(device=self.dev, dtype=dtype).contiguous()
                for t in (a, b, c, d)]

    def barrier_system(self, dtype):
        """The implicit θ = ½ rows of the ladder's grid at t = 0 as
        ``models/pde._fd_solve`` builds them, the nodes at or above 130
        knocked out into identity rows, garbage in a[0] and c[n-1], and
        the strikes' payoffs as the (strikes, n) right-hand sides."""
        from optpricer_tpu_torch.models.pde import _operator_tridiag
        from optpricer_tpu_torch.ops.grid import build_grid

        S0, T, r, q = self.LV_MARKET
        x_np, dx, dt = build_grid(S0, T, 0.3, self.N_S, self.N_T, 4.0)
        S = torch.exp(torch.as_tensor(x_np[1:-1], dtype=torch.float64))
        a_L, b_L, c_L = _operator_tridiag(smile(S, 0.0), dx, r, q)
        out = S >= 130.0
        a_L, b_L, c_L = (torch.where(out, 0.0, t) for t in (a_L, b_L, c_L))
        a, b, c = -0.5 * dt * a_L, 1.0 - 0.5 * dt * b_L, -0.5 * dt * c_L
        a[0] = 1e30
        c[-1] = float("nan")
        K = torch.as_tensor(self.strikes)[:, None]
        d = torch.where(out, 0.0, torch.clamp(S - K, min=0.0))
        return [t.to(device=self.dev, dtype=dtype) for t in (a, b, c, d)]

    def k8_setup(self, kind, american, method, strikes=None, N_S=None,
                 N_t=None):
        """(operands, σ table, fd_lv kwargs, layer -> prices) for K8 on the
        ladder, or on ``strikes`` x ``N_S`` x ``N_t``; ``kind`` "call",
        "put" or a call mask."""
        from optpricer_tpu_torch.ops import fd_lv as flv

        S0, T, r, q = self.LV_MARKET
        strikes = self.strikes if strikes is None else strikes
        N_S, N_t = N_S or self.N_S, N_t or self.N_T
        (x_np, dt, K_arr, mask, params, K32, sign, m, m_pad) = \
            flv._kernel_inputs(S0, strikes, T, r, q, kind, N_S=N_S, N_t=N_t,
                               S_max_mult=4.0, ref_vol=0.3)
        tab = flv._sigma_table(smile, x_np, dt, N_S, N_t, m_pad, self.dev)
        ops = [torch.from_numpy(t).to(self.dev) for t in (params, K32, sign)]
        kw = dict(n_t=N_t, m=m, m_pad=m_pad, theta=0.5,
                  american=american, method=method)
        return ops, tab, kw, lambda V: flv._ladder_prices(
            V, x_np, K_arr, mask, S0, r, T)

    # -- phase 3 ---------------------------------------------------------
    def phase3(self, record):
        from optpricer_tpu_torch.ops import fd_lv as flv
        from optpricer_tpu_torch.ops import thomas as tth

        def k7_check(case, got, ref, rtol):
            torch.cuda.synchronize()
            if not torch.isfinite(got).all():
                raise AssertionError(f"tridiag {case}: non-finite solution")
            # norm-wise: max |x_k - x_p| / max |x_p|
            diff = (got - ref).abs().double()
            rel = diff.max().item() / ref.abs().max().item()
            if rel > rtol:
                raise AssertionError(f"tridiag {case}: max rel err {rel:.3e} "
                                     f"> {rtol}")
            record("tridiag", rel, diff.max().item(), 0.0, case)

        n, batch = self.K7_SHAPE
        rtols = {torch.float64: 1e-10, torch.float32: 2e-5}
        f64, f32 = torch.float64, torch.float32
        cases = [(f"{n} x {batch} f64", (n, batch, f64)),
                 (f"{n} x {batch} f32", (n, batch, f32)),
                 (f"{n} x {n} f64 shared columns (propagator build)",
                  (n, n, f64, True))]
        # the batch-1 solves of the PDE marches (PSOR's 511 rows, the
        # local-vol FD's 199), n <= 3, and a size for the partitioned kernel
        cases += [(f"{m} x 1 {tag}", (m, 1, dt)) for m, dt, tag in (
            (n, f64, "f64"), (199, f64, "f64"), (199, f32, "f32"))]
        cases += [(f"{m} x 5 f64", (m, 5, f64)) for m in (1, 2, 3)]
        cases += [(f"{m} x 8 {tag} (partitioned)", (m, 8, dt))
                  for m, dt, tag in ((1025, f64, "f64"), (1025, f32, "f32"),
                                     (1536, f64, "f64"), (4095, f64, "f64"),
                                     (4095, f32, "f32"))]
        for case, args in cases:
            a, b, c, d = self.k7_system(*args)
            k7_check(case, tth.tridiag_solve_kernel(a, b, c, d),
                     tth._thomas_plain(a, b, c, d), rtols[args[2]])
        # the "auto" ladder's call: one (n,) row per coefficient for every
        # strike, the (strikes, n) rhs, through the last-axis adapter
        for dtype, tag in ((torch.float64, "f64"), (torch.float32, "f32")):
            a, b, c, d = self.k7_system(n, batch, dtype, shared=True)
            k7_check(f"{batch} x {n} {tag} shared rows, last axis (the "
                     "ladder's call)",
                     tth.tridiag_solve_kernel_lastdim(a[:, 0], b[:, 0],
                                                      c[:, 0], d.t()),
                     tth._thomas_plain(a, b, c, d).t(), rtols[dtype])
        a, b, c, d = (t.t().contiguous()
                      for t in self.k7_system(37, 3, torch.float64))
        k7_check("ragged (3, 37) last axis",
                 tth.tridiag_solve_kernel_lastdim(a, b, c, d),
                 tth._thomas_plain(a.t(), b.t(), c.t(), d.t()).t(), 1e-10)
        for dtype, tag in ((f64, "f64"), (f32, "f32")):
            a, b, c, d = self.barrier_system(dtype)
            k7_check(f"{batch} x {n} {tag} θ-scheme rows, knocked out above "
                     "130, last axis",
                     tth.tridiag_solve_kernel_lastdim(a, b, c, d),
                     tth._thomas_plain(a[:, None], b[:, None], c[:, None],
                                       d.t()).t(), rtols[dtype])

        # the pre-kernel's plan of both forms at the ladder's shape, held
        # to its plain version exactly (the same correctly rounded f32
        # operations)
        for method in ("pcr", "thomas"):
            ops, tab, kw, _ = self.k8_setup("call", False, method)
            plan_kw = {k: kw[k] for k in ("n_t", "m", "m_pad", "theta",
                                          "method")}
            got = flv.fd_lv_plan(ops[0], tab, **plan_kw)
            ref = flv._fd_lv_plan_plain(ops[0], tab, **plan_kw)
            gap = (got - ref).abs().max().item()
            print(f"phase 3 fd_lv plan {method} {self.N_S - 1} rows x "
                  f"{self.N_T} steps: {got.numel()} words, max |kernel − "
                  f"plain| {gap:.3e}, equal: {torch.equal(got, ref)}")
            if not torch.equal(got, ref):
                raise AssertionError(f"fd_lv plan {method}: kernel and plain "
                                     f"plans differ (max {gap:.3e})")

        # both methods at the ladder's full 512 steps; the plain Thomas
        # march (~5·10^6 small launches) is timed once on the European
        # call; a ragged ladder of 1 025 strikes, calls and puts mixed, and
        # PCR's largest grid, 1 024 rows; Thomas's ragged ladder at 32
        # steps (its plain march is a Python loop over rows and steps)
        ragged = torch.linspace(70.0, 130.0, 1025).double().numpy()
        mixed = (torch.arange(ragged.size) % 2 == 0).numpy()
        k8_cases = [(kind, am, "pcr", {}) for kind in ("call", "put")
                    for am in (False, True)]
        k8_cases += [("call", False, "thomas", {}),
                     ("put", True, "thomas", {}),
                     (mixed, True, "pcr", dict(strikes=ragged)),
                     ("put", True, "pcr", dict(N_S=1025)),
                     (mixed, True, "thomas", dict(strikes=ragged, N_t=32))]
        for kind, am, method, shape in k8_cases:
            ops, tab, kw, prices = self.k8_setup(kind, am, method, **shape)
            k = flv.fd_lv(*ops, tab, **kw)
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            p = flv._fd_lv_plain(*ops, tab, **kw)
            end.record()
            end.synchronize()
            if method == "thomas" and not am and not shape:  # the call
                self.plain_thomas_ms = start.elapsed_time(end)
            dprice = float(abs(prices(k) - prices(p)).max())
            label = kind if isinstance(kind, str) else "calls and puts"
            case = (f"{method} {label} american={am} {k.shape[1]} x "
                    f"{kw['m']} x {kw['n_t']}")
            print(f"phase 3 fd_lv {case}: max |price difference| "
                  f"{dprice:.3e}; plain version {start.elapsed_time(end):.1f}"
                  f" ms [{self.card}]")
            if not (torch.isfinite(k).all() and dprice <= RTOL):
                raise AssertionError(f"fd_lv {case}: max |price difference| "
                                     f"{dprice:.3e} > {RTOL}")
            record("fd_lv", (k - p).abs().max().item(), dprice, 0.0, case)

    # -- phase 4 ---------------------------------------------------------
    def phase4(self):
        from optpricer_tpu_torch.ops import fd_lv as flv

        for method in ("pcr", "thomas"):
            ops, tab, kw, _ = self.k8_setup("put", True, method)
            a = flv.fd_lv(*ops, tab, **kw).clone()
            b = flv.fd_lv(*ops, tab, **kw).clone()
            if not torch.equal(a, b):
                raise AssertionError(f"fd_lv {method} is not bitwise "
                                     "reproducible")

    # -- phase 5 ---------------------------------------------------------
    def config4(self, label, fn):
        """``fn(device=...)`` on the card (timed) and on the CPU: equal to
        rtol 1e-9."""
        out, self.wall[label] = timed(lambda: fn(device=self.dev))
        cpu = fn(device="cpu")
        pairs = out.items() if isinstance(out, dict) else [("", out)]
        for key, value in pairs:
            ref = cpu[key] if key else cpu
            if not abs(value - ref) <= 1e-9 * abs(ref):
                raise AssertionError(f"{label} {key}: {value} on "
                                     f"{self.dev} vs {ref} on the CPU")
        return out

    def ladder(self, solver, dtype=None):
        import optpricer_tpu_torch as tp

        S0, T, r, q = self.LV_MARKET
        return tp.fd_price_local_vol_batch(
            S0, self.strikes, T, r, q, smile, "call", solver=solver,
            N_S=self.N_S, N_t=self.N_T, ref_vol=0.3, dtype=dtype,
            device=self.dev)

    def phase5(self) -> dict:
        """The PDE path with its launch counts set to 0 just before and
        read just after; returns them."""
        import optpricer_tpu_torch as tp
        from optpricer_tpu_torch.ops import fd_lv as flv
        from optpricer_tpu_torch.ops import thomas as tth

        dev, grid4 = self.dev, self.GRID4
        pde_fns = {"tridiag_pcr_kernel": tth.tridiag_solve_kernel,
                   "fd_lv_kernel": flv.fd_lv}
        for fn in pde_fns.values():
            fn.launches = 0
        tth.tridiag_solve_kernel.launches_by_shape.clear()
        flv.fd_lv.launches_by_method = dict.fromkeys(flv.METHODS, 0)
        print("phase 5 main path, PDE:")
        t0 = time.perf_counter()
        spec4 = tp.OptionSpec(S0=100.0, K=100.0, T=1.0, r=0.05, sigma=0.2)
        bs4 = {k: tp.bs_price(spec4, k, device=dev) for k in ("call", "put")}
        delta4 = float(tp.bs_greeks_vec(100.0, 100.0, 1.0, 0.05, 0.0, 0.2,
                                        "call", device=dev)["delta"])
        c4 = self.config4
        eu = c4("fd_price European call", lambda **k: tp.fd_price(
            spec4, "call", **grid4, **k))
        eu_put = c4("fd_price European put", lambda **k: tp.fd_price(
            spec4, "put", **grid4, **k))
        am = c4("fd_price American put PSOR", lambda **k: tp.fd_price(
            spec4, "put", american=True, american_method="psor", **grid4,
            **k))
        ko = c4("fd_price_barrier up-and-out 130", lambda **k:
                tp.fd_price_barrier(spec4, "call", 130.0, "up-and-out",
                                    **grid4, **k))
        ki = c4("fd_price_barrier up-and-in 130", lambda **k:
                tp.fd_price_barrier(spec4, "call", 130.0, "up-and-in",
                                    **grid4, **k))
        gk = c4("fd_greeks", lambda **k: tp.fd_greeks(spec4, "call",
                                                       **grid4, **k))
        fem = c4("fem_price", lambda **k: tp.fem_price(spec4, "call",
                                                        **grid4, **k))
        tree = tp.crr(spec4, "put", N=self.CRR_STEPS, american=True,
                      device=dev)
        print(f"  config 4 ({grid4['N_S']} x {grid4['N_t']}): European call "
              f"{eu:.10f} (BS {bs4['call']:.10f}), put {eu_put:.10f}; "
              f"American put PSOR {am:.10f} (crr {self.CRR_STEPS} "
              f"{tree:.10f}); up-and-out {ko:.10f}, up-and-in {ki:.10f}; "
              f"delta {gk['delta']:.6f} (BS {delta4:.6f}), gamma "
              f"{gk['gamma']:.6f}, theta {gk['theta']:.6f}; fem {fem:.10f}; "
              f"every call equals device='cpu' to rtol 1e-9")
        checks = [
            ("European call vs BS (rel 1e-3)",
             abs(eu - bs4["call"]) / eu < 1e-3),
            ("American put > European put", am > eu_put),
            ("American put vs crr (rel 0.003)",
             abs(am - tree) / tree < 0.003),
            ("0 < KO < European", 0.0 < ko < eu),
            ("KI + KO = vanilla", abs(ki + ko - eu) <= 1e-12 * eu),
            ("fd_greeks delta vs BS (0.005)",
             abs(gk["delta"] - delta4) < 0.005),
            ("fem_price vs BS (rel 2e-3)",
             abs(fem - bs4["call"]) / bs4["call"] < 2e-3),
        ]
        for what, ok in checks:
            if not ok:
                raise AssertionError(f"config 4: {what} failed")

        flat = tp.fd_price_local_vol(100.0, 100.0, 1.0, 0.05, 0.0,
                                     lambda S, t: 0.2 * torch.ones_like(S),
                                     "call", N_S=200, N_t=200, ref_vol=0.2,
                                     device=dev)
        term = tp.fd_price_local_vol(
            100.0, 100.0, 1.0, 0.05, 0.0,
            lambda S, t: torch.sqrt(0.03 + 0.02 * t) * torch.ones_like(S),
            "call", N_S=300, N_t=300, ref_vol=0.2, device=dev)
        bs_rms = tp.bs_price(tp.OptionSpec(100.0, 100.0, 1.0, 0.05, 0.2),
                             "call", device=dev)   # RMS of σ(t) is 0.2
        print(f"  fd_price_local_vol 200 x 200, σ ≡ 0.2: {flat:.10f} (BS "
              f"{bs4['call']:.10f}); 300 x 300, σ(t)² = 0.03 + 0.02t: "
              f"{term:.10f} (BS at the RMS vol 0.2 {bs_rms:.10f})")
        if abs(flat - bs4["call"]) / bs4["call"] >= 0.002 \
                or abs(term - bs_rms) / bs_rms >= 0.005:
            raise AssertionError("fd_price_local_vol off Black-Scholes")

        # "auto" in its float64 default and in float32, the fused kernel's
        # type: the three float32 ladders agree to atol 2e-4 + rtol 2e-5,
        # and each to the float64 one within the round-off of a 512-step
        # float32 march (rtol 1e-4; 6.6e-5 measured on the CPU)
        ladders = {}
        for label, solver, dtype in (("auto", "auto", None),
                                     ("auto f32", "auto", "float32"),
                                     ("fused", "fused", None),
                                     ("fused_thomas", "fused_thomas", None)):
            out, self.wall[f"ladder {label}"] = timed(
                lambda: self.ladder(solver, dtype))
            out = out.cpu().numpy() if isinstance(out, torch.Tensor) else out
            if out.shape != self.strikes.shape \
                    or not math.isfinite(float(out.sum())):
                raise AssertionError(f"ladder {label}: bad output")
            ladders[label] = out.astype(float)
        mid = len(self.strikes) // 2
        f64 = ladders["auto"]
        for a, b in (("fused", "auto f32"), ("fused_thomas", "auto f32"),
                     ("fused", "fused_thomas")):
            gap = abs(ladders[a] - ladders[b])
            excess = (gap - 2e-4 - 2e-5 * abs(ladders[b])).max()
            print(f"  ladder {len(self.strikes)} x {self.N_S} x {self.N_T} "
                  f"{a} vs {b}: max |diff| {gap.max():.3e}, largest excess "
                  f"over atol 2e-4 + rtol 2e-5 {excess:.3e}; K="
                  f"{self.strikes[mid]:.4f} {ladders[a][mid]:.8f} vs "
                  f"{ladders[b][mid]:.8f}")
            if excess > 0.0:
                raise AssertionError(f"ladder {a} vs {b}: max gap "
                                     f"{gap.max():.3e}")
        for label in ("auto f32", "fused", "fused_thomas"):
            rel = (abs(ladders[label] - f64) / abs(f64)).max()
            print(f"  ladder {label} vs float64 auto: max rel diff "
                  f"{rel:.3e} (rtol 1e-4)")
            if rel > 1e-4:
                raise AssertionError(f"ladder {label} vs float64: {rel:.3e}")

        flags = ["--S0", "100", "--K", "100", "--T", "1", "--r", "0.05",
                 "--sigma", "0.2", "--N-S", str(grid4["N_S"]), "--N-t",
                 str(grid4["N_t"]), "--american", "--kind", "put"]
        out_fd = run_cli(["fd", *flags])
        proj = tp.fd_price(spec4, "put", american=True, **grid4, device=dev)
        if out_fd != f"{proj:.10f}":
            raise AssertionError(f"cli fd {out_fd!r} vs {proj:.10f}")
        print(f"  cli fd American put (projection): {out_fd}")
        launches = {name: fn.launches for name, fn in pde_fns.items()}
        self.k7_shapes = dict(tth.tridiag_solve_kernel.launches_by_shape)
        if sum(self.k7_shapes.values()) != launches["tridiag_pcr_kernel"]:
            raise AssertionError(f"K7 launches by shape {self.k7_shapes} "
                                 "do not add up to its count")
        self.k8_methods = dict(flv.fd_lv.launches_by_method)
        if sum(self.k8_methods.values()) != launches["fd_lv_kernel"]:
            raise AssertionError(f"K8 launches by method {self.k8_methods} "
                                 "do not add up to its count")
        print(f"  PDE path {time.perf_counter() - t0:.2f} s; launches in this "
              f"process: {launches}; K7 launches by (rows, systems): "
              f"{dict(self.k7_shapes)}; K8 launches by method: "
              f"{self.k8_methods}")
        counts = dict(launches, **{f"fd_lv_kernel {method}": count
                                   for method, count
                                   in self.k8_methods.items()})
        for name, count in counts.items():
            if count == 0:
                raise AssertionError(f"{name} was not launched on the PDE "
                                     "path")
        return launches

    # -- phase 6 ---------------------------------------------------------
    def phase6(self, times):
        """Adds K7's, K8's and the ladder's times to ``times``, prints every
        entry of ``times``, then the config-4 walls."""
        import optpricer_tpu_torch as tp
        from optpricer_tpu_torch.ops import fd_lv as flv
        from optpricer_tpu_torch.ops import thomas as tth
        from optpricer_tpu_torch.ops import tridiag

        dev = self.dev
        n, batch = self.K7_SHAPE
        # K7 is timed like every kernel (events around the wrapper, the
        # host's launch latency in) and also queued behind a device sleep,
        # the device's time alone: a single system's launch takes a few µs,
        # less than the wrapper's host time
        def k7_times(what, fn):
            times[("k7", what)] = cuda_ms(fn, reps=21)
            times[("k7 device", what)] = cuda_ms(fn, reps=21, queued=True)

        for dtype, tag in ((torch.float64, "f64"), (torch.float32, "f32")):
            a, b, c, d = self.k7_system(n, batch, dtype, seed=1)
            k7_times(tag, lambda: tth.tridiag_solve_kernel(a, b, c, d))
            times[("k7plain", tag)] = cuda_ms(
                lambda: tth._thomas_plain(a, b, c, d))
            self.k7_bytes[tag] = 5 * n * batch * a.element_size()
        a, b, c, d = self.k7_system(n, batch, torch.float64, shared=True,
                                    seed=1)
        k7_times("shared columns f64",
                 lambda: tth.tridiag_solve_kernel(a, b, c, d))
        # the ladder's call: one coefficient row, 1 024 (..., n) rhs rows
        rows = [t[:, 0] for t in (a, b, c)]
        rhs = d.t().contiguous()
        k7_times("ladder call (last axis) f64",
                 lambda: tth.tridiag_solve_kernel_lastdim(*rows, rhs))
        # the single systems of the PSOR and local-vol FD marches
        for m in (n, 199):
            a, b, c, d = self.k7_system(m, 1, torch.float64, seed=1)
            k7_times(f"{m} x 1 f64",
                     lambda: tth.tridiag_solve_kernel(a, b, c, d))
        # the library call: a dense batched LU solve of the same systems
        a, b, c, d = self.k7_system(n, batch, torch.float64, seed=1,
                                    garbage=False)
        dense = tridiag.tridiag_dense(a.t(), b.t(), c.t())
        rhs = d.t().unsqueeze(-1).contiguous()
        times[("k7 library torch.linalg.solve", "f64")] = cuda_ms(
            lambda: torch.linalg.solve(dense, rhs), reps=3)
        gap = (torch.linalg.solve(dense, rhs)[..., 0].t()
               - tth.tridiag_solve_kernel(a, b, c, d)).abs().max().item()
        del dense
        torch.cuda.empty_cache()
        print(f"phase 6 dense torch.linalg.solve vs K7: max |x difference| "
              f"{gap:.3e}")
        for method in ("pcr", "thomas"):
            for kind, am, tag in (("put", True, "american put"),
                                  ("call", False, "call")):
                ops, tab, kw, _ = self.k8_setup(kind, am, method)
                times[(f"k8 {tag}", method)] = cuda_ms(
                    lambda: flv.fd_lv(*ops, tab, **kw))
            plan_kw = {k: kw[k] for k in ("n_t", "m", "m_pad", "theta",
                                          "method")}
            times[("k8 plan", method)] = cuda_ms(
                lambda: flv.fd_lv_plan(ops[0], tab, **plan_kw))
            if method == "pcr":   # the European calls
                times[("k8plain", method)] = cuda_ms(
                    lambda: flv._fd_lv_plain(*ops, tab, **kw), reps=3)
        times[("k8plain", "thomas")] = self.plain_thomas_ms
        for solver in ("auto", "fused", "fused_thomas"):
            times[(f"ladder {solver}", "call")] = cuda_ms(
                lambda: self.ladder(solver), reps=3)
        for (what, size), ms in times.items():
            print(f"phase 6 time {what} {size}: {ms:.4f} ms [{self.card}]")

        spec4 = tp.OptionSpec(S0=100.0, K=100.0, T=1.0, r=0.05, sigma=0.2)
        g4 = self.GRID4
        calls = {
            "fd_price European call": lambda: tp.fd_price(
                spec4, "call", **g4, device=dev),
            "fd_price American put PSOR": lambda: tp.fd_price(
                spec4, "put", american=True, american_method="psor", **g4,
                device=dev),
            "fd_price American put projection": lambda: tp.fd_price(
                spec4, "put", american=True, **g4, device=dev),
            "fd_price_barrier up-and-out 130": lambda: tp.fd_price_barrier(
                spec4, "call", 130.0, "up-and-out", **g4, device=dev),
            "fd_greeks": lambda: tp.fd_greeks(spec4, "call", **g4,
                                              device=dev),
            "fem_price": lambda: tp.fem_price(spec4, "call", **g4,
                                              device=dev),
        }
        walls_ms = {}
        for label, fn in calls.items():
            walls = [timed(fn)[1] for _ in range(3)]
            walls_ms[label] = statistics.median(walls) * 1e3
            first = self.wall.get(label)
            first = "" if first is None else \
                f" (first call in phase 5: {first * 1e3:.4f} ms)"
            print(f"phase 6 wall {label} {g4['N_S']} x {g4['N_t']}: "
                  f"{statistics.median(walls) * 1e3:.4f} ms, median of 3"
                  f"{first} [{self.card}]")
        # device-busy share against the unprofiled wall (the profiler
        # slows the host)
        profiled = {
            "fd_price American put PSOR": (
                calls["fd_price American put PSOR"],
                walls_ms["fd_price American put PSOR"]),
            "fd_price European call": (
                calls["fd_price European call"],
                walls_ms["fd_price European call"]),
            "ladder auto": (lambda: self.ladder("auto"),
                            times[("ladder auto", "call")]),
            "ladder fused": (lambda: self.ladder("fused"),
                             times[("ladder fused", "call")]),
            "ladder fused_thomas": (lambda: self.ladder("fused_thomas"),
                                    times[("ladder fused_thomas", "call")])}
        for label, (fn, ref_ms) in profiled.items():
            wall, busy, n_k, _ = device_busy(fn)
            print(f"phase 6 profile {label}: device busy {busy:.4f} ms "
                  f"in {n_k} kernels; {wall:.4f} ms wall under the "
                  f"profiler, {ref_ms:.4f} ms without: busy "
                  f"{100.0 * busy / ref_ms:.1f}% [{self.card}]")
        for label in ("auto", "auto f32", "fused", "fused_thomas"):
            print(f"phase 6 wall ladder {label} {len(self.strikes)} x "
                  f"{self.N_S} x {self.N_T}, first call in phase 5: "
                  f"{self.wall[f'ladder {label}'] * 1e3:.4f} ms "
                  f"[{self.card}]")

    def kernel_entries(self, launches, worst, times):
        n, batch = self.K7_SHAPE
        m, B = self.N_S - 1, len(self.strikes)
        k7_ops = 10 * n * batch
        k8_bytes = 4 * (self.N_T * (m + 1) + (m + 1) * B + 2 * B + 6)
        return [
            {"name": "tridiag_pcr_kernel", "route": "cuda",
             "source": "optpricer_tpu_torch/csrc/thomas.cu",
             "replaces": "optpricer_tpu/ops/pallas_tridiag.py:31",
             "launches": launches["tridiag_pcr_kernel"],
             "max_abs_err": worst["tridiag"][1],
             "ms": times[("k7", "f64")],
             "plain_ms": times[("k7plain", "f64")],
             **dict(zip(("bound_ms", "bound_by"),
                        bound(k7_ops, self.k7_bytes["f64"]))),
             "library_ms": times[("k7 library torch.linalg.solve", "f64")],
             "shape": f"{n} rows x {batch} systems, f64, full coefficient "
                      "arrays",
             "device_ms": times[("k7 device", "f64")],
             "ms_f32": times[("k7", "f32")],
             "device_ms_f32": times[("k7 device", "f32")],
             "plain_ms_f32": times[("k7plain", "f32")],
             "bound_ms_f32": bound(k7_ops, self.k7_bytes["f32"])[0],
             **{f"{key}_shared_columns": times[(what, "shared columns f64")]
                for key, what in (("ms", "k7"), ("device_ms", "k7 device"))},
             **{f"{key}_ladder_call": times[(what,
                                             "ladder call (last axis) f64")]
                for key, what in (("ms", "k7"), ("device_ms", "k7 device"))},
             "bound_ms_ladder_call": bound(k7_ops, 8 * (2 * n * batch
                                                        + 3 * n))[0],
             **{f"{key}_{m}x1": times[(what, f"{m} x 1 f64")]
                for m in (n, 199)
                for key, what in (("ms", "k7"), ("device_ms", "k7 device"))},
             **{f"bound_ms_{m}x1": bound(10 * m, 8 * 5 * m)[0]
                for m in (n, 199)},
             "launches_by_shape": {f"{r} x {b}": k for (r, b), k
                                   in sorted(self.k7_shapes.items())}},
            {"name": "fd_lv_kernel", "route": "cuda",
             "source": "optpricer_tpu_torch/csrc/fd_lv.cu",
             "replaces": "optpricer_tpu/ops/pallas_fd_lv.py:63",
             "launches": launches["fd_lv_kernel"],
             "max_abs_err": worst["fd_lv"][1],
             "ms": times[("k8 call", "pcr")],
             "plain_ms": times[("k8plain", "pcr")],
             **dict(zip(("bound_ms", "bound_by"), bound(
                 ops_k8_ladder(B, m, self.N_T), k8_bytes))),
             "library_ms": None,
             "shape": f"PCR, {B} European calls x {m} rows x {self.N_T} "
                      "steps",
             "launches_by_method": self.k8_methods,
             "ms_thomas": times[("k8 call", "thomas")],
             "bound_ms_thomas": bound(ops_k8_ladder(B, m, self.N_T),
                                      k8_bytes)[0],
             "plain_ms_thomas": times[("k8plain", "thomas")],
             "ms_american_put": times[("k8 american put", "pcr")],
             "ms_thomas_american_put": times[("k8 american put", "thomas")],
             "bound_ms_american_put": bound(ops_k8_ladder(
                 B, m, self.N_T, american=True), k8_bytes)[0],
             "pre_kernel": "fd_lv_plan_kernel",
             "pre_kernel_ms": times[("k8 plan", "pcr")],
             "pre_kernel_ms_thomas": times[("k8 plan", "thomas")]},
        ]


# the 3-slice SVI table of phase 3's Dupire cases: rows a, b, ρ, m, σ, T
SVI3 = ((0.01, 0.02, 0.035), (0.12, 0.14, 0.15), (-0.4, -0.3, -0.25),
        (0.0, 0.02, 0.03), (0.1, 0.12, 0.15), (0.25, 0.5, 1.0))
# The desk's K4 call as commit 1eec4fa ran it on an NVIDIA H100 80GB HBM3,
# before σ_loc shared the centre's slice values and the step plans were
# written once per launch: the (6, 3) SVI table its fit gave (f32, rows a,
# b, ρ, m, σ, T) and the first 11 of the 21 sums (the rest 0) of
# lv_milstein (the desk's scheme) and lv_euler at 200 000 x 500,
# up-and-out 130, seed 42. Any later kernel must give them bit for bit.
DESK_SVI = (
    ("0x1.efa434p-10", "0x1.38fbccp-8", "0x1.45a722p-7"),
    ("0x1.3e8f36p-7", "0x1.37c8dcp-6", "0x1.39d4a4p-5"),
    ("-0x1.62d55ep-2", "-0x1.6676a4p-2", "-0x1.65de3ep-2"),
    ("-0x1.014cd6p-3", "-0x1.edc366p-4", "-0x1.eb0c2ap-4"),
    ("0x1.ca16a2p-1", "0x1.be1ee0p-1", "0x1.be0b7ep-1"),
    ("0x1.0p-2", "0x1.0p-1", "0x1.0p+0"))
DESK_SUMS = {
    "milstein": ("0x1.86a0p+17", "0x1.438cf2p+19", "0x1.28d53ep+22",
                 "0x1.2b19acp+24", "0x1.ca5074p+30", "0x1.eb4d9ep+25",
                 "0x1.87738ep+16", "0x1.9a2d0ap+15", "0x1.39e3f0p+18",
                 "0x1.2b7bdcp+23", "0x1.ed68cep+15"),
    "log_euler": ("0x1.86a0p+17", "0x1.438eb4p+19", "0x1.28e4d8p+22",
                  "0x1.2b19c2p+24", "0x1.ca50cep+30", "0x1.eb4f30p+25",
                  "0x1.876eccp+16", "0x1.9a1f78p+15", "0x1.39e2dcp+18",
                  "0x1.2b7854p+23", "0x1.ed603ep+15"),
}


def desk_svi() -> torch.Tensor:
    """The recorded desk table ``DESK_SVI`` as the kernel takes it."""
    return torch.tensor([[float.fromhex(h) for h in row] for row in DESK_SVI],
                        dtype=torch.float32)


# K3 per base draw, antithetic, counted like K1: half a Threefry block
# (40), half a Box-Muller pair (a log32, a sqrt, a cos and a sin: 22), two
# exp32 (44), the two payoffs and their average (12), and the 10 moments
# with their Kahan steps, shared by the two draws of an element (32)
OPS_K3_DRAW = 150


def ops_k4_lv_path(svi, dt: float, n_steps: int) -> float:
    """K4 lv_milstein per path over its ``n_steps`` steps, antithetic, by
    the least work of its function. Per step: half a Threefry block and
    half a Box-Muller pair (65); per state three σ_loc evaluations, each
    the log-moneyness (a division and a log32, 21), the blends in T (15),
    Gatheral's formula with its floors and clip (15) and the SVI slices
    this step reads: the select chain picks one slice or two for each of
    t, t + dT and t − dT, a slice's w at k does not depend on t, so each
    slice read is counted once, with ∂w/∂k and ∂²w/∂k² for those of t (a
    sqrt and two divisions among 14 operations) and w alone for the others
    (7); then the bump, the difference quotient of σ·S and the Milstein
    update with its floor (21) and the barrier compare (2). The step times
    and plans are the kernel's (``ops/path_mc._blend_plan``)."""
    import numpy as np

    from optpricer_tpu_torch.ops import path_mc as pmc

    f32 = np.float32
    Ts = [f32(T) for T in np.asarray(svi, f32)[5]]
    dt, dT, t_min = f32(dt), f32(1e-4), f32(1e-8)
    total = 0.0
    for step in range(n_steps):
        t = f32(f32(2 * (step // 2)) * dt)
        if step % 2:
            t = f32(t + dt)
        t = max(t, t_min)
        centre = set(pmc._blend_plan(Ts, t)[:2])
        read = centre.union(pmc._blend_plan(Ts, f32(t + dT))[:2],
                            pmc._blend_plan(Ts, max(f32(t - dT), t_min))[:2])
        sigma = 21 + 15 + 15 + 14 * len(centre) + 7 * len(read - centre)
        total += 65 + 2 * (3 * sigma + 23)
    return total


class Config5Slice:
    """BASELINE config 5 (SVI calibration → Dupire σ(S, t) → local-vol
    Milstein MC against the local-vol FDM barrier cross-check) on K4's
    Dupire branches, and the heterogeneous-book pricer on K3: kernel checks,
    determinism, main paths and timings at the main paths' sizes."""

    LV_SHAPE = ((1 << 18) + 123, 16)      # phase-3 K4-lv cases
    DESK = dict(n_paths=200_000, n_steps=500)
    BOOK_SIZE = 1000
    DEEP = 8                                  # deep in-the-money contracts
    MARKET = (100.0, 100.0, 1.0, 0.05, 0.02)   # S0, K, T, r, q

    def __init__(self, dev, card):
        self.dev, self.card = dev, card
        self.plain_ms = {}

    # -- inputs ----------------------------------------------------------
    def desk_surface(self, device=None):
        import optpricer_tpu_torch as tp
        from optpricer_tpu_torch.scripts import \
            desk_workflow_localvol_barrier as desk

        _, _, _, _, fwd, strikes, ivs = desk.synth_market()
        return tp.fit_svi_surface(strikes, fwd, ivs,
                                  device=device or self.dev)

    def k4_lv(self, n, n_steps, pay, scheme, anti, svi, market=None,
              seed=11):
        """(seed, params, run kwargs) of one K4 Dupire call."""
        from optpricer_tpu_torch.ops import path_mc as pmc
        from optpricer_tpu_torch.ops import terminal_mc as tmc

        params, static = pmc._resolve_config(
            n, n_steps, *(market or self.MARKET), None,
            pay.get("is_call", True), pay["payoff"], anti,
            pay.get("barrier", 0.0), pay.get("barrier_type", "up-and-out"),
            pay.get("rebate", 0.0), pay.get("average_type", "arithmetic"),
            pay.get("strike_type", "fixed"), 1.0, svi, scheme, 0.01, None)
        static["svi"] = static["svi"].to(self.dev)
        reps, n_prog = tmc._plan_grid(n, pmc.TILE)
        return (tmc._seed_pair(seed, self.dev), params.to(self.dev),
                dict(n_programs=n_prog, reps=reps, **static))

    def main_k4(self, surface):
        """The K4 call of the desk workflow's fused row."""
        return self.desk_k4(surface.svi_table(), "milstein")

    def desk_k4(self, svi, scheme):
        """The desk's K4 call on the SVI table ``svi`` under ``scheme``."""
        from optpricer_tpu_torch.scripts import \
            desk_workflow_localvol_barrier as desk

        return self.k4_lv(self.DESK["n_paths"], self.DESK["n_steps"],
                          dict(payoff="barrier", barrier=130.0), scheme,
                          True, svi, seed=desk.SEED)

    def book(self):
        """1 000 contracts: 992 calls and puts, K 70..130, S0 95..105, T
        0.5..2, σ 0.2..0.4, then ``DEEP`` calls K 48..54 and puts K 178..184
        at S0 100, T 0.5, σ 0.2, in the money on all but ~1e-5 of paths."""
        import numpy as np

        rng = np.random.default_rng(0)
        B = self.BOOK_SIZE - self.DEEP
        half = self.DEEP // 2
        deep_K = np.concatenate([np.linspace(48.0, 54.0, half),
                                 np.linspace(178.0, 184.0, half)])
        return (np.concatenate([rng.uniform(95.0, 105.0, B),
                                np.full(self.DEEP, 100.0)]),
                np.concatenate([np.linspace(70.0, 130.0, B), deep_K]),
                np.concatenate([rng.uniform(0.5, 2.0, B),
                                np.full(self.DEEP, 0.5)]), 0.03, 0.01,
                np.concatenate([rng.uniform(0.2, 0.4, B),
                                np.full(self.DEEP, 0.2)]),
                np.concatenate([np.where(np.arange(B) % 2 == 0, "call",
                                         "put"),
                                ["call"] * half + ["put"] * half]))

    def book_prices(self, s, book):
        """Per-contract prices from the (10, B) sums: the dual-CV estimate,
        and the plain mean for the ``DEEP`` contracts. On those the
        reference's dual-CV estimator, kept as it is, takes Var(Y2) as a
        difference of f32 moments of ~1: a change of the sums within the
        kernel's round-off moves their CV price by tens of stderr (ROADMAP
        §C)."""
        from optpricer_tpu_torch.ops import mc_batch as tmb

        cv, plain = (tmb._book_estimate(s, book, c)[0] for c in (True,
                                                                  False))
        cv[-self.DEEP:] = plain[-self.DEEP:]
        return cv

    def book_call(self):
        """The user's book call that phase 5 makes: euro_price_mc_batch on
        the 1 000 contracts at 1M paths each, with the dual CV."""
        from optpricer_tpu_torch.ops import mc_batch as tmb

        args = self.book()
        return lambda: tmb.euro_price_mc_batch(*args, n_paths=1_000_000,
                                               seed=3, device=self.dev)

    def k3(self, n_paths, antithetic):
        """(operands, kwargs, book columns) of one K3 call on the book."""
        from optpricer_tpu_torch.ops import mc_batch as tmb

        kparams, book = tmb.batch_kparams(*self.book())
        reps, n_prog = tmb._plan(n_paths)
        ops = (torch.tensor([7], dtype=torch.int32, device=self.dev),
               torch.tensor([float(n_paths)], device=self.dev),
               torch.from_numpy(kparams).to(self.dev))
        return ops, dict(n_programs=n_prog, reps=reps,
                         antithetic=antithetic), book

    # -- phase 3 ---------------------------------------------------------
    def phase3(self, record, payoffs):
        from optpricer_tpu_torch.models import mc_fused
        from optpricer_tpu_torch.ops import mc_batch as tmb
        from optpricer_tpu_torch.ops import path_mc as pmc

        def k4_check(what, setup, pay):
            """Kernel vs plain; returns the plain call's milliseconds."""
            seed, params, run = setup
            k = pmc.path_mc(seed, params, **run)
            p, ms = event_ms(lambda: pmc._path_mc_plain(seed, params, **run))
            rel = compare(k, p, what)
            record("path_lv", rel, *(mc_fused._estimate_from_stats(
                s, *self.MARKET, 0.0, pay.get("is_call", True), "local_vol",
                True)[0] for s in (k, p)), what)
            return ms

        for name, pay in payoffs.items():
            if pay.get("geo_cv"):               # the geometric CV is GBM's
                name, pay = "asian-arithmetic", dict(pay, geo_cv=False)
            for scheme in ("log_euler", "milstein"):
                for anti in (True, False):
                    k4_check(f"path lv {scheme} {name} anti={anti} "
                             f"{self.LV_SHAPE[0]} x {self.LV_SHAPE[1]}",
                             self.k4_lv(*self.LV_SHAPE, pay, scheme, anti,
                                        SVI3), pay)
        self.surface = self.desk_surface()
        setup = self.main_k4(self.surface)
        # the plain version at the main shape takes seconds: timed here once
        self.plain_ms["k4 lv"] = k4_check(
            "path lv main shape: desk surface, milstein up-and-out 130, "
            "200000 x 500", setup, dict(payoff="barrier", barrier=130.0))

        for n_paths in (1 << 20, 1_000_003):
            for anti in (True, False):
                ops, kw, book = self.k3(n_paths, anti)
                k = tmb.mc_batch(*ops, **kw)
                p = tmb._mc_batch_plain(*ops, **kw)
                case = (f"book {self.BOOK_SIZE} contracts x {n_paths} paths "
                        f"anti={anti}")
                rows = [t.transpose(1, 2).reshape(-1, tmb.NSTAT)
                        [:self.BOOK_SIZE] for t in (k, p)]
                rel = compare(*rows, f"mc_batch {case}")
                prices = [self.book_prices(t.cpu().numpy().astype(float).T,
                                           book) for t in rows]
                i = int(abs(prices[0] - prices[1]).argmax())
                record("mc_batch", rel, prices[0][i], prices[1][i],
                       f"{case}, contract {i}")

    # -- phase 4 ---------------------------------------------------------
    def phase4(self):
        from optpricer_tpu_torch.ops import mc_batch as tmb
        from optpricer_tpu_torch.ops import path_mc as pmc

        seed, params, run = self.main_k4(self.surface)
        a = pmc.path_mc(seed, params, **run).clone()
        b = pmc.path_mc(seed, params, **run).clone()
        if not torch.equal(a, b):
            raise AssertionError("path kernel (lv_milstein) is not bitwise "
                                 "reproducible")
        # the recorded sums on the recorded desk table, bit for bit
        svi = desk_svi()
        fitted = torch.equal(torch.as_tensor(self.surface.svi_table()), svi)
        for scheme, sums in DESK_SUMS.items():
            seed, params, run = self.desk_k4(svi, scheme)
            got = pmc.path_mc(seed, params, **run).cpu()
            want = torch.zeros_like(got)
            want[:len(sums)] = torch.tensor([float.fromhex(h) for h in sums])
            if not torch.equal(got, want):
                i = int((got != want).nonzero()[0])
                raise AssertionError(
                    f"path kernel {scheme} on the recorded desk table: sum "
                    f"{i} is {float(got[i]).hex()}, the recorded "
                    f"{float(want[i]).hex()}")
        print(f"phase 4 desk K4 call on the recorded table (the fit here "
              f"{'equals' if fitted else 'differs from'} it): lv_milstein "
              f"and lv_euler give the recorded 21 sums bit for bit")
        ops, kw, _ = self.k3(1 << 20, True)
        if not torch.equal(tmb.mc_batch(*ops, **kw).clone(),
                           tmb.mc_batch(*ops, **kw).clone()):
            raise AssertionError("book kernel is not bitwise reproducible")

    # -- phase 5 ---------------------------------------------------------
    def phase5(self) -> dict:
        """Config 5 and the book, each with its launch count set to 0 just
        before it and read just after; returns them."""
        import numpy as np

        import optpricer_tpu_torch as tp
        from optpricer_tpu_torch.ops import mc_batch as tmb
        from optpricer_tpu_torch.ops import path_mc as pmc
        from optpricer_tpu_torch.ops import thomas as tth
        from optpricer_tpu_torch.scripts import \
            desk_workflow_localvol_barrier as desk

        dev = self.dev
        print("phase 5 main path, config 5 (desk workflow):")
        pmc.path_mc.launches = 0
        t0 = time.perf_counter()
        # the calibration on the card equals the same call on the CPU
        _, _, _, _, fwd, strikes, ivs = desk.synth_market()
        cpu = self.desk_surface("cpu")
        worst_w = 0.0
        for T_, sl in self.surface.slices.items():
            k = torch.log(torch.as_tensor(strikes[T_] / fwd[T_]))
            w_dev = sl.total_var(k, device="cpu")
            w_cpu = cpu.slices[T_].total_var(k, device="cpu")
            worst_w = max(worst_w, float(((w_dev - w_cpu) / w_cpu).abs()
                                         .max()))
        print(f"  fit_svi_surface on {dev} vs cpu: max rel |Δw| on the "
              f"quotes {worst_w:.3e} (rtol 1e-8)")
        if worst_w > 1e-8:
            raise AssertionError(f"fit_svi_surface: {worst_w:.3e}")
        # the golden Dupire probes (tests/goldens.json, rtol 1e-6)
        goldens = json.loads((ROOT / "tests" / "goldens.json").read_text())
        sl = {T_: tp.SVIParams(a=0.02 * T_ + 0.02, b=0.15, rho=-0.3, m=0.02,
                               sigma=0.12, expiry=T_) for T_ in (0.25, 0.5,
                                                                 1.0)}
        fn = tp.dupire_local_vol_func(tp.VolSurface(
            sl, forward_curve={T_: 100 * math.exp(0.03 * T_) for T_ in sl},
            device=dev), 0.03, 0.0)
        for key, want in goldens["dupire_probe"].items():
            S_, t_ = key[1:].split("_t")
            got = float(fn(torch.tensor([float(S_)], dtype=torch.float64,
                                        device=dev), float(t_))[0])
            if abs(got - want) > 1e-6 * abs(want):
                raise AssertionError(f"dupire_probe {key}: {got} vs {want}")
        print("  dupire_local_vol_func on the golden surface: the six "
              "dupire_probe goldens to rtol 1e-6")

        # tests/test_baseline_configs.py:64-91 on the card
        S0, r, q = 100.0, 0.05, 0.02
        bfwd = {T_: S0 * np.exp((r - q) * T_) for T_ in (0.25, 0.5, 1.0)}
        bstrikes, bivs = {}, {}
        for T_, F in bfwd.items():
            bstrikes[T_] = np.linspace(0.8 * F, 1.2 * F, 15)
            k = np.log(bstrikes[T_] / F)
            bivs[T_] = 0.2 + 0.05 * k ** 2 - 0.02 * k + 0.005 * np.sqrt(T_)
        bsurf = tp.fit_svi_surface(bstrikes, bfwd, bivs, device=dev)
        fd_lv = tp.fd_price_local_vol(
            S0, 100.0, 1.0, r, q, tp.dupire_local_vol_func(bsurf, r, q),
            "call", N_S=200, N_t=200, device=dev)
        mc_lv, mc_se = tp.exotic_price_mc_dupire(
            "vanilla", bsurf, S0, 100.0, 1.0, r, q, scheme="milstein",
            n_steps=100, n_paths=50_000, seed=21, device=dev)
        ko, ko_se = tp.exotic_price_mc_dupire(
            "barrier", bsurf, S0, 100.0, 1.0, r, q, scheme="milstein",
            barrier=130.0, barrier_type="up-and-out", n_steps=100,
            n_paths=50_000, seed=22, device=dev)
        print(f"  config-5 test on the card: fd_lv {fd_lv:.10f}, Milstein "
              f"50000 x 100 vanilla {mc_lv:.10f} (se {mc_se:.3e}), up-and-out "
              f"130 {ko:.10f} (se {ko_se:.3e})")
        if not (abs(fd_lv - mc_lv) < 5 * mc_se + 0.15 and 0 < ko < fd_lv):
            raise AssertionError("config 5: |fd_lv - mc_lv| >= 5 se + 0.15 "
                                 "or KO out of (0, fd_lv)")

        # the desk workflow end to end at its full size
        k7 = tth.tridiag_solve_kernel
        k7.launches_by_shape.clear()
        k7_before = k7.launches
        out = desk.run(**self.DESK, device=dev)
        desk_k7 = dict(k7.launches_by_shape)
        if sum(desk_k7.values()) != k7.launches - k7_before or not desk_k7:
            raise AssertionError(f"desk workflow: K7 launches by shape "
                                 f"{desk_k7} against "
                                 f"{k7.launches - k7_before} launches")
        self.desk_times = out["times"]
        print(f"  desk workflow: K7 launches by (rows, systems) "
              f"{desk_k7}")
        gap = abs(out["fused_barrier"] - out["mc_barrier"])
        band = 5.0 * math.hypot(out["fused_se"], out["mc_se"]) + 1e-3
        dgap = abs(out["grid_greeks"]["delta"] - out["bump_greeks"]["delta"])
        print(f"  desk stage 4 ({self.DESK['n_paths']} x "
              f"{self.DESK['n_steps']}): BS vanilla {out['bs_vanilla']:.10f}; "
              f"FDM const σ vanilla {out['fdm_vanilla']:.10f}, barrier "
              f"{out['fdm_barrier']:.10f}; FDM local vol vanilla "
              f"{out['fdm_lv_vanilla']:.10f}; MC+Milstein path matrix vanilla "
              f"{out['mc_vanilla']:.10f}, barrier {out['mc_barrier']:.10f} "
              f"(se {out['mc_se']:.3e}); fused kernel barrier "
              f"{out['fused_barrier']:.10f} (se {out['fused_se']:.3e}); "
              f"|fused - matrix| {gap:.3e} (limit {band:.3e})")
        print(f"  desk stage 5: fd_greeks delta "
              f"{out['grid_greeks']['delta']:.6f} vs bump "
              f"{out['bump_greeks']['delta']:.6f} (|diff| {dgap:.2e}, limit "
              "0.005); Dupire probes " + ", ".join(
                  f"σ({S_:g}, {t_:g}) {s_:.4f}" for S_, t_, s_ in
                  out["dupire"]))
        if not (gap <= band and dgap < 0.005):
            raise AssertionError("desk workflow: fused vs path-matrix barrier "
                                 "or FD vs bump delta out of bounds")

        # a flat 0.2 surface prices Black-Scholes through the kernel route
        flat = tp.VolSurface({T_: tp.SVIParams(a=0.04 * T_, b=1e-8, rho=0.0,
                                               m=0.0, sigma=0.1, expiry=T_)
                              for T_ in (0.25, 0.5, 1.0)}, device=dev)
        px, se = tp.exotic_price_mc_dupire(
            "vanilla", flat, 100.0, 110.0, 1.0, 0.03, 0.0,
            scheme="log_euler", n_steps=100, n_paths=1_000_000, seed=5,
            device=dev)
        check_price("exotic_price_mc_dupire flat 0.2 surface log-Euler 1M x "
                    "100", px, se, tp.bs_price(tp.OptionSpec(**SPEC), "call",
                                               device=dev), slack=0.01)
        lv_launches = pmc.path_mc.launches
        print(f"  config 5 {time.perf_counter() - t0:.2f} s; path_mc_kernel "
              f"launches in it: {lv_launches}")
        if lv_launches == 0:
            raise AssertionError("path_mc_kernel was not launched on the "
                                 "config-5 path")

        print("phase 5 main path, the book (euro_price_mc_batch):")
        tmb.mc_batch.launches = 0
        t0 = time.perf_counter()
        args = self.book()
        bs = tp.bs_price_vec(*args, device=dev).cpu().numpy()
        deep = np.arange(self.BOOK_SIZE) >= self.BOOK_SIZE - self.DEEP
        excess = {}
        for cv in (True, False):
            prices, ses = tmb.euro_price_mc_batch(
                *args, n_paths=1_000_000, seed=3, control_variate=cv,
                device=dev)
            # the CV price of every contract but the deep ones; the plain
            # mean of every contract
            held = ~deep if cv else np.ones_like(deep)
            gap = np.where(held, abs(prices - bs), 0.0)
            excess[cv] = (gap - 5 * ses - 1e-4)[held].max()
            i = int(gap.argmax())
            print(f"  {self.BOOK_SIZE} contracts x 1M paths, "
                  f"{'dual CV' if cv else 'no CV'}: max |price - BS| "
                  f"{gap.max():.3e} (contract {i}: {prices[i]:.8f} vs "
                  f"{bs[i]:.8f}, se {ses[i]:.3e}); largest excess over 5 se "
                  f"+ 1e-4: {excess[cv]:.3e}")
            if cv:
                print("  the deep contracts' CV prices, not held (ROADMAP "
                      "§C): |price - BS| / se " + ", ".join(
                          f"{d:.1f}" for d in (abs(prices - bs)
                                               / ses)[deep]))
            if not np.isfinite(prices).all():
                raise AssertionError("euro_price_mc_batch: a price is not "
                                     "finite")
        if max(excess.values()) > 0.0:
            raise AssertionError("euro_price_mc_batch off Black-Scholes")
        book_launches = tmb.mc_batch.launches
        print(f"  book {time.perf_counter() - t0:.2f} s; mc_batch_kernel "
              f"launches in it: {book_launches}")
        if book_launches == 0:
            raise AssertionError("mc_batch_kernel was not launched on the "
                                 "book path")
        return {"path_mc_kernel lv": lv_launches,
                "mc_batch_kernel": book_launches}

    # -- phase 6 ---------------------------------------------------------
    def phase6(self, times):
        from optpricer_tpu_torch.ops import mc_batch as tmb
        from optpricer_tpu_torch.ops import path_mc as pmc

        seed, params, run = self.main_k4(self.surface)
        times[("k4 lv_milstein", "200000 x 500")] = cuda_ms(
            lambda: pmc.path_mc(seed, params, **run))
        seed_e, params_e, run_e = self.desk_k4(self.surface.svi_table(),
                                               "log_euler")
        times[("k4 lv_euler", "200000 x 500")] = cuda_ms(
            lambda: pmc.path_mc(seed_e, params_e, **run_e))
        # one call, in phase 3 (it takes seconds)
        times[("k4plain lv_milstein", "200000 x 500")] = \
            self.plain_ms["k4 lv"]
        ops, kw, _ = self.k3(1 << 20, True)
        times[("k3", "1000 x 2^20")] = cuda_ms(lambda: tmb.mc_batch(*ops,
                                                                     **kw))
        times[("k3plain", "1000 x 2^20")] = cuda_ms(
            lambda: tmb._mc_batch_plain(*ops, **kw), reps=3)
        for what in ("k4 lv_milstein", "k4 lv_euler", "k4plain lv_milstein"):
            print(f"phase 6 time {what} 200000 x 500: "
                  f"{times[(what, '200000 x 500')]:.4f} ms [{self.card}]")
        for what in ("k3", "k3plain"):
            print(f"phase 6 time {what} 1000 contracts x 2^20: "
                  f"{times[(what, '1000 x 2^20')]:.4f} ms [{self.card}]")
        print(f"phase 6 wall euro_price_mc_batch 1000 contracts x 1M, dual "
              f"CV (median of 21): {wall_ms(self.book_call()):.4f} ms "
              f"[{self.card}]")
        _, secs = timed(lambda: self.desk_surface())
        print(f"phase 6 wall fit_svi_surface (3 x 21 quotes, batched LM): "
              f"{secs * 1e3:.4f} ms [{self.card}]")
        for stage, secs in self.desk_times.items():
            print(f"phase 6 wall desk stage {stage} (phase 5's run): "
                  f"{secs * 1e3:.4f} ms [{self.card}]")

    def kernel_entries(self, launches, worst, times):
        n, steps = self.DESK["n_paths"], self.DESK["n_steps"]
        n_slices = len(self.surface.expiries)
        _, params, run = self.main_k4(self.surface)
        B = self.BOOK_SIZE
        return [
            {"name": "path_mc_kernel lv_milstein", "route": "cuda",
             "source": "optpricer_tpu_torch/csrc/path_mc.cu",
             "replaces": "optpricer_tpu/ops/pallas_path_mc.py:68",
             "launches": launches["path_mc_kernel lv"],
             "max_abs_err": worst["path_lv"][1],
             "ms": times[("k4 lv_milstein", "200000 x 500")],
             "plain_ms": times[("k4plain lv_milstein", "200000 x 500")],
             **dict(zip(("bound_ms", "bound_by"), bound(
                 n * ops_k4_lv_path(run["svi"].cpu(), float(params[10]),
                                    steps),
                 8 + 96 + 4 * 6 * n_slices + 84))),
             "library_ms": None,
             "shape": f"Dupire Milstein up-and-out barrier, {n_slices} SVI "
                      f"slices, {n} paths x {steps} steps, antithetic",
             "ms_lv_euler": times[("k4 lv_euler", "200000 x 500")]},
            {"name": "mc_batch_kernel", "route": "cuda",
             "source": "optpricer_tpu_torch/csrc/mc_batch.cu",
             "replaces": "optpricer_tpu/ops/pallas_mc_batch.py:32",
             "launches": launches["mc_batch_kernel"],
             "max_abs_err": worst["mc_batch"][1],
             "ms": times[("k3", "1000 x 2^20")],
             "plain_ms": times[("k3plain", "1000 x 2^20")],
             **dict(zip(("bound_ms", "bound_by"), bound(
                 B * (1 << 20) * OPS_K3_DRAW, 8 + 4 * 8 * B + 4 * 10 * B))),
             "library_ms": None,
             "shape": f"{B} contracts x 2^20 base draws each, antithetic"},
        ]



# phase 5's K6 calls besides the [basket-path] book: key -> (``k6`` args,
# (pairs, steps))
K6_OTHER_SHAPES = (
    ("16_assets_barrier", (16, "basket_barrier", "up-and-in", 1.1),
     (1 << 18, 64)),
    ("1_asset_worstof_2p20", (1, "worstof_barrier", "up-and-out", 1.3),
     (1 << 20, 64)))
# all three, the [basket-path] book first
K6_SHAPES = (("basket_path", (10, "asian_basket"), (1 << 18, 64)),
             *K6_OTHER_SHAPES)
# phase 3's K6 path pairs at 16 steps: 1, 2 and 4 reps of 17, 33 and 49
# programs, each with a ragged last tile
K6_REPS = {1: (1 << 16) + 123, 2: (1 << 18) + 123, 4: 3 * (1 << 18) + 123}


def k6_plain_kw(run: dict) -> dict:
    """``run`` without the kernel's ``host_params``: the plain version's
    keyword arguments."""
    return {k: v for k, v in run.items() if k != "host_params"}


def k6_waves(dev) -> dict:
    """key -> (resident blocks per SM, grid blocks, waves) of K6's
    instantiation at each of ``K6_SHAPES`` on this card."""
    from optpricer_tpu_torch.ops import basket_mc as tbk
    from optpricer_tpu_torch.ops import terminal_mc as tmc

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    out = {}
    for key, (a, payoff, *_), (n, _) in K6_SHAPES:
        per_sm = tbk.blocks_per_sm(a, tbk.PAYOFF_IDS[payoff], True)
        reps, n_prog = tmc._plan_grid(n, tbk.TILE)
        blocks, _ = tbk._launch_plan(n_prog, reps)
        out[key] = (per_sm, blocks, blocks / (per_sm * sms))
    return out


def ops_k6_path_step(a: int, antithetic: bool, barrier: bool) -> float:
    """K6 per path pair and step, by the least work of its function: the
    draws, ⌈a/2⌉ Threefry blocks (80) and Box-Muller pairs (a log32, a sqrt,
    a cos and a sin: 50), and the correlation chain, a(a+1)/2 FMAs (2
    each), once (the mirrored leg's shocks are their negation); per leg the
    a exp32 (22) with their argument's FMA and the spot product (3), a FMAs
    for the basket sum (2), and the Asian add or the barrier compare (1)."""
    legs = 2 if antithetic else 1
    per_leg = a * (22 + 3) + 2 * a + 1
    return -(-a // 2) * 130 + a * (a + 1) + legs * per_leg


def ops_k4_lsv_path_step(deg: int, qe: bool, antithetic: bool) -> float:
    """K4's LSV branches per path and step, by the least work of their
    function: one Threefry block (80) for the two shocks, and a Box-Muller
    pair (50; under QE half a pair, 25, and the uniform's norminv32, 45);
    per leg the leverage (S/S0, a log32, the forward drift, the scale and
    two clips: 28) with its deg-FMA Horner polynomial, one exp32 (22) with
    its argument (8), the variance step (Euler: the correlated shock, a
    sqrt and the truncated update, 12; QE: the quadratic branch and the
    ρ-coupling, 30) and the payoff's running compare (2)."""
    legs = 2 if antithetic else 1
    draws = 80 + (25 + 45 if qe else 50)
    per_leg = 28 + 2 * deg + 22 + 8 + (30 if qe else 12) + 2
    return draws + legs * per_leg


class MultiAssetLsvSlice:
    """The multi-asset stack on the basket kernel (K6) and the LSV engine on
    K4's lsv / lsv_qe branches, at the sizes of the reference's own
    ``bench.py`` diagnostics: kernel checks, determinism, main paths and
    timings."""

    BASKET = dict(a=10, corr=0.35, n_steps=64, n_paths=1 << 18, seed=3)
    SMALL = ((1 << 16) + 123, 16)          # phase-3 K6 and K4-lsv cases
    LSV_CAL = dict(n_steps=96, n_paths=131_072, n_bins=128, seed=0)
    LSV_PRICE = dict(n_paths=1 << 20, seed=7)
    HESTON = dict(v0=0.04, kappa=1.5, theta=0.04, xi=0.5, rho=-0.6)

    def __init__(self, dev, card):
        self.dev, self.card = dev, card
        self.times = {}
        self.models = {}

    # -- inputs ----------------------------------------------------------
    def book(self, a=None):
        """bench.py:360-388's [basket-path] book (10 assets, corr 0.35,
        default_rng(2) spots U(60, 140) and vols U(0.15, 0.4), equal
        weights, K = mean spot), or its first ``a`` assets."""
        import numpy as np

        a_full = self.BASKET["a"] if a is None or a <= 10 else a
        rng = np.random.default_rng(2)
        S0s = rng.uniform(60, 140, a_full)
        sig = rng.uniform(0.15, 0.4, a_full)
        a = a or a_full
        S0s, sig = S0s[:a], sig[:a]
        corr = self.BASKET["corr"] * np.ones((a, a)) \
            + (1 - self.BASKET["corr"]) * np.eye(a)
        return S0s, np.ones(a) / a, float(S0s.mean()), sig, corr

    def k6(self, a, payoff, btype="up-and-out", frac=1.0, anti=True,
           shape=None, rebate=0.0, seed=3):
        """(seed, params, run kwargs) of one K6 call on ``book(a)``; the
        barrier at ``frac`` times the level at t = 0. The kernel's kwargs
        hold the host copy of params; ``k6_plain_kw`` drops it."""
        import numpy as np

        from optpricer_tpu_torch.ops import basket_mc as tbk
        from optpricer_tpu_torch.ops import terminal_mc as tmc

        n, n_steps = shape or (self.BASKET["n_paths"],
                               self.BASKET["n_steps"])
        S0s, w, K, sig, corr = self.book(a)
        lvl = float(S0s.min()) if payoff == "worstof_barrier" \
            else float(S0s @ w)
        up = btype.startswith("up")
        params = tbk._build_params(n, n_steps, list(S0s), list(w), K, 1.0,
                                   0.03, [0.0] * a, list(sig),
                                   np.linalg.cholesky(corr), frac * lvl,
                                   rebate, True, payoff, up)
        reps, n_prog = tmc._plan_grid(n, tbk.TILE)
        run = dict(n_programs=n_prog, reps=reps, n_assets=a,
                   n_steps=n_steps, antithetic=anti,
                   payoff_id=tbk.PAYOFF_IDS[payoff], barrier_up=up,
                   knock_in=btype.endswith("in"))
        # the host copy of params, as the public entry passes it (a tree
        # whose kernel reads params on the card takes none)
        if "host_params" in inspect.signature(tbk.basket_mc).parameters:
            run["host_params"] = params
        return tmc._seed_pair(seed, self.dev), params.to(self.dev), run

    def user_calls(self) -> dict:
        """label -> the user's K6 call at two of ``K6_SHAPES``, as phase 5
        makes it: basket_exotic_mc on the [basket-path] book, and on the
        16-asset basket barrier (up-and-in at 110% of the basket)."""
        import optpricer_tpu_torch as tp

        S0s, w, K, sig, corr = self.book()
        S16, w16, K16, sig16, corr16 = self.book(16)
        base = dict(n_steps=self.BASKET["n_steps"],
                    n_paths=self.BASKET["n_paths"], device=self.dev)
        return {
            "basket_exotic_mc [basket-path] asian 10 assets 2^18 x 64":
            lambda: tp.basket_exotic_mc(
                S0s, w, K, 1.0, 0.03, sigmas=sig, corr=corr,
                payoff="asian_basket", seed=self.BASKET["seed"], **base),
            "basket_exotic_mc basket barrier up-and-in 16 assets 2^18 x 64":
            lambda: tp.basket_exotic_mc(
                S16, w16, K16, 1.0, 0.03, sigmas=sig16, corr=corr16,
                payoff="basket_barrier", barrier=1.1 * float(S16 @ w16),
                barrier_type="up-and-in", seed=11, **base)}

    def surface(self, device=None):
        """bench.py:400-403's 3-slice SVI surface."""
        import numpy as np

        import optpricer_tpu_torch as tp

        sl = {T: tp.SVIParams(a=0.03 * T, b=0.12 * T, rho=-0.4, m=0.0,
                              sigma=0.25, expiry=T) for T in (0.25, 0.5, 1.0)}
        return tp.VolSurface(sl, forward_curve={
            T: 100 * np.exp(0.03 * T) for T in sl},
            device=device or self.dev)

    def calibrate(self, scheme):
        import optpricer_tpu_torch as tp

        return tp.lsv_calibrate(self.surface(), self.HESTON, 100.0, 0.03,
                                T=1.0, scheme=scheme, dtype="float32",
                                device=self.dev, **self.LSV_CAL)

    @staticmethod
    def poly_model(model):
        """``model`` with its leverage rows replaced by the path kernel's
        degree-12 polynomials (``lsv._leverage_poly``) sampled on 2 049
        bins: the function K4-lsv prices, for the torch scan."""
        import dataclasses

        import numpy as np

        from optpricer_tpu_torch.models import lsv as tl

        coeffs, x_width = tl._leverage_poly(model)
        x = np.linspace(-x_width, x_width, 2049)
        u = np.clip(x / x_width, -1.0, 1.0)
        rows = np.stack([np.clip(np.polyval(c.astype(np.float64), u), 0.05,
                                 20.0) for c in coeffs])
        dev = model.leverage.device
        return dataclasses.replace(
            model, x_bins=torch.as_tensor(x, device=dev),
            leverage=torch.as_tensor(rows, device=dev))

    def k4_lsv(self, model, n, pay, anti=True, seed=7):
        """(seed, params, run kwargs) of one K4-lsv call on ``model``."""
        from optpricer_tpu_torch.models import lsv as tl

        coeffs, x_width = tl._leverage_poly(model)
        return self.k4_lsv_table(
            dict(model.heston, coeffs=coeffs, x_width=x_width,
                 scheme=model.scheme), model.n_steps, n, pay, anti, seed)

    def k4_lsv_table(self, lsv, n_steps, n, pay, anti=True, seed=7):
        """(seed, params, run kwargs) of one K4-lsv call on the ``lsv``
        dict's coefficient table."""
        from optpricer_tpu_torch.ops import path_mc as pmc
        from optpricer_tpu_torch.ops import terminal_mc as tmc

        params, static = pmc._resolve_config(
            n, n_steps, 100.0, 100.0, 1.0, 0.03, 0.0, None, True,
            pay["payoff"], anti, pay.get("barrier", 0.0), "up-and-out", 0.0,
            "arithmetic", pay.get("strike_type", "fixed"), 1.0, None,
            "log_euler", 0.01, None, lsv=lsv)
        static["svi"] = static["svi"].to(self.dev)
        reps, n_prog = tmc._plan_grid(n, pmc.TILE)
        return (tmc._seed_pair(seed, self.dev), params.to(self.dev),
                dict(n_programs=n_prog, reps=reps, **static))

    # -- phase 3 ---------------------------------------------------------
    def phase3(self, record):
        import numpy as np

        from optpricer_tpu_torch.models import lsv as tl
        from optpricer_tpu_torch.models import mc_fused
        from optpricer_tpu_torch.ops import basket_mc as tbk
        from optpricer_tpu_torch.ops import path_mc as pmc

        def k6_check(what, setup):
            seed, params, run = setup
            k = tbk.basket_mc(seed, params, **run)
            p, ms = event_ms(lambda: tbk._basket_mc_plain(
                seed, params, **k6_plain_kw(run)))
            rel = compare(k, p, what)
            # price units: the plain mean ΣX / n of each
            record("basket", rel, *(float(s[1] / s[0]) for s in (k, p)),
                   what)
            return ms

        self.times[("k6plain", "main")] = k6_check(
            "basket main shape: [basket-path] book asian 2^18 x 64",
            self.k6(10, "asian_basket"))
        cases = [("asian_basket", "up-and-out", 1.0, 0.0),
                 ("worstof_barrier", "down-and-out", 0.9, 0.0),
                 ("worstof_barrier", "up-and-in", 1.1, 0.0),
                 ("basket_barrier", "up-and-out", 1.1, 1.5),
                 ("basket_barrier", "down-and-in", 0.9, 0.0)]
        for a in (1, 3, 16):
            for payoff, btype, frac, rebate in cases:
                for anti in (True, False) if a == 3 else (True,):
                    k6_check(f"basket a={a} {payoff} {btype} anti={anti} "
                             f"{self.SMALL[0]} x {self.SMALL[1]}",
                             self.k6(a, payoff, btype, frac, anti,
                                     self.SMALL, rebate))
        # every instantiated asset count, a payoff each, at 1, 2 and 4 reps
        for a in range(1, tbk.MAX_ASSETS + 1):
            payoff, btype, frac, rebate = cases[a % len(cases)]
            for reps, n in K6_REPS.items():
                setup = self.k6(a, payoff, btype, frac, a % 2 == 0,
                                (n, self.SMALL[1]), rebate)
                if setup[2]["reps"] != reps:
                    raise AssertionError(f"{n} pairs: {setup[2]['reps']} "
                                         f"reps, not {reps}")
                k6_check(f"basket a={a} {payoff} {btype} anti={a % 2 == 0} "
                         f"{n} x {self.SMALL[1]} ({reps} reps)", setup)

        def k4_check(what, setup):
            seed, params, run = setup
            k = pmc.path_mc(seed, params, **run)
            p, ms = event_ms(lambda: pmc._path_mc_plain(seed, params, **run))
            rel = compare(k, p, what)
            record("path_lsv", rel, *(mc_fused._estimate_from_stats(
                s, 100.0, 100.0, 1.0, 0.03, 0.0, 0.0, True, "lsv",
                True)[0] for s in (k, p)), what)
            return ms

        for scheme in ("euler", "qe"):
            self.models[scheme] = model = self.calibrate(scheme)
            ms = k4_check(f"path {model.scheme} main shape: calibrated "
                          f"table, up-and-out 130, 2^20 x 96",
                          self.k4_lsv(model, self.LSV_PRICE["n_paths"],
                                      dict(payoff="barrier", barrier=130.0)))
            self.times[("k4plain lsv", scheme)] = ms
        x_bins = np.linspace(-1.0, 1.0, 64)
        lev = np.stack([1.0 + 0.3 * x_bins ** 2 * np.exp(-0.5 * k / 8)
                        for k in range(self.SMALL[1])])
        pays = {"vanilla": dict(payoff="vanilla"),
                "barrier": dict(payoff="barrier", barrier=125.0),
                "asian": dict(payoff="asian"),
                "digital": dict(payoff="digital"),
                "lookback-floating": dict(payoff="lookback",
                                          strike_type="floating")}
        for scheme in ("euler", "qe"):
            model = tl.LSVModel(100.0, 0.03, 0.0, 1.0, scheme=scheme,
                                x_bins=torch.as_tensor(x_bins),
                                leverage=torch.as_tensor(lev), **self.HESTON)
            for name, pay in pays.items():
                for anti in (True, False):
                    k4_check(f"path {scheme} table model {name} anti={anti} "
                             f"{self.SMALL[0]} x {self.SMALL[1]}",
                             self.k4_lsv(model, self.SMALL[0], pay, anti))
        # a degree-5 table (the Horner loop over a shared row) and a table
        # longer than the window of steps a block stages at once
        rng = np.random.default_rng(5)
        for scheme in ("euler", "qe"):
            for n_steps, deg in ((self.SMALL[1], 5), (pmc.LEV_WINDOW + 2, 12)):
                coeffs = 0.05 * rng.standard_normal((n_steps, deg + 1))
                coeffs[:, -1] += 1.0
                lsv = dict(self.HESTON, coeffs=coeffs, x_width=0.6,
                           scheme=scheme)
                k4_check(f"path {scheme} degree {deg} table up-and-out 125 "
                         f"{self.SMALL[0]} x {n_steps}",
                         self.k4_lsv_table(lsv, n_steps, self.SMALL[0],
                                           pays["barrier"]))

    # -- phase 4 ---------------------------------------------------------
    def phase4(self):
        from optpricer_tpu_torch.ops import basket_mc as tbk
        from optpricer_tpu_torch.ops import path_mc as pmc

        seed, params, run = self.k6(16, "basket_barrier", "up-and-in", 1.1)
        if not torch.equal(tbk.basket_mc(seed, params, **run).clone(),
                           tbk.basket_mc(seed, params, **run).clone()):
            raise AssertionError("basket kernel is not bitwise reproducible")
        for scheme, model in self.models.items():
            seed, params, run = self.k4_lsv(
                model, self.LSV_PRICE["n_paths"],
                dict(payoff="barrier", barrier=130.0))
            if not torch.equal(pmc.path_mc(seed, params, **run).clone(),
                               pmc.path_mc(seed, params, **run).clone()):
                raise AssertionError(f"path kernel ({model.scheme}) is not "
                                     "bitwise reproducible")
            again = self.calibrate(scheme)
            if not torch.equal(again.leverage, model.leverage):
                spread = float((again.leverage - model.leverage).abs().max())
                raise AssertionError(f"lsv_calibrate ({scheme}) is not "
                                     f"reproducible: max |dL| {spread:.3e}")

    # -- phase 5 ---------------------------------------------------------
    def phase5(self) -> dict:
        """The multi-asset path and the LSV path, each with its launch
        count set to 0 just before it and read just after; returns them."""
        import dataclasses
        import tempfile

        import numpy as np

        import optpricer_tpu_torch as tp
        from optpricer_tpu_torch.ops import basket_mc as tbk
        from optpricer_tpu_torch.ops import path_mc as pmc
        from optpricer_tpu_torch.utils import serialization as sz

        dev = self.dev
        print("phase 5 main path, multi-asset (basket_exotic_mc on K6, "
              "basket_price_mc):")
        tbk.basket_mc.launches = 0
        t0 = time.perf_counter()
        S0s, w, K, sig, corr = self.book()
        kw = dict(sigmas=sig, corr=corr, payoff="asian_basket",
                  n_steps=self.BASKET["n_steps"],
                  n_paths=self.BASKET["n_paths"], seed=self.BASKET["seed"],
                  device=dev)
        (px, se), secs = timed(lambda: tp.basket_exotic_mc(S0s, w, K, 1.0,
                                                           0.03, **kw))
        (px_x, se_x), secs_x = timed(lambda: tp.basket_exotic_mc(
            S0s, w, K, 1.0, 0.03, backend="xla", **kw))
        band = 5 * (se + se_x) + 1e-3
        print(f"  [basket-path] 10-asset asian 2^18 pairs x 64: K6 "
              f"{px:.10f} (se {se:.3e}, {secs * 1e3:.3f} ms wall) vs the f64 "
              f"torch scan {px_x:.10f} (se {se_x:.3e}, {secs_x * 1e3:.3f} ms "
              f"wall): |diff| {abs(px - px_x):.3e} (limit {band:.3e})")
        if not abs(px - px_x) <= band:
            raise AssertionError("[basket-path]: K6 off the torch scan")
        S16, w16, K16, sig16, corr16 = self.book(16)
        chol16 = np.linalg.cholesky(corr16)
        call = (11, self.BASKET["n_paths"], self.BASKET["n_steps"], S16, w16,
                K16, 1.0, 0.03, None, sig16, chol16, True)
        bar = float(S16 @ w16) * 1.1
        sums = {t: tbk.basket_path_sumstats_kernel(
            *call, payoff="basket_barrier", barrier=b, barrier_type=t,
            device=dev).double().cpu()
            for t, b in (("up-and-in", bar), ("up-and-out", bar),
                         ("up-and-out ", 1e12))}
        gap = abs(float(sums["up-and-in"][1] + sums["up-and-out"][1]
                        - sums["up-and-out "][1]))
        rel = gap / abs(float(sums["up-and-out "][1]))
        print(f"  16-asset basket barrier 110%: in + out - no barrier, ΣX "
              f"rel {rel:.3e} (limit 1e-3)")
        if not rel <= 1e-3:
            raise AssertionError(f"16-asset in + out != vanilla ({rel:.3e})")
        one = dict(barrier=130.0, barrier_type="up-and-out", n_steps=64,
                   n_paths=1 << 20, seed=5, device=dev)
        p1, s1 = tp.basket_exotic_mc([100.0], [1.0], 100.0, 1.0, 0.03,
                                     sigmas=[0.2], corr=[[1.0]],
                                     payoff="worstof_barrier", **one)
        pe, sse = tp.exotic_price_mc("barrier", 100.0, 100.0, 1.0, 0.03,
                                     sigma=0.2, **dict(one, seed=6))
        band = 5 * math.hypot(s1, sse) + 1e-3
        print(f"  1-asset worst-of up-and-out 130: {p1:.10f} (se {s1:.3e}) "
              f"vs exotic_price_mc {pe:.10f} (se {sse:.3e}), |diff| "
              f"{abs(p1 - pe):.3e} (limit {band:.3e})")
        if not abs(p1 - pe) <= band:
            raise AssertionError("1-asset worst-of barrier off "
                                 "exotic_price_mc")
        # bench.py:341-357's 100-asset basket
        rng = np.random.default_rng(0)
        a = 100
        S100, sig100 = rng.uniform(50, 150, a), rng.uniform(0.15, 0.4, a)
        corr100 = 0.3 * np.ones((a, a)) + 0.7 * np.eye(a)
        kw100 = dict(sigmas=sig100, corr=corr100, n_paths=1 << 19, seed=1,
                     device=dev)
        (p_cv, se_cv), self.wall_100 = timed(lambda: tp.basket_price_mc(
            S100, np.ones(a) / a, float(S100.mean()), 1.0, 0.03, **kw100))
        p_raw, se_raw = tp.basket_price_mc(
            S100, np.ones(a) / a, float(S100.mean()), 1.0, 0.03,
            control_variate=False, **kw100)
        check_price("100-asset basket 2^19 pairs, geometric CV", p_cv, se_raw,
                    p_raw, self.wall_100, slack=0.0, what="no-CV")
        print(f"    (CV se {se_cv:.3e}, no CV {se_raw:.3e})")
        two = dict(sigmas=[0.2, 0.3], corr=[[1.0, 0.4], [0.4, 1.0]],
                   n_paths=1 << 20, seed=2, device=dev)
        px, se = tp.basket_price_mc([100.0, 95.0], [1.0, -1.0], 0.0, 1.0,
                                    0.03, payoff="spread", **two)
        check_price("2-asset spread (1, -1), K = 0", px, se, float(
            tp.margrabe_price(100.0, 95.0, 1.0, sigma1=0.2, sigma2=0.3,
                              rho=0.4, device=dev)), what="Margrabe")
        for mode in ("min", "max"):
            px, se = tp.basket_price_mc([100.0, 95.0], [0.5, 0.5], 98.0, 1.0,
                                        0.03, payoff=f"rainbow_{mode}", **two)
            check_price(f"2-asset rainbow {mode} call K = 98", px, se,
                        tp.rainbow_price_stulz(100.0, 95.0, 98.0, 1.0, 0.03,
                                               sigma1=0.2, sigma2=0.3,
                                               rho=0.4, mode=mode,
                                               device=dev), what="Stulz")
        g = tp.basket_greeks_mc([100.0], [1.0], 110.0, 1.0, 0.03,
                                sigmas=[0.2], corr=[[1.0]],
                                n_paths=1_000_000, seed=7, device=dev)
        ref = {k: float(v) for k, v in tp.bs_greeks_vec(
            100.0, 110.0, 1.0, 0.03, 0.0, 0.2, "call", device=dev).items()}
        print(f"  basket_greeks_mc 1 asset 1M: delta {g['delta'][0]:.6f} "
              f"(BS {ref['delta']:.6f}), vega {g['vega'][0]:.6f} (BS "
              f"{ref['vega']:.6f})")
        if abs(g["delta"][0] - ref["delta"]) > 3e-3 \
                or abs(g["vega"][0] - ref["vega"]) > 0.3:
            raise AssertionError("basket_greeks_mc off the BS bands")
        flags = ["--S0s", ",".join(repr(float(v)) for v in S0s), "--sigmas",
                 ",".join(repr(float(v)) for v in sig), "--rho", "0.35", "--K",
                 repr(K), "--T", "1", "--r", "0.03", "--payoff",
                 "asian_basket", "--n-steps", str(self.BASKET["n_steps"]),
                 "--n-paths", str(self.BASKET["n_paths"]), "--seed",
                 str(self.BASKET["seed"])]
        out = run_cli(["basket", *flags])
        px, se = tp.basket_exotic_mc(S0s, w, K, 1.0, 0.03, **kw)
        if out != f"{px:.10f}  (stderr {se:.10f})":
            raise AssertionError(f"cli basket {out!r} vs {px:.10f} {se:.10f}")
        print(f"  cli basket (asian, the [basket-path] book): {out}")
        basket_launches = tbk.basket_mc.launches
        print(f"  multi-asset {time.perf_counter() - t0:.2f} s; "
              f"basket_mc_kernel launches in it: {basket_launches}")
        if basket_launches == 0:
            raise AssertionError("basket_mc_kernel was not launched on the "
                                 "multi-asset path")

        print("phase 5 main path, LSV (lsv_calibrate, lsv_price_mc on "
              "K4-lsv, lsv_greeks_mc):")
        pmc.path_mc.launches = 0
        t0 = time.perf_counter()
        surf = self.surface()
        iv = float(surf.iv_from_logm(math.log(100.0 / (100.0 * math.exp(
            0.03))), 1.0))
        bs = tp.bs_price(tp.OptionSpec(100.0, 100.0, 1.0, 0.03, iv), "call",
                         device=dev)
        for scheme in ("euler", "qe"):
            model, self.times[("cal", scheme)] = timed(
                lambda: self.calibrate(scheme))
            if not torch.equal(model.leverage, self.models[scheme].leverage):
                raise AssertionError("lsv_calibrate differs from phase 3's")
            poly = self.poly_model(model)
            for payoff, extra in (("barrier", dict(barrier=130.0)),
                                  ("vanilla", {})):
                (pk, sk), secs = timed(lambda: tp.lsv_price_mc(
                    payoff, model, 100.0, **self.LSV_PRICE, device=dev,
                    **extra))
                scan = dict(backend="xla", n_paths=1 << 18, seed=8,
                            device=dev, **extra)
                ps, ss = tp.lsv_price_mc(payoff, poly, 100.0, **scan)
                check_price(f"lsv {scheme} {payoff} 2^20 x 96 on K4-lsv vs "
                            "the f64 scan at 2^18 on the kernel's leverage "
                            "polynomials", pk, sk + ss, ps, secs, slack=0.0,
                            what="scan")
                pt, st = tp.lsv_price_mc(payoff, model, 100.0, **scan)
                print(f"    the scan on the calibrated table itself: "
                      f"{pt:.10f} (se {st:.3e}); the degree-12 compression "
                      f"moves the price by {ps - pt:+.3e} (not held)")
            gap = abs(pk - bs)
            print(f"  lsv {scheme} ATM vanilla {pk:.10f} (se {sk:.3e}) vs "
                  f"the surface's BS {bs:.10f}: |err| {gap:.3e} (limit "
                  f"{max(4 * sk, 0.25):.3e}); calibration "
                  f"{self.times[('cal', scheme)] * 1e3:.3f} ms wall")
            if not gap < max(4 * sk, 0.25):
                raise AssertionError(f"lsv {scheme}: ATM off the surface")
        model = self.models["euler"]
        gkw = dict(n_paths=1 << 16, seed=4, device=dev)
        g, self.times[("greeks", "euler")] = timed(
            lambda: tp.lsv_greeks_mc("vanilla", model, 100.0, **gkw))
        h = 0.5
        up, _ = tp.lsv_price_mc("vanilla", dataclasses.replace(
            model, S0=100.0 + h), 100.0, backend="xla", **gkw)
        dn, _ = tp.lsv_price_mc("vanilla", dataclasses.replace(
            model, S0=100.0 - h), 100.0, backend="xla", **gkw)
        fd = (up - dn) / (2 * h)
        band = 0.02 * max(1.0, abs(fd)) + 4 * g["delta_stderr"]
        print(f"  lsv_greeks_mc delta {g['delta']:.6f} (se "
              f"{g['delta_stderr']:.3e}) vs CRN bump {fd:.6f}: |diff| "
              f"{abs(g['delta'] - fd):.3e} (limit {band:.3e}); d_v0 "
              f"{g['d_v0']:.6f}")
        if not abs(g["delta"] - fd) <= band:
            raise AssertionError("lsv_greeks_mc delta off the CRN bump")
        with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
            surf_path = str(Path(tmp) / "surface.json")
            model_path = str(Path(tmp) / "lsv.json")
            sz.save_surface(surf, surf_path)
            flags = ["--S0", "100", "--K", "100", "--T", "1", "--r", "0.03",
                     "--sigma", "0.2", "--n-steps", "64", "--n-paths",
                     "262144", "--seed", "0"]
            out = run_cli(["lsv", *flags, "--surface", surf_path,
                           "--save-model", model_path])
            cli_model = tp.lsv_calibrate(
                surf, self.HESTON, 100.0, 0.03, 0.0, T=1.0, n_steps=64,
                n_paths=65_536, n_bins=128, seed=0, device=dev)
            if not torch.equal(sz.load_lsv(model_path, device=dev).leverage,
                               cli_model.leverage):
                raise AssertionError("cli lsv: saved table differs")
            px, se = tp.lsv_price_mc("vanilla", cli_model, 100.0,
                                     n_paths=262_144, seed=0, device=dev)
            if out != f"{px:.10f}  (stderr {se:.10f})":
                raise AssertionError(f"cli lsv {out!r} vs {px:.10f} "
                                     f"{se:.10f}")
        print(f"  cli lsv (surface file, 64 steps, saved model): {out}")
        lsv_launches = pmc.path_mc.launches
        print(f"  LSV {time.perf_counter() - t0:.2f} s; path_mc_kernel "
              f"launches in it: {lsv_launches}")
        if lsv_launches == 0:
            raise AssertionError("path_mc_kernel (lsv) was not launched on "
                                 "the LSV path")
        return {"basket_mc_kernel": basket_launches,
                "path_mc_kernel lsv": lsv_launches}

    # -- phase 6 ---------------------------------------------------------
    def phase6(self):
        from optpricer_tpu_torch.ops import basket_mc as tbk
        from optpricer_tpu_torch.ops import path_mc as pmc

        seed, params, run = self.k6(10, "asian_basket")
        self.times[("k6", "main")] = cuda_ms(
            lambda: tbk.basket_mc(seed, params, **run))
        self.waves = k6_waves(self.dev)
        # phase 5's other K6 shapes: the 16-asset basket barrier (three
        # calls) and the 1-asset worst-of barrier at 2^20 pairs
        for key, args, shape in K6_OTHER_SHAPES:
            seed, params, run = self.k6(*args, shape=shape)
            self.times[("k6", key)] = cuda_ms(
                lambda: tbk.basket_mc(seed, params, **run))
        for scheme, model in self.models.items():
            seed, params, run = self.k4_lsv(
                model, self.LSV_PRICE["n_paths"],
                dict(payoff="barrier", barrier=130.0))
            self.times[("k4 lsv", scheme)] = cuda_ms(
                lambda: pmc.path_mc(seed, params, **run))
        print(f"phase 6 time K6 [basket-path] 2^18 pairs x 64 x 10 assets: "
              f"{self.times[('k6', 'main')]:.4f} ms, plain (one call, phase "
              f"3) {self.times[('k6plain', 'main')]:.4f} ms; "
              + "; ".join(f"{key} {self.times[('k6', key)]:.4f} ms"
                          for key, _, _ in K6_OTHER_SHAPES)
              + f" [{self.card}]")
        for scheme in self.models:
            print(f"phase 6 time K4-lsv {scheme} up-and-out 2^20 x 96: "
                  f"{self.times[('k4 lsv', scheme)]:.4f} ms, plain (one call,"
                  f" phase 3) {self.times[('k4plain lsv', scheme)]:.4f} ms "
                  f"[{self.card}]")
        for key, label in ((("cal", "euler"), "lsv_calibrate euler 96 x 128 "
                            "bins x 131072 particles f32"),
                           (("cal", "qe"), "lsv_calibrate qe (same size)"),
                           (("greeks", "euler"), "lsv_greeks_mc vanilla "
                            "2^16 x 96 f64 (jacfwd, 8 parameters)")):
            print(f"phase 6 wall {label} (phase 5's run): "
                  f"{self.times[key] * 1e3:.4f} ms [{self.card}]")
        print(f"phase 6 wall basket_price_mc 100 assets 2^19 pairs f64 "
              f"(phase 5's run): {self.wall_100 * 1e3:.4f} ms [{self.card}]")
        for label, fn in self.user_calls().items():
            print(f"phase 6 wall {label} (median of 21): {wall_ms(fn):.4f} "
                  f"ms [{self.card}]")

    def kernel_entries(self, launches, worst):
        n, steps = self.BASKET["n_paths"], self.BASKET["n_steps"]
        a = self.BASKET["a"]
        deg = 12
        n4 = self.LSV_PRICE["n_paths"]
        steps4 = self.models["euler"].n_steps
        return [
            {"name": "basket_mc_kernel", "route": "cuda",
             "source": "optpricer_tpu_torch/csrc/basket_mc.cu",
             "replaces": "optpricer_tpu/ops/pallas_basket_mc.py:58",
             "launches": launches["basket_mc_kernel"],
             "max_abs_err": worst["basket"][1],
             "ms": self.times[("k6", "main")],
             "plain_ms": self.times[("k6plain", "main")],
             **dict(zip(("bound_ms", "bound_by"), bound(
                 n * steps * ops_k6_path_step(a, True, False),
                 8 + 4 * (7 + 4 * a + a * a) + 4 * 6))),
             "library_ms": None,
             "shape": f"[basket-path] asian, {a} assets, {n} pairs x "
                      f"{steps} steps, antithetic",
             **{f"ms_{key}": self.times[("k6", key)]
                for key, _, _ in K6_OTHER_SHAPES},
             **{f"bound_ms_{key}": bound(
                 shape[0] * shape[1] * ops_k6_path_step(args[0], True, True),
                 8 + 4 * (7 + 4 * args[0] + args[0] ** 2) + 4 * 6)[0]
                for key, args, shape in K6_OTHER_SHAPES},
             "blocks_per_sm": self.waves["basket_path"][0],
             **{f"blocks_per_sm_{key}": self.waves[key][0]
                for key, _, _ in K6_OTHER_SHAPES}},
            {"name": "path_mc_kernel lsv", "route": "cuda",
             "source": "optpricer_tpu_torch/csrc/path_mc.cu",
             "replaces": "optpricer_tpu/ops/pallas_path_mc.py:68",
             "launches": launches["path_mc_kernel lsv"],
             "max_abs_err": worst["path_lsv"][1],
             "ms": self.times[("k4 lsv", "euler")],
             "plain_ms": self.times[("k4plain lsv", "euler")],
             **dict(zip(("bound_ms", "bound_by"), bound(
                 n4 * steps4 * ops_k4_lsv_path_step(deg, False, True),
                 8 + 96 + 4 * steps4 * (deg + 1) + 84))),
             "library_ms": None,
             "shape": f"lsv euler up-and-out 130, calibrated table, {n4} "
                      f"paths x {steps4} steps, antithetic",
             "ms_qe": self.times[("k4 lsv", "qe")],
             "plain_ms_qe": self.times[("k4plain lsv", "qe")],
             "bound_ms_qe": bound(
                 n4 * steps4 * ops_k4_lsv_path_step(deg, True, True),
                 0)[0]},
        ]


class ClosedFormSlice:
    """The closed-form slice: the Heston/Bates COS pricers with their fit
    and Greeks, the analytic Americans and the American implied vol, the
    Lévy models, validation and the profiling utilities, through the public
    API on the card at desk sizes, each held to its ``device="cpu"`` call
    or an oracle. The slice has no kernel of its own; its path launches K1
    (validation's Monte Carlo) and K7 (the FD/FEM propagator builds)."""

    MKT = (100.0, 0.04, 0.01)                 # S0, r, q of the Heston board
    # the heston_cos golden's parameters (tests/golden_cases.py:221-226)
    HESTON = dict(v0=0.045, kappa=1.8, theta=0.05, xi=0.45, rho=-0.55)
    EXPIRIES = (0.1, 0.25, 0.5, 0.75, 1.0, 1.5, 2.0, 3.0)
    N_STRIKES = 1024
    LEVY_MKT = (100.0, 1.0, 0.03, 0.0)        # S0, T, r, q
    VG = dict(sigma=0.2, theta=-0.14, nu=0.2)
    NIG = dict(alpha=8.0, beta=-4.0, delta=0.4)
    CGMY = dict(C=0.5, G=5.0, M=9.0, Y=0.8)
    PATHS = dict(n_paths=200_000, n_steps=252)
    CONFIG2 = dict(n=1000, N=500, N_fine=2000)   # American puts, lattices

    def __init__(self, dev, card):
        self.dev, self.card = dev, card
        self.strikes = torch.linspace(60.0, 140.0,
                                      self.N_STRIKES).double().numpy()
        self.calls = {}   # label -> the slice's user call, for phase 6

    # -- phase 5 ---------------------------------------------------------
    def board(self, kind, device, bates=False):
        import optpricer_tpu_torch as tp

        S0, r, q = self.MKT
        jumps = dict(lam=0.0, mJ=-0.1, sJ=0.15) if bates else {}
        price = tp.bates_price_cos if bates else tp.heston_price_cos
        return torch.stack([price(S0, self.strikes, T, r, q, **self.HESTON,
                                  **jumps, kind=kind, N=256, device=device)
                            for T in self.EXPIRIES])

    @staticmethod
    def close(got, want, rtol, atol, what):
        """Max |got − want| / (atol + rtol·|want|); raises above 1."""
        got, want = got.double().cpu(), want.double().cpu()
        if got.shape != want.shape or not torch.isfinite(got).all():
            raise AssertionError(f"{what}: bad output {got.shape}")
        worst = float(((got - want).abs()
                       / (atol + rtol * want.abs())).max())
        if worst > 1.0:
            raise AssertionError(f"{what}: |diff| / (atol {atol} + rtol "
                                 f"{rtol}·|cpu|) reaches {worst:.3f}")
        return worst

    def heston(self):
        import numpy as np

        import optpricer_tpu_torch as tp

        dev, (S0, r, q), H = self.dev, self.MKT, self.HESTON
        calls, secs = timed(lambda: self.board("call", dev))
        puts = self.board("put", dev)
        worst = max(self.close(self.board(k, dev), self.board(k, "cpu"),
                               1e-10, 1e-12, f"heston board {k}")
                    for k in ("call", "put"))
        T = torch.tensor(self.EXPIRIES, dtype=torch.float64)[:, None]
        K = torch.tensor(self.strikes)[None, :]
        parity = (calls.cpu() - puts.cpu() - (S0 * torch.exp(-q * T)
                                              - K * torch.exp(-r * T)))
        gap = float(parity.abs().max())
        golden = float(tp.heston_price_cos(S0, 105.0, 0.75, r, q, **H,
                                           device=dev))
        bates0 = torch.equal(self.board("call", dev, bates=True), calls)
        print(f"  heston board {len(self.EXPIRIES)} expiries x "
              f"{self.N_STRIKES} strikes, N 256: {secs * 1e3:.3f} ms wall; "
              f"card vs cpu: largest |diff| / (1e-12 + 1e-10·|cpu|) "
              f"{worst:.3e}; max |C − P − (S0e^-qT − Ke^-rT)| {gap:.3e}; "
              f"golden heston_cos {golden:.15f} (goldens.json "
              f"5.634047782422982); bates λ=0 equal to heston: {bates0}")
        if gap > 1e-10 * S0:
            raise AssertionError(f"heston board: put-call parity off by "
                                 f"{gap:.3e}")
        if abs(golden - 5.634047782422982) > 1e-9 * 5.634047782422982:
            raise AssertionError(f"heston_cos golden {golden!r}")
        if not bates0:
            raise AssertionError("bates_price_cos with lam=0 differs from "
                                 "heston_price_cos")
        shape = f"{len(self.EXPIRIES)} x {self.N_STRIKES}"
        self.calls[f"heston_price_cos board {shape} calls"] = \
            lambda: self.board("call", dev)
        self.calls[f"bates_price_cos board {shape} calls"] = \
            lambda: self.board("call", dev, bates=True)

        # Greeks against central differences of the price on the card
        g = tp.heston_greeks_cos(S0, 105.0, 0.75, r, q, **H, device=dev)
        h = 0.05
        px = [float(tp.heston_price_cos(S0 + d, 105.0, 0.75, r, q, **H,
                                        device=dev)) for d in (-h, 0.0, h)]
        delta_fd = (px[2] - px[0]) / (2.0 * h)
        gamma_fd = (px[2] - 2.0 * px[1] + px[0]) / (h * h)
        print(f"  heston_greeks_cos: delta {g['delta']:.10f} (central "
              f"difference, h {h}: {delta_fd:.10f}), gamma "
              f"{g['gamma']:.10f} ({gamma_fd:.10f}); vega_v0 "
              f"{g['vega_v0']:.6f}, theta {g['theta']:.6f}")
        for name, fd in (("delta", delta_fd), ("gamma", gamma_fd)):
            if abs(g[name] - fd) > 1e-5 * abs(fd):
                raise AssertionError(f"heston_greeks_cos {name} {g[name]} "
                                     f"vs central difference {fd}")
        self.calls["heston_greeks_cos"] = lambda: tp.heston_greeks_cos(
            S0, 105.0, 0.75, r, q, **H, device=dev)

        # fit_heston on a synthetic 8 x 21 surface
        Ts = np.repeat(self.EXPIRIES, 21)
        Ks = np.tile(np.linspace(80.0, 120.0, 21), len(self.EXPIRIES))
        px = tp.heston_price_cos(S0, torch.tensor(Ks), torch.tensor(Ts), r,
                                 q, **H, N=128, device=dev)
        iv = tp.bs_implied_vol_vec(S0, Ks, Ts, r, q, px, "call",
                                   device=dev).cpu().numpy()
        fit, secs = timed(lambda: tp.fit_heston(Ks, Ts, iv, S0, r, q,
                                                device=dev))
        fit_cpu = tp.fit_heston(Ks, Ts, iv, S0, r, q, device="cpu")
        names = ("v0", "kappa", "theta", "xi", "rho")
        gap = max(abs(fit[k] - fit_cpu[k]) for k in names)
        off = max(abs(fit[k] - H[k]) for k in names)
        print(f"  fit_heston 8 x 21 quotes, n_cos 128: rmse "
              f"{fit['rmse']:.3e}, max |param − cpu fit| {gap:.3e}, max "
              f"|param − true| {off:.3e} ({secs * 1e3:.3f} ms wall)")
        if not fit["rmse"] < 1e-6 or gap > 1e-8:
            raise AssertionError(f"fit_heston: {fit} vs cpu {fit_cpu}")
        self.calls["fit_heston 8 x 21 quotes"] = lambda: tp.fit_heston(
            Ks, Ts, iv, S0, r, q, device=dev)

    def american(self):
        import numpy as np

        import optpricer_tpu_torch as tp

        dev = self.dev
        # config 2: 1 000 American puts, K 50..150, N = 500
        n, N, N_fine = (self.CONFIG2[k] for k in ("n", "N", "N_fine"))
        K = torch.linspace(50.0, 150.0, n).double().numpy()
        px = tp.crr_vec(100.0, K, 1.0, 0.03, 0.0, 0.2, "put", N=N,
                        american=True, device=dev).cpu().numpy()
        iv, secs = timed(lambda: tp.american_implied_vol(
            px, 100.0, K, 1.0, 0.03, 0.0, "put", N=N, device=dev))
        ok = ~np.isnan(iv)
        intrinsic = np.maximum(K - 100.0, 0.0)
        err = float(np.abs(iv[ok] - 0.2).max())
        print(f"  american_implied_vol crr N={N} on config 2's {n} puts: "
              f"max |σ − 0.2| {err:.3e} over {int(ok.sum())} strikes; "
              f"{int((~ok).sum())} NaN, all at intrinsic ({secs * 1e3:.3f} "
              f"ms wall)")
        if err > 1e-8 or not (px[~ok] <= intrinsic[~ok] + 1e-12).all():
            raise AssertionError("american_implied_vol crr round trip")
        self.calls[f"american_implied_vol crr {n} puts N={N}"] = \
            lambda: tp.american_implied_vol(px, 100.0, K, 1.0, 0.03, 0.0,
                                            "put", N=N, device=dev)
        # the same strikes priced as tests/test_binomial.py:160-165 prices
        # its chain (N = 2 000, r 0.05, q 0.02), inverted through BS2002
        px2 = tp.crr_vec(100.0, K, 1.0, 0.05, 0.02, 0.2, "put", N=N_fine,
                         american=True, device=dev).cpu().numpy()
        iv2, secs = timed(lambda: tp.american_implied_vol(
            px2, 100.0, K, 1.0, 0.05, 0.02, "put", engine="bs2002",
            device=dev))
        ok2 = ~np.isnan(iv2)
        near = ok2 & (K >= 90.0) & (K <= 110.0)
        err_near = float(np.abs(iv2[near] - 0.2).max())
        err_all = float(np.abs(iv2[ok2] - 0.2).max())
        print(f"  american_implied_vol bs2002 of N={N_fine} lattice puts: max "
              f"|σ − 0.2| {err_near:.3e} on K 90..110 (the test's span, "
              f"bound 2e-3), {err_all:.3e} over all {int(ok2.sum())} "
              f"strikes ({secs * 1e3:.3f} ms wall)")
        if err_near > 2e-3:
            raise AssertionError("american_implied_vol bs2002 off the "
                                 "lattice inverse")
        self.calls[f"american_implied_vol bs2002 {n} puts"] = \
            lambda: tp.american_implied_vol(px2, 100.0, K, 1.0, 0.05, 0.02,
                                            "put", engine="bs2002",
                                            device=dev)
        bs = tp.bjerksund_stensland_price(100.0, K, 1.0, 0.05, 0.02,
                                          sigma=0.2, kind="put", device=dev)
        worst = self.close(bs, tp.bjerksund_stensland_price(
            100.0, K, 1.0, 0.05, 0.02, sigma=0.2, kind="put", device="cpu"),
            1e-12, 1e-13, "bjerksund_stensland_price")
        print(f"  bjerksund_stensland_price {n} puts card vs cpu: largest "
              f"|diff| / (1e-13 + 1e-12·|cpu|) {worst:.3e}")

    def levy(self):
        import optpricer_tpu_torch as tp

        dev = self.dev
        S0, T, r, q = self.LEVY_MKT
        cos = {"vg": (tp.vg_price_cos, self.VG),
               "nig": (tp.nig_price_cos, self.NIG),
               "cgmy": (tp.cgmy_price_cos, self.CGMY)}
        for name, (fn, kw) in cos.items():
            for kind in ("call", "put"):
                out = fn(S0, self.strikes, T, r, q, **kw, kind=kind,
                         device=dev)
                worst = self.close(out, fn(S0, self.strikes, T, r, q, **kw,
                                           kind=kind, device="cpu"),
                                   1e-10, 1e-12, f"{name}_price_cos {kind}")
            print(f"  {name}_price_cos {self.N_STRIKES} strikes: card vs "
                  f"cpu largest |diff| / (1e-12 + 1e-10·|cpu|) {worst:.3e}")
            self.calls[f"{name}_price_cos {self.N_STRIKES} strikes"] = \
                lambda fn=fn, kw=kw: fn(S0, self.strikes, T, r, q, **kw,
                                        device=dev)
        n = self.PATHS["n_paths"]
        for name, fn, kw, cos_fn in (
                ("vg_paths", tp.vg_paths, self.VG, tp.vg_price_cos),
                ("nig_paths", tp.nig_paths, self.NIG, tp.nig_price_cos)):
            paths, secs = timed(lambda: fn(S0, T, r, q, **kw, **self.PATHS,
                                           seed=7, device=dev))
            if paths.shape != (self.PATHS["n_steps"] + 1, 2 * n) \
                    or paths.dtype != torch.float64 \
                    or not torch.isfinite(paths).all():
                raise AssertionError(f"{name}: bad paths")
            ST = paths[-1].clone()
            del paths
            disc = math.exp(-r * T)
            # an antithetic pair shares its clock: one sample a pair
            mean_pair = disc * 0.5 * (ST[:n] + ST[n:])
            pay = disc * 0.5 * (torch.clamp(ST[:n] - 100.0, min=0.0)
                                + torch.clamp(ST[n:] - 100.0, min=0.0))
            m, se = float(mean_pair.mean()), float(mean_pair.std()) / n**0.5
            c, c_se = float(pay.mean()), float(pay.std()) / n**0.5
            ref = float(cos_fn(S0, 100.0, T, r, q, **kw, device=dev))
            print(f"  {name} {n} x {self.PATHS['n_steps']} f64 antithetic: "
                  f"e^-rT E[S_T] {m:.6f} (se {se:.2e}, S0 {S0}); ATM call "
                  f"{c:.6f} (se {c_se:.2e}) vs COS {ref:.6f} "
                  f"({secs * 1e3:.3f} ms wall)")
            if abs(m - S0) > 4.0 * se or abs(c - ref) > 4.0 * c_se + 1e-3:
                raise AssertionError(f"{name}: off its COS oracle")
            self.calls[f"{name} {n} x {self.PATHS['n_steps']} f64"] = \
                lambda fn=fn, kw=kw: fn(S0, T, r, q, **kw, **self.PATHS,
                                        seed=7, device=dev)

    def validation(self):
        import numpy as np

        import optpricer_tpu_torch as tp

        dev = self.dev
        opt = tp.OptionSpec(S0=100.0, K=100.0, T=1.0, r=0.05, sigma=0.2)
        out, secs = timed(lambda: tp.cross_validate(opt, "call", device=dev))
        two = tp.cross_validate(opt, "put", methods=["bs", "fdm"],
                                device=dev)
        print(f"  cross_validate defaults: max_discrepancy "
              f"{out['max_discrepancy']:.6f} (bs {out['bs']:.6f}, mc "
              f"{out['mc'][0]:.6f}, tree {out['tree']:.6f}, fdm "
              f"{out['fdm']:.6f}, fem {out['fem']:.6f}; {secs * 1e3:.3f} ms "
              f"wall); ['bs', 'fdm'] put {two['max_discrepancy']:.6f}")
        if not out["max_discrepancy"] < 0.5 or \
                not two["max_discrepancy"] < 0.1:
            raise AssertionError("cross_validate discrepancies")
        self.calls["cross_validate defaults"] = \
            lambda: tp.cross_validate(opt, "call", device=dev)
        sweeps = {"tree": [50, 100, 200, 400, 800], "fdm": [50, 100, 200],
                  "mc": [1000, 10_000, 100_000]}
        conv = {m: tp.convergence_analysis(opt, "call", m, "N", v,
                                           device=dev)
                for m, v in sweeps.items()}
        print("  convergence_analysis: " + "; ".join(
            f"{m} errors {[f'{e:.2e}' for e in c['errors']]} order "
            f"{c['order']:.3f}" for m, c in conv.items()))
        if not conv["tree"]["order"] > 0 \
                or not conv["fdm"]["errors"][-1] < conv["fdm"]["errors"][0]:
            raise AssertionError("convergence_analysis orders")
        self.calls["convergence_analysis fdm 50/100/200"] = \
            lambda: tp.convergence_analysis(opt, "call", "fdm", "N",
                                            sweeps["fdm"], device=dev)
        spots, vols = np.linspace(0.8, 1.2, 11), np.linspace(-0.1, 0.1, 11)
        cube = tp.stress_test(opt, "call", spots, vols, [0.0], device=dev)
        cube_cpu = tp.stress_test(opt, "call", spots, vols, [0.0],
                                  device="cpu")
        worst = self.close(torch.tensor(cube), torch.tensor(cube_cpu), 1e-12,
                           1e-13, "stress_test")
        base = tp.bs_price(opt, "call", device=dev)
        print(f"  stress_test 11 x 11 spot x vol: centre {cube[5, 5, 0]:.10f}"
              f" (bs {base:.10f}); card vs cpu {worst:.3e} of the band")
        if cube.shape != (11, 11, 1) or abs(cube[5, 5, 0] - base) > 1e-9:
            raise AssertionError("stress_test centre")
        self.calls["stress_test 11 x 11"] = lambda: tp.stress_test(
            opt, "call", spots, vols, [0.0], device=dev)

        n = self.PATHS["n_paths"]
        paths = tp.gbm_paths(100.0, 0.05, 0.0, 0.2, 1.0,
                             self.PATHS["n_steps"], n, seed=11, device=dev)
        std = {}
        for freq in (1, 4):
            res, secs = timed(lambda: tp.backtest_delta_hedge(
                opt, "call", paths, freq, device=dev))
            pnl = res["pnl"]
            pairs = 0.5 * (pnl[:n] + pnl[n:])
            se = float(pairs.std()) / n**0.5
            std[freq] = res["std_pnl"]
            print(f"  backtest_delta_hedge gbm_paths {n} x "
                  f"{self.PATHS['n_steps']} antithetic, every {freq} "
                  f"step(s): mean P&L {res['mean_pnl']:.6f} (se {se:.2e}), "
                  f"std {res['std_pnl']:.6f} ({secs * 1e3:.3f} ms wall)")
            if abs(res["mean_pnl"]) > 4.0 * se + 0.01:
                raise AssertionError("backtest_delta_hedge mean P&L")
        if not std[4] > std[1]:
            raise AssertionError("backtest_delta_hedge: rebalancing less "
                                 "often should widen the P&L")
        self.calls[f"backtest_delta_hedge {n} x {self.PATHS['n_steps']} "
                   "every step"] = \
            lambda: tp.backtest_delta_hedge(opt, "call", paths, 1,
                                            device=dev)

    def profiling(self):
        import optpricer_tpu_torch as tp
        from optpricer_tpu_torch.utils import profiling

        spec = tp.OptionSpec(**SPEC)
        with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
            with profiling.trace(tmp):
                tp.euro_price_mc(spec, "call", n_paths=1_000_000, seed=7,
                                 device=self.dev)
            text = (Path(tmp) / "trace.json").read_text()
        mem = profiling.device_memory()
        print(f"  profiling.trace around euro_price_mc 1M: trace.json "
              f"{len(text)} bytes, names terminal_mc_kernel: "
              f"{'terminal_mc_kernel' in text}; device_memory: {mem}")
        if "terminal_mc_kernel" not in text:
            raise AssertionError("the trace does not name terminal_mc_kernel")
        if len(mem) != torch.cuda.device_count() \
                or torch.cuda.get_device_name(0) not in mem[0]["device"] \
                or not mem[0]["bytes_limit"] > 0:
            raise AssertionError(f"device_memory: {mem}")

    def cli(self):
        """The five subcommands as subprocesses, started together, each
        against the same call in-process."""
        import optpricer_tpu_torch as tp

        market = ["--S0", "100", "--K", "110", "--T", "1", "--r", "0.03",
                  "--sigma", "0.2"]
        cases = {
            "heston": (["--lam", "0.3", "--mJ", "-0.1", "--sJ", "0.15"],
                       lambda: tp.bates_price_cos(
                           100.0, 110.0, 1.0, 0.03, 0.0, v0=0.04, kappa=1.5,
                           theta=0.04, xi=0.4, rho=-0.6, lam=0.3, mJ=-0.1,
                           sJ=0.15, device=self.dev)),
            "american": (["--kind", "put"],
                         lambda: tp.bjerksund_stensland_price(
                             100.0, 110.0, 1.0, 0.03, 0.0, sigma=0.2,
                             kind="put", device=self.dev)),
            "barrier": (["--lower", "80", "--upper", "130", "--engine", "fd"],
                        lambda: tp.fd_price_double_barrier(
                            tp.OptionSpec(100.0, 110.0, 1.0, 0.03, 0.2),
                            "call", lower=80.0, upper=130.0, N_S=400,
                            N_t=400, device=self.dev)),
            "lookback": ([], lambda: tp.lookback_price_bs(
                100.0, 1.0, 0.03, 0.0, sigma=0.2, K=110.0, device=self.dev)),
            "levy": (["--model", "nig"], lambda: tp.nig_price_cos(
                100.0, 110.0, 1.0, 0.03, 0.0, **self.NIG, device=self.dev)),
        }
        procs = {name: subprocess.Popen(
            [sys.executable, "-m", "optpricer_tpu_torch.cli", name, *market,
             *extra], cwd=ROOT, stdout=subprocess.PIPE, text=True)
            for name, (extra, _) in cases.items()}
        lines = []
        for name, proc in procs.items():
            out, _ = proc.communicate(timeout=600)
            if proc.returncode != 0:
                raise AssertionError(f"cli {name} exited {proc.returncode}")
            want = f"{float(cases[name][1]()):.10f}"
            if out.strip() != want:
                raise AssertionError(f"cli {name} {out.strip()!r} vs {want}")
            lines.append(f"{name} {' '.join(cases[name][0])} {want}")
        print("  cli (subprocesses, each equal to the call in-process): "
              + " | ".join(lines))

    def phase5(self) -> dict:
        """The closed-form path with K1's and K7's launch counts set to 0
        just before it and read just after; returns them."""
        from optpricer_tpu_torch.ops import terminal_mc as tmc
        from optpricer_tpu_torch.ops import thomas as tth

        fns = {"terminal_mc_kernel": tmc.terminal_mc,
               "tridiag_pcr_kernel": tth.tridiag_solve_kernel}
        for fn in fns.values():
            fn.launches = 0
        print("phase 5 main path, closed forms (COS, analytic Americans, "
              "Lévy, validation, profiling):")
        t0 = time.perf_counter()
        self.heston()
        self.american()
        self.levy()
        self.validation()
        self.profiling()
        self.cli()
        launches = {name: fn.launches for name, fn in fns.items()}
        print(f"  closed-form path {time.perf_counter() - t0:.2f} s; "
              f"launches in this process: {launches}")
        for name, count in launches.items():
            if count == 0:
                raise AssertionError(f"{name} was not launched on the "
                                     "closed-form path")
        return launches

    # -- phase 6 ---------------------------------------------------------
    @staticmethod
    def kernel_busy(fn):
        """(summed kernel ms, kernels) of one call of ``fn`` under
        torch.profiler, recording the CUDA activity alone and summing the
        profiler's raw Kineto events: the host's op events, and turning
        each event into a Python ``FunctionEvent`` (``prof.events()``),
        would cost more than the longest calls here take (some launch
        400 000 kernels)."""
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        kernels = [e.duration_ns()
                   for e in prof.profiler.kineto_results.events()
                   if e.device_type() == DeviceType.CUDA]
        return sum(kernels) / 1e6, len(kernels)

    def phase6(self):
        """Each call's host-clock wall (median of 3 after a warm-up; one
        run for a call of more than a second, phase 5's call its warm-up)
        and, from one more run under torch.profiler, the time its kernels
        kept the device busy and that time's share of the wall."""
        t0 = time.perf_counter()
        for label, fn in self.calls.items():
            _, first = timed(fn)
            wall = first * 1e3 if first > 1.0 else wall_ms(fn, reps=3)
            busy, n_kernels = self.kernel_busy(fn)
            print(f"phase 6 wall {label}: {wall:.4f} ms, device busy "
                  f"{busy:.4f} ms ({100.0 * busy / wall:.1f}%, "
                  f"{n_kernels} kernels) [{self.card}]")
        print(f"phase 6 closed forms {time.perf_counter() - t0:.2f} s")


def main():
    t_start = time.perf_counter()
    # phase 1: device
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; "
                         "this check needs a CUDA card")
    from optpricer_tpu_torch import _build
    import optpricer_tpu_torch as tp
    from optpricer_tpu_torch.models import mc_fused
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
        if line.startswith("--- ") or "Function properties" in line \
                or "spill" in line or "Used" in line:
            print("  " + line.strip())
    for label, (per_sm, blocks, waves, _) in k4_waves(dev).items():
        dynamics, _, _, n, n_steps = K4_TIMED[label]
        print(f"phase 2 K4 {label} ({n} x {n_steps}): {per_sm} resident "
              f"blocks per SM, {blocks} blocks, {waves:.2f} waves")
    for key, (per_sm, blocks, waves) in k6_waves(dev).items():
        print(f"phase 2 K6 {key}: {per_sm} resident blocks per SM, {blocks} "
              f"blocks, {waves:.2f} waves")
    occupancy = k1_k5_waves(dev)
    for key, (per_sm, blocks, waves) in occupancy.items():
        print(f"phase 2 {key}: {per_sm} resident blocks per SM, {blocks} "
              f"blocks, {waves:.2f} waves")

    # phase 3: kernels against their plain versions, on the card
    print(f"phase 3 starts at {time.perf_counter() - t_start:.1f} s")
    market = MARKET
    # worst[name] = [max rel err, max |price difference|, its case]
    worst = {k: [0.0, 0.0, "-"] for k in ("terminal", "qmc", "path",
                                          "qmc_path", "tridiag", "fd_lv",
                                          "path_lv", "mc_batch", "basket",
                                          "path_lsv")}

    def record(name, rel, price_k, price_p, case):
        diff = abs(price_k - price_p)
        worst[name][0] = max(worst[name][0], rel)
        if diff > worst[name][1] or worst[name][2] == "-":
            worst[name][1:] = [max(worst[name][1], diff), case]

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
        case = f"n={n} call={is_call} anti={anti} invcdf={inv}"
        rel = compare(k, p, f"terminal {case}")
        record("terminal", rel, *(tmc.terminal_estimate(
            s, *market, is_call, True)[0] for s in (k, p)), case)
    for case in K2_CASES[:-1]:
        seed, params, kw, R = k2_setup(dev, case)
        k = tmc.terminal_qmc(seed, params, **kw)
        p = tmc._mc_qmc_plain(seed.to(dev), params.to(dev),
                              **{a: v for a, v in kw.items() if a != "device"})
        rel = compare(k, p, f"qmc {case}")
        if sha256(k) != K2_SUMS[case]:
            raise AssertionError(f"qmc {case}: rows differ from the recorded "
                                 "ones (K2_SUMS)")
        is_call = case.split()[1] == "call"
        record("qmc", rel, *(tmc.qmc_estimate(
            rows.double().cpu().numpy().reshape(R, -1, tmc.NSTAT).sum(1),
            *market, is_call)[0] for rows in (k, p)), case)
    print(f"phase 3 qmc: the (n_programs, 13) rows of {len(K2_CASES) - 1} "
          "cases equal K2_SUMS bit for bit")

    def k4_check(what, setup, pay, signed=()):
        """The kernel against its plain version on one K4 setup."""
        seed, params, run, dynamics, geo, mkt = setup
        k = pmc.path_mc(seed, params, **run)
        p = pmc._path_mc_plain(seed, params, **run)
        rel = compare(k, p, what, signed=signed)
        record("path", rel, *(mc_fused._estimate_from_stats(
            s, *mkt, pay.get("is_call", True), dynamics, True,
            geo_ey=geo)[0] for s in (k, p)), what)

    heston = dict(v0=0.04, kappa=1.5, theta=0.05, xi=0.6, rho=-0.7)
    sabr = dict(alpha0=0.2, beta=0.6, nu=0.4, rho=-0.3)
    k4_shape = ((1 << 18) + 123, 16)  # paths (a ragged count), steps
    k4_runs = [(name, {}, anti, greeks) for name in K4_PAYOFFS
               for anti in (True, False) for greeks in (False, True)]
    k4_runs += [(name, dyn, anti, False) for name in ("vanilla", "up-and-out")
                for dyn in (dict(heston=heston),
                            dict(heston=heston, scheme="qe"),
                            dict(sabr=dict(sabr, beta=1.0)), dict(sabr=sabr))
                for anti in (True, False)]
    for name, dyn, anti, greeks in k4_runs:
        k4_check(f"path {name} {list(dyn.values())} anti={anti} "
                 f"greeks={greeks}",
                 k4_call(dev, *k4_shape, K4_PAYOFFS[name], dyn, anti,
                         greeks),
                 K4_PAYOFFS[name], signed=K4_SIGNED)
    # every K4 configuration that phase 5 runs, at its shape and market
    main_k4 = k4_call(dev, 1_000_000, 252, K4_PAYOFFS["asian-geo_cv"], {},
                      True, False, mkt=(100.0, 100.0, *market[2:]))
    k4_check("path main shape 1M x 252 asian geo_cv", main_k4,
             K4_PAYOFFS["asian-geo_cv"])
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
         for dyn in SV_PHASE5 for is_call, kind in ((True, "call"),
                                                     (False, "put"))]
    for label, pay, dyn, n_steps, greeks, mkt in phase5_k4:
        k4_check(f"path phase-5 shape 1M x {n_steps} {label} "
                 f"{list(dyn.values())}",
                 k4_call(dev, 1_000_000, n_steps, pay, dyn, True, greeks,
                         mkt=mkt), pay, signed=K4_SIGNED)

    def k5_price(rows, R, ppr):
        reps_stats = rows.double().cpu().numpy().reshape(R, ppr, 6).sum(1)
        return qmp.qmc_path_estimate(reps_stats, SPEC["S0"], SPEC["q"],
                                     SPEC["T"])[0]

    for key in K5_CASES[:-1]:
        payoff, n, d = key.split()
        tensors, kw, (R, ppr) = k5_setup(qmp, dev, payoff, int(n), int(d))
        k = qmp.qmc_path(*tensors, **kw)
        p = qmp._qmc_path_plain(*tensors, **kw)
        case = f"{payoff} {n} x 8 x {d}"
        rel = compare(k, p, f"qmc_path {case}")
        if sha256(k) != QMC_PATH_SUMS[key]:
            raise AssertionError(f"qmc_path {case}: sums differ from the "
                                 f"recorded ones (QMC_PATH_SUMS)")
        record("qmc_path", rel, k5_price(k, R, ppr), k5_price(p, R, ppr),
               case)
    print(f"phase 3 qmc_path: the (n_programs, 6) sums of {len(K5_CASES) - 1}"
          " cases equal QMC_PATH_SUMS bit for bit")
    # the arithmetic Asian past 252 steps, against the plain mirror that
    # sums the steps in step order, as the kernel does
    for sigma in (0.2, 0.0):
        m_bits, d_pad, reps5, ppr5 = qmp._plan(4096, 2048, 2)
        arrays = qmp._kernel_inputs(3, 4096, 2048, 100.0, 100.0, 1.0, 0.03,
                                    0.0, sigma, n_replicates=2, barrier=0.0,
                                    rebate=0.0, payout=1.0)
        tensors = [torch.from_numpy(a).to(dev) for a in arrays]
        kw5 = dict(n_programs=2 * ppr5, reps=reps5, progs_per_rep=ppr5,
                   n_steps=2048, d_pad=d_pad, m_bits=m_bits,
                   payoff_id=qmp.PAYOFF_IDS["asian"], barrier_up=True,
                   knock_in=False, is_call=True, arithmetic=True,
                   fixed_strike=True)
        k = qmp.qmc_path(*tensors, **kw5)
        p = qmp._qmc_path_plain(*tensors, **kw5, step_order=True)
        case = f"arithmetic asian 4096 x 2 x 2048 sigma={sigma}"
        record("qmc_path", compare(k, p, f"qmc_path {case}"),
               *(qmp.qmc_path_estimate(
                   rows.double().cpu().numpy().reshape(2, ppr5, 6).sum(1),
                   100.0, 0.0, 1.0)[0] for rows in (k, p)), case)

    pde = PdeSlice(dev, card)
    pde.phase3(record)
    desk = Config5Slice(dev, card)
    desk.phase3(record, K4_PAYOFFS)
    multi = MultiAssetLsvSlice(dev, card)
    multi.phase3(record)

    for name, (rel, dprice, case) in worst.items():
        if name == "tridiag":
            print(f"phase 3 {name} kernel vs plain: max norm-wise rel err "
                  f"{rel:.3e} (rtol 1e-10 f64, 2e-5 f32), max |x difference| "
                  f"{dprice:.3e} in case [{case}]")
        elif name == "fd_lv":
            print(f"phase 3 {name} kernel vs plain: max |layer difference| "
                  f"{rel:.3e}, max |price difference| {dprice:.3e} "
                  f"(limit {RTOL}) in case [{case}]")
        else:
            print(f"phase 3 {name} kernel vs plain: counts equal, max rel "
                  f"err of the unsigned stats {rel:.3e} (rtol {RTOL}), max "
                  f"|price difference| {dprice:.3e} in case [{case}]")

    # phase 4: determinism
    print(f"phase 4 starts at {time.perf_counter() - t_start:.1f} s")
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
    pde.phase4()
    desk.phase4()
    multi.phase4()
    print("phase 4 determinism: terminal kernel at 2^24, path kernel at "
          "1M x 252 and lv_milstein at 200000 x 500, fd_lv PCR and Thomas at "
          "1024 x 511 x 512, the book kernel at 1000 contracts x 2^20, the "
          "basket kernel at 16 assets x 2^18 x 64, lsv and lsv_qe at 2^20 x "
          "96, two runs on one input each: bitwise equal; lsv_calibrate "
          "(euler, qe; 96 x 128 x 131072, f32, one seed) twice: equal "
          "leverage tables")

    # phase 5: the main path through the public API
    print(f"phase 5 starts at {time.perf_counter() - t_start:.1f} s")
    spec = tp.OptionSpec(**SPEC)
    bs = tp.bs_price(spec, "call", device=dev)
    launch_fns = {"terminal_mc_kernel": tmc.terminal_mc,
                  "terminal_qmc_kernel": tmc.terminal_qmc,
                  "path_mc_kernel": pmc.path_mc,
                  "qmc_path_kernel": qmp.qmc_path}
    for fn in launch_fns.values():
        fn.launches = 0
    print("phase 5 main path, Monte Carlo:")
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
    for label, dyn in zip(("heston euler", "sabr beta=1"), SV_PHASE5):
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

    launches.update(pde.phase5())
    launches.update(desk.phase5())
    launches.update(multi.phase5())
    closed = ClosedFormSlice(dev, card)
    closed_launches = closed.phase5()

    # phase 6: time
    print(f"phase 6 starts at {time.perf_counter() - t_start:.1f} s")
    times = {}
    for n in (1 << 30, 1 << 24, 1_000_000):   # 1M: phase 5's two 1M calls
        reps, n_prog = tmc._plan_grid(n, 2 * tmc.TILE)
        params = tmc._terminal_params(n, *market, True).to(dev)
        kw = dict(n_programs=n_prog, reps=reps, antithetic=True)
        times[("k1", n)] = cuda_ms(lambda: tmc.terminal_mc(seed, params, **kw))
        if n < 1 << 30:   # the plain version at 2^24 and 1M
            times[("k1plain", n)] = cuda_ms(
                lambda: tmc._mc_sumstats_plain(seed, params, **kw))
    k2_threads, k2_waves = {}, {}
    for case in (K2_CASES[-1], "7 call 1048576 16"):
        seed2, params2, kw2, _ = k2_setup(dev, case)
        n = int(case.split()[2])
        if n == 1 << 22 and sha256(tmc.terminal_qmc(
                seed2, params2, **kw2)) != K2_SUMS[case]:
            raise AssertionError(f"qmc {case}: rows differ from the recorded "
                                 "ones (K2_SUMS)")
        times[("k2", n)] = cuda_ms(
            lambda: tmc.terminal_qmc(seed2, params2, **kw2))
        times[("k2 device", n)] = cuda_ms(
            lambda: tmc.terminal_qmc(seed2, params2, **kw2), queued=True)
        plain_kw = {a: v for a, v in kw2.items() if a != "device"}
        seed2, params2 = seed2.to(dev), params2.to(dev)
        times[("k2plain", n)] = cuda_ms(
            lambda: tmc._mc_qmc_plain(seed2, params2, **plain_kw))
        k2_threads[n] = tmc._qmc_threads(dev.index, kw2["n_programs"],
                                         kw2["reps"])
        k2_waves[n] = kw2["n_programs"] / tmc._qmc_clusters(
            dev.index, k2_threads[n], kw2["reps"])
    print(f"phase 6 time K2 2^22 x 16 {times[('k2', 1 << 22)]:.4f} ms (the "
          f"device's time alone {times[('k2 device', 1 << 22)]:.4f} ms), "
          f"2^20 x 16 {times[('k2', 1 << 20)]:.4f} ms (device "
          f"{times[('k2 device', 1 << 20)]:.4f} ms); blocks of "
          f"{k2_threads[1 << 22]} and {k2_threads[1 << 20]} threads "
          f"[{card}]")
    seed4, params4, run4 = main_k4[:3]
    times[("k4", "1M x 252")] = cuda_ms(
        lambda: pmc.path_mc(seed4, params4, **run4))
    times[("k4plain", "1M x 252")] = cuda_ms(
        lambda: pmc._path_mc_plain(seed4, params4, **run4))
    run4g = dict(run4, with_greeks=True)
    times[("k4greeks", "1M x 252")] = cuda_ms(
        lambda: pmc.path_mc(seed4, params4, **run4g))
    sv_calls = k4_timed_calls(dev, multi)
    sv_labels = [f"{d} vanilla" for d in SV_TIMED]
    for label in sv_labels:
        seed_sv, params_sv, run_sv = sv_calls[label]
        times[("k4", label)] = cuda_ms(
            lambda: pmc.path_mc(seed_sv, params_sv, **run_sv))
    print(f"phase 6 time K4 gbm asian + geometric CV 1M x 252: "
          f"{times[('k4', '1M x 252')]:.4f} ms, with Greek moments "
          f"{times[('k4greeks', '1M x 252')]:.4f} ms; "
          + "; ".join(f"{label} 1M x 64 {times[('k4', label)]:.4f} ms"
                      for label in sv_labels) + f" [{card}]")
    k5_bounds = {}
    for n, d in ((65_536, 64), (1 << 20, 252)):
        tensors, kw5, (R5, _) = k5_setup(qmp, dev, "asian", n, d)
        shape = f"{n} x 8 x {d}"
        if d > 64 and sha256(qmp.qmc_path(*tensors, **kw5)) != \
                QMC_PATH_SUMS[K5_CASES[-1]]:
            raise AssertionError(f"qmc_path asian {shape}: sums differ from "
                                 "the recorded ones (QMC_PATH_SUMS)")
        times[("k5", shape)] = cuda_ms(lambda: qmp.qmc_path(*tensors, **kw5),
                                       reps=3 if d > 64 else 5)
        times[("k5 device", shape)] = cuda_ms(
            lambda: qmp.qmc_path(*tensors, **kw5), reps=3 if d > 64 else 5,
            queued=True)
        times[("k5plain", shape)] = cuda_ms(
            lambda: qmp._qmc_path_plain(*tensors, **kw5),
            reps=3 if d > 64 else 5)
        # the kernel reads every input but B, which it reads by its plan
        in_bytes = sum(t.numel() * t.element_size()
                       for i, t in enumerate(tensors) if i != 4)
        k5_bounds[shape] = bound(n * R5 * ops_k5_point(d),
                                 in_bytes + kw5["n_programs"] * 6 * 4)
    print(f"phase 6 time K1 2^30 {times[('k1', 1 << 30)]:.4f} ms, 1M "
          f"{times[('k1', 1_000_000)]:.4f} ms; K5 asian "
          + "; ".join(f"{shape} {times[('k5', shape)]:.4f} ms (the device's "
                      f"time alone {times[('k5 device', shape)]:.4f} ms)"
                      for shape in k5_bounds) + f" [{card}]")
    clock = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True, timeout=60).stdout.split()[0]
    text = sass_text(_build.library_path())
    k1k5 = {"sms": torch.cuda.get_device_properties(dev).multi_processor_count,
            "sm_clock_max_mhz": float(clock), "sass k1": sass_k1(text),
            "sass k5": sass_k5(text)}
    resources = res_usage(_build.library_path(), K1_K5_NAMES)
    for name, line in resources.items():
        print(f"phase 6 resources {name}: {line}")
    for line in k1_k5_sass_lines("phase 6", k1k5):
        print(line)
    for line in k2_issue_lines("phase 6", sass_k2(text), k1k5,
                               {str(n): t for n, t in k2_threads.items()}):
        print(line)
    pde.phase6(times)
    desk.phase6(times)
    multi.phase6()
    closed.phase6()
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
         "bound_ms_2p30": bound((1 << 30) * OPS_K1_DRAW, 36)[0],
         "ms_1M": times[("k1", 1_000_000)],
         "plain_ms_1M": times[("k1plain", 1_000_000)],
         "bound_ms_1M": bound(1_000_000 * OPS_K1_DRAW, 36)[0],
         "blocks_per_sm": occupancy["K1 anti box-muller 2^30"][0],
         "waves_2p30": occupancy["K1 anti box-muller 2^30"][2],
         "resources": {k: v for k, v in resources.items()
                       if "terminal_mc" in k}},
        {"name": "terminal_qmc_kernel", "route": "cuda",
         "source": "optpricer_tpu_torch/csrc/terminal_mc.cu",
         "replaces": "optpricer_tpu/ops/pallas_mc.py:214",
         "launches": launches["terminal_qmc_kernel"],
         "max_abs_err": worst["qmc"][1],
         "ms": times[("k2", 1 << 22)], "plain_ms": times[("k2plain", 1 << 22)],
         **dict(zip(("bound_ms", "bound_by"),
                    bound((1 << 22) * OPS_K2_POINT, 36 + 64 * 13 * 4))),
         "library_ms": None, "shape": "2^22 points x 16 replicates",
         "device_ms": times[("k2 device", 1 << 22)],
         "ms_2p20": times[("k2", 1 << 20)],
         "device_ms_2p20": times[("k2 device", 1 << 20)],
         "plain_ms_2p20": times[("k2plain", 1 << 20)],
         "bound_ms_2p20": bound((1 << 20) * OPS_K2_POINT,
                                36 + 32 * 13 * 4)[0],
         "threads_per_block": k2_threads[1 << 22],
         "threads_per_block_2p20": k2_threads[1 << 20],
         "waves": k2_waves[1 << 22], "waves_2p20": k2_waves[1 << 20],
         "resources": {k: v for k, v in resources.items()
                       if "qmc_kernel" in k}},
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
             True, True), 188)[0],
         **{f"ms_{d}_1Mx64": times[("k4", f"{d} vanilla")]
            for d in SV_TIMED}},
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
         "bound_ms_2p20x252": k5_bounds["1048576 x 8 x 252"][0],
         "device_ms": times[("k5 device", "65536 x 8 x 64")],
         "device_ms_2p20x252": times[("k5 device", "1048576 x 8 x 252")],
         "blocks_per_sm": occupancy["K5 asian 65536 x 8 x 64"][0],
         "blocks_per_sm_2p20x252": occupancy["K5 asian 1048576 x 8 x 252"][0],
         "resources": {k: v for k, v in resources.items()
                       if "qmc_path" in k}},
    ] + pde.kernel_entries(launches, worst, times) \
        + desk.kernel_entries(launches, worst, times) \
        + multi.kernel_entries(launches, worst)
    for entry in kernels:   # K1 and K7 on the closed-form path
        if entry["name"] in closed_launches:
            entry["launches_closed_form"] = closed_launches[entry["name"]]
    print(f"chip_smoke.py {time.perf_counter() - t_start:.1f} s; card: {card}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))


# -- --ab: this tree's K4, K7 and PDE numbers against another tree's -------
AB_TURNS = ("other", "this", "this", "other") * 2
K7_NAMES = re.compile(r"\b(?:tridiag_\w+_kernel|thomas_kernel)\b")
# a path_mc_kernel instantiation's mangled template arguments: dynamics,
# payoff, Greeks, antithetic and, from this tree on, the LSV coefficients
K4_KERNEL = re.compile(
    r"path_mc_kernelILi(\d+)ELi(\d)ELb([01])ELb([01])E(?:Li(\d+)E)?E")
LV_MILSTEIN = 6
# an fd_lv kernel instantiation's mangled bool template arguments
K8_KERNEL = re.compile(r"(fd_lv_[a-z]+_kernel)I((?:Lb[01]E)+)E")
# a basket_mc_kernel instantiation's: payoff, antithetic, asset count (the
# bucket's largest in a tree that buckets the counts)
K6_KERNEL = re.compile(r"basket_mc_kernelILi(\d)ELb([01])ELi(\d+)EE")
K6_PAYOFFS = ("asian_basket", "worstof_barrier", "basket_barrier")
# a mc_batch_kernel instantiation's: antithetic
K3_KERNEL = re.compile(r"mc_batch_kernelILb([01])EE")


def k3_k6_label(name: str) -> str | None:
    """The ``--ab`` name of a K3 or K6 kernel instantiation's mangled
    ``name``, or None."""
    m = K6_KERNEL.search(name)
    if m:
        return (f"basket_mc_kernel<{K6_PAYOFFS[int(m[1])]}, anti={m[2]}, "
                f"{m[3]} assets>")
    m = K3_KERNEL.search(name)
    return m and f"mc_batch_kernel<anti={m[1]}>"


def k4_label(m: re.Match) -> str | None:
    """The name of a ``K4_KERNEL`` match that ``--ab`` reports: K4's
    LV_MILSTEIN instantiations, and the ``K4_TIMED`` ones (antithetic; LSV
    at the reference's 13 coefficients)."""
    from optpricer_tpu_torch.ops import path_mc as pmc

    dyn, payoff, greeks, anti, nc = (int(m[1]), int(m[2]), m[3] == "1",
                                     m[4] == "1", m[5])
    if dyn == LV_MILSTEIN:
        return (f"path_mc_kernel<LV_MILSTEIN, payoff {payoff}, "
                f"anti={int(anti)}>")
    if not anti or nc not in (None, "0", str(pmc.MAX_COEFFS)):
        return None
    if nc == "0" and dyn in (pmc.DYNAMICS["lsv"], pmc.DYNAMICS["lsv_qe"]):
        return None
    for label, (dynamics, pay, g, _, _) in K4_TIMED.items():
        if (pmc.DYNAMICS[dynamics], pmc.PAYOFF_IDS[pay], g) == \
                (dyn, payoff, greeks):
            return f"path_mc_kernel {label}"
    return None


def ptxas_k4_k7(report: str) -> dict:
    """{kernel: 'N registers, S bytes spill stores, L bytes spill loads'}
    from a verbose build's report, for K4's LV_MILSTEIN and ``K4_TIMED``
    instantiations, K7's and K8's kernels and every instantiation of K3 and
    K6."""
    lines = report.splitlines()
    found = {}
    for i, line in enumerate(lines[:-2]):
        m = re.search(r"Function properties for (\S+)", line)
        k4 = m and K4_KERNEL.search(m.group(1))
        k7 = m and re.search(r"(tridiag_\w+?_kernel|thomas_kernel)I([fd])",
                             m.group(1))
        k8 = m and K8_KERNEL.search(m.group(1))
        key = k4_label(k4) if k4 else (
            f"{k7.group(1)}<{dict(f='float', d='double')[k7.group(2)]}>"
            if k7 else None)
        if k8:
            flags = re.findall(r"Lb([01])E", k8.group(2))
            key = f"{k8.group(1)}<{', '.join(flags)}>"
        if m and key is None:
            key = k3_k6_label(m.group(1))
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", lines[i + 1])
        regs = re.search(r"Used (\d+) registers", lines[i + 2])
        if not (key and spill and regs):
            continue
        found[key] = (f"{regs.group(1)} registers, {spill.group(1)} bytes "
                      f"spill stores, {spill.group(2)} bytes spill loads")
    return found


# SASS opcode classes (the opcode before its first '.'; U-prefixed uniform
# integer ops count as integer)
SASS_FP32 = {"FADD", "FMUL", "FFMA", "FSETP", "FSET", "FMNMX", "FSEL",
             "FCHK", "FRND", "FSWZADD"}
SASS_INT = {"IADD3", "IADD", "IMAD", "IMUL", "ISETP", "IABS", "IMNMX",
            "LOP3", "LOP", "SHF", "SHL", "SHR", "LEA", "PRMT", "SEL", "POPC",
            "FLO", "BREV", "BMSK", "IDP", "SGXT"}
SASS_CONV = {"I2F", "F2I", "F2F", "I2I", "I2FP", "F2IP", "F2FP"}


def sass_class(opcode: str) -> str:
    base = opcode.split(".")[0]
    if base == "MUFU":
        return "mufu"
    if base in SASS_FP32:
        return "fp32"
    if base in SASS_CONV:
        return "conversion"
    if base.startswith(("LD", "ST", "ULDC", "ATOM", "RED")):
        return "memory"
    if base in SASS_INT or (base[:1] == "U" and base[1:] in SASS_INT):
        return "int"
    return "other"


def sass_text(lib: Path) -> str:
    """``cuobjdump -sass`` of the library ``lib``."""
    from optpricer_tpu_torch import _build

    cuobjdump = Path(_build.find_nvcc()).parent / "cuobjdump"
    return subprocess.run([str(cuobjdump), "-sass", str(lib)],
                          capture_output=True, text=True, check=True,
                          timeout=900).stdout


def k4_sass_label(name: str) -> str | None:
    m = K4_KERNEL.search(name)
    label = m and k4_label(m)
    return None if not label or "LV_MILSTEIN" in label else label


def k3_k6_sass_label(name: str) -> str | None:
    """The K3 and K6 instantiations of the main path: K3 antithetic, K6 at
    ``K6_SHAPES``' asset counts and payoffs, antithetic."""
    label = k3_k6_label(name)
    main = {f"basket_mc_kernel<{payoff}, anti=1, {a} assets>"
            for _, (a, payoff, *_), _ in K6_SHAPES}
    return label if label in main | {"mc_batch_kernel<anti=1>"} else None


def sass_step_loops(text: str, labeller=k4_sass_label,
                    innermost: bool = False) -> dict:
    """label -> instruction counts (``sass_counts``) of the loop of each
    kernel that ``labeller`` names in ``text`` (``sass_text``): the static
    instructions from the target of the smallest backward branch whose
    span holds a MUFU instruction (the Box-Muller square root, log32's
    division) to that branch, with the backward branches inside it
    (``inner_loops``) and its CALLs (the division and sin/cos slow paths).
    ``innermost``: a list of every such loop that holds no other, in
    address order (K3's full and tail rep loops), not the smallest."""
    out = {}
    for name, ops, loops in sass_functions(text):
        label = labeller(name)
        if not label:
            continue
        with_mufu = [(j, i) for j, i in loops
                     if any(o.startswith("MUFU") for o in ops[j:i + 1])]
        if not with_mufu:
            out[label] = None
            continue

        def counted(j, i):
            return dict(sass_counts(ops[j:i + 1]), inner_loops=sum(
                j < jj and ii < i for jj, ii in loops))

        if innermost:
            out[label] = [counted(j, i) for j, i in sorted(with_mufu)
                          if not any(j <= jj and ii <= i and (jj, ii) != (j, i)
                                     for jj, ii in with_mufu)]
        else:
            out[label] = counted(*min(with_mufu, key=lambda ji: ji[1] - ji[0]))
    return out


def sass_functions(text: str):
    """(mangled name, opcodes, loops) of each function in ``text``
    (``sass_text``): its instructions' opcodes (predicates dropped) in
    address order and its loops, the (target, branch) index pairs of its
    backward branches."""
    for chunk in re.split(r"\n\s*Function : ", text)[1:]:
        insts, labels = [], {}
        for line in chunk.splitlines():
            lab = re.match(r"\s*(\.L_x_\d+):", line)
            if lab:
                labels[lab.group(1)] = len(insts)
                continue
            ins = re.search(r"/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;", line)
            if ins:
                insts.append((int(ins.group(1), 16), ins.group(2)))
        index = {addr: i for i, (addr, _) in enumerate(insts)}
        loops = []
        for i, (_, txt) in enumerate(insts):
            br = re.search(r"\bBRA\S*\s+`?\(?(0x[0-9a-f]+|\.L_x_\d+)", txt)
            if not br:
                continue
            tgt = br.group(1)
            j = labels.get(tgt) if tgt.startswith(".L") \
                else index.get(int(tgt, 16))
            if j is not None and j < i:
                loops.append((j, i))
        ops = [re.sub(r"^@!?U?P\w+\s+", "", t).split()[0] for _, t in insts]
        yield chunk.split(None, 1)[0], ops, loops


# SASS opcodes that issue to the ALU pipe, at half the FP32 rate on Hopper:
# the integer ops but IMAD / IMUL (the FMA pipe), and the float compares,
# selects and min / max
SASS_ALU = {"IADD3", "IADD", "ISETP", "IABS", "IMNMX", "LOP3", "LOP", "SHF",
            "SHL", "SHR", "LEA", "PRMT", "SEL", "POPC", "FLO", "BREV", "BMSK",
            "SGXT", "FSETP", "FSET", "FSEL", "FMNMX", "PLOP3", "P2R", "R2P"}


def sass_counts(ops) -> dict:
    """Instruction counts of ``ops`` by class (``sass_class``), with the
    ALU-pipe ops (``SASS_ALU``), MUFU.RCP (one a log32 division), FRND
    (one an exp32), FMUL, LDS, LDG and STS among them."""
    counts = {c: 0 for c in ("int", "fp32", "mufu", "conversion", "memory",
                             "other")}
    for o in ops:
        counts[sass_class(o)] += 1
    base = [o.split(".")[0] for o in ops]
    counts.update(total=len(ops), alu=sum(b in SASS_ALU for b in base),
                  rcp=sum(o.startswith("MUFU.RCP") for o in ops),
                  frnd=base.count("FRND"), fmul=base.count("FMUL"),
                  lds=base.count("LDS"), ldg=base.count("LDG"),
                  sts=base.count("STS"), calls=base.count("CALL"))
    return counts


def sass_k1(text: str) -> dict:
    """label -> counts (``sass_counts``) of each rep loop of K1's antithetic
    Box-Muller instantiation (the full and the tail body's, in address
    order; one in a tree without the split): the innermost loops that hold
    a MUFU.RCP, log32's division, one a rep."""
    out = {}
    for name, ops, loops in sass_functions(text):
        m = K1_KERNEL.search(name)
        if not m or (m[1], m[2]) != ("1", "0"):
            continue
        rcp = [(j, i) for j, i in loops
               if any(o.startswith("MUFU.RCP") for o in ops[j:i + 1])]
        inner = [(j, i) for j, i in sorted(rcp)
                 if not any(j <= jj and ii <= i and (jj, ii) != (j, i)
                            for jj, ii in rcp)]
        out["terminal_mc_kernel<anti=1, box-muller>"] = [
            sass_counts(ops[j:i + 1]) for j, i in inner]
    return out


def sass_k2(text: str) -> dict:
    """K2's instantiation for two reps or fewer (the main path's; the only
    one in a tree without the Kahan split): ``loops``, the counts
    (``sass_counts``) of the innermost loops that hold a MUFU.RCP (one a
    point: norminv32's log32 division), each with its ``points``, in
    address order (one rep loop in a tree with a block per 256 elements;
    the full and the tail row loop in one with a cluster a program), and
    ``rest``, the counts of the instructions outside every loop."""
    for name, ops, loops in sass_functions(text):
        if "terminal_qmc_kernel" not in name or "ILb1E" in name:
            continue
        rcp = [(j, i) for j, i in loops
               if any(o.startswith("MUFU.RCP") for o in ops[j:i + 1])]
        inner = [(j, i) for j, i in sorted(set(rcp))
                 if not any(j <= jj and ii <= i and (jj, ii) != (j, i)
                            for jj, ii in rcp)]
        looped = {t for j, i in set(loops) for t in range(j, i + 1)}
        return {"loops": [dict(sass_counts(ops[j:i + 1]),
                               points=sum(o.startswith("MUFU.RCP")
                                          for o in ops[j:i + 1]))
                          for j, i in inner],
                "rest": sass_counts([o for t, o in enumerate(ops)
                                     if t not in looped])}
    return {}


def k2_issue_lines(side: str, sass: dict, turn: dict, threads: dict) -> list:
    """The lines that report K2's SASS (``sass_k2``): its static
    instructions a point in the first RCP loop (the full body), and the
    time they give at one instruction a lane and cycle at 2^22 x 16 and
    2^20 x 16 if each thread issued that loop once an iteration and the
    instructions outside the loops once. ``threads``: points -> a block's
    threads (none for a tree that launches a block a 256-element row)."""
    from optpricer_tpu_torch.ops import terminal_mc as tmc

    if not sass.get("loops"):
        return []
    loop, rest = sass["loops"][0], sass["rest"]["total"]
    rate = turn["sms"] * 128 * turn["sm_clock_max_mhz"] * 1e6
    lines = [f"sass {side} terminal_qmc_kernel: loop {i + 1} of "
             f"{len(sass['loops'])} " + ", ".join(
                 f"{k} {v}" for k, v in lp.items())
             for i, lp in enumerate(sass["loops"])]
    lines.append(f"sass {side} terminal_qmc_kernel: outside the loops "
                 + ", ".join(f"{k} {v}" for k, v in sass["rest"].items()))
    for n in (1 << 22, 1 << 20):
        _, reps, ppr = tmc._plan_qmc(n, 16)
        n_prog = 16 * ppr
        block = threads.get(str(n))
        if block is None:   # a block a 256-element row, a loop trip a rep
            n_threads, trips = n_prog * 128 * 256, reps
        else:               # a cluster a program, a loop trip a row
            n_threads = n_prog * 8 * block
            trips = 16 // (block // 64)
        issued = loop["total"] * trips + rest
        lines.append(
            f"sass {side} terminal_qmc_kernel at {n} x 16: "
            f"{loop['total'] / loop['points']:.1f} static instructions a "
            f"point in the full loop; {issued} a thread, "
            f"{issued * n_threads / rate * 1e3:.4f} ms at one a lane and "
            f"cycle (4 schedulers an SM)")
    return lines


def sass_k5(text: str) -> list:
    """The loops of K5's Asian instantiation, each a dict: ``kind``, its
    own instructions' counts (``sass_counts``, nested loops left out),
    ``depth`` and ``parent`` (the enclosing loop's index). Kinds, by what a
    loop's own instructions hold: "normals" (a MUFU.RCP: norminv32's
    log32 division, one a step), "sobol bits" (a loop inside it, or inside
    "common", with LDG: the direction numbers of the ladder), "common"
    (STS and no MUFU outside the bridge: the block-common words),
    "bridge group" (FRND: an exp32 a column), "bridge terms" (FMUL: the
    product, "sparse" with an LDS a term, "dense" otherwise), "bridge
    staging" (STS inside the group: the B slab) or "other"."""
    for name, ops, loops in sass_functions(text):
        m = K5_KERNEL.search(name)
        if not m or m[1] != "2":
            continue
        loops = sorted(set(loops))
        parent = [max((p for p, (jj, ii) in enumerate(loops)
                       if jj <= j and i <= ii and (jj, ii) != (j, i)),
                      key=lambda p: loops[p][0], default=None)
                  for j, i in loops]
        out = []
        for q, (j, i) in enumerate(loops):
            inner = [loops[c] for c, p in enumerate(parent) if p == q]
            own = [o for t, o in enumerate(ops[j:i + 1], j)
                   if not any(jj <= t <= ii for jj, ii in inner)]
            c = sass_counts(own)
            depth, p = 0, parent[q]
            while p is not None:
                depth, p = depth + 1, parent[p]
            out.append(dict(counts=c, depth=depth, parent=parent[q]))
        for loop in out:
            c = loop["counts"]
            up = out[loop["parent"]]["kind"] if loop["parent"] is not None \
                else None
            if c["rcp"]:
                kind = "normals"
            elif c["frnd"]:
                kind = "bridge group"
            elif c["fmul"] >= 8:
                kind = "bridge terms " + ("sparse" if c["lds"] >= c["fmul"]
                                          else "dense")
            elif c["sts"] and up == "bridge group":
                kind = "bridge staging"
            elif c["sts"]:
                kind = "common"
            elif c["ldg"] and up in ("normals", "common"):
                kind = "sobol bits"
            else:
                kind = "other"
            loop["kind"] = kind
        # parents are listed before their children (sorted by start)
        for loop in out:
            if loop["parent"] is not None and loop["kind"] == "other":
                loop["kind"] = "inside " + out[loop["parent"]]["kind"]
        return out
    return []


def k5_issue(loops: list, n_steps: int, m_bits: int, width) -> dict:
    """Instructions a point of K5's Asian issues in each kind of loop
    (``sass_k5``) at ``n_steps``: each loop's own instructions times its
    iterations a point, from what one iteration does: steps (a MUFU.RCP
    each), one group of 8 columns, table entries (8 FMUL each), bits of
    the ladder (an LDG each), B slab rows (an LDG each) or common words (an
    STS each). ``width``: the sparse bridge's entries a column (None for
    the dense product). Loops of one kind at one depth (a loop the
    compiler versioned) share its iterations evenly."""
    groups = -(-n_steps // 8)
    sparse = any(lp["kind"] == "bridge terms sparse" for lp in loops)
    kinds = [(lp["kind"], lp["depth"]) for lp in loops]
    per_point = {}
    for lp in loops:
        c, kind = lp["counts"], lp["kind"]
        if kind == "normals":
            trips = n_steps / c["rcp"]
        elif kind == "bridge group":
            trips = groups
        elif kind == "bridge terms sparse":
            trips = groups * width / (c["fmul"] / 8)
        elif kind == "bridge terms dense":
            trips = 0.0 if sparse else groups * n_steps / (c["fmul"] / 8)
        elif kind == "bridge staging":
            trips = groups * (2 * n_steps / 64) / max(1, c["ldg"])
        elif kind == "common":
            trips = (n_steps / 64) / max(1, c["sts"])
        elif kind == "sobol bits":
            up = loops[lp["parent"]]["kind"]
            bits = m_bits - 6 if up == "common" else m_bits
            steps = n_steps / 64 if up == "common" else n_steps
            trips = steps * bits / max(1, c["ldg"])
        else:
            trips = 0.0
        trips /= kinds.count((kind, lp["depth"]))
        key = "sobol" if kind in ("normals", "common", "sobol bits") \
            else "bridge" if kind.startswith("bridge") else "other"
        for field in ("total", "alu"):
            per_point[f"{key} {field}"] = per_point.get(
                f"{key} {field}", 0.0) + c[field] * trips
    return per_point


def res_usage(lib: Path, pattern: re.Pattern) -> dict:
    """mangled name -> 'REG:.. STACK:.. SHARED:.. LOCAL:..' of each kernel
    of the library that ``pattern`` matches (``cuobjdump -res-usage``):
    registers, and local memory (spills) in bytes a thread."""
    from optpricer_tpu_torch import _build

    cuobjdump = Path(_build.find_nvcc()).parent / "cuobjdump"
    text = subprocess.run([str(cuobjdump), "-res-usage", str(lib)],
                          capture_output=True, text=True, check=True,
                          timeout=900).stdout
    out, name = {}, None
    for line in text.splitlines():
        m = re.search(r"Function (\S+):", line)
        if m:
            name = m.group(1)
            continue
        if name and "REG:" in line and pattern.search(name):
            out[name] = " ".join(line.split())
            name = None
    return out


K1_K5_NAMES = re.compile(r"terminal_mc_kernelILb1ELb0E|qmc_path_kernelILi2E"
                         r"|terminal_qmc_kernel")


def host_us(fn, reps: int = 200) -> float:
    """Host microseconds per call of ``fn``, ``reps`` calls enqueued with
    no synchronize in between."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    us = (time.perf_counter() - t0) / reps * 1e6
    torch.cuda.synchronize()
    return us


AB_GROUPS = ("k1k5", "k4", "k3k6", "pde")


def ab_turn(tree: Path, groups=AB_GROUPS) -> dict:
    """One turn of ``--ab``: the numbers of the package in ``tree`` (its
    kernels built from its own sources), timed by this script's rules, for
    the kernel groups ``groups`` (``AB_GROUPS``: K1 and K5, K4, K3 and K6,
    the PDE kernels K7 and K8)."""
    sys.path.insert(0, str(tree))
    import optpricer_tpu_torch as tp
    from optpricer_tpu_torch import _build
    from optpricer_tpu_torch.ops import path_mc as pmc

    if not Path(tp.__file__).resolve().is_relative_to(tree):
        raise SystemExit(f"chip_smoke --ab: imported {tp.__file__}, not the "
                         f"package in {tree}")
    dev, card = torch.device("cuda", 0), card_line()
    report = io.StringIO()
    with redirect_stdout(report):
        _build.build(verbose=True)
    _build.load()
    clock = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True, timeout=60).stdout.split()[0]
    out = {"card": card, "sm_clock_max_mhz": float(clock),
           "sms": torch.cuda.get_device_properties(dev).multi_processor_count,
           "ptxas": ptxas_k4_k7(report.getvalue()),
           # a tree from before the per-path grid has no occupancy query
           "k4 occupancy": k4_waves(dev) if hasattr(pmc, "blocks_per_sm")
           and "k4" in groups else {}}
    if report.getvalue():  # this turn built the library
        text = sass_text(_build.library_path())
        if "k4" in groups:
            out["sass"] = sass_step_loops(text)
        if "k3k6" in groups:
            out["sass k3 k6"] = sass_step_loops(text, k3_k6_sass_label, True)
        if "k1k5" in groups:
            out["sass k1"], out["sass k5"] = sass_k1(text), sass_k5(text)
            out["sass k2"] = sass_k2(text)
    multi = MultiAssetLsvSlice(dev, card)
    desk = Config5Slice(dev, card)
    if "k1k5" in groups:
        out.update(ab_k1_k5(dev))
    if "k3k6" in groups:
        out.update(ab_k3_k6(dev, multi, desk))
    if "k4" in groups:
        out.update(ab_k4(dev, multi, desk))
    if "pde" in groups:
        out.update(ab_pde(dev, card))
    return out


def ab_k4(dev, multi, desk) -> dict:
    """``ab_turn``'s K4 numbers: ``K4_TIMED``'s times and sums, the walls
    of config 3's exotic_price_mc and of lsv_price_mc, and the desk's
    lv_milstein and lv_euler calls."""
    import optpricer_tpu_torch as tp
    from optpricer_tpu_torch.ops import path_mc as pmc

    out = {}
    out["k4 sums timed"], out["k4 sums 2^18"] = {}, {}
    for label, (seed, params, run) in k4_timed_calls(dev, multi).items():
        out["k4 sums timed"][label] = [
            float(v) for v in pmc.path_mc(seed, params, **run).cpu()]
        out[f"k4 {label} ms"] = cuda_ms(
            lambda: pmc.path_mc(seed, params, **run))
    # the user's calls around K4 gbm and K4 lsv: host clock, median of 21
    walls = {"exotic_price_mc asian 1M x 252 geo CV (config 3)": lambda:
             tp.exotic_price_mc("asian", 100.0, 100.0, 1.0, 0.03, sigma=0.2,
                                n_steps=252, n_paths=1_000_000, seed=7,
                                control_variate=True, device=dev)}
    for scheme in ("euler", "qe"):
        walls[f"lsv_price_mc {scheme} up-and-out 130 2^20 x 96"] = \
            lambda model=multi.models[scheme]: tp.lsv_price_mc(
                "barrier", model, 100.0, **multi.LSV_PRICE, device=dev,
                barrier=130.0)
    for what, fn in walls.items():
        fn()
        out[f"wall {what} ms"] = statistics.median(
            timed(fn)[1] * 1e3 for _ in range(21))
    for label, (seed, params, run) in k4_timed_calls(dev, multi,
                                                     n=1 << 18).items():
        if run["reps"] != 1:
            raise AssertionError(f"{label} at 2^18 paths: {run['reps']} reps")
        out["k4 sums 2^18"][label] = [
            float(v).hex() for v in pmc.path_mc(seed, params, **run).cpu()]

    for scheme in ("milstein", "log_euler"):
        seed, params, run = desk.desk_k4(desk_svi(), scheme)
        sums = pmc.path_mc(seed, params, **run).cpu()
        out[f"k4 {scheme} sums"] = [float(v).hex() for v in sums]
        out[f"k4 {scheme} ms"] = cuda_ms(
            lambda: pmc.path_mc(seed, params, **run))
    return out


def ab_pde(dev, card) -> dict:
    """``ab_turn``'s K7 and K8 numbers and the PDE walls."""
    import optpricer_tpu_torch as tp
    from optpricer_tpu_torch.ops import fd_lv as flv
    from optpricer_tpu_torch.ops import thomas as tth

    out = {}
    pde = PdeSlice(dev, card)
    # K8 on the ladder: both forms, European calls and American puts, the
    # layer's bytes hashed for the bit-for-bit comparison across turns
    out["k8 layers"] = {}
    for method in ("pcr", "thomas"):
        for kind, am, tag in (("call", False, "call"),
                              ("put", True, "american put")):
            ops, tab, kw, _ = pde.k8_setup(kind, am, method)
            layer = flv.fd_lv(*ops, tab, **kw).cpu().numpy()
            out["k8 layers"][f"{method} {tag}"] = hashlib.sha256(
                layer.tobytes()).hexdigest()
            out[f"k8 {method} {tag} ms"] = cuda_ms(
                lambda: flv.fd_lv(*ops, tab, **kw))
    for solver in ("fused", "fused_thomas"):
        fn = lambda: pde.ladder(solver)
        fn()
        out[f"wall ladder {solver} {pde.N_STRIKES} x {pde.N_S} x "
            f"{pde.N_T} ms"] = statistics.median(
                timed(fn)[1] * 1e3 for _ in range(21))

    n, batch = pde.K7_SHAPE
    f64, f32 = torch.float64, torch.float32
    calls = {}
    for m, b, dtype, tag in ((n, batch, f64, "f64"), (n, batch, f32, "f32"),
                             (n, 1, f64, "f64"), (n, 1, f32, "f32"),
                             (199, 1, f64, "f64")):
        ops = pde.k7_system(m, b, dtype, seed=1)
        calls[f"{m} x {b} {tag}"] = \
            lambda ops=ops: tth.tridiag_solve_kernel(*ops)
    shared = pde.k7_system(n, n, f64, shared=True, seed=1)
    calls[f"{n} x {n} f64 shared columns"] = \
        lambda: tth.tridiag_solve_kernel(*shared)
    a, b, c, d = pde.k7_system(n, batch, f64, shared=True, seed=1)
    rows, rhs = [t[:, 0] for t in (a, b, c)], d.t().contiguous()
    calls[f"ladder call {batch} x {n} f64 (last axis)"] = \
        lambda: tth.tridiag_solve_kernel_lastdim(*rows, rhs)
    cols = pde.k7_system(n, n, f64, seed=2)[3]
    calls[f"propagator build {n} x {n} f64 (last axis, rhs transposed)"] = \
        lambda: tth.tridiag_solve_kernel_lastdim(*rows, cols.T)
    for what, fn in calls.items():
        out[f"k7 {what}"] = dict(ms=cuda_ms(fn, reps=21),
                                 device_ms=cuda_ms(fn, reps=21, queued=True),
                                 host_us=host_us(fn))

    spec4 = tp.OptionSpec(S0=100.0, K=100.0, T=1.0, r=0.05, sigma=0.2)
    g4 = pde.GRID4
    marches = {
        f"ladder auto f64 {pde.N_STRIKES} x {pde.N_S} x {pde.N_T}": (
            lambda: pde.ladder("auto"), 5),
        "fd_price American put PSOR 512 x 256": (lambda: tp.fd_price(
            spec4, "put", american=True, american_method="psor", **g4,
            device=dev), 3),
        "fd_price European call 512 x 256": (lambda: tp.fd_price(
            spec4, "call", **g4, device=dev), 5),
        "fd_price_local_vol 200 x 200": (lambda: tp.fd_price_local_vol(
            100.0, 100.0, 1.0, 0.05, 0.0,
            lambda S, t: 0.2 * torch.ones_like(S), "call", N_S=200, N_t=200,
            ref_vol=0.2, device=dev), 5),
    }
    for what, (fn, reps) in marches.items():
        fn()
        wall = statistics.median(timed(fn)[1] * 1e3 for _ in range(reps))
        _, busy, n_k, k7 = device_busy(fn, K7_NAMES)
        out[f"pde {what}"] = dict(wall_ms=wall, busy_ms=busy, k7_ms=k7,
                                  kernels=n_k)
    return out


def ab_k1_k5(dev) -> dict:
    """``ab_turn``'s K1 and K5 numbers: K1 (antithetic Box-Muller) at 2^30
    and 1 000 000 draws and K5 (the geometric Asian) at 65 536 x 8 x 64 and
    2^20 x 8 x 252, each ``ms`` (median of 5; of 3 at 252 steps) and
    ``device ms`` (the start event behind a queued device sleep: the
    device's time alone); their sums by SHA-256 (K1's 13 also as hex;
    K5's at every ``K5_CASES`` case); the walls (median of 21) of
    euro_price_mc at 2^30 and of exotic_price_mc(backend="qmc") at 65 536
    x 8 x 64, and the host time of K5's ``_kernel_inputs`` there; the
    resident blocks per SM (none for a tree without the occupancy queries)
    and each kernel's registers and local memory (``cuobjdump
    -res-usage``)."""
    import optpricer_tpu_torch as tp
    from optpricer_tpu_torch import _build
    from optpricer_tpu_torch.ops import qmc_path as qmp
    from optpricer_tpu_torch.ops import terminal_mc as tmc

    out = {"k1 sums": {}, "k1 sums hex": {}, "k5 sums": {}}
    for n, label in ((1 << 30, "2^30"), (1_000_000, "1M")):
        reps, n_prog = tmc._plan_grid(n, 2 * tmc.TILE)
        params = tmc._terminal_params(n, *MARKET, True).to(dev)
        seed = tmc._seed_pair(7, dev)
        kw = dict(n_programs=n_prog, reps=reps, antithetic=True)
        sums = tmc.terminal_mc(seed, params, **kw)
        out["k1 sums"][label] = sha256(sums)
        out["k1 sums hex"][label] = [float(v).hex() for v in sums.cpu()]
        out[f"k1 {label} ms"] = cuda_ms(
            lambda: tmc.terminal_mc(seed, params, **kw))
        out[f"k1 {label} device ms"] = cuda_ms(
            lambda: tmc.terminal_mc(seed, params, **kw), queued=True)
    for key in K5_CASES:
        payoff, n, d = key.split()
        tensors, kw, _ = k5_setup(qmp, dev, payoff, int(n), int(d))
        out["k5 sums"][key] = sha256(qmp.qmc_path(*tensors, **kw))
        if payoff == "asian" and (n, d) in (("65536", "64"),
                                            ("1048576", "252")):
            reps = 3 if d == "252" else 5
            out[f"k5 asian {n} x 8 x {d} ms"] = cuda_ms(
                lambda: qmp.qmc_path(*tensors, **kw), reps=reps)
            out[f"k5 asian {n} x 8 x {d} device ms"] = cuda_ms(
                lambda: qmp.qmc_path(*tensors, **kw), reps=reps,
                queued=True)
    spec = tp.OptionSpec(**SPEC)
    walls = {
        "euro_price_mc 2^30": lambda: tp.euro_price_mc(
            spec, "call", n_paths=1 << 30, seed=7, device=dev),
        "exotic_price_mc qmc geometric asian 65536 x 8 x 64": lambda:
            tp.exotic_price_mc("asian", *MARKET[:5], sigma=0.2, n_steps=64,
                               n_paths=65_536, seed=0, backend="qmc",
                               average_type="geometric", device=dev)}
    for label, fn in walls.items():
        out[f"wall {label} ms"] = wall_ms(fn)
    # the host's share of the qmc wall: the kernel's inputs as numpy
    out["k5 kernel_inputs 65536 x 8 x 64 us"] = host_us(
        lambda: qmp._kernel_inputs(0, 65_536, 64, *MARKET, n_replicates=8,
                                   barrier=0.0, rebate=0.0, payout=1.0),
        reps=21)
    out.update(ab_k2(dev))
    # the same with a fresh seed a call: the replicate shifts built anew
    seeds = iter(range(1_000, 10_000))
    out["k5 kernel_inputs 65536 x 8 x 64 fresh seed us"] = host_us(
        lambda: qmp._kernel_inputs(next(seeds), 65_536, 64, *MARKET,
                                   n_replicates=8, barrier=0.0, rebate=0.0,
                                   payout=1.0), reps=21)
    out["wall exotic_price_mc qmc geometric asian 65536 x 8 x 64 fresh "
        "seed ms"] = wall_ms(
        lambda: tp.exotic_price_mc("asian", *MARKET[:5], sigma=0.2,
                                   n_steps=64, n_paths=65_536,
                                   seed=next(seeds), backend="qmc",
                                   average_type="geometric", device=dev))
    occ = {}
    if hasattr(tmc, "blocks_per_sm"):
        occ["k1 anti box-muller"] = tmc.blocks_per_sm(True, False)
    if hasattr(qmp, "blocks_per_sm"):
        for d in (64, 252):
            occ[f"k5 asian {d} steps"] = qmp.blocks_per_sm(2, d)
    out["k1 k5 occupancy"] = occ
    out["k1 k5 resources"] = res_usage(_build.library_path(), K1_K5_NAMES)
    return out


def ab_k2(dev) -> dict:
    """``ab_k1_k5``'s K2 numbers: its rows by SHA-256 at ``K2_CASES``; its
    ``ms`` and ``device ms`` (median of 5) at the main path's call and at
    2^20 x 16; the host microseconds of each part of that call
    (``k2_host_us``); the walls (median of 21) of mc_sumstats_qmc and
    euro_price_mc(backend="qmc") at 2^22 x 16."""
    import optpricer_tpu_torch as tp
    from optpricer_tpu_torch.ops import terminal_mc as tmc

    out = {"k2 sums": {}}
    for case in K2_CASES:
        seed, params, kw, _ = k2_setup(dev, case)
        out["k2 sums"][case] = sha256(tmc.terminal_qmc(seed, params, **kw))
    for case in ("7 call 4194304 16", "7 call 1048576 16"):
        seed, params, kw, _ = k2_setup(dev, case)
        label = " x ".join(case.split()[2:])
        out[f"k2 {label} ms"] = cuda_ms(
            lambda: tmc.terminal_qmc(seed, params, **kw))
        out[f"k2 {label} device ms"] = cuda_ms(
            lambda: tmc.terminal_qmc(seed, params, **kw), queued=True)
    out["k2 host us"] = k2_host_us(dev)
    out["k2 threads"], out["k2 occupancy"] = {}, {}
    if hasattr(tmc, "_qmc_threads"):
        for n in (1 << 22, 1 << 20):
            _, reps, ppr = tmc._plan_qmc(n, 16)
            threads = tmc._qmc_threads(dev.index, 16 * ppr, reps)
            clusters = tmc._qmc_clusters(dev.index, threads, reps)
            out["k2 threads"][str(n)] = threads
            out["k2 occupancy"][f"{n} x 16"] = (threads, clusters,
                                               16 * ppr / clusters)
    spec = tp.OptionSpec(**SPEC)
    out["wall mc_sumstats_qmc 2^22 x 16 ms"] = wall_ms(
        lambda: tmc.mc_sumstats_qmc(7, 1 << 22, *MARKET, True,
                                    n_replicates=16, device=dev))
    out["wall euro_price_mc qmc 2^22 ms"] = wall_ms(
        lambda: tp.euro_price_mc(spec, "call", n_paths=1 << 22, seed=7,
                                 backend="qmc", device=dev))
    return out


def k2_host_us(dev) -> dict:
    """Host microseconds a call (``host_us``) of each part of K2's call in
    mc_sumstats_qmc at 2^22 x 16, as the wrapper of commit 4bc6091 makes
    them: the params and the seed pair sent to the card, the scratch and
    output allocations, ``_build.load()``, entering ``torch.cuda.device``;
    the library's entry point alone (buffers made beforehand; in a tree
    that passes the arguments by value, after ``_qmc_args`` packs them),
    the whole wrapper ``terminal_qmc``, and the rows' copy to the host, by
    ``.cpu()`` and into pinned memory."""
    from optpricer_tpu_torch import _build
    from optpricer_tpu_torch.ops import terminal_mc as tmc

    seed, params, kw, _ = k2_setup(dev, K2_CASES[-1])
    n_rep, _, _ = tmc._plan_qmc(1 << 22, 16)
    host = tmc._terminal_params(n_rep, *MARKET, True)
    n_prog = kw["n_programs"]
    rows = tmc.terminal_qmc(seed, params, **kw)
    torch.cuda.synchronize()

    def pinned_copy():
        out = torch.empty(rows.shape, dtype=rows.dtype, pin_memory=True)
        out.copy_(rows, non_blocking=True)
        torch.cuda.current_stream(dev).synchronize()

    def allocations():
        torch.empty((n_prog * 128, 16), dtype=torch.float32, device=dev)
        torch.empty((n_prog, 16), dtype=torch.float32, device=dev)

    def device_context():
        with torch.cuda.device(dev):
            pass

    parts = {"params .to(dev)": lambda: host.to(dev),
             "seed pair .to(dev)": lambda: tmc._seed_pair(7, dev),
             "allocations": allocations,
             "_build.load()": _build.load,
             "torch.cuda.device": device_context}
    lib = _build.load()
    stream = torch.cuda.current_stream(dev).cuda_stream
    if len(_build._SIGNATURES["optpricer_terminal_qmc"]) == 8:
        # commit 4bc6091's entry point: block rows in a scratch buffer and
        # a combine pass
        scratch = torch.empty((n_prog * 128, 16), dtype=torch.float32,
                              device=dev)
        buf = torch.empty((n_prog, 16), dtype=torch.float32, device=dev)
        parts["entry point"] = lambda: lib.optpricer_terminal_qmc(
            seed.data_ptr(), params.data_ptr(), scratch.data_ptr(),
            buf.data_ptr(), n_prog, kw["reps"], kw["progs_per_rep"], stream)
    else:
        # a cluster a program: the arguments by value, one launch
        args = tmc._qmc_args(seed, params)
        threads = tmc._qmc_threads(dev.index, n_prog, kw["reps"])
        parts["_qmc_args"] = lambda: tmc._qmc_args(seed, params)
        parts["entry point"] = lambda: lib.optpricer_terminal_qmc(
            args.ctypes.data, rows.data_ptr(), n_prog, kw["reps"],
            kw["progs_per_rep"], threads, stream)
    parts["terminal_qmc"] = lambda: tmc.terminal_qmc(seed, params, **kw)
    parts["rows.cpu()"] = lambda: rows.cpu()
    parts["rows to pinned memory"] = pinned_copy
    return {name: host_us(fn) for name, fn in parts.items()}


def ab_k3_k6(dev, multi, desk) -> dict:
    """``ab_turn``'s K3 and K6 numbers: K6 at ``K6_SHAPES`` (its 6 sums as
    hex at one rep, as floats at the 1-asset call's four) and K3 at 1 000
    contracts x 2^20 (the SHA-256 of its (n_ktiles, 10, 128) sums), each
    ``ms``; the host-clock walls (median of 21) of the user calls around
    them (``user_calls``, ``book_call``); K6's resident blocks per SM and
    waves (none for a tree without its occupancy query)."""
    from optpricer_tpu_torch.ops import basket_mc as tbk
    from optpricer_tpu_torch.ops import mc_batch as tmb

    out = {"k6 sums": {}, "k6 sums 4 reps": {}}
    for key, args, shape in K6_SHAPES:
        seed, params, run = multi.k6(*args, shape=shape)
        sums = tbk.basket_mc(seed, params, **run).cpu()
        if run["reps"] == 1:
            out["k6 sums"][key] = [float(v).hex() for v in sums]
        else:
            out["k6 sums 4 reps"][key] = [float(v) for v in sums]
        out[f"k6 {key} ms"] = cuda_ms(
            lambda: tbk.basket_mc(seed, params, **run))
    ops, kw, _ = desk.k3(1 << 20, True)
    out["k3 sums"] = hashlib.sha256(
        tmb.mc_batch(*ops, **kw).cpu().numpy().tobytes()).hexdigest()
    out["k3 1000 x 2^20 ms"] = cuda_ms(lambda: tmb.mc_batch(*ops, **kw))
    for label, fn in [*multi.user_calls().items(),
                      ("euro_price_mc_batch 1000 x 1M dual CV",
                       desk.book_call())]:
        out[f"wall {label} ms"] = wall_ms(fn)
    out["k6 occupancy"] = k6_waves(dev) if hasattr(tbk, "blocks_per_sm") \
        else {}
    return out


AB_NOT_TIMES = ("card", "sm_clock_max_mhz", "sms", "ptxas", "k4 occupancy",
                "sass", "k4 sums timed", "k4 sums 2^18", "k8 layers",
                "k6 sums 4 reps", "k6 occupancy", "sass k3 k6", "sass k1",
                "sass k5", "k1 sums hex", "k1 k5 occupancy",
                "k1 k5 resources", "sass k2", "k2 threads",
                "k2 occupancy")


def ab_issue_ms(label: str, counts: dict, turn: dict) -> float:
    """Milliseconds that the loop's static instructions take at one a lane
    and cycle on the turn's card, issued once per rep or step of the loop
    ``label`` names at the main path's shape: a K3 rep is a base-draw pair,
    1 024 lanes (1 000 contracts, padded) x 2^19 of them at 2^20 draws a
    contract; a K6 step is one step of one path pair. A loop unrolled by
    the compiler holds several: counted by its MUFU instructions (a rep or
    a step's Box-Muller pairs each take one for log32's division and one
    for the square root)."""
    from optpricer_tpu_torch.ops import basket_mc as tbk
    from optpricer_tpu_torch.ops import terminal_mc as tmc

    per_loop = counts["mufu"] // 2
    if label.startswith("terminal_mc"):
        # 64 programs x 256 reps x 32 768 elements at 2^30 draws: 2^29
        # thread-reps, one log32 division (MUFU.RCP) each
        per_loop, iterations = counts["rcp"], 1 << 29
    elif label.startswith("mc_batch"):
        iterations = 1024 * (1 << 20) // 2
    else:
        per_loop //= (int(label.split(", ")[-1].split()[0]) + 1) // 2
        key = next(k for k, (a, payoff, *_), _ in K6_SHAPES
                   if label == f"basket_mc_kernel<{payoff}, anti=1, {a} "
                   f"assets>")
        n, n_steps = dict((k, sh) for k, _, sh in K6_SHAPES)[key]
        reps, n_prog = tmc._plan_grid(n, tbk.TILE)
        iterations = n_prog * reps * tbk.TILE * n_steps
    return (counts["total"] / per_loop * iterations
            / (turn["sms"] * 128 * turn["sm_clock_max_mhz"] * 1e6) * 1e3)


def k1_k5_sass_lines(side: str, turn: dict) -> list:
    """The lines that report K1's rep loops and K5's loops (``sass_k1``,
    ``sass_k5`` in ``turn``) with the issue time their static counts give
    at the main path's shapes, at one instruction a lane and cycle, and
    that of their ALU-pipe ops alone at half that rate."""
    lines = []
    issue_line = (" if each static instruction issued once an iteration "
                  "(one a lane and cycle, 4 schedulers an SM)")
    for label, loops in turn.get("sass k1", {}).items():
        for i, counts in enumerate(loops):
            alu = dict(counts, total=2 * counts["alu"])
            lines.append(
                f"sass {side} {label}: rep loop {i + 1} of {len(loops)} "
                + ", ".join(f"{k} {v}" for k, v in counts.items())
                + f"; {ab_issue_ms(label, counts, turn):.4f} ms at 2^30"
                + issue_line + f"; its ALU-pipe ops alone at half that rate "
                f"{ab_issue_ms(label, alu, turn):.4f} ms")
    loops = turn.get("sass k5")
    if loops is None:
        return lines
    for i, lp in enumerate(loops):
        lines.append(f"sass {side} qmc_path_kernel<asian> loop {i + 1} of "
                     f"{len(loops)} ({lp['kind']}, depth {lp['depth']}): "
                     + ", ".join(f"{k} {v}" for k, v in lp["counts"].items()))
    rate = turn["sms"] * 128 * turn["sm_clock_max_mhz"] * 1e6
    sparse = any(lp["kind"] == "bridge terms sparse" for lp in loops)
    for n, d in ((65_536, 64), (1 << 20, 252)):
        m_bits = max(math.ceil(math.log2(n)), 11)
        per_point = k5_issue(loops, d, m_bits,
                             (d - 1).bit_length() + 1 if sparse else None)
        ms = {part: (per_point.get(f"{part} total", 0.0) * 8 * n / rate * 1e3,
                     2 * per_point.get(f"{part} alu", 0.0) * 8 * n / rate
                     * 1e3) for part in ("sobol", "bridge")}
        lines.append(
            f"sass {side} qmc_path_kernel<asian> at {n} x 8 x {d}: "
            + ", ".join(f"{k} {v:.1f}" for k, v in per_point.items())
            + " instructions a point; " + ", ".join(
                f"{part} {t:.4f} ms (its ALU-pipe ops alone {a:.4f} ms)"
                for part, (t, a) in ms.items()) + issue_line)
    return lines


def ab(other: Path, groups=AB_GROUPS):
    """Run ``ab_turn`` on ``other`` and on this tree in the turns
    ``AB_TURNS``, one process each, for the kernel groups ``groups``, and
    print (``ab_report``) every number side by side, the ratio
    other / this of each kernel's timed calls and of the user calls' walls
    in the slowest and the fastest pairing of turns, the ptxas lines and
    the SASS counts of each tree's turn that built it (with the issue time
    they give), the resident blocks and waves, and whether each kernel's
    results are equal bit for bit across the turns. The last line is one
    JSON object with every turn's numbers."""
    trees = {"this": ROOT, "other": other.resolve()}
    turns = []
    with tempfile.TemporaryDirectory() as tmp:
        for i, side in enumerate(AB_TURNS):
            path = Path(tmp) / f"{i}.json"
            subprocess.run([sys.executable, __file__, "--ab-turn",
                            str(trees[side]), str(path), ",".join(groups)],
                           check=True, env=dict(os.environ, PYTHONPATH=""),
                           timeout=1500)
            turns.append((side, json.loads(path.read_text())))
    ab_report(turns, trees)


def ab_report(turns, trees):
    """``ab``'s lines for the turns ``turns`` ((side, numbers) pairs)."""
    from optpricer_tpu_torch.ops import path_mc as pmc
    from optpricer_tpu_torch.ops import terminal_mc as tmc

    sides = ", ".join(side for side, _ in turns)
    first = turns[0][1]
    print(f"card: {first['card']}; {first['sms']} SMs, max SM clock "
          f"{first['sm_clock_max_mhz']:.0f} MHz; turns: {sides} "
          f"(other = {trees['other']})")
    keys = list(dict.fromkeys(k for _, t in turns for k in t))
    for key in keys:
        if key in AB_NOT_TIMES or key.endswith("sums") or key == "side":
            continue
        value = next(t[key] for _, t in turns if key in t)
        fields = list(dict.fromkeys(f for _, t in turns
                                    for f in t.get(key) or {})) \
            if isinstance(value, dict) else [None]
        for field in fields:
            values = [t.get(key) if field is None
                      else t.get(key, {}).get(field) for _, t in turns]
            print(f"{key}{'' if field is None else ' ' + field}: "
                  + ", ".join("-" if v is None else f"{v:.4f}"
                              for v in values))
    timed_keys = [k for k in first if k.startswith(("k1 ", "k2 ", "k5 ",
                                                    "k8 ", "k6 ", "k3 "))
                  and k.endswith(" ms")]
    for key in [f"k4 {label} ms" for label in K4_TIMED
                if f"k4 {label} ms" in first] + timed_keys \
            + [k for k in first if k.startswith("wall ")]:
        ms = {side: [t[key] for s, t in turns if s == side and key in t]
              for side in ("other", "this")}
        if not (ms["other"] and ms["this"]):
            continue
        slow = min(ms["other"]) / max(ms["this"])
        fast = max(ms["other"]) / min(ms["this"])
        print(f"{key[:-3]}: other / this {slow:.3f}x in the slowest pairing "
              f"of turns, {fast:.3f}x in the fastest")
    for side, turn in turns:
        for name, line in turn["ptxas"].items():
            print(f"ptxas {side} {name}: {line}")
    seen = set()
    for side, turn in turns:
        if side in seen:
            continue
        seen.add(side)
        for label, (per_sm, blocks, waves, _) in \
                turn["k4 occupancy"].items():
            print(f"k4 {side} {label}: {per_sm} resident blocks per SM, "
                  f"{blocks} blocks, {waves:.2f} waves")
        for key, (per_sm, blocks, waves) in \
                turn.get("k6 occupancy", {}).items():
            print(f"k6 {side} {key}: {per_sm} resident blocks per SM, "
                  f"{blocks} blocks, {waves:.2f} waves")
        for key, per_sm in turn.get("k1 k5 occupancy", {}).items():
            print(f"{key} {side}: {per_sm} resident blocks per SM")
        for key, (threads, clusters, waves) in \
                turn.get("k2 occupancy", {}).items():
            print(f"k2 {side} {key}: blocks of {threads} threads, "
                  f"{clusters} clusters of 8 resident, {waves:.2f} waves")
        for name, line in turn.get("k1 k5 resources", {}).items():
            print(f"resources {side} {name}: {line}")
    issue_line = (" if each static instruction issued once an iteration "
                  "(one a lane and cycle, 4 schedulers an SM)")
    for side, turn in turns:
        for label, loops in turn.get("sass k3 k6", {}).items():
            for i, counts in enumerate(loops or []):
                print(f"sass {side} {label}: loop {i + 1} of {len(loops)} "
                      + ", ".join(f"{k} {v}" for k, v in counts.items())
                      + f"; {ab_issue_ms(label, counts, turn):.4f} ms at "
                      f"the main path's shape" + issue_line)
        for line in k1_k5_sass_lines(side, turn):
            print(line)
        for line in k2_issue_lines(side, turn.get("sass k2", {}), turn,
                                   turn.get("k2 threads", {})):
            print(line)
    for side, turn in turns:
        for label, counts in turn.get("sass", {}).items():
            if counts is None:
                print(f"sass {side} {label}: no step-pair loop found")
                continue
            _, _, _, n, n_steps = K4_TIMED[label.split(" ", 1)[1]]
            reps, n_prog = tmc._plan_grid(n, pmc.TILE)
            paths = n_prog * reps * pmc.TILE
            issue_ms = (counts["total"] * paths * (n_steps // 2)
                        / (turn["sms"] * 128
                           * turn["sm_clock_max_mhz"] * 1e6) * 1e3)
            print(f"sass {side} {label}: step-pair loop "
                  + ", ".join(f"{k} {v}" for k, v in counts.items())
                  + f"; {issue_ms:.4f} ms at {n} x {n_steps} if each static "
                  f"instruction issued once a step pair (one a lane and "
                  f"cycle, 4 schedulers an SM)")

    def same(values):
        return "equal" if all(v == values[0] for v in values) else "NOT equal"

    if "k4 sums 2^18" in first:
        for label in K4_TIMED:
            sums = [t["k4 sums 2^18"][label] for _, t in turns]
            this = [t["k4 sums timed"][label] for s, t in turns
                    if s == "this"]
            that = [t["k4 sums timed"][label] for s, t in turns
                    if s == "other"]
            rel = max(compare(torch.tensor(a), torch.tensor(b), label,
                              signed=K4_SIGNED) for a in this for b in that)
            print(f"k4 {label}: the 21 sums at 2^18 paths (one rep) are "
                  f"{same(sums)} bit for bit across the turns; at the timed "
                  f"shape this vs other max rel err of the unsigned sums "
                  f"{rel:.3e} (rtol {RTOL})")
        for scheme in ("milstein", "log_euler"):
            sums = [t[f"k4 {scheme} sums"] for _, t in turns]
            print(f"k4 {scheme} at the desk's call: the 21 sums are "
                  f"{same(sums)} bit for bit across the turns")
    for key in first.get("k6 sums", {}):
        sums = [t["k6 sums"][key] for _, t in turns]
        print(f"k6 {key}: the 6 sums (one rep) are {same(sums)} bit for bit "
              f"across the turns")
    for key in first.get("k6 sums 4 reps", {}):
        this = [t["k6 sums 4 reps"][key] for s, t in turns if s == "this"]
        that = [t["k6 sums 4 reps"][key] for s, t in turns if s == "other"]
        rel = max(abs(x - y) / abs(y) for a in this for b in that
                  for x, y in zip(a, b) if y != 0.0)
        print(f"k6 {key}: the 6 sums (4 reps) this vs other max rel "
              f"{rel:.3e}")
    if "k3 sums" in first:
        digests = [t["k3 sums"] for _, t in turns]
        print(f"k3 1000 x 2^20: the (n_ktiles, 10, 128) sums are "
              f"{same(digests)} bit for bit across the turns (SHA-256 "
              f"{', '.join(d[:12] for d in digests)})")
    for label in first.get("k1 sums", {}):
        digests = [t["k1 sums"][label] for _, t in turns]
        this = [t["k1 sums hex"][label] for s, t in turns if s == "this"]
        that = [t["k1 sums hex"][label] for s, t in turns if s == "other"]
        rel = max((abs(float.fromhex(x) - float.fromhex(y))
                   / abs(float.fromhex(y)) for a in this for b in that
                   for x, y in zip(a, b) if float.fromhex(y) != 0.0),
                  default=0.0)
        print(f"k1 {label}: the 13 sums are {same(digests)} bit for bit "
              f"across the turns (SHA-256 "
              f"{', '.join(d[:12] for d in digests)}); this vs other max "
              f"rel {rel:.3e} (rtol {RTOL})")
    for key in first.get("k5 sums", {}):
        digests = [t["k5 sums"][key] for _, t in turns]
        recorded = QMC_PATH_SUMS.get(key)
        print(f"k5 {key}: the (n_programs, 6) sums are {same(digests)} bit "
              f"for bit across the turns (SHA-256 "
              f"{', '.join(d[:12] for d in digests)}); "
              + ("equal to" if recorded == digests[0] else "NOT equal to")
              + " QMC_PATH_SUMS")
    for key in first.get("k2 sums", {}):
        digests = [t["k2 sums"][key] for _, t in turns]
        recorded = K2_SUMS.get(key)
        print(f"k2 {key}: the (n_programs, 13) rows are {same(digests)} bit "
              f"for bit across the turns (SHA-256 "
              f"{', '.join(d[:12] for d in digests)}); "
              + ("equal to" if recorded == digests[0] else "NOT equal to")
              + " K2_SUMS")
    for case in first.get("k8 layers", {}):
        digests = [t["k8 layers"][case] for _, t in turns]
        print(f"k8 {case} {PdeSlice.N_STRIKES} x {PdeSlice.N_S - 1} x "
              f"{PdeSlice.N_T}: the layer is {same(digests)} bit for bit "
              f"across the turns (SHA-256 "
              f"{', '.join(d[:12] for d in digests)})")
    print(json.dumps({"turns": [dict(t, side=s) for s, t in turns]}))


if __name__ == "__main__":
    args = sys.argv[1:]
    if args[:1] == ["--ab-turn"] and len(args) in (3, 4):
        chosen = args[3].split(",") if len(args) == 4 else AB_GROUPS
        Path(args[2]).write_text(json.dumps(ab_turn(Path(args[1]).resolve(),
                                                    chosen)))
    elif args[:1] == ["--ab"] and len(args) in (2, 3):
        chosen = args[2].split(",") if len(args) == 3 else AB_GROUPS
        if not set(chosen) <= set(AB_GROUPS):
            raise SystemExit(f"chip_smoke --ab: groups among {AB_GROUPS}")
        ab(Path(args[1]), chosen)
    elif not args:
        main()
    else:
        raise SystemExit("usage: chip_smoke.py [--ab OTHER_TREE "
                         f"[GROUP,...]], GROUP in {AB_GROUPS}")
