"""Readings that a cell's limits are set from, on the card:

* the program's: the cell's own run (the window at its load, the
  reference's judge) on each of ``--seeds``;
* the control's: the reference itself in a lower precision (``--dtype``,
  bfloat16 for the float32 the configurations state) put in the program's
  place, on the window's first ``--control-sample`` requests of each of
  ``--control-seeds``, judged as the program is.

    python3 perfbench/calibrate.py --workload <cell> --seeds 1,2,... \
        --control-seeds 7,8,9 [--seconds 3] [--control-sample 16]

One JSON line a reading on standard output. The benchmark's runs never
run this.
"""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--control-sample", type=int, default=16)
    p.add_argument("--dtype", default="bfloat16")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))

    import torch

    from perfbench import generator, harness

    seeds = [int(s) for s in args.seeds.split(",") if s]
    controls = [int(s) for s in args.control_seeds.split(",") if s]
    for seed in seeds:
        t = time.perf_counter()
        r = harness.run_cell(args.workload, seed, args.seconds, False,
                             device=args.device)
        print(json.dumps({"side": "program", "seed": seed,
                          "correct": r["correct"], "checks": r["checks"],
                          "metrics": r["metrics"],
                          "seconds": time.perf_counter() - t}), flush=True)
    cell = harness.load_cell(args.workload)
    ref = harness.reference(cell["traffic_data"]["entry"])
    dtype = getattr(torch, args.dtype)
    for seed in controls:
        t = time.perf_counter()
        reqs = generator.Requests(cell["config_data"], cell["traffic_data"],
                                  seed, generator.WINDOW).take(
                                      args.control_sample)
        try:
            outs = ref.control(cell["config_data"], cell["traffic_data"],
                               reqs, device=args.device, seed=seed,
                               dtype=dtype)
            checks = harness.judge(cell, list(zip(reqs, outs)), seed,
                                   args.device)
        except RuntimeError as e:      # a control that crashes has failed
            checks = {"error": repr(e)}
        print(json.dumps({"side": "control", "dtype": args.dtype,
                          "seed": seed, "checks": checks,
                          "seconds": time.perf_counter() - t}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
