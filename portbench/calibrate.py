"""Readings of the correctness numbers over many seeds, for setting limits.

    python3 portbench/calibrate.py --workload <cell> --seeds 1,2,3 [--seconds 2]
        [--control <name> | --fault <name>] [--out <file.jsonl>]

One process runs the cell once a seed as run.py does (a short window, no
trace) and prints, a line a seed, the judge's readings of the sampled
outputs and the verdict of the cell's limits on them. With --control, the
runner's control (the reference at the next precision below the
configuration's, `CONTROLS` in `runners/<entry>.py`) takes the program's
place in the judged outputs; with --fault, one of the runner's `FAULTS`
breaks the timed path underneath while the window runs. A limit lies
above the largest program reading and below the smallest control reading
of a number that the control fails. The benchmark's own runs never run
this.
"""

import argparse
import importlib
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="Correctness readings over many seeds.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated seeds")
    p.add_argument("--seconds", type=float, default=2.0)
    group = p.add_mutually_exclusive_group()
    group.add_argument("--control", default=None)
    group.add_argument("--fault", default=None)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    from portbench import harness
    from portbench.run import cache_dirs

    cache_dirs()
    import torch

    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 3
    device = torch.device("cuda", 0)
    man = harness.manifest(ROOT)
    out = open(args.out, "a") if args.out else None
    try:
        for seed in (int(s) for s in args.seeds.split(",")):
            cell = harness.cell(man, args.workload, seed, args.seconds, False)
            runner = importlib.import_module(f"portbench.runners.{cell.cfg['entry']}")
            side = args.control or args.fault or "program"
            control = runner.CONTROLS[args.control] if args.control else None
            fault = runner.FAULTS[args.fault] if args.fault else None
            t0 = time.perf_counter()
            res = runner.run(cell, device, t0, control=control, fault=fault)
            correct, rows = harness.verdict(res["readings"], cell.limits)
            line = json.dumps({"workload": args.workload, "seed": seed, "side": side,
                               "correct": correct, "checks": rows,
                               "readings": res["readings"], "stats": res["stats"],
                               "metrics": res.get("metrics"),
                               "seconds": time.perf_counter() - t0})
            print(line, flush=True)
            if out:
                out.write(line + "\n")
                out.flush()
            torch.cuda.empty_cache()
    finally:
        if out:
            out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
