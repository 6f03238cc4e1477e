"""Run one cell of the port's benchmark once, on the card.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell's entry in BENCHMARK.json names its configuration and traffic;
the configuration's `entry` names the runner (`runners/<entry>.py`) that
builds the port, makes the weights and the traffic from the seed on the
card, warms up, runs the window and hands the sampled outputs to the
judge (`judges/<entry>.py`). With --trace 0 the result carries the cell's
end-to-end metrics, with --trace 1 its per-layer metrics, each read by
`metrics/<metric>.py`. The last line of standard output is the result;
the last lines of standard error are the correctness numbers beside
their limits. Without a card, without the port, or with JAX or the JAX
package loaded once the window has closed, the run prints no result and
exits with another code than 0.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def parse(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="Run one cell of the port's benchmark once.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def card_line() -> str:
    """The card's name and power limit as nvidia-smi prints them."""
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=60).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "nvidia-smi: not read"


def cache_dirs() -> None:
    """Build and kernel caches at fixed paths inside the checkout (the
    port's own kernels build into build/torch_kernels there)."""
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton_cache")):
        os.environ[var] = os.path.join(ROOT, "build", sub)


def main(argv=None) -> int:
    args = parse(argv)
    from portbench import harness

    cell = harness.cell(harness.manifest(ROOT), args.workload, args.seed, args.seconds,
                        bool(args.trace))
    cache_dirs()
    import torch

    chips = cell.entry["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: the cell needs {chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available",
              file=sys.stderr)
        return 3
    torch.set_num_threads(1)  # one client thread; no idle intra-op pool spinning beside it
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    print(f"[portbench] {card_line()}; torch {torch.__version__}, CUDA {torch.version.cuda}",
          flush=True)
    runner = importlib.import_module(f"portbench.runners.{cell.cfg['entry']}")
    res = runner.run(cell, device, T0)

    found = harness.forbidden_modules()
    if found:
        print(f"portbench: the run loaded {', '.join(found)}", file=sys.stderr)
        return 4
    correct, rows = harness.verdict(res["readings"], cell.limits)
    result = {"correct": correct, "attempted": res["attempted"], "failed": res["failed"]}
    device_info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips,
                   "memory_peak_bytes": int(res["memory_peak"])}
    if cell.trace:
        t = res["trace"]
        metrics = {}
        for m in cell.metrics:
            value = harness.reader(m["name"]).read(t)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        device_info.update(busy_s=t.busy_s, window_s=t.window_s)
    else:
        metrics = {m["name"]: {"value": res["metrics"][m["name"]][0], "unit": m["unit"]}
                   for m in cell.metrics}
    result.update(metrics=metrics, device=device_info)
    if cell.trace:
        result["breakdown"] = res["breakdown"]
    print(f"[portbench] stats {json.dumps(res['stats'])}", flush=True)
    result["checks"] = {name: {"value": v, "limit": lim} for name, v, lim in rows}
    for name, v, lim in rows:
        print(f"check {name} {v!r} limit {lim!r} {'ok' if v <= lim else 'FAIL'}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
