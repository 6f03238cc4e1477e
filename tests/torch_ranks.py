"""Spawn the port's rank program (`tests/torch_rank_worker.py`) over N gloo
ranks on the CPU and collect each rank's results.

torchrun's --standalone rendezvous takes a free local port of its own, so
tests in several xdist workers do not clash. Each spawn has a time limit:
on expiry its whole process group is killed and the test fails (a rank
waiting on a collective that never comes must not hang the run).
"""

from __future__ import annotations

import glob
import json
import os
import os.path as osp
import signal
import subprocess
import sys

import numpy as np
import torch

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))
WORKER = osp.join(REPO, "tests", "torch_rank_worker.py")


def _run(cmd: list, what: str, timeout: float) -> str:
    """Run torchrun's command in its own process group; its output, or an
    AssertionError with the first rank's traceback (or the time limit)."""
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    proc = subprocess.Popen(cmd, cwd=REPO, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True, start_new_session=True)
    try:
        log, _ = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        log, _ = proc.communicate()
        raise AssertionError(f"{what} passed its {timeout} s limit:\n{log[-4000:]}")
    first = log.find("]: Traceback")
    assert proc.returncode == 0, f"{what}: rc {proc.returncode}\n{log[max(first, 0):][:5000]}"
    return log


def torchrun(nproc: int) -> list:
    return [sys.executable, "-m", "torch.distributed.run", "--standalone",
            f"--nproc-per-node={nproc}"]


def spawn_command(argv: list, nproc: int, workdir, timeout: float = 300.0) -> list:
    """`python -m onepose_tpu_torch *argv` over `nproc` ranks; returns each
    rank's standard output (torchrun writes them under workdir/logs)."""
    log_dir = osp.join(str(workdir), "logs")
    cmd = torchrun(nproc) + ["--redirects=1", f"--log-dir={log_dir}", "-m",
                             "onepose_tpu_torch", *argv]
    _run(cmd, f"{argv[0]} over {nproc} ranks", timeout)
    outs = []
    for r in range(nproc):
        (path,) = glob.glob(osp.join(log_dir, "**", str(r), "stdout.log"), recursive=True)
        with open(path) as f:
            outs.append(f.read())
    return outs


def spawn(task: str, nproc: int, workdir, inputs: dict, options: dict | None = None,
          state_dicts: dict | None = None, timeout: float = 240.0) -> list:
    """Run `task` (comma-separated tasks) over `nproc` ranks; returns
    [rank 0's results, ...] (dicts of numpy arrays keyed "<task>.<name>")."""
    tag = task.replace(",", "_")
    in_dir = osp.join(str(workdir), f"{tag}_in")
    out_dir = osp.join(str(workdir), f"{tag}_out")
    os.makedirs(in_dir, exist_ok=True)
    os.makedirs(out_dir, exist_ok=True)
    np.savez(osp.join(in_dir, "inputs.npz"), **inputs)
    with open(osp.join(in_dir, "options.json"), "w") as f:
        json.dump(options or {}, f)
    for name, sd in (state_dicts or {}).items():
        torch.save(sd, osp.join(in_dir, f"{name}.pt"))
    _run(torchrun(nproc) + [WORKER, task, in_dir, out_dir], f"{task} over {nproc} ranks",
         timeout)
    return [dict(np.load(osp.join(out_dir, f"rank{r}.npz"))) for r in range(nproc)]
