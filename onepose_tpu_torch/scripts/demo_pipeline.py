"""One command from a scanned capture to the demo video, on the card.

Port of `scripts/demo_pipeline.sh`: parse the annotation and the test
captures (`parse-scan`), build the object map (`map`), then run the demo
with video output (`demo`, with tracking when asked), each as
`python -m onepose_tpu_torch <command>`, in the shell script's order and
directory layout. It stops at the first command that fails and exits with
that command's code.

    python -m onepose_tpu_torch.scripts.demo_pipeline <obj_dir> [--with-tracking | -u]

<obj_dir> holds the OnePose-Cap layout: <obj>-annotate/ and <obj>-test/
(Frames.m4v, ARposes.txt, Box.txt, intrinsics.txt), <obj> being
<obj_dir>'s name. Outputs: <obj>-annotate-parsed/, <obj>-test-parsed/,
sfm_model/ (the map; its anno/ feeds the demo) and demo_out/. Extra
`key=value` arguments come from the environment, as in the shell script:
MAP_ARGS for map and DEMO_ARGS for demo (split as a shell splits them).

Each command's output is passed on when it ends. The last line is
{"demo_pipeline": {"obj_dir", "commands": [{"argv", "rc", "seconds",
"summary", "launches"}, ...], "video"}}: each command run, its exit code,
host seconds, its last output line (the command's JSON summary) and the
kernel launches it reported; "video" is the demo's video, once it ran.
"""

from __future__ import annotations

import argparse
import json
import os
import shlex
import subprocess
import sys
import time
from pathlib import Path

from onepose_tpu_torch._device import resolve_device
from onepose_tpu_torch.__main__ import LAUNCHES


def plan(obj_dir: str, with_tracking: bool = False, map_args: str = "",
         demo_args: str = "") -> list:
    """(title, argv after `python -m onepose_tpu_torch`) of each command,
    in order."""
    obj = Path(obj_dir)
    name = obj.name
    annotate, test = obj / f"{name}-annotate", obj / f"{name}-test"
    return [
        ("Parse scanned data", ["parse-scan", f"data_dir={annotate}",
                                f"out_dir={obj / f'{name}-annotate-parsed'}"]),
        ("Parse scanned data", ["parse-scan", f"data_dir={test}",
                                f"out_dir={obj / f'{name}-test-parsed'}"]),
        ("Run SfM to reconstruct object point cloud for pose estimation",
         ["map", f"data_dir={obj / f'{name}-annotate-parsed'}", f"out_dir={obj / 'sfm_model'}",
          *shlex.split(map_args)]),
        ("Run inference and output demo video",
         ["demo", f"data_dir={obj / f'{name}-test-parsed'}",
          f"anno_dir={obj / 'sfm_model' / 'anno'}", f"out_dir={obj / 'demo_out'}",
          f"use_tracking={str(with_tracking).lower()}", "make_video=true",
          *shlex.split(demo_args)]),
    ]


def _last_json(text: str):
    lines = text.strip().splitlines()
    try:
        return json.loads(lines[-1]) if lines else None
    except json.JSONDecodeError:
        return None


def run(commands: list, python: str = sys.executable) -> tuple:
    """Run each command in turn until one fails: (its exit code, else 0;
    one record a command run)."""
    records = []
    for title, argv in commands:
        print("-" * len(title) + f"\n{title}:\n" + "-" * len(title), flush=True)
        t0 = time.perf_counter()
        proc = subprocess.run([python, "-m", "onepose_tpu_torch", *argv], capture_output=True,
                              text=True)
        sys.stdout.write(proc.stdout)
        sys.stderr.write(proc.stderr)
        launches = [line[len(LAUNCHES):] for line in proc.stderr.splitlines()
                    if line.startswith(LAUNCHES)]
        records.append({"argv": argv, "rc": proc.returncode,
                        "seconds": time.perf_counter() - t0, "summary": _last_json(proc.stdout),
                        "launches": json.loads(launches[-1]) if launches else None})
        if proc.returncode != 0:
            print(f"demo_pipeline: `{' '.join(argv)}` exited {proc.returncode}",
                  file=sys.stderr, flush=True)
            return proc.returncode, records
    return 0, records


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("obj_dir")
    parser.add_argument("-u", "--with-tracking", action="store_true")
    args = parser.parse_args(argv)
    resolve_device("cuda")
    rc, records = run(plan(args.obj_dir, args.with_tracking, os.environ.get("MAP_ARGS", ""),
                           os.environ.get("DEMO_ARGS", "")))
    video = None
    if rc == 0:
        video = (records[-1]["summary"] or {}).get("video")
        print(f"demo video under {Path(args.obj_dir) / 'demo_out'}", flush=True)
    print(json.dumps({"demo_pipeline": {"obj_dir": args.obj_dir, "commands": records,
                                        "video": video}}), flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
