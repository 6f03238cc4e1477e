"""CLI dispatcher: `python -m onepose_tpu_torch <command> [--config X] [K=V ...]`.

Port of onepose_tpu/__main__.py: the same commands and the same `--config`
/ K=V parsing (`config.load_config`). Ported so far, each on the card
unless device=cpu is given:
  map         build an object map (SfM)
  infer       evaluation inference (cm-degree recall) over a sequence or roster
  detect      feature-matching 2D detection: color_det/ crops and intrin_det/
The JAX package's other commands are listed and exit non-zero, naming the
ROADMAP item that ports each.
"""

from __future__ import annotations

import argparse
import sys

from onepose_tpu_torch.config import load_config

# command -> (what it does, the ROADMAP item that ports it)
PENDING = {
    "train": ("train the GATsSPG matcher", "A11"),
    "demo": ("detection + tracking video", "A13"),
    "merge-anno": ("merge annotation indices", "A15"),
    "parse-scan": ("parse an ARKit capture", "A15"),
    "video2img": ("extract video frames", "A15"),
    "convert": ("convert PyTorch weights to msgpack checkpoints", "A15"),
}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="onepose_tpu_torch")
    sub = parser.add_subparsers(dest="command", required=True)

    from onepose_tpu_torch.cli import detect_cmd, infer, map_object

    map_object.add_parser(sub)
    infer.add_parser(sub)
    detect_cmd.add_parser(sub)
    for name, (what, item) in PENDING.items():
        p = sub.add_parser(name, help=f"{what} (not ported yet: ROADMAP {item})")
        p.add_argument("args", nargs=argparse.REMAINDER)
        p.set_defaults(_pending=item)

    args = parser.parse_args(argv)
    if getattr(args, "_pending", None):
        print(f"onepose_tpu_torch: `{args.command}` is not ported yet (ROADMAP "
              f"{args._pending}); the JAX package runs it: python -m onepose_tpu "
              f"{args.command}", file=sys.stderr)
        return 2
    cfg = load_config(args._defaults, args.config, args.overrides)
    cfg.pop("compilation_cache_dir", None)  # the port has no compilation cache
    args._run(cfg)
    return 0


if __name__ == "__main__":
    sys.exit(main())
