"""CLI dispatcher: `python -m onepose_tpu_torch <command> [--config X] [K=V ...]`.

Port of onepose_tpu/__main__.py: the same nine commands and the same
`--config` / K=V parsing (`config.load_config`). The commands that run
models run on the card unless device=cpu is given; the others are host
work:
  map         build an object map (SfM)
  train       train the GATsSPG matcher
  infer       evaluation inference (cm-degree recall) over a sequence or roster
  demo        detection + tracking over a video's frames
  detect      feature-matching 2D detection: color_det/ crops and intrin_det/
  merge-anno  merge annotation indices (host)
  parse-scan  parse an ARKit capture (host)
  video2img   extract video frames (host)
  convert     convert PyTorch weights to msgpack checkpoints (host)
"""

from __future__ import annotations

import argparse
import sys

from onepose_tpu_torch.config import load_config


def build_parser() -> argparse.ArgumentParser:
    from onepose_tpu_torch.cli import (
        convert_cmd,
        demo,
        detect_cmd,
        infer,
        map_object,
        merge_anno_cmd,
        parse_scan_cmd,
        train_cmd,
    )

    parser = argparse.ArgumentParser(prog="onepose_tpu_torch")
    sub = parser.add_subparsers(dest="command", required=True)
    for module in (map_object, infer, train_cmd, parse_scan_cmd, demo, detect_cmd,
                   merge_anno_cmd, convert_cmd):
        module.add_parser(sub)
    return parser


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    cfg = load_config(args._defaults, args.config, args.overrides)
    cfg.pop("compilation_cache_dir", None)  # the port has no compilation cache
    args._run(cfg)
    return 0


if __name__ == "__main__":
    sys.exit(main())
