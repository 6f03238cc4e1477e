"""The benchmark of the PyTorch / CUDA port (`onepose_tpu_torch`).

`python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>` runs one cell of `BENCHMARK.json` once on the card and
prints one JSON result line last. Everything a cell needs is found by
name: its configuration in `configs/<config>.json`, its traffic in
`traffic/<traffic>.json`, the limits of its correctness numbers in
`limits/<cell>.json`, the code that runs the port for the
configuration's `entry` in `runners/<entry>.py`, and each per-layer
metric's reader in `metrics/<metric>.py`.
"""
