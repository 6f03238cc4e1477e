"""The port stands alone: it imports torch, never JAX, flax or the JAX
package, and its entry points run on CUDA unless the caller names the CPU."""

import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "onepose_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
# onepose_tpu_torch never matches: its name goes on with "_", not ".".
FORBIDDEN = re.compile(r"import jax|from jax|flax|onepose_tpu\.")


MODULES = (
    "onepose_tpu_torch, onepose_tpu_torch.runtime, "
    "onepose_tpu_torch.geometry, onepose_tpu_torch.models.bridge, "
    "onepose_tpu_torch.ops.kernels, onepose_tpu_torch.models.superglue, "
    "onepose_tpu_torch.models.nn_matcher, onepose_tpu_torch.parallel.sfm_parallel, "
    "onepose_tpu_torch.sfm, onepose_tpu_torch.sfm.mapping, onepose_tpu_torch.ops.lm, "
    "onepose_tpu_torch.geometry.triangulation, onepose_tpu_torch.native, "
    "onepose_tpu_torch.native.frame_loader, onepose_tpu_torch.config, "
    "onepose_tpu_torch.data, onepose_tpu_torch.data.paths, onepose_tpu_torch.data.padding, "
    "onepose_tpu_torch.data.anno_io, onepose_tpu_torch.data.colmap_io, "
    "onepose_tpu_torch.data.colmap_database, onepose_tpu_torch.utils.checkpoint, "
    "onepose_tpu_torch.utils.profiling, onepose_tpu_torch.utils.precision, "
    "onepose_tpu_torch.cli.common, onepose_tpu_torch.cli.map_object, "
    "onepose_tpu_torch.__main__, onepose_tpu_torch.sfm.cache, "
    "onepose_tpu_torch.geometry.epnp, onepose_tpu_torch.geometry.transforms, "
    "onepose_tpu_torch.geometry.similarity, onepose_tpu_torch.eval, "
    "onepose_tpu_torch.eval.evaluator, onepose_tpu_torch.detector, "
    "onepose_tpu_torch.detector.feature_detector, onepose_tpu_torch.utils.vis, "
    "onepose_tpu_torch.cli.infer, onepose_tpu_torch.cli.detect_cmd, "
    "onepose_tpu_torch.train, onepose_tpu_torch.train.losses, "
    "onepose_tpu_torch.train.train_step, onepose_tpu_torch.train.loop, "
    "onepose_tpu_torch.train.callbacks, onepose_tpu_torch.data.dataset, "
    "onepose_tpu_torch.utils.seeding, onepose_tpu_torch.cli.train_cmd, "
    "onepose_tpu_torch.ops.optical_flow, onepose_tpu_torch.tracker, "
    "onepose_tpu_torch.tracker.ba_tracker, onepose_tpu_torch.cli.demo, "
    "onepose_tpu_torch.models.convert, onepose_tpu_torch.cli.convert_cmd, "
    "onepose_tpu_torch.data.scan_parser, onepose_tpu_torch.cli.parse_scan_cmd, "
    "onepose_tpu_torch.cli.merge_anno_cmd, onepose_tpu_torch.utils.comm, "
    "onepose_tpu_torch.parallel, onepose_tpu_torch.parallel.mesh, "
    "onepose_tpu_torch.parallel.sharded_attention, onepose_tpu_torch.parallel.tensor_parallel, "
    "onepose_tpu_torch.parallel.stage_pipeline, onepose_tpu_torch.parallel.distributed_ba, "
    "onepose_tpu_torch.utils.costs, onepose_tpu_torch.bench, onepose_tpu_torch.scripts, "
    "onepose_tpu_torch.scripts.roofline_audit, onepose_tpu_torch.scripts.bench_train_step, "
    "onepose_tpu_torch.scripts.profile_pnp, onepose_tpu_torch.scripts.audit_collectives, "
    "onepose_tpu_torch.scripts.bench_pair_batching, onepose_tpu_torch.scripts.bench_matcher_parts, "
    "onepose_tpu_torch.scripts.bench_mixed_attention, onepose_tpu_torch.scripts.profile_sp_layers, "
    "onepose_tpu_torch.scripts.profile_superpoint_parts, onepose_tpu_torch.scripts.demo_pipeline, "
    "onepose_tpu_torch.models.superpoint_variants, onepose_tpu_torch.scripts.bench_sp_front, "
    "onepose_tpu_torch.scripts.bench_sp_score, onepose_tpu_torch.scripts.bench_sp_variants, "
    "onepose_tpu_torch.scripts.profile_flash_phases, onepose_tpu_torch.scripts.compare_flash_builds"
)


def _assert_import_loads_none_of(tops: tuple) -> None:
    """Importing every port module loads no module under `tops`."""
    code = (
        f"import sys, {MODULES}\n"
        f"bad = [m for m in sys.modules if m.split('.')[0] in {tops!r}]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def test_import_loads_no_jax():
    _assert_import_loads_none_of(("jax", "flax", "onepose_tpu", "triton"))


def test_import_loads_no_optional_io_package():
    """The card's machine has no h5py (and may lack cv2, yaml, msgpack,
    tensorboard): the port imports each only inside the function that
    needs it."""
    _assert_import_loads_none_of(("h5py", "cv2", "yaml", "msgpack", "tensorboard"))


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_source_names_no_jax(path):
    text = path.read_text()
    hits = [line for line in text.splitlines() if FORBIDDEN.search(line)]
    assert not hits, hits


def test_pipeline_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the no-CUDA error cannot be shown here")
    from onepose_tpu_torch.runtime.pipeline import PosePipeline

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        PosePipeline(device="cuda")


def _cpu_device_defaults(module) -> list:
    """'module.qualname(param)' for each public function, method or class of
    `module`, defined there, whose device parameter defaults to the CPU."""
    import inspect

    def is_cpu(v):
        return (isinstance(v, str) and v.split(":")[0] == "cpu") or (
            isinstance(v, torch.device) and v.type == "cpu")

    found = []
    for name, obj in vars(module).items():
        if name.startswith("_") or getattr(obj, "__module__", None) != module.__name__:
            continue
        members = [(name, obj)]
        if inspect.isclass(obj):
            members += [(f"{name}.{m}", f) for m, f in vars(obj).items()
                        if inspect.isfunction(f) and not (m.startswith("_") and m != "__init__")]
        for qual, fn in members:
            if not callable(fn):
                continue
            try:
                params = inspect.signature(fn).parameters.values()
            except (TypeError, ValueError):
                continue
            found += [f"{module.__name__}.{qual}({p.name})" for p in params
                      if "device" in p.name and is_cpu(p.default)]
    return found


def test_no_public_factory_defaults_to_cpu():
    """Every public function, method and class of the port that takes a
    device defaults to the card: the CPU runs only when the caller names
    it."""
    import importlib

    found = []
    for name in MODULES.split(", "):
        found += _cpu_device_defaults(importlib.import_module(name))
    assert not found, found


def test_create_train_state_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the no-CUDA error cannot be shown here")
    from onepose_tpu_torch.models.gats_spg import GATsSPG
    from onepose_tpu_torch.train.train_step import TrainConfig, create_train_state

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        create_train_state(0, GATsSPG(num_blocks=1), TrainConfig())
