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
    "onepose_tpu_torch.cli.infer, onepose_tpu_torch.cli.detect_cmd"
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
    """The card's machine has no h5py (and may lack cv2, yaml, msgpack): the
    port imports each only inside the function that needs it."""
    _assert_import_loads_none_of(("h5py", "cv2", "yaml", "msgpack"))


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
