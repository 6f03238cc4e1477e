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


def test_import_loads_no_jax():
    code = (
        "import sys, onepose_tpu_torch, onepose_tpu_torch.runtime, "
        "onepose_tpu_torch.geometry, onepose_tpu_torch.models.bridge, "
        "onepose_tpu_torch.ops.kernels, onepose_tpu_torch.models.superglue, "
        "onepose_tpu_torch.models.nn_matcher, onepose_tpu_torch.parallel.sfm_parallel, "
        "onepose_tpu_torch.sfm, onepose_tpu_torch.sfm.mapping, onepose_tpu_torch.ops.lm, "
        "onepose_tpu_torch.geometry.triangulation, onepose_tpu_torch.native\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'flax', 'onepose_tpu', "
        "'triton')]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


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
