"""`correct` on the CPU at a size a test run holds: the harness's look for
a card is skipped and the rest of a run is driven, the port's plain
paths standing in for its kernels. The control (the reference at the next
precision below the configuration's) and each fault the cells can have,
planted underneath the timed path, must read above a sound run by a wide
margin, and above the cell's limits. `test_run_on_card` runs a cell for
real and skips without a card."""

import json
import os
import subprocess
import sys
import time

import pytest
import torch

from portbench import harness
from portbench.runners import pose_pipeline as serve
from portbench.runners import superglue_pairs as pairs

torch.set_num_threads(2)
ROOT = os.path.dirname(harness.HERE)
MAN = harness.manifest(ROOT)
CPU = torch.device("cpu")


def _serve_cell(name="serve_b64", seed=11):
    c = harness.cell(MAN, name, seed, 0.5, False)
    c.cfg.update(image_size=128, max_keypoints=64, shape3d=128)
    objects = c.traffic["objects"]
    c.traffic.update(batch=2 * objects, pool=2, valid_points=[60 if objects > 1 else 128, 128],
                     sources_per_object=2 if objects == 1 else 1, map_spacing=8)
    return c


def _map_cell(seed=12):
    c = harness.cell(MAN, "map_sg4096", seed, 0.5, False)
    c.cfg.update(image_size=128, max_keypoints=64, pair_chunk_asked=3,
                 num_layers=2, sinkhorn_iterations=20)
    c.traffic.update(frames=6, covis=2, pairs=6)
    return c


def _worst_ratio(bad: dict, good: dict, limits: dict) -> float:
    """The largest reading of `bad` over max(good's reading, a tenth of
    the limit), over the numbers."""
    return max(bad[k] / max(good[k], 0.1 * limits[k], 1e-12) for k in limits)


@pytest.fixture(scope="module")
def sound():
    out = {}
    for name in ("serve_b64", "serve_roster_b64"):
        c = _serve_cell(name)
        out[name] = (c, serve.run(c, CPU, time.perf_counter()))
    c = _map_cell()
    out["map_sg4096"] = (c, pairs.run(c, CPU, time.perf_counter()))
    return out


@pytest.mark.parametrize("name", ["serve_b64", "serve_roster_b64", "map_sg4096"])
def test_sound_run_reads_finite(sound, name):
    c, res = sound[name]
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert set(c.limits) <= set(res["readings"])
    assert all(v >= 0 and v == v for v in res["readings"].values())


def test_serve_control_fails(sound):
    c, good = sound["serve_b64"]
    bad = serve.run(_serve_cell(), CPU, time.perf_counter(), control=serve.CONTROLS["fp8"])
    assert _worst_ratio(bad["readings"], good["readings"], c.limits) >= 3
    assert harness.verdict(bad["readings"], c.limits)[0] is False


def test_map_control_fails(sound):
    c, good = sound["map_sg4096"]
    bad = pairs.run(_map_cell(), CPU, time.perf_counter(), control=pairs.CONTROLS["tf32"])
    assert _worst_ratio(bad["readings"], good["readings"], c.limits) >= 3
    assert harness.verdict(bad["readings"], c.limits)[0] is False


def _keypoints_shifted(monkeypatch):
    from onepose_tpu_torch.runtime import pipeline as rt

    real = rt.extract_keypoints

    def shifted(*a, **k):
        out = real(*a, **k)
        out["keypoints"] = torch.where(out["mask"][..., None], out["keypoints"] + 1.0, 0.0)
        return out

    monkeypatch.setattr(rt, "extract_keypoints", shifted)


def _half_batch(monkeypatch):
    from onepose_tpu_torch.runtime import pipeline as rt

    real = rt.extract_keypoints

    def half(score_map, descriptor_map, **k):
        h = score_map.shape[0] // 2
        out = real(score_map[:h], descriptor_map[:h], **k)
        return {key: torch.cat([v, v]) for key, v in out.items()}

    monkeypatch.setattr(rt, "extract_keypoints", half)


def _pose_altered(monkeypatch):
    from onepose_tpu_torch.runtime import pipeline as rt

    real = rt.ransac_pnp

    def altered(*a, **k):
        out = real(*a, **k)
        out["pose"] = out["pose"].clone()
        out["pose"][:, :3, 3] += 0.05
        return out

    monkeypatch.setattr(rt, "ransac_pnp", altered)


@pytest.mark.parametrize("fault", [_keypoints_shifted, _half_batch, _pose_altered])
def test_serve_faults_fail(sound, monkeypatch, fault):
    c, good = sound["serve_b64"]
    fault(monkeypatch)
    bad = serve.run(_serve_cell(), CPU, time.perf_counter())
    assert _worst_ratio(bad["readings"], good["readings"], c.limits) >= 3
    assert not harness.verdict(bad["readings"], c.limits)[0]


def _assignment_altered(monkeypatch):
    from onepose_tpu_torch.models import superglue as sg

    real = sg.log_sinkhorn

    def altered(*a, **k):
        z = real(*a, **k).clone()
        z[:, 0, :] = z[:, 0, :].flip(-1)
        return z

    monkeypatch.setattr(sg, "log_sinkhorn", altered)


def _half_chunk(monkeypatch):
    from onepose_tpu_torch.models import superglue as sg

    real = sg.SuperGlue.similarity

    def half(self, kpts0, kpts1, desc0, desc1, scores0, scores1, hw0, hw1, mask0, mask1):
        h = -(-kpts0.shape[0] // 2)
        s = real(self, kpts0[:h], kpts1[:h], desc0[:h], desc1[:h], scores0[:h], scores1[:h],
                 hw0, hw1, mask0[:h], mask1[:h])
        return torch.cat([s, s])[:kpts0.shape[0]]

    monkeypatch.setattr(sg.SuperGlue, "similarity", half)


@pytest.mark.parametrize("fault", [_assignment_altered, _half_chunk])
def test_map_faults_fail(sound, monkeypatch, fault):
    c, good = sound["map_sg4096"]
    fault(monkeypatch)
    bad = pairs.run(_map_cell(), CPU, time.perf_counter())
    assert _worst_ratio(bad["readings"], good["readings"], c.limits) >= 3
    assert not harness.verdict(bad["readings"], c.limits)[0]


@pytest.mark.parametrize("name", sorted(pairs.FAULTS))
def test_map_runner_faults_fail(sound, name):
    c, good = sound["map_sg4096"]
    bad = pairs.run(_map_cell(), CPU, time.perf_counter(), fault=pairs.FAULTS[name])
    assert _worst_ratio(bad["readings"], good["readings"], c.limits) >= 3
    assert not harness.verdict(bad["readings"], c.limits)[0]


def test_run_without_a_card_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the refusal is for machines without one")
    p = subprocess.run([sys.executable, os.path.join(harness.HERE, "run.py"), "--workload",
                        "serve_b64", "--seed", "1", "--seconds", "1", "--trace", "0"],
                       capture_output=True, text=True, timeout=300)
    assert p.returncode != 0
    assert not any(line.startswith("{") for line in p.stdout.splitlines())


@pytest.mark.card
@pytest.mark.parametrize("name", [w["name"] for w in MAN["workloads"]])
def test_run_on_card(name):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    p = subprocess.run([sys.executable, os.path.join(harness.HERE, "run.py"), "--workload", name,
                        "--seed", "2147483700", "--seconds", "3", "--trace", "0"],
                       capture_output=True, text=True, timeout=1200)
    assert p.returncode == 0, p.stderr[-2000:]
    result = json.loads(p.stdout.strip().splitlines()[-1])
    assert result["correct"] and result["device"]["platform"] == "gpu"
