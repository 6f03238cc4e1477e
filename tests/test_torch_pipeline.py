"""The port's slice as a whole against the JAX package on the CPU: images
to poses through PosePipeline.

Configuration (the fused serving path with the three kernels on):
SuperPoint(nms kernel) -> extract_keypoints -> GATsSPG(GATs kernel, fused
dual-softmax) -> RANSAC-PnP, fp32, at batch 2, 64 x 64 images, 64 keypoint
slots, 32 3D points x 4 leaves, 2 blocks, 32 hypotheses. JAX runs its
Pallas kernels in interpret mode; the port runs the plain versions of its
CUDA kernels (device="cpu"). Parameters go through the bridge; the RANSAC
draws are JAX's own, injected.

match_threshold is lowered from 0.2 to 0.02 on both sides: with random
weights few pairs clear 0.2, and the comparison needs matches.

Tolerances: keypoints, masks, matches0 and num_inliers identical;
descriptors 1e-5; poses 1e-4 where pnp_ok.

The bf16 serving configuration (SuperPoint with the NMS and VGG-stage
kernels, GATsSPG with the fused block and dual-softmax kernels, the JAX
package's serving default) is compared the same way, with bf16
tolerances: see test_bf16_images_to_poses_matches_jax.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from onepose_tpu.models.gats_spg import GATsSPG as JaxGATsSPG
from onepose_tpu.models.superpoint import SuperPoint as JaxSuperPoint
from onepose_tpu.runtime.pipeline import ObjectAnnotation as JaxAnno
from onepose_tpu.runtime.pipeline import PosePipeline as JaxPipeline
from onepose_tpu.runtime.pipeline import stack_annotations as jax_stack
from onepose_tpu_torch.models import bridge
from onepose_tpu_torch.models.gats_spg import GATsSPG
from onepose_tpu_torch.models.superpoint import SuperPoint
from onepose_tpu_torch.runtime.pipeline import ObjectAnnotation, PosePipeline, stack_annotations

torch.set_num_threads(2)

B, S, KPTS, N3, L, BLOCKS, HYP, THR = 2, 64, 64, 32, 4, 2, 32, 0.02
FIELDS = ("points3d", "desc3d", "leaf_desc", "mask3d", "leaf_mask")


def _anno_np(rng, c=256):
    def unit(x):
        return (x / np.linalg.norm(x, axis=-1, keepdims=True)).astype(np.float32)

    mask3d = np.ones(N3, bool)
    mask3d[-4:] = False
    return dict(
        points3d=((rng.random((N3, 3)) - 0.5) * 0.2).astype(np.float32),
        desc3d=unit(rng.normal(size=(N3, c))),
        leaf_desc=unit(rng.normal(size=(N3, L, c))),
        mask3d=mask3d,
        leaf_mask=rng.random((N3, L)) < 0.8,
    )


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(0)
    images = rng.random((B, S, S, 1)).astype(np.float32)
    K = np.broadcast_to(np.array([[60.0, 0, 32], [0, 60.0, 32], [0, 0, 1]], np.float32),
                        (B, 3, 3)).copy()
    anno = _anno_np(rng)
    jax_anno = JaxAnno(**{k: jnp.asarray(v) for k, v in anno.items()})
    jsp = JaxSuperPoint(nms_pallas=True)
    jm = JaxGATsSPG(num_blocks=BLOCKS, gats_use_pallas=True, fused_match=True,
                    match_threshold=THR)
    sp_params = jsp.init(jax.random.PRNGKey(0), jnp.asarray(images))
    m_params = JaxGATsSPG(num_blocks=BLOCKS).init(
        jax.random.PRNGKey(1), jnp.zeros((1, KPTS, 256)), jax_anno.desc3d[None],
        jax_anno.leaf_desc[None])
    jax_pipe = JaxPipeline(superpoint=jsp, matcher=jm, max_keypoints=KPTS,
                           ransac_hypotheses=HYP, compute_dtype=jnp.float32)
    sp = SuperPoint(nms_kernel=True)
    sp.load_state_dict(bridge.superpoint_state_dict(jax.tree.map(np.asarray, sp_params)))
    m = GATsSPG(num_blocks=BLOCKS, gats_kernel=True, fused_match=True, match_threshold=THR)
    m.load_state_dict(bridge.gats_spg_state_dict(jax.tree.map(np.asarray, m_params)))
    pipe = PosePipeline(superpoint=sp, matcher=m, max_keypoints=KPTS, ransac_hypotheses=HYP,
                        device="cpu")
    return dict(images=images, K=K, anno=anno, jax_anno=jax_anno, sp_params=sp_params,
                m_params=m_params, jax_pipe=jax_pipe, pipe=pipe)


def _draws(key, b=B):
    return torch.from_numpy(np.stack(
        [np.asarray(jax.random.uniform(k, (HYP, 3))) for k in jax.random.split(key, b)]))


def _compare(got, want, features_given=False):
    for k in ("kpt_mask", "matches0", "num_inliers", "pnp_ok", "num_matches"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
    if not features_given:
        np.testing.assert_array_equal(got["keypoints"].numpy(), np.asarray(want["keypoints"]))
        np.testing.assert_allclose(got["descriptors"].numpy(), np.asarray(want["descriptors"]),
                                   atol=1e-5, rtol=0)
    ok = got["pnp_ok"].numpy()
    np.testing.assert_allclose(got["pose"].numpy()[ok], np.asarray(want["pose"])[ok], atol=1e-4)
    np.testing.assert_array_equal(got["inliers"].numpy(), np.asarray(want["inliers"]))


def test_images_to_poses_matches_jax(setup):
    s = setup
    key = jax.random.PRNGKey(5)
    want = s["jax_pipe"](s["sp_params"], s["m_params"], jnp.asarray(s["images"]),
                         jnp.asarray(s["K"]), s["jax_anno"], key)
    anno = ObjectAnnotation(**{k: torch.from_numpy(v) for k, v in s["anno"].items()})
    got = s["pipe"](s["images"], s["K"], anno, draws=_draws(key))
    _compare(got, want)
    assert got["kpt_mask"].sum() > 0 and got["num_matches"].sum() > 0
    assert got["pose"].shape == (B, 4, 4) and torch.isfinite(got["pose"]).all()


def test_from_features_with_batched_annotations_matches_jax(setup):
    """from_features, with one object per frame (stack_annotations)."""
    s = setup
    rng = np.random.default_rng(9)
    other = _anno_np(rng)
    feats_j = jax.jit(lambda p, x: JaxSuperPoint(nms_pallas=True).apply(p, x))(
        s["sp_params"], jnp.asarray(s["images"]))
    from onepose_tpu.models.superpoint import extract_keypoints as jax_extract

    feats = jax_extract(feats_j["score_map"], feats_j["descriptor_map"], max_keypoints=KPTS)
    # Plant matches: the second object's first descriptors are frame 1's.
    other["desc3d"][:8] = np.asarray(feats["descriptors"])[1, :8]
    key = jax.random.PRNGKey(6)
    jax_batched = jax_stack([s["jax_anno"], JaxAnno(**{k: jnp.asarray(v) for k, v in
                                                       other.items()})])
    want = s["jax_pipe"].from_features(s["m_params"], feats, jnp.asarray(s["K"]), jax_batched,
                                       key)
    batched = stack_annotations([
        ObjectAnnotation(**{k: torch.from_numpy(v) for k, v in a.items()})
        for a in (s["anno"], other)
    ])
    assert batched.batched and batched.points3d.shape == (B, N3, 3)
    got = s["pipe"].from_features({k: np.asarray(v) for k, v in feats.items()}, s["K"],
                                  batched, draws=_draws(key))
    _compare(got, want, features_given=True)
    assert int(got["num_matches"][1]) >= 4


@pytest.fixture(scope="module")
def setup_bf16(setup):
    """The bf16 serving configuration with every kernel flag on, on both
    sides, with setup's weights, images and annotation."""
    s = setup
    jsp = JaxSuperPoint(dtype=jnp.bfloat16, nms_pallas=True, use_pallas=True)
    jm = JaxGATsSPG(num_blocks=BLOCKS, dtype=jnp.bfloat16, block_fused=True, fused_match=True,
                    match_threshold=THR)
    jax_pipe = JaxPipeline(superpoint=jsp, matcher=jm, max_keypoints=KPTS, ransac_hypotheses=HYP)
    sp = SuperPoint(dtype=torch.bfloat16, nms_kernel=True, vgg_kernel=True)
    sp.load_state_dict(s["pipe"].superpoint.state_dict())
    m = GATsSPG(num_blocks=BLOCKS, dtype=torch.bfloat16, block_fused=True, fused_match=True,
                match_threshold=THR)
    m.load_state_dict(s["pipe"].matcher.state_dict())
    pipe = PosePipeline(superpoint=sp, matcher=m, max_keypoints=KPTS, ransac_hypotheses=HYP,
                        device="cpu")
    return dict(jax_pipe=jax_pipe, pipe=pipe)


def test_bf16_images_to_poses_matches_jax(setup, setup_bf16):
    """Images to poses in bf16, every kernel flag on, against the JAX
    PosePipeline built the same way.

    From the same images: the kept keypoint scores of each frame, sorted,
    agree within 1e-4 + 1e-2 relative, and every output is finite. Slot
    positions are not compared here: with random weights the score map is
    nearly flat (every score within 0.02 of 1/65), and NMS and top-k turn
    1-ulp bf16 differences into other picks (JAX's own XLA and Pallas bf16
    paths do not agree on every slot either).

    From the same features (the JAX side's bf16 keypoints and
    descriptors), the bf16 matcher and RANSAC-PnP: matches0 agree on at
    least 95% of the slots, and poses agree within 1e-3 on the frames
    whose matches0 are identical (then RANSAC sees the same
    correspondences and the same draws; the solve is fp32 on both sides).
    """
    s = setup
    key = jax.random.PRNGKey(7)
    want = setup_bf16["jax_pipe"](s["sp_params"], s["m_params"], jnp.asarray(s["images"]),
                                  jnp.asarray(s["K"]), s["jax_anno"], key)
    anno = ObjectAnnotation(**{k: torch.from_numpy(v) for k, v in s["anno"].items()})
    got = setup_bf16["pipe"](s["images"], s["K"], anno, draws=_draws(key))
    for k in ("pose", "descriptors", "kpt_scores", "matching_scores0"):
        assert torch.isfinite(got[k]).all(), k
    assert got["pose"].shape == (B, 4, 4) and got["kpt_mask"].sum() > 0
    ws = -np.sort(-np.where(np.asarray(want["kpt_mask"]), np.asarray(want["kpt_scores"]), 0), 1)
    gs = -np.sort(-np.where(got["kpt_mask"].numpy(), got["kpt_scores"].numpy(), 0), 1)
    np.testing.assert_allclose(gs, ws, atol=1e-4, rtol=1e-2)

    feats_j = JaxSuperPoint(dtype=jnp.bfloat16, nms_pallas=True, use_pallas=True).apply(
        s["sp_params"], jnp.asarray(s["images"]))
    from onepose_tpu.models.superpoint import extract_keypoints as jax_extract

    feats = jax_extract(feats_j["score_map"], feats_j["descriptor_map"], max_keypoints=KPTS)
    key = jax.random.PRNGKey(8)
    want = setup_bf16["jax_pipe"].from_features(s["m_params"], feats, jnp.asarray(s["K"]),
                                                s["jax_anno"], key)
    got = setup_bf16["pipe"].from_features({k: np.asarray(v) for k, v in feats.items()}, s["K"],
                                           anno, draws=_draws(key))
    agree = np.mean(got["matches0"].numpy() == np.asarray(want["matches0"]))
    assert agree >= 0.95, agree
    same = np.all(got["matches0"].numpy() == np.asarray(want["matches0"]), axis=-1)
    same &= got["pnp_ok"].numpy() & np.asarray(want["pnp_ok"])
    assert same.any(), "no frame with identical matches to compare poses on"
    np.testing.assert_allclose(got["pose"].numpy()[same], np.asarray(want["pose"])[same],
                               atol=1e-3)
    assert got["num_matches"].sum() > 0


def test_pipeline_defaults_to_cuda_and_fp32_only():
    """Defaults: CUDA, bf16 with the bf16 kernel set (the JAX package's
    serving default); fp32 keeps the fp32 kernel set; fp16 raises."""
    pipe = PosePipeline(device="cpu")
    sp, m = pipe.superpoint, pipe.matcher
    assert sp.dtype == torch.bfloat16 and m.dtype == torch.bfloat16
    assert sp.nms_kernel and sp.vgg_kernel and m.block_fused and m.fused_match
    assert not m.gats_0.gats_kernel
    pipe = PosePipeline(compute_dtype=torch.float32, device="cpu")
    sp, m = pipe.superpoint, pipe.matcher
    assert sp.nms_kernel and not sp.vgg_kernel and m.gats_0.gats_kernel and m.fused_match
    assert not m.block_fused
    with pytest.raises(ValueError, match="bfloat16"):
        PosePipeline(compute_dtype=torch.float16, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            PosePipeline()
