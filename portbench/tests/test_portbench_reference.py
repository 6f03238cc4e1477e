"""The plain reference against the port's plain fp32 path on the CPU, at
small sizes, on the same seeded weights."""

import pytest
import torch

from portbench import scenes, weights
from portbench.reference import nets, ransac

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def sp():
    return nets.zero_mean_filters(weights.make(nets.superpoint_specs(256, 0.0), 1, "cpu"))


def test_superpoint_matches_the_port(sp):
    from onepose_tpu_torch.models.superpoint import SuperPoint, extract_keypoints

    images = scenes._textures(2, 64, torch.Generator().manual_seed(0), "cpu")
    model = SuperPoint()
    model.load_state_dict(sp)
    with torch.no_grad():
        port = model(images)
        ref = nets.superpoint(sp, images, 4)
        assert torch.allclose(port["score_map"], ref["score"], atol=1e-6, rtol=1e-4)
        assert torch.allclose(port["descriptor_map"], ref["desc"], atol=1e-5)
        kp = extract_keypoints(port["score_map"], port["descriptor_map"], 32, 0.005, 4)
        sel = nets.select_keypoints(ref["score"], 32, 0.005, 4)
    assert torch.equal(kp["mask"], sel["mask"])
    assert torch.allclose(kp["scores"], sel["scores"], atol=1e-6)
    m = kp["mask"]
    ours = nets.sample_descriptors(kp["keypoints"], ref["desc"]) * m[..., None]
    assert torch.allclose(kp["descriptors"], ours, atol=1e-5)


def test_gats_spg_matches_the_port():
    from onepose_tpu_torch.models.gats_spg import GATsSPG

    gs = weights.make(nets.gats_spg_specs(256, 2, 0.1), 2, "cpu")
    g = torch.Generator().manual_seed(3)
    d2 = nets.l2_normalize(torch.randn(2, 20, 256, generator=g))
    d3 = nets.l2_normalize(torch.randn(2, 30, 256, generator=g))
    leaves = nets.l2_normalize(torch.randn(2, 30, 4, 256, generator=g))
    m2 = torch.rand(2, 20, generator=g) > 0.2
    m3 = torch.rand(2, 30, generator=g) > 0.2
    lm = torch.rand(2, 30, 4, generator=g) > 0.3
    model = GATsSPG(num_blocks=2)
    model.load_state_dict(gs)
    with torch.no_grad():
        x2p, x3p = model._gnn(d2, d3, leaves, m2, m3, lm)
        out = model(d2, d3, leaves, m2, m3, lm)
        x2, x3 = nets.gats_spg_gnn(gs, d2, d3, leaves, m2, m3, lm, blocks=2)
        conf = nets.gats_spg_conf(gs, x2, x3, m2, m3)
    assert torch.allclose(x2p, x2, atol=1e-5) and torch.allclose(x3p, x3, atol=1e-5)
    assert torch.allclose(out["conf_matrix"], conf, atol=1e-6)
    mm = nets.mutual_matches(conf, 0.2, m2)
    assert torch.equal(out["matches0"].long(), mm["matches0"])


def test_superglue_matches_the_port():
    from onepose_tpu_torch.models.superglue import SuperGlue

    w = weights.make(nets.superglue_specs(256, 2), 4, "cpu")
    g = torch.Generator().manual_seed(5)
    k0, k1 = torch.rand(1, 24, 2, generator=g) * 64, torch.rand(1, 20, 2, generator=g) * 64
    d0 = nets.l2_normalize(torch.randn(1, 24, 256, generator=g))
    d1 = nets.l2_normalize(torch.randn(1, 20, 256, generator=g))
    s0, s1 = torch.rand(1, 24, generator=g), torch.rand(1, 20, generator=g)
    m0, m1 = torch.rand(1, 24, generator=g) > 0.2, torch.rand(1, 20, generator=g) > 0.2
    model = SuperGlue(num_layers=2, sinkhorn_iterations=30)
    model.load_state_dict(w)
    with torch.no_grad():
        out = model(k0, k1, d0, d1, s0, s1, (64, 64), (64, 64), m0, m1)
        sim = nets.superglue_scores(w, k0, k1, d0, d1, s0, s1, (64, 64), m0, m1, layers=2)
        z = nets.log_sinkhorn(sim, w["bin_score"], m0, m1, 30)
    assert torch.allclose(out["log_assignment"], z, atol=1e-4)


def test_ransac_matches_the_port():
    from onepose_tpu_torch.geometry.ransac import ransac_pnp

    g = torch.Generator().manual_seed(6)
    pts3d = torch.randn(2, 40, 3, generator=g) * 0.1 + torch.tensor([0.0, 0.0, 0.5])
    K = torch.tensor([[500.0, 0, 64], [0, 500.0, 64], [0, 0, 1]]).expand(2, 3, 3)
    uv = pts3d @ K[0].T
    pts2d = uv[..., :2] / uv[..., 2:] + torch.randn(2, 40, 2, generator=g) * 0.5
    mask = torch.rand(2, 40, generator=g) > 0.1
    draws = torch.rand(2, 64, 3, generator=g)
    a = ransac_pnp(pts2d, pts3d, K, mask, draws=draws, n_hyp=64)
    b = ransac.ransac_pnp(pts2d, pts3d, K, mask, draws=draws, n_hyp=64)
    assert torch.equal(a["num_inliers"], b["num_inliers"]) and bool(b["ok"].all())
    assert torch.allclose(a["pose"], b["pose"], atol=1e-6)


def test_fp8_round_is_coarser_than_bf16():
    x = torch.randn(1000, generator=torch.Generator().manual_seed(7))
    e8 = (nets.fp8_round(x) - x).abs().max()
    e16 = (x.to(torch.bfloat16).float() - x).abs().max()
    assert e8 > 8 * e16
