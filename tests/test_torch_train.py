"""The port's training stack against the JAX package's, on the CPU.

Each test feeds numpy inputs from a seed to both packages at small shapes
(GATsSPG with 1 block at d_model 256, 32 keypoint slots, 48 points, 4
leaves); weights cross through `models.bridge`, checkpoints through each
package's own codec. What they hold:
- K2's autograd.Function (plain forward injected) against jax.grad through
  the JAX package's custom VJP (its Pallas forward in interpret mode);
- the focal loss, the loss metrics, the lr schedule, the clip and the
  whole optimizer (clip, Adam, MultiSteps) against optax, its state in
  optax's layout;
- the train step over 3 micro-steps for accumulate 1 and 2: losses to 1e-4
  relative, the first step's gradients, the parameters after (Adam turns
  the sign of a near-zero gradient into a full lr step, so they are held
  to a few lr);
- the dataset's items and the batch order, byte for byte;
- each callback's files; the checkpoints across the packages both ways.

JAX compilations are shared through module-scoped fixtures.
"""

import json
import zipfile

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import serialization

from onepose_tpu.data import dataset as jax_dataset
from onepose_tpu.models.gats_spg import GATsSPG as JaxGATsSPG
from onepose_tpu.ops.pallas.gats import gats_leaf_attention as jax_gats
from onepose_tpu.train import callbacks as jax_callbacks
from onepose_tpu.train import losses as jax_losses
from onepose_tpu.train import train_step as jts
from onepose_tpu.utils import checkpoint as jax_ckpt
from onepose_tpu_torch.data import dataset as port_dataset
from onepose_tpu_torch.data.anno_io import save_anno2d, save_anno2d_npz, write_anno_index
from onepose_tpu_torch.models import bridge
from onepose_tpu_torch.models.gats_spg import GATsSPG
from onepose_tpu_torch.ops.kernels import gats as port_gats
from onepose_tpu_torch.train import callbacks as port_callbacks
from onepose_tpu_torch.train import losses as port_losses
from onepose_tpu_torch.train import train_step as pts
from onepose_tpu_torch.utils import checkpoint as port_ckpt

torch.set_num_threads(2)

SHAPES = dict(b=2, n2=32, n3=48, L=4, C=256)
STEPS = 3
LR = 1e-3
LOSS_REL = 1e-4  # ROADMAP A11's criterion for the loss history
GRAD_ABS, GRAD_REL = 1e-5, 1e-4  # fp32 sums in another order
PARAM_LRS = 5  # parameters after STEPS updates, in units of lr


def write_annotations(root, rng, frames=6, points=40, C=256, kpts=(20, 40), hw=(96, 128),
                      fmt="npz"):
    """A map's annotations as `map` writes them: the object's 3D artifacts,
    one 2D annotation per frame (some with more keypoints than a small
    shape2d, points seen from 1 to 6 frames: fewer and more than the
    leaves) and anno_index.json with the image sizes. Returns the index."""
    anno = root / "anno"
    anno.mkdir(parents=True)
    unit = lambda x: (x / np.linalg.norm(x, axis=-1, keepdims=True)).astype(np.float32)
    counts = rng.integers(1, 7, points)
    desc_concat = unit(rng.normal(size=(int(counts.sum()), C)))
    bounds = np.concatenate([[0], np.cumsum(counts)])
    desc_avg = unit(np.stack([desc_concat[s:e].mean(0) for s, e in zip(bounds, bounds[1:])]))
    xyz = rng.normal(size=(points, 3)).astype(np.float32) * 0.1
    np.savez(anno / "anno_3d_average.npz", keypoints3d=xyz, descriptors3d=desc_avg.T,
             scores3d=rng.random((points, 1)).astype(np.float32))
    np.savez(anno / "anno_3d_collect.npz", keypoints3d=xyz, descriptors3d=desc_concat.T,
             scores3d=rng.random((len(desc_concat), 1)).astype(np.float32))
    np.save(anno / "idxs.npy", counts)
    entries = []
    save = save_anno2d_npz if fmt == "npz" else save_anno2d
    for f in range(frames):
        n = int(rng.integers(*kpts))
        m = min(n, points) // 2
        assign = np.stack([rng.permutation(n)[:m], rng.permutation(points)[:m]])
        kp = (rng.random((n, 2)) * [hw[1], hw[0]]).astype(np.float32)
        desc = unit(rng.normal(size=(n, C)))
        desc[assign[0]] = unit(desc_avg[assign[1]] + 0.3 * desc[assign[0]])
        path = str(anno / f"{f}.{fmt}")
        save(path, kp, desc, rng.random(n).astype(np.float32), assign)
        entries.append({"anno_id": f + 1, "anno_file": path, "anno3d_dir": str(anno),
                        "img_file": str(root / "color" / f"{f}.png"),
                        "pose_file": str(root / "poses_ba" / f"{f}.txt"),
                        "height": hw[0], "width": hw[1]})
    index = str(anno / "anno_index.json")
    write_anno_index(index, entries)
    return index


def _batch(rng, b, n2, n3, L, C):
    """A train batch: descriptors, masks, a ground truth of n2 // 2 matches."""
    conf = np.zeros((b, n2, n3), np.float32)
    for i in range(b):
        conf[i, np.arange(n2 // 2), rng.permutation(n3)[:n2 // 2]] = 1.0
    d = lambda *s: rng.normal(size=s).astype(np.float32)
    return dict(desc2d=d(b, n2, C), desc3d=d(b, n3, C), leaf_desc=d(b, n3, L, C),
                mask2d=rng.random((b, n2)) < 0.9, mask3d=rng.random((b, n3)) < 0.9,
                leaf_mask=rng.random((b, n3, L)) < 0.8, conf_gt=conf)


def _jnp(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _torch(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def _port_state(jax_params, accumulate, weight_decay=0.0):
    model = GATsSPG(num_blocks=1, gats_kernel=True, fused_match=False)
    model.load_state_dict(bridge.gats_spg_state_dict(jax.tree.map(np.asarray, jax_params)))
    cfg = pts.TrainConfig(accumulate=accumulate, steps_per_epoch=10, weight_decay=weight_decay)
    return pts.TrainState(model, pts.make_optimizer(cfg, model)), cfg


def _tree_max_abs(a, b):
    la, lb = jax.tree.leaves(a), jax.tree.leaves(b)
    assert len(la) == len(lb)
    return max(float(np.max(np.abs(np.asarray(x, np.float64) - np.asarray(y, np.float64))))
               for x, y in zip(la, lb))


@pytest.fixture(scope="module")
def batches():
    rng = np.random.default_rng(0)
    return [_batch(rng, **SHAPES) for _ in range(STEPS)]


@pytest.fixture(scope="module")
def jax_runs(batches):
    """For accumulate 1 and 2: the JAX state before and after STEPS
    micro-steps, its metrics each step, and the first batch's gradients."""
    runs = {}
    model = JaxGATsSPG(num_blocks=1, fused_match=False)
    for acc in (1, 2):
        cfg = jts.TrainConfig(accumulate=acc, steps_per_epoch=10)
        state0 = jts.create_train_state(jax.random.PRNGKey(0), model, cfg, _jnp(batches[0]))
        step = jax.jit(jts.make_train_step(model, cfg))
        state, metrics = state0, []
        for b in batches:
            state, m = step(state, _jnp(b))
            metrics.append({k: float(v) for k, v in m.items()})
        runs[acc] = dict(state0=state0, state=state, metrics=metrics)
    grad = jax.grad(lambda p: jts.loss_fn(p, model.apply, _jnp(batches[0]),
                                          jts.TrainConfig())[0])
    runs["grads0"] = jax.tree.map(np.asarray, grad(runs[1]["state0"].params))
    return runs


# -- K2 with a gradient -------------------------------------------------------


@pytest.mark.parametrize("masked", [True, False], ids=["masked", "unmasked"])
def test_gats_function_gradients_match_jax(masked):
    """GatsLeafAttention (plain forward injected, as the kernel is on the
    card) against jax.grad through the JAX package's custom VJP, for the
    leaves, d3, W and a; and the same gradients as autograd through the
    plain version."""
    rng = np.random.default_rng(1)
    b, n3, L, C = 2, 6, 3, 256
    leaf = rng.normal(size=(b, n3, L, C)).astype(np.float32)
    d3 = rng.normal(size=(b, n3, C)).astype(np.float32)
    W = (rng.normal(size=(C, C)) * 0.06).astype(np.float32)
    a2 = (rng.normal(size=(2, C)) * 0.06).astype(np.float32)
    mask = rng.random((b, n3, L)) < 0.7 if masked else None
    cot = rng.normal(size=(b, n3, C)).astype(np.float32)

    def jloss(l, d, w, a):
        return jnp.sum(jax_gats(l, d, None if mask is None else jnp.asarray(mask), w, a, 0.2)
                       * cot)

    want = jax.grad(jloss, argnums=(0, 1, 2, 3))(leaf, d3, W, a2)
    mask_add = port_gats.additive_mask(None if mask is None else torch.from_numpy(mask))

    def port_grads(fn):
        ts = [torch.tensor(x, requires_grad=True) for x in (leaf, d3, W, a2)]
        out = fn(ts[0], ts[1], port_gats.leaf_logit_vectors(ts[2], ts[3]))
        (out * torch.from_numpy(cot)).sum().backward()
        return [t.grad.numpy() for t in ts]

    got = port_grads(lambda l, d, wa: port_gats.GatsLeafAttention.apply(
        l, d, mask_add, wa, 0.2, port_gats.gats_leaf_attention_plain))
    plain = port_grads(lambda l, d, wa: port_gats.gats_leaf_attention_plain(l, d, mask_add, wa))
    for name, g, p, w in zip(("leaves", "desc3d", "W", "a"), got, plain, want):
        np.testing.assert_allclose(g, np.asarray(w), atol=GRAD_ABS, rtol=GRAD_REL, err_msg=name)
        np.testing.assert_array_equal(g, p, err_msg=name)


def test_gats_function_takes_no_mask_gradient():
    """The backward returns gradients only where the forward's inputs need
    them (none for the mask, none for data leaves), and its forward gets
    detached inputs (a CUDA kernel input must not require grad)."""
    rng = np.random.default_rng(2)
    leaf = torch.from_numpy(rng.normal(size=(1, 5, 3, 8)).astype(np.float32))
    d3 = torch.tensor(rng.normal(size=(1, 5, 8)).astype(np.float32), requires_grad=True)
    wa = torch.tensor(rng.normal(size=(2, 8)).astype(np.float32), requires_grad=True)
    mask_add = port_gats.additive_mask(torch.from_numpy(rng.random((1, 5, 3)) < 0.5))
    seen = []

    def forward(*args):
        seen.extend(t.requires_grad for t in args if isinstance(t, torch.Tensor))
        return port_gats.gats_leaf_attention_plain(*args)

    out = port_gats.GatsLeafAttention.apply(leaf, d3, mask_add, wa, 0.2, forward)
    out.sum().backward()
    assert seen and not any(seen)
    assert leaf.grad is None and d3.grad is not None and wa.grad is not None


# -- loss, schedule, clip and optimizer ---------------------------------------


@pytest.mark.parametrize("masked", [False, True], ids=["all_slots", "valid_mask"])
def test_focal_loss_matches_jax(masked):
    rng = np.random.default_rng(3)
    conf = rng.random((2, 9, 11)).astype(np.float32)
    conf[0, 0, :4] = [0.0, 1.0, 1e-9, 1 - 1e-9]  # beyond the clip on both sides
    target = (rng.random((2, 9, 11)) < 0.2).astype(np.float32)
    target[1] = 0.0  # no positive in one frame
    valid = rng.random((2, 9, 11)) < 0.7 if masked else None
    jl, jg = jax.value_and_grad(lambda c: jax_losses.focal_loss(
        c, jnp.asarray(target), valid_mask=None if valid is None else jnp.asarray(valid)))(conf)
    tc = torch.tensor(conf, requires_grad=True)
    pl = port_losses.focal_loss(tc, torch.from_numpy(target),
                                valid_mask=None if valid is None else torch.from_numpy(valid))
    pl.backward()
    np.testing.assert_allclose(float(pl.detach()), float(jl), rtol=1e-6)
    np.testing.assert_allclose(tc.grad.numpy(), np.asarray(jg), rtol=1e-5, atol=1e-9)
    # no positive anywhere: the positive side contributes zero, still finite
    empty = port_losses.focal_loss(torch.from_numpy(conf), torch.zeros(2, 9, 11))
    np.testing.assert_allclose(float(empty), float(jax_losses.focal_loss(
        conf, jnp.zeros((2, 9, 11)))), rtol=1e-6)


def test_loss_metrics_match_jax():
    """Precision and recall at the thresholds 0.2 (conf) and 0.5 (truth),
    on a conf matrix with values on both sides of them."""
    rng = np.random.default_rng(4)
    conf = rng.choice([0.1, 0.19, 0.2, 0.21, 0.6], size=(2, 7, 9)).astype(np.float32)
    gt = (rng.random((2, 7, 9)) < 0.3).astype(np.float32)
    batch = {k: np.zeros(1, np.float32) for k in ("desc2d", "desc3d", "leaf_desc")}
    batch["conf_gt"] = gt
    _, jm = jts.loss_fn(None, lambda *a: {"conf_matrix": jnp.asarray(conf)}, _jnp(batch),
                        jts.TrainConfig())
    _, pm = pts.loss_fn(lambda *a: {"conf_matrix": torch.from_numpy(conf)}, _torch(batch),
                        pts.TrainConfig())
    for k in ("loss", "precision", "recall"):
        np.testing.assert_allclose(float(pm[k]), float(jm[k]), rtol=1e-6, err_msg=k)
    assert 0 < float(pm["precision"]) < 1 and 0 < float(pm["recall"]) < 1


@pytest.mark.parametrize("accumulate", [1, 2])
def test_lr_schedule_matches_optax(accumulate):
    """The numbers of tests/test_pipeline.py::TestTraining::
    test_lr_milestones_respect_accumulation: 1e-3 at 5 * upe - 1, 5e-4 at
    5 * upe, 2.5e-4 at 10 * upe updates; every count against optax's; and
    after 5 epochs of micro-batches the optimizer's update count sits at
    the first milestone."""
    cfg = pts.TrainConfig(lr=1e-3, lr_gamma=0.5, milestones=(5, 10), steps_per_epoch=100,
                          accumulate=accumulate)
    sched = pts.make_lr_schedule(cfg)
    jsched = jts.make_lr_schedule(jts.TrainConfig(**vars(cfg)))
    upe = cfg.steps_per_epoch // accumulate
    np.testing.assert_allclose(sched(5 * upe - 1), 1e-3, rtol=1e-6)
    np.testing.assert_allclose(sched(5 * upe), 5e-4, rtol=1e-6)
    np.testing.assert_allclose(sched(10 * upe), 2.5e-4, rtol=1e-6)
    for c in range(0, 12 * upe, 7):
        np.testing.assert_allclose(sched(c), float(jsched(c)), rtol=1e-6)
    p = torch.nn.Parameter(torch.zeros(4))
    opt = pts.Optimizer([p], ["w.W"], cfg)
    for _ in range(5 * cfg.steps_per_epoch):
        opt.update([torch.ones(4)])
    assert opt.count == 5 * cfg.steps_per_epoch // accumulate
    np.testing.assert_allclose(sched(opt.count), 5e-4, rtol=1e-6)


@pytest.mark.parametrize("scale", [0.01, 1.0, 30.0], ids=["below", "near", "above"])
def test_clip_matches_optax(scale):
    rng = np.random.default_rng(5)
    grads = [(rng.normal(size=s) * scale).astype(np.float32) for s in ((3, 4), (7,), (2, 2, 2))]
    want, _ = optax.clip_by_global_norm(0.5).update(grads, optax.EmptyState())
    got = pts.clip_by_global_norm([torch.from_numpy(g) for g in grads], 0.5)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-9)
    np.testing.assert_allclose(float(pts.global_norm([torch.from_numpy(g) for g in grads])),
                               float(optax.global_norm(grads)), rtol=1e-6)


@pytest.mark.parametrize("accumulate,weight_decay", [(1, 0.0), (2, 0.0), (3, 0.0), (2, 1e-2)],
                         ids=["adam", "adam_acc2", "adam_acc3", "adamw_acc2"])
def test_optimizer_matches_optax(accumulate, weight_decay):
    """Clip, Adam (AdamW) and MultiSteps against JAX's make_optimizer on
    gradients that cross the clip norm: the parameters after 7 micro-steps,
    and the state in optax's layout as flax serializes it (keys, counts,
    moments, the accumulated gradients)."""
    rng = np.random.default_rng(6)
    jparams = {"params": {"lin": {"kernel": rng.normal(size=(3, 4)).astype(np.float32)},
                          "g": {"W": rng.normal(size=(5,)).astype(np.float32)}}}
    cfg = pts.TrainConfig(accumulate=accumulate, weight_decay=weight_decay, steps_per_epoch=4,
                          milestones=(1, 2))
    tx = jts.make_optimizer(jts.TrainConfig(**vars(cfg)))
    jstate = tx.init(jparams)
    ps = [torch.nn.Parameter(torch.tensor(jparams["params"]["lin"]["kernel"].T.copy())),
          torch.nn.Parameter(torch.tensor(jparams["params"]["g"]["W"]))]
    opt = pts.Optimizer(ps, ["lin.weight", "g.W"], cfg)
    for i in range(7):
        s = 0.3 if i % 2 else 3.0  # global norms on both sides of 0.5
        g = {"params": {"lin": {"kernel": (rng.normal(size=(3, 4)) * s).astype(np.float32)},
                        "g": {"W": (rng.normal(size=(5,)) * s).astype(np.float32)}}}
        upd, jstate = tx.update(g, jstate, jparams)
        jparams = optax.apply_updates(jparams, upd)
        opt.update([torch.tensor(g["params"]["lin"]["kernel"].T.copy()),
                    torch.tensor(g["params"]["g"]["W"])])
    np.testing.assert_allclose(ps[0].detach().numpy().T, jparams["params"]["lin"]["kernel"],
                               atol=1e-6)
    np.testing.assert_allclose(ps[1].detach().numpy(), jparams["params"]["g"]["W"], atol=1e-6)
    want = jax.tree.map(np.asarray, serialization.to_state_dict(jstate))
    got = opt.jax_state()
    assert jax.tree.structure(got) == jax.tree.structure(want)
    assert _tree_max_abs(got, want) < 1e-5
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        assert a.dtype == b.dtype and a.shape == b.shape


# -- the train step -------------------------------------------------------------


@pytest.mark.parametrize("accumulate", [1, 2])
def test_train_step_matches_jax(accumulate, batches, jax_runs):
    run = jax_runs[accumulate]
    state, _ = _port_state(run["state0"].params, accumulate)
    # the eval step at the initial parameters gives the first step's metrics
    ev = pts.make_eval_step(state.model, state.tx.cfg)(state, _torch(batches[0]))
    for k in ("loss", "precision", "recall"):
        np.testing.assert_allclose(float(ev[k]), run["metrics"][0][k], rtol=LOSS_REL, err_msg=k)
    step = pts.make_train_step(state.model, state.tx.cfg)
    got = []
    for b in batches:
        state, m = step(state, _torch(b))
        got.append({k: float(v) for k, v in m.items()})
    for g, w in zip(got, run["metrics"]):
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(g[k], w[k], rtol=LOSS_REL, err_msg=k)
        for k in ("precision", "recall"):
            assert g[k] == w[k], k
    assert state.step == STEPS == int(run["state"].step)
    diff = _tree_max_abs(state.state_dict()["params"],
                         jax.tree.map(np.asarray, run["state"].params))
    assert diff < PARAM_LRS * LR, f"parameters differ by {diff:.3e} after {STEPS} steps"


def test_first_step_gradients_match_jax(batches, jax_runs):
    state, cfg = _port_state(jax_runs[1]["state0"].params, 1)
    params = list(state.tx.params)
    loss, _ = pts.loss_fn(state.model, _torch(batches[0]), cfg)
    grads = torch.autograd.grad(loss, params)
    got = bridge.state_dict_to_jax(dict(zip(state.tx.names, grads)))
    want = jax_runs["grads0"]
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_allclose(a, b, atol=GRAD_ABS, rtol=GRAD_REL)


# -- checkpoints across the packages --------------------------------------------


@pytest.mark.parametrize("accumulate", [1, 2])
def test_port_checkpoint_loads_in_jax(accumulate, batches, jax_runs, tmp_path):
    """A port checkpoint after STEPS micro-steps restores into JAX's train
    state through its own load_checkpoint: every leaf, counts included."""
    run = jax_runs[accumulate]
    state, _ = _port_state(run["state0"].params, accumulate)
    step = pts.make_train_step(state.model, state.tx.cfg)
    for b in batches:
        state, _ = step(state, _torch(b))
    path = port_ckpt.save_checkpoint(str(tmp_path), state.state_dict(), 0)
    restored = jax_ckpt.load_checkpoint(path, run["state0"])
    got = jax.tree.map(np.asarray, serialization.to_state_dict(restored))
    want = state.state_dict()
    assert jax.tree.structure(got) == jax.tree.structure(want)
    assert _tree_max_abs(got, want) == 0.0
    assert int(restored.step) == STEPS
    # and it trains on in JAX
    jstep = jax.jit(jts.make_train_step(JaxGATsSPG(num_blocks=1, fused_match=False),
                                        jts.TrainConfig(accumulate=accumulate,
                                                        steps_per_epoch=10)))
    _, m = jstep(restored, _jnp(batches[0]))
    assert np.isfinite(float(m["loss"]))


@pytest.mark.parametrize("accumulate", [1, 2])
def test_port_resumes_a_jax_checkpoint(accumulate, jax_runs, tmp_path):
    """JAX's checkpoint after STEPS micro-steps into the port's state: the
    port writes back the same tree."""
    run = jax_runs[accumulate]
    path = jax_ckpt.save_checkpoint(str(tmp_path), run["state"], 0)
    state, _ = _port_state(run["state0"].params, accumulate)
    state.load_state_dict(port_ckpt.load_checkpoint(path, state.state_dict()))
    want = jax.tree.map(np.asarray, serialization.to_state_dict(run["state"]))
    got = state.state_dict()
    assert jax.tree.structure(got) == jax.tree.structure(want)
    assert _tree_max_abs(got, want) == 0.0
    assert state.step == STEPS and state.tx.count == STEPS // accumulate


def test_bridge_round_trips(jax_runs):
    """JAX params -> port state_dict -> JAX params, and the port's own
    state_dict -> JAX -> port, exactly."""
    jparams = jax.tree.map(np.asarray, jax_runs[1]["state0"].params)
    back = bridge.gats_spg_params(bridge.gats_spg_state_dict(jparams))
    assert jax.tree.structure(back) == jax.tree.structure(jparams)
    assert _tree_max_abs(back, jparams) == 0.0
    sd = pts.init_params(GATsSPG(num_blocks=2), seed=7).state_dict()
    again = bridge.gats_spg_state_dict(bridge.gats_spg_params(sd))
    assert set(again) == set(sd)
    for k in sd:
        assert torch.equal(again[k], sd[k]), k


def test_init_params_is_seeded():
    a = pts.init_params(GATsSPG(num_blocks=1), 3).state_dict()
    b = pts.init_params(GATsSPG(num_blocks=1), 3).state_dict()
    c = pts.init_params(GATsSPG(num_blocks=1), 4).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["gats_0.W"], c["gats_0.W"])
    assert not torch.equal(a["final_proj.weight"], c["final_proj.weight"])


# -- the dataset --------------------------------------------------------------


@pytest.mark.parametrize("fmt", ["npz", "json"])
def test_dataset_matches_jax(fmt, tmp_path):
    """Items and batches, byte for byte, in the loop's order of draws: the
    example batch, then two epochs shuffled by seed + epoch."""
    index = write_annotations(tmp_path, np.random.default_rng(8), frames=7, fmt=fmt)
    kw = dict(num_leaf=4, shape2d=32, shape3d=48, seed=11)
    jds, pds = jax_dataset.GATsSPGDataset(index, **kw), port_dataset.GATsSPGDataset(index, **kw)
    seeds = [0, 21, 22]
    for s in seeds:
        jb = list(jax_dataset.batch_iterator(jds, 2, seed=s))
        pb = list(port_dataset.batch_iterator(pds, 2, seed=s))
        assert len(jb) == len(pb) == 3
        for a, b in zip(jb, pb):
            assert set(a) == set(b)
            for k in a:
                assert a[k].dtype == b[k].dtype, k
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    item = pds[0]
    assert item["leaf_mask"].any() and not item["leaf_mask"].all()
    assert item["conf_gt"].sum() > 0


def test_prefetch_to_device_keeps_order_and_values():
    rng = np.random.default_rng(9)
    batches = [{"x": rng.normal(size=(2, 3)).astype(np.float32), "m": rng.random(4) < 0.5}
               for _ in range(5)]
    out = list(port_dataset.prefetch_to_device(iter(batches), device="cpu"))
    assert len(out) == 5
    for a, b in zip(batches, out):
        np.testing.assert_array_equal(a["x"], b["x"].numpy())
        np.testing.assert_array_equal(a["m"], b["m"].numpy())


# -- callbacks ------------------------------------------------------------------


def _records():
    return [{"epoch": 0, "train_loss": 2.0, "val_cmd5": 0.3, "epoch_seconds": 1.0},
            {"epoch": 1, "train_loss": 2.5, "val_cmd5": 0.5, "epoch_seconds": 0.9},
            {"epoch": 2, "train_loss": 1.5, "val_cmd5": 0.4, "epoch_seconds": 1.1}]


def test_best_metric_tracker_writes_jax_file(tmp_path):
    files = []
    for mod, d in ((jax_callbacks, tmp_path / "jax"), (port_callbacks, tmp_path / "port")):
        cb = mod.BestMetricTracker()
        cb.on_train_start(str(d), {})
        for r in _records():
            cb.on_epoch_end(r["epoch"], dict(r), None)
        files.append(json.loads((d / "best_metrics.json").read_text()))
    assert files[0] == files[1] == {"train_loss": 1.5, "val_cmd5": 0.5, "epoch_seconds": 1.1}


def test_best_checkpoint_and_hparams(batches, jax_runs, tmp_path):
    """best.msgpack holds the whole train state (JAX's load_checkpoint takes
    it) from the best epoch; best.json names it; hparams.json counts the
    parameters as the JAX package does."""
    state, _ = _port_state(jax_runs[2]["state0"].params, 2)
    step = pts.make_train_step(state.model, state.tx.cfg)
    cb = port_callbacks.BestCheckpoint(str(tmp_path / "ckpt"), monitor="train_loss")
    kept = None
    for r, b in zip(_records(), batches):
        state, _ = step(state, _torch(b))
        cb.on_epoch_end(r["epoch"], r, state)
        if r["train_loss"] == 1.5:
            kept = state.state_dict()
    assert json.loads((tmp_path / "ckpt" / "best.json").read_text()) == {
        "epoch": 2, "train_loss": 1.5}
    restored = jax_ckpt.load_checkpoint(str(tmp_path / "ckpt" / "best.msgpack"),
                                        jax_runs[2]["state0"])
    assert _tree_max_abs(jax.tree.map(np.asarray, serialization.to_state_dict(restored)),
                         kept) == 0.0
    rec = port_callbacks.log_hyperparameters(str(tmp_path), {"lr": 1e-3}, state)
    want = jax_callbacks.count_parameters(jax_runs[2]["state0"].params)
    assert rec["model/params_total"] == want
    assert json.loads((tmp_path / "hparams.json").read_text())["model/params_total"] == want


def test_code_snapshot_zips_the_port(tmp_path):
    port_callbacks.CodeSnapshot().on_train_start(str(tmp_path), {})
    with zipfile.ZipFile(tmp_path / "code_snapshot.zip") as zf:
        names = set(zf.namelist())
    for want in ("onepose_tpu_torch/train/loop.py", "onepose_tpu_torch/csrc/gats.cu",
                 "onepose_tpu_torch/cli/train_cmd.py"):
        assert want in names
    assert not any(n.startswith("onepose_tpu/") for n in names)


def test_tensorboard_logger_writes_events(tmp_path):
    pytest.importorskip("tensorboard")
    cb = port_callbacks.TensorBoardLogger(str(tmp_path / "tb"))
    cb.on_train_start(str(tmp_path), {"lr": 1e-3})
    for r in _records():
        cb.on_epoch_end(r["epoch"], r, None)
    cb.on_train_end(_records())
    assert list((tmp_path / "tb").glob("events.out.tfevents.*"))


def test_tensorboard_logger_without_the_package(tmp_path, monkeypatch):
    """Where torch.utils.tensorboard cannot be imported the logger writes
    nothing and raises nothing (the JAX package's behaviour)."""
    import builtins

    real = builtins.__import__

    def refuse(name, *a, **k):
        if name.startswith("torch.utils.tensorboard"):
            raise ImportError(name)
        return real(name, *a, **k)

    monkeypatch.setattr(builtins, "__import__", refuse)
    cb = port_callbacks.TensorBoardLogger(str(tmp_path / "tb"))
    cb.on_train_start(str(tmp_path), {})
    cb.on_epoch_end(0, _records()[0], None)
    cb.on_train_end([])
    assert not (tmp_path / "tb").exists()


def test_model_callbacks_match_jax(batches, jax_runs, tmp_path):
    """MatchPRCurve, ConfusionMatrixLogger and GradientWatch on one held-out
    batch under the same parameters: the same records and files."""
    jstate = jax_runs[1]["state0"]
    jmodel = JaxGATsSPG(num_blocks=1, fused_match=False)
    pstate, _ = _port_state(jstate.params, 1)
    b = batches[1]
    b = dict(b, conf_gt=np.where(b["conf_gt"] > 0, 1.0, 0.0).astype(np.float32))
    made = {}
    for pkg, mod, st, model in (
            ("jax", jax_callbacks, jstate, jmodel),
            ("port", port_callbacks, pstate, GATsSPG(num_blocks=1, fused_match=False))):
        d = tmp_path / pkg
        batch = _jnp(b) if pkg == "jax" else b
        cbs = [mod.MatchPRCurve(batch, model, run_dir=str(d)),
               mod.ConfusionMatrixLogger(batch, model, threshold=0.001, run_dir=str(d)),
               mod.GradientWatch(batch, model, run_dir=str(d))]
        rec = {"epoch": 0}
        for cb in cbs:
            cb.on_train_start(str(d), {})
            cb.on_epoch_end(0, rec, st)
        made[pkg] = (rec, {p: json.loads((d / p).read_text()) for p in (
            "pr_curve_epoch0.json", "confusion_epoch0.json", "watch_epoch0.json")})
    (jrec, jfiles), (prec, pfiles) = made["jax"], made["port"]
    assert set(jrec) == set(prec)
    for k in jrec:
        np.testing.assert_allclose(prec[k], jrec[k], rtol=1e-4, err_msg=k)
    assert pfiles["confusion_epoch0.json"] == jfiles["confusion_epoch0.json"]
    assert pfiles["pr_curve_epoch0.json"] == jfiles["pr_curve_epoch0.json"]
    jw, pw = jfiles["watch_epoch0.json"], pfiles["watch_epoch0.json"]
    assert set(pw) == set(jw)
    for k in jw:
        np.testing.assert_allclose(pw[k], jw[k], rtol=1e-4, err_msg=k)


def test_match_metrics_match_jax():
    rng = np.random.default_rng(10)
    conf = rng.random((2, 6, 9)).astype(np.float32) ** 3
    gt = (rng.random((2, 6, 9)) < 0.2).astype(np.float32)
    assert port_callbacks.match_pr_curve(conf, gt) == jax_callbacks.match_pr_curve(conf, gt)
    for t in (0.05, 0.2):
        assert (port_callbacks.match_confusion(conf, gt, t)
                == jax_callbacks.match_confusion(conf, gt, t))


def test_dataset_pose_items(tmp_path):
    """load_pose_gt adds pose_gt and K, read as the JAX package reads them."""
    index = write_annotations(tmp_path, np.random.default_rng(12), frames=2)
    for f in range(2):
        (tmp_path / "poses_ba").mkdir(exist_ok=True)
        (tmp_path / "intrin_ba").mkdir(exist_ok=True)
        np.savetxt(tmp_path / "poses_ba" / f"{f}.txt", np.eye(4) * (f + 1))
        np.savetxt(tmp_path / "intrin_ba" / f"{f}.txt", np.eye(3) * (f + 2))
    kw = dict(num_leaf=4, shape2d=32, shape3d=48, seed=1, load_pose_gt=True)
    a = jax_dataset.GATsSPGDataset(index, **kw)[1]
    b = port_dataset.GATsSPGDataset(index, **kw)[1]
    for k in ("pose_gt", "K"):
        np.testing.assert_array_equal(a[k], b[k])
        assert b[k].dtype == np.float32


class _IdentityMatcher(torch.nn.Module):
    """Matches 2D slot i to 3D slot i where both are real (a stand-in for a
    trained matcher, so that the validation's pose path has exact matches)."""

    def __init__(self):
        super().__init__()
        self.w = torch.nn.Parameter(torch.zeros(1))

    def forward(self, desc2d, desc3d, leaf_desc, mask2d, mask3d, leaf_mask):
        n = desc2d.shape[1]
        idx = torch.arange(n, dtype=torch.int32)[None].expand(desc2d.shape[0], n)
        return {"matches0": torch.where(mask2d & mask3d[:, :n], idx, -1)}


def test_pose_validation_recovers_planted_poses():
    """make_pose_val_fn: matches -> RANSAC-PnP (draws seeded by the item) ->
    cm-degree recall, on items whose keypoints are the exact projections of
    their points under a known pose."""
    from onepose_tpu_torch.train.loop import make_pose_val_fn

    rng = np.random.default_rng(13)
    K = np.array([[500.0, 0, 256], [0, 500.0, 256], [0, 0, 1]], np.float32)
    items = []
    for i in range(3):
        xyz = (rng.random((40, 3)) - 0.5).astype(np.float32) * 0.2
        pose = np.eye(4, dtype=np.float32)
        pose[:3, 3] = [0.01 * i, -0.02, 0.8]
        uv = (xyz + pose[:3, 3]) @ K.T
        kp = (uv[:, :2] / uv[:, 2:]).astype(np.float32)
        mask = np.ones(40, bool)
        mask[30:] = False
        items.append({"desc2d": np.zeros((40, 8), np.float32),
                      "desc3d": np.zeros((40, 8), np.float32),
                      "leaf_desc": np.zeros((40, 2, 8), np.float32), "mask2d": mask,
                      "mask3d": np.ones(40, bool), "leaf_mask": np.ones((40, 2), bool),
                      "kpts2d": kp, "points3d": xyz, "pose_gt": pose, "K": K})
    model = _IdentityMatcher()
    state = pts.TrainState(model, None)
    out = make_pose_val_fn(items, model, n_hyp=64)(state)
    assert out["val_cmd1"] == 1.0 and out["val_num_frames"] == 3, out
    assert out["val_mean_rot_deg"] < 0.1 and out["val_mean_trans_cm"] < 0.1
