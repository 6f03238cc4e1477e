"""The training step of the GATsSPG matcher.

Port of onepose_tpu/train/train_step.py. The optimization contract is the
reference's (configs/experiment/train_GATsSPG.yaml:21-41,
src/models/GATsSPG_lightning_model.py:117-127): Adam, lr 1e-3, MultiStepLR
milestones [5, 10, 15, 20] epochs x 0.5, gradient clip 0.5, batch 8 with
2-step accumulation, the focal loss (alpha 0.5, gamma 2) on the
dual-softmax confidence matrix.

The JAX package's optimizer is the optax chain clip_by_global_norm(0.5) ->
adam (adamw with a weight decay), under MultiSteps(every_k=accumulate)
when accumulate > 1. `Optimizer` computes the same updates:
- the clip scales by max_norm / norm only when norm >= max_norm (optax's
  rule; `torch.nn.utils.clip_grad_norm_` divides by norm + 1e-6 always);
- accumulation is MultiSteps' running mean acc + (g - acc) / (n + 1), and
  the inner chain runs once every `accumulate` micro-steps on that mean;
- Adam is `torch.optim.Adam` (AdamW), whose update is optax's; its lr is
  set before each update from `make_lr_schedule`, indexed by optimizer
  updates, not micro-steps.
`TrainState.step` counts micro-steps, as the JAX package's train state does; the
metrics' grad_norm is the global norm of the micro-batch's raw gradients.

The train state's checkpoint is the JAX package's artifact
(`TrainState.state_dict`, `load_state_dict`): {step, params, opt_state}
with the JAX package's parameter layout and optax's state layout, so
either package resumes the other's checkpoints.

Data parallelism (`make_train_step(..., group=)`): each rank of the group
holds the same parameters and optimizer state and takes its slice of the
global batch; the focal loss normalises over the global batch (the
positive and negative counts are all-reduced before the division, as the
JAX package's loss over its sharded batch does), the gradients of the
ranks' shares are summed by one all-reduce, and every rank applies the
same update. The metrics are those of the global batch.

The step runs in fp32 with TF32 off (`utils.precision.fp32_matmuls`). The
matcher is GATsSPG(gats_kernel=True, fused_match=False): the GATs kernel
with its gradient (`ops.kernels.gats.GatsLeafAttention`) and the dense
head whose conf_matrix the loss reads.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Iterable, Optional

import numpy as np
import torch
from torch import nn

from onepose_tpu_torch._device import resolve_device
from onepose_tpu_torch.models import bridge
from onepose_tpu_torch.models.gats import GraphAttentionLayer
from onepose_tpu_torch.train.losses import focal_loss
from onepose_tpu_torch.utils.comm import all_reduce
from onepose_tpu_torch.utils.precision import fp32_matmuls


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    lr: float = 1e-3
    weight_decay: float = 0.0
    clip_norm: float = 0.5
    milestones: tuple = (5, 10, 15, 20)  # epochs
    lr_gamma: float = 0.5
    steps_per_epoch: int = 1000
    accumulate: int = 1
    focal_alpha: float = 0.5
    focal_gamma: float = 2.0
    pos_weight: float = 0.5
    neg_weight: float = 0.5


def make_lr_schedule(cfg: TrainConfig) -> Callable[[int], float]:
    """MultiStepLR with milestones in epochs, as a function of the optimizer's
    update count. Under accumulation the count advances once per
    `accumulate` micro-batches, so an epoch of `steps_per_epoch` dataset
    batches is steps_per_epoch // accumulate updates (optax's
    piecewise_constant_schedule: the scale applies from its boundary on)."""
    updates_per_epoch = max(cfg.steps_per_epoch // max(cfg.accumulate, 1), 1)
    boundaries = {int(m * updates_per_epoch): cfg.lr_gamma for m in cfg.milestones}

    def schedule(count: int) -> float:
        lr = cfg.lr
        for b in sorted(boundaries):
            if count >= b:
                lr *= boundaries[b]
        return lr

    return schedule


def global_norm(tensors: Iterable[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares over every tensor (optax.global_norm)."""
    return torch.stack([t.square().sum() for t in tensors]).sum().sqrt()


def clip_by_global_norm(grads: list, max_norm: float) -> list:
    """optax.clip_by_global_norm: each g as it is when the global norm is
    below max_norm, else g / norm * max_norm."""
    norm = global_norm(grads)
    keep = norm < max_norm
    return [torch.where(keep, g, g / norm * max_norm) for g in grads]


def _i32(v: int) -> np.ndarray:
    return np.asarray(v, np.int32)


class Optimizer:
    """clip_by_global_norm -> Adam (AdamW with weight_decay) on `params`,
    under MultiSteps(every_k=accumulate) when accumulate > 1.

    `names` are the parameters' state_dict names, which place each one in
    the JAX package's layout (`jax_state`, `load_jax_state`)."""

    def __init__(self, params: list, names: list, cfg: TrainConfig):
        self.params, self.names, self.cfg = list(params), list(names), cfg
        self.schedule = make_lr_schedule(cfg)
        self.every_k = max(cfg.accumulate, 1)
        kw = dict(lr=cfg.lr, betas=(0.9, 0.999), eps=1e-8)
        self.adam = (torch.optim.AdamW(self.params, weight_decay=cfg.weight_decay, **kw)
                     if cfg.weight_decay else torch.optim.Adam(self.params, **kw))
        self.count = 0  # optimizer updates: Adam's and the schedule's count
        self.mini_step = 0  # micro-steps into the current accumulation
        self.acc = ([torch.zeros_like(p) for p in self.params] if self.every_k > 1 else None)

    def update(self, grads: list) -> None:
        """Take one micro-batch's gradients: the parameters are updated at
        every micro-step, or at every `accumulate`-th."""
        if self.acc is not None:
            n = self.mini_step
            for a, g in zip(self.acc, grads):
                a.add_((g - a) / (n + 1))
            self.mini_step = (n + 1) % self.every_k
            if n != self.every_k - 1:
                return
            grads = self.acc
        clipped = clip_by_global_norm(grads, self.cfg.clip_norm)
        for p, g in zip(self.params, clipped):
            p.grad = g
        for group in self.adam.param_groups:
            group["lr"] = self.schedule(self.count)
        self.adam.step()
        for p in self.params:
            p.grad = None
        self.count += 1
        if self.acc is not None:
            for a in self.acc:
                a.zero_()

    # -- the JAX package's layout (optax's state as its checkpoints hold it) --

    def _tree(self, tensors) -> dict:
        return bridge.state_dict_to_jax(dict(zip(self.names, tensors)))

    def _untree(self, tree) -> list:
        sd = bridge.jax_to_state_dict(tree)
        if set(sd) != set(self.names):
            raise ValueError(f"optimizer state names differ from the parameters': "
                             f"{sorted(set(sd) ^ set(self.names))[:5]}")
        return [sd[n] for n in self.names]

    def jax_state(self) -> dict:
        """The optax state tree: {"0": clip (empty), "1": {"0": adam {count,
        mu, nu}, ["1": weight decay (empty),] last: schedule {count}}},
        inside {mini_step, gradient_step, inner_opt_state, acc_grads,
        skip_state} when accumulate > 1."""
        state = [self.adam.state.get(p, {}) for p in self.params]
        mu = [s["exp_avg"] if s else torch.zeros_like(p) for s, p in zip(state, self.params)]
        nu = [s["exp_avg_sq"] if s else torch.zeros_like(p) for s, p in zip(state, self.params)]
        adam = {"count": _i32(self.count), "mu": self._tree(mu), "nu": self._tree(nu)}
        chain = [adam, {"count": _i32(self.count)}]
        if self.cfg.weight_decay:
            chain.insert(1, {})
        inner = {"0": {}, "1": {str(i): s for i, s in enumerate(chain)}}
        if self.acc is None:
            return inner
        return {"mini_step": _i32(self.mini_step), "gradient_step": _i32(self.count),
                "inner_opt_state": inner, "acc_grads": self._tree(self.acc), "skip_state": {}}

    def load_jax_state(self, tree: dict) -> None:
        """Restore from `jax_state`'s layout (a checkpoint of either package)."""
        inner = tree
        if self.acc is not None:
            inner = tree["inner_opt_state"]
            self.mini_step = int(tree["mini_step"])
            for a, v in zip(self.acc, self._untree(tree["acc_grads"])):
                a.copy_(v)
        adam = inner["1"]["0"]
        self.count = int(adam["count"])
        mu, nu = self._untree(adam["mu"]), self._untree(adam["nu"])
        step = torch.tensor(float(self.count))
        self.adam.load_state_dict({
            "state": {i: {"step": step.clone(), "exp_avg": m, "exp_avg_sq": v}
                      for i, (m, v) in enumerate(zip(mu, nu))},
            "param_groups": self.adam.state_dict()["param_groups"],
        })


def make_optimizer(cfg: TrainConfig, model: nn.Module) -> Optimizer:
    names, params = zip(*model.named_parameters())
    return Optimizer(params, names, cfg)


class TrainState:
    """The matcher (its parameters), its optimizer and `step`, the
    micro-steps taken (the JAX package's TrainState)."""

    def __init__(self, model: nn.Module, tx: Optimizer, step: int = 0):
        self.model, self.tx, self.step = model, tx, step

    def apply_gradients(self, grads: list) -> None:
        self.tx.update(grads)
        self.step += 1

    def state_dict(self) -> dict:
        """{step, params, opt_state} as numpy arrays in the JAX package's
        layout: what `utils.checkpoint.save_checkpoint` writes."""
        params = bridge.gats_spg_params(dict(self.model.named_parameters()))
        return {"step": _i32(self.step), "params": params, "opt_state": self.tx.jax_state()}

    def load_state_dict(self, tree: dict) -> None:
        sd = bridge.gats_spg_state_dict(tree["params"])
        with torch.no_grad():
            for name, p in self.model.named_parameters():
                p.copy_(sd[name])
        self.tx.load_jax_state(tree["opt_state"])
        self.step = int(tree["step"])


def init_params(model: nn.Module, seed: int) -> nn.Module:
    """Draw every parameter of `model` again under torch.manual_seed(seed)
    on the CPU generator (the caller's stream untouched): the GATs layers'
    W and a by Xavier-normal, as at construction, every Linear by its
    reset_parameters. The port's own init, not the JAX package's PRNGKey
    one: the same weights in both packages come from one checkpoint."""
    with torch.random.fork_rng(devices=[]), torch.no_grad():
        torch.manual_seed(seed)
        for m in model.modules():
            if isinstance(m, GraphAttentionLayer):
                m.W.copy_(nn.init.xavier_normal_(torch.empty(m.W.shape)))
                m.a.copy_(nn.init.xavier_normal_(torch.empty(m.a.shape)))
            elif m is not model and hasattr(m, "reset_parameters"):
                m.reset_parameters()
    return model


def create_train_state(seed: int, model: nn.Module, cfg: TrainConfig,
                       device: str | torch.device = "cuda") -> TrainState:
    """The model's parameters drawn from `seed` (`init_params`, on the CPU)
    and moved to `device` (the card unless the caller names the CPU; raises
    without CUDA), and its optimizer there."""
    dev = resolve_device(device)
    init_params(model.cpu(), seed).to(dev)
    return TrainState(model, make_optimizer(cfg, model))


def _forward(model: nn.Module, batch: dict) -> dict:
    return model(batch["desc2d"], batch["desc3d"], batch["leaf_desc"], batch.get("mask2d"),
                 batch.get("mask3d"), batch.get("leaf_mask"))


def loss_fn(model: nn.Module, batch: dict, cfg: TrainConfig, group=None):
    """(loss, metrics {loss, precision, recall}) of one batch; the metrics
    detached, matches by the thresholds 0.2 (conf) and 0.5 (ground truth).
    With a process `group`, the batch is this rank's slice: the loss is
    its share of the global batch's, the metrics the global batch's."""
    out = _forward(model, batch)
    conf = out["conf_matrix"]
    if conf is None:
        raise ValueError("training needs the dense confidence matrix: construct the matcher "
                         "with GATsSPG(fused_match=False)")
    loss = focal_loss(conf, batch["conf_gt"], alpha=cfg.focal_alpha, gamma=cfg.focal_gamma,
                      pos_weight=cfg.pos_weight, neg_weight=cfg.neg_weight, group=group)
    with torch.no_grad():
        pred_pos = conf > 0.2
        gt_pos = batch["conf_gt"] > 0.5
        # [loss, tp, predicted, ground truth]: summed over the ranks.
        sums = torch.stack([loss.detach(), (pred_pos & gt_pos).sum().to(loss.dtype),
                            pred_pos.sum().to(loss.dtype), gt_pos.sum().to(loss.dtype)])
        if group is not None:
            sums = all_reduce(sums, group)
        total, tp, n_pred, n_gt = sums
        precision = tp / n_pred.clamp(min=1)
        recall = tp / n_gt.clamp(min=1)
    return loss, {"loss": total, "precision": precision, "recall": recall}


def _sum_over(grads: list, group) -> list:
    """The gradients summed over the ranks of `group`: one all-reduce of
    their concatenation."""
    flat = all_reduce(torch.cat([g.reshape(-1) for g in grads]), group)
    return [f.view_as(g) for f, g in zip(flat.split([g.numel() for g in grads]), grads)]


def make_train_step(model: Optional[nn.Module], cfg: TrainConfig, group=None):
    """train_step(state, batch) -> (state, metrics): the focal loss, its
    gradients by autograd, their raw global norm, then the optimizer
    (`state` is updated in place and returned). With a process `group`,
    data parallelism over its ranks (see the module's docstring)."""

    def train_step(state: TrainState, batch: dict):
        params = list(state.tx.params)
        with fp32_matmuls():
            loss, metrics = loss_fn(state.model, batch, cfg, group)
            grads = list(torch.autograd.grad(loss, params))
            if group is not None:
                grads = _sum_over(grads, group)
            metrics["grad_norm"] = global_norm(grads)
            state.apply_gradients(grads)
        return state, metrics

    return train_step


def make_eval_step(model: Optional[nn.Module], cfg: TrainConfig):
    def eval_step(state: TrainState, batch: dict) -> dict:
        with torch.no_grad(), fp32_matmuls():
            return loss_fn(state.model, batch, cfg)[1]

    return eval_step
