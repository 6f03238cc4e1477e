"""Losses.

Port of onepose_tpu/train/losses.py: the focal loss on the dual-softmax
confidence matrix (the reference's src/losses/focal_loss.py:4-32) with the
shipped hyperparameters (configs/experiment/train_GATsSPG.yaml:52-55:
alpha 0.5, gamma 2, positive and negative weights 0.5 / 0.5).
"""

from __future__ import annotations

from typing import Optional

import torch


def focal_loss(
    conf: torch.Tensor,
    target: torch.Tensor,
    alpha: float = 0.5,
    gamma: float = 2.0,
    pos_weight: float = 0.5,
    neg_weight: float = 0.5,
    valid_mask: Optional[torch.Tensor] = None,
    eps: float = 1e-6,
    group=None,
) -> torch.Tensor:
    """Mean focal loss over positive and negative entries.

    conf: [..., N2, N3] dual-softmax confidences in (0, 1).
    target: [..., N2, N3] binary ground-truth assignment matrix.
    valid_mask: optional [..., N2, N3] bool mask of the pairs that count
      (None, the default, computes over padded slots too, as the reference
      does; the pad mask gives the mask-aware variant).

    Positive term: -alpha * (1 - p)^gamma * log(p), mean over positives.
    Negative term: -(1 - alpha) * p^gamma * log(1 - p), mean over negatives.
    Total = pos_weight * pos_mean + neg_weight * neg_mean; a side with no
    entries contributes zero (its count is clamped to 1).

    group: a process group whose ranks each hold a slice of the batch. The
    means are then over the global batch, as the JAX package takes them
    over its sharded batch: the positive and negative counts are
    all-reduced before the division, and the result is this rank's share
    of the global loss (the shares sum to it; so do their gradients).
    """
    conf = conf.clamp(eps, 1.0 - eps)
    pos = target > 0.5
    neg = ~pos
    if valid_mask is not None:
        pos = pos & valid_mask
        neg = neg & valid_mask
    posf = pos.to(conf.dtype)
    negf = neg.to(conf.dtype)

    loss_pos = -alpha * torch.pow(1.0 - conf, gamma) * torch.log(conf)
    loss_neg = -(1.0 - alpha) * torch.pow(conf, gamma) * torch.log(1.0 - conf)

    n_pos, n_neg = posf.sum(), negf.sum()
    if group is not None:
        from onepose_tpu_torch.utils.comm import all_reduce

        n_pos, n_neg = all_reduce(n_pos, group), all_reduce(n_neg, group)
    mean_pos = (loss_pos * posf).sum() / n_pos.clamp(min=1.0)
    mean_neg = (loss_neg * negf).sum() / n_neg.clamp(min=1.0)
    return pos_weight * mean_pos + neg_weight * mean_neg
