"""Training of the GATsSPG matcher: the loss, the optimizer step, the loop
and its callbacks (port of onepose_tpu/train/)."""

from onepose_tpu_torch.train.losses import focal_loss
from onepose_tpu_torch.train.train_step import (
    TrainConfig,
    TrainState,
    create_train_state,
    make_eval_step,
    make_train_step,
)
