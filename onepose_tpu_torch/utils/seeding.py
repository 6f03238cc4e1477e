"""Determinism helpers.

Port of onepose_tpu/utils/seeding.py. The reference seeds everything at
the start of every entry (pytorch-lightning's seed_everything(12345),
train_GATsSPG.yaml:17); the port's own randomness is keyed explicitly
(torch generators seeded where they are made), so what is left to seed is
Python's and numpy's global state, as in the JAX package.
"""

from __future__ import annotations

import os
import random

import numpy as np


def seed_everything(seed: int = 12345) -> int:
    random.seed(seed)
    np.random.seed(seed % (2**32))
    os.environ["PYTHONHASHSEED"] = str(seed)
    return seed
