"""Batched pair matching for the `map` front end (one device)."""

from onepose_tpu_torch.parallel.sfm_parallel import (
    make_nn_pair_matcher,
    make_superglue_pair_matcher,
)

__all__ = ["make_nn_pair_matcher", "make_superglue_pair_matcher"]
