"""Multi-device work over `torch.distributed` ranks: the mesh, sharded
attention, tensor and stage parallelism, distributed BA and the batched
pair matching of `map`.

Axes, as in the JAX package: "data" (the batch or frame axis) and "points"
(the matcher's 3D points and their leaves); the tensor-parallel mesh names
its second axis "model". One process and one device per rank; with no
process group every mesh is 1 x 1.
"""

from onepose_tpu_torch.parallel.mesh import (
    Mesh,
    batch_sharding,
    make_mesh,
    points_sharding,
    replicate_pytree,
    replicated,
    shard_batch,
)
from onepose_tpu_torch.parallel.sfm_parallel import (
    make_nn_pair_matcher,
    make_superglue_pair_matcher,
    resolve_sfm_mesh,
)

__all__ = [
    "Mesh", "batch_sharding", "make_mesh", "points_sharding", "replicate_pytree", "replicated",
    "shard_batch", "make_nn_pair_matcher", "make_superglue_pair_matcher", "resolve_sfm_mesh",
]
