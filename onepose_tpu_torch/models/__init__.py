"""Neural models of the port: SuperPoint and the GATsSPG 2D-3D matcher
(PyTorch modules, fp32, channel-last layouts at the public functions)."""

from onepose_tpu_torch.models.gats_spg import GATsSPG, match_from_conf
from onepose_tpu_torch.models.superpoint import SuperPoint, extract_keypoints

__all__ = ["GATsSPG", "SuperPoint", "extract_keypoints", "match_from_conf"]
