"""Neural models of the port: SuperPoint, the GATsSPG 2D-3D matcher, the
SuperGlue 2D-2D matcher and the mutual-NN matcher (PyTorch modules,
channel-last layouts at the public functions)."""

from onepose_tpu_torch.models.gats_spg import GATsSPG, match_from_conf
from onepose_tpu_torch.models.nn_matcher import NNMatcher2D3D, mutual_nn_match
from onepose_tpu_torch.models.superglue import SuperGlue
from onepose_tpu_torch.models.superpoint import SuperPoint, extract_keypoints

__all__ = ["GATsSPG", "NNMatcher2D3D", "SuperGlue", "SuperPoint", "extract_keypoints",
           "match_from_conf", "mutual_nn_match"]
