"""Data layer: dataset directory schema, padding contracts, annotation and
COLMAP I/O, the training dataset (`dataset`) (port of onepose_tpu/data/;
capture parsing comes with `parse-scan`)."""

from onepose_tpu_torch.data import paths
from onepose_tpu_torch.data.padding import (
    pad_keypoints2d,
    pad_points3d,
    assign_to_conf_matrix,
)
from onepose_tpu_torch.data.anno_io import (
    save_annotation_npz,
    load_annotation_npz,
    annotation_from_npz_dir,
)
