"""g2o pose-graph edge export. Copied from
``neural_spectral_codec_tpu/retrieval/g2o.py`` (host numpy): the same
``EDGE_SE3:QUAT`` text for the same edges."""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from neural_spectral_codec_torch.ops.quantization import pose_to_7dof


def compute_pose_graph_edge(source_pose: np.ndarray, target_pose: np.ndarray,
                            relative_transform: np.ndarray,
                            information_matrix: np.ndarray) -> Dict:
    """Edge dict for g2o; the caller fills in the source and target ids."""
    return {
        "source_id": 0,
        "target_id": 0,
        "relative_pose": pose_to_7dof(relative_transform),
        "information_matrix": information_matrix,
    }


def save_loop_closures_g2o(loop_closures: List[Dict], output_path: str) -> None:
    """One ``EDGE_SE3:QUAT`` line per edge: ids, x y z qx qy qz qw, then
    the 21 upper-triangular entries of the information matrix."""
    with open(output_path, "w") as f:
        for lc in loop_closures:
            p = lc["relative_pose"]  # [x, y, z, qw, qx, qy, qz]
            info = lc["information_matrix"]
            f.write(f"EDGE_SE3:QUAT {lc['source_id']} {lc['target_id']} ")
            f.write(f"{p[0]} {p[1]} {p[2]} {p[4]} {p[5]} {p[6]} {p[3]} ")
            f.write(" ".join(str(info[i, j]) for i in range(6)
                             for j in range(i, 6)))
            f.write(" \n")
