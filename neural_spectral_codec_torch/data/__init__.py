"""Host-side data layer of the port (numpy copies of
``neural_spectral_codec_tpu/data/``): the dataset readers (KITTI, NCLT,
HeLiPR, the multi-dataset loader), SE(3) pose math and synthetic streams.
``native_io.frame_source`` reads a loader's scans ahead through the native
IO library."""

from neural_spectral_codec_torch.data.pose_utils import (  # noqa: F401
    inverse_pose,
    compose_poses,
    relative_pose,
    transform_points,
    euclidean_distance,
    rotation_angle,
    rotation_angle_degrees,
    interpolate_poses,
    pose_difference,
    is_valid_transformation,
    cartesian_to_spherical,
    spherical_to_cartesian,
    compute_overlap,
)
from neural_spectral_codec_torch.data.kitti import KITTILoader  # noqa: F401
from neural_spectral_codec_torch.data.nclt import NCLTLoader  # noqa: F401
from neural_spectral_codec_torch.data.helipr import HeLiPRLoader  # noqa: F401
from neural_spectral_codec_torch.data.multi_dataset import (  # noqa: F401
    MultiDatasetLoader,
    create_multi_dataset_loader,
)
from neural_spectral_codec_torch.data.synthetic import SyntheticLoader  # noqa: F401
