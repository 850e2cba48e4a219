"""Retrieval: the device-resident W₁ database, geometric verification,
two-stage loop closing and the g2o export."""

from neural_spectral_codec_torch.retrieval.g2o import (  # noqa: F401
    compute_pose_graph_edge, save_loop_closures_g2o)
from neural_spectral_codec_torch.retrieval.retriever import (  # noqa: F401
    WassersteinRetriever, query_math)
from neural_spectral_codec_torch.retrieval.two_stage import (  # noqa: F401
    LoopClosureCandidate, TwoStageRetrieval, batch_loop_closing,
    create_two_stage_retrieval)
from neural_spectral_codec_torch.retrieval.verification import (  # noqa: F401
    GeometricVerifier, batch_verify_candidates, verify_loop_closure,
    voxel_downsample)
