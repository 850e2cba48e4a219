"""Keyframe selection (host numpy), the keyframe graph (numpy
construction, torch tensors for the GNN) and the online graph manager."""

from neural_spectral_codec_torch.keyframe.criteria import (  # noqa: F401
    KeyframeSelectionCriteria, analyze_keyframe_spacing,
    estimate_keyframe_rate)
from neural_spectral_codec_torch.keyframe.selector import (  # noqa: F401
    Keyframe, KeyframeSelector, select_keyframes_from_kitti)
from neural_spectral_codec_torch.keyframe.graph import (  # noqa: F401
    KeyframeGraph, TemporalGraphManager, build_graph, graph_to_coo,
    graph_to_tensors)
