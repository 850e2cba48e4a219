"""Keyframe graph (numpy construction, torch tensors for the GNN) and the
online graph manager."""

from neural_spectral_codec_torch.keyframe.graph import (  # noqa: F401
    KeyframeGraph, TemporalGraphManager, build_graph, graph_to_tensors)
