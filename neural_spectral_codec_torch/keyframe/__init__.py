"""Keyframe graph (numpy construction, torch tensors for the GNN)."""

from neural_spectral_codec_torch.keyframe.graph import (  # noqa: F401
    KeyframeGraph, build_graph, graph_to_tensors)
