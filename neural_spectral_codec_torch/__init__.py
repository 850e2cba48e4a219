"""Neural Spectral Codec — PyTorch + CUDA port for NVIDIA Hopper.

A port of ``neural_spectral_codec_tpu`` (JAX, the reference) that keeps
its layout and names: ``ops/`` (projection, spectral encoding, W₁),
``keyframe/``, ``models/`` (GNN, serving step), ``retrieval/`` and
``parallel/`` (one controller over a list of devices). The
TPU's Pallas kernels are hand-written CUDA C++ for ``sm_90a`` in
``csrc/``, built with nvcc at first use (``_build.py``). Every kernel has
a plain PyTorch version: a CPU tensor takes it, a CUDA tensor launches the
kernel. This package imports torch and numpy, never jax.

The common entry points are importable as ``neural_spectral_codec_torch.X``
(the JAX package's lazy top-level names); each is imported at its first
use, so importing the package stays cheap and builds nothing.
"""

import importlib

from neural_spectral_codec_torch.device import resolve_device  # noqa: F401

__version__ = "0.1.0"

_EXPORTS = {
    "SpectralEncoderConfig": "ops.spectral",
    "encode_points_batch": "ops.spectral",
    "pad_points": "ops.range_image",
    "KeyframeSelector": "keyframe.selector",
    "Keyframe": "keyframe.selector",
    "TemporalGraphManager": "keyframe.graph",
    "build_graph_from_keyframes": "keyframe.graph",
    "SpectralGNN": "models.gnn",
    "GNNTrainer": "training.trainer",
    "TripletMiner": "training.miner",
    "WassersteinRetriever": "retrieval.retriever",
    "TwoStageRetrieval": "retrieval.two_stage",
    "GeometricVerifier": "retrieval.verification",
    "NeuralSpectralCodecPipeline": "pipeline",
    "run_pipeline": "pipeline",
    "run_benchmark": "evaluation",
    "load_config": "utils.config",
    "Profiler": "utils.profiler",
}

__all__ = ["resolve_device", "ops", *_EXPORTS]


def __getattr__(name):
    """Lazy top-level API (JAX ``__init__.py:31-59``) and the ``ops``
    subpackage, imported on first access."""
    if name == "ops":
        return importlib.import_module(f"{__name__}.{name}")
    if name in _EXPORTS:
        module = importlib.import_module(f"{__name__}.{_EXPORTS[name]}")
        return getattr(module, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
