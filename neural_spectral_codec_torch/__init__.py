"""Neural Spectral Codec — PyTorch + CUDA port for NVIDIA Hopper.

A port of ``neural_spectral_codec_tpu`` (JAX, the reference) that keeps
its layout and names: ``ops/`` (projection, spectral encoding, W₁),
``keyframe/``, ``models/`` (GNN, serving step), ``retrieval/`` and
``parallel/`` (one controller over a list of devices). The
TPU's Pallas kernels are hand-written CUDA C++ for ``sm_90a`` in
``csrc/``, built with nvcc at first use (``_build.py``). Every kernel has
a plain PyTorch version: a CPU tensor takes it, a CUDA tensor launches the
kernel. This package imports torch and numpy, never jax.
"""

from neural_spectral_codec_torch.device import resolve_device  # noqa: F401

__all__ = ["resolve_device"]
