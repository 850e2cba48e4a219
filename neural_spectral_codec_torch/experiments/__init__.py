"""Measurement entry points of the port, run on a CUDA card:

    python -m neural_spectral_codec_torch.experiments.ring_stage_probe
    python -m neural_spectral_codec_torch.experiments.profile_hotpath
"""
