"""Synthetic LiDAR streams and SE(3) pose math (numpy, copied from
``neural_spectral_codec_tpu/data/``)."""
