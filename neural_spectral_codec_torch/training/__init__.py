"""Offline GNN training: triplet loss, triplet mining, Recall@K
validation and the trainer (port of ``neural_spectral_codec_tpu/
training/``)."""
