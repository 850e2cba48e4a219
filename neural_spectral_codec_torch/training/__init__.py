"""Offline GNN training: triplet loss, triplet mining, Recall@K
validation and the trainer (port of ``neural_spectral_codec_tpu/
training/``)."""

from neural_spectral_codec_torch.training.loss import (  # noqa: F401
    triplet_loss)
from neural_spectral_codec_torch.training.miner import (  # noqa: F401
    TripletMiner, create_triplet_miner)
from neural_spectral_codec_torch.training.validation import (  # noqa: F401
    find_revisit_queries, recall_loop_closure)
from neural_spectral_codec_torch.training.trainer import (  # noqa: F401
    GNNTrainer, create_trainer)
