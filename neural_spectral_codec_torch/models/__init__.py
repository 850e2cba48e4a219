"""GNN, Flax parameter conversion and the serving step."""

from neural_spectral_codec_torch.models.convert import from_flax  # noqa: F401
from neural_spectral_codec_torch.models.gnn import (  # noqa: F401
    EdgeGATLayer, LocalUpdateGNN, SpectralGNN, create_spectral_gnn,
    gnn_forward)
from neural_spectral_codec_torch.models.serving import (  # noqa: F401
    encode_scan, serve_step)
