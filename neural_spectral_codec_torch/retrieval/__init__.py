"""Retrieval: the device-resident W₁ database."""

from neural_spectral_codec_torch.retrieval.retriever import (  # noqa: F401
    WassersteinRetriever, query_math)
