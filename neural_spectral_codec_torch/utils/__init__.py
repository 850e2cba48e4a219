"""Utilities of the port: configs (``config``), stage timing
(``profiler``), CUDA-event timing (``timing``) and logging set-up
(``logging_setup``)."""

from neural_spectral_codec_torch.utils.profiler import Profiler  # noqa: F401
from neural_spectral_codec_torch.utils.config import (  # noqa: F401
    load_config, validate_config)
from neural_spectral_codec_torch.utils.logging_setup import (  # noqa: F401
    setup_logging)
