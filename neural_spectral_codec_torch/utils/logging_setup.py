"""Console + timestamped-file logging, the port's copy of
``neural_spectral_codec_tpu/utils/logging_setup.py``."""

from __future__ import annotations

import logging
import sys
import time
from pathlib import Path
from typing import Optional


def setup_logging(log_dir: Optional[str] = "logs",
                  level: int = logging.INFO,
                  name: str = "train") -> Optional[str]:
    """Configure root logging with a console handler and, if ``log_dir`` is
    given, a timestamped file handler. Returns the log file path."""
    handlers = [logging.StreamHandler(sys.stdout)]
    log_path = None
    if log_dir is not None:
        Path(log_dir).mkdir(parents=True, exist_ok=True)
        stamp = time.strftime("%Y%m%d_%H%M%S")
        log_path = str(Path(log_dir) / f"{name}_{stamp}.log")
        handlers.append(logging.FileHandler(log_path))
    logging.basicConfig(
        level=level,
        format="%(asctime)s | %(levelname)s | %(name)s | %(message)s",
        handlers=handlers,
        force=True,
    )
    return log_path
