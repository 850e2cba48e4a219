"""YAML configs with ``inherit:`` chains and a schema check. Port of
``neural_spectral_codec_tpu/utils/config.py``.

``load_config`` needs PyYAML and raises ``ImportError`` where it is not
installed; the pipeline itself takes a config dict, so a caller without
PyYAML builds the dict in code. ``validate_config`` type- and
range-checks the known keys and warns about unknown sections.
"""

from __future__ import annotations

import logging
from pathlib import Path
from typing import Any, Dict, Optional

logger = logging.getLogger(__name__)


def _deep_merge(base: Dict, override: Dict) -> Dict:
    out = dict(base)
    for k, v in override.items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = _deep_merge(out[k], v)
        else:
            out[k] = v
    return out


def load_config(path: str, validate: bool = True) -> Dict[str, Any]:
    """Load a YAML config, resolving ``inherit: <file>`` (relative to the
    config's directory) by deep-merging it over its parent."""
    try:
        import yaml
    except ImportError as e:
        raise ImportError(
            f"load_config({path!r}) needs PyYAML, which is not installed; "
            "pass the pipeline a config dict instead") from e
    p = Path(path)
    with open(p) as f:
        cfg = yaml.safe_load(f) or {}
    parent = cfg.pop("inherit", None)
    if parent:
        cfg = _deep_merge(load_config(str((p.parent / parent).resolve()),
                                      validate=False), cfg)
    if validate:
        validate_config(cfg)
    return cfg


# (section, key) -> (type(s), optional (lo, hi) range)
_SCHEMA = {
    ("encoding", "n_elevation"): (int, (1, 4096)),
    ("encoding", "n_azimuth"): (int, (4, 16384)),
    ("encoding", "n_bins"): (int, (1, 4096)),
    ("encoding", "target_elevation_bins"): (int, (1, 4096)),
    ("encoding", "alpha"): ((int, float), (1e-6, 100.0)),
    ("encoding", "epsilon"): ((int, float), (0.0, 1.0)),
    ("encoding", "max_range"): ((int, float), (0.1, 10000.0)),
    ("encoding", "min_range"): ((int, float), (0.0, 10000.0)),
    ("keyframe", "distance_threshold"): ((int, float), (0.0, 1e6)),
    ("keyframe", "rotation_threshold"): ((int, float), (0.0, 360.0)),
    ("keyframe", "overlap_threshold"): ((int, float), (0.0, 1.0)),
    ("keyframe", "temporal_threshold"): ((int, float), (0.0, 1e6)),
    ("keyframe", "temporal_neighbors"): (int, (1, 1000)),
    ("keyframe", "max_active_nodes"): (int, (1, 10_000_000)),
    ("gnn", "input_dim"): (int, (1, 1 << 20)),
    ("gnn", "hidden_dim"): (int, (1, 1 << 20)),
    ("gnn", "output_dim"): (int, (1, 1 << 20)),
    ("gnn", "n_layers"): (int, (1, 64)),
    ("gnn", "dropout"): ((int, float), (0.0, 1.0)),
    ("retrieval", "top_k"): (int, (1, 10000)),
    ("retrieval", "storage"): (str, None),
    ("retrieval", "spatial_filter_distance"): ((int, float), (0.0, 1e6)),
    ("retrieval", "icp_fitness_threshold"): ((int, float), (0.0, 1.0)),
    ("retrieval", "icp_rmse_threshold"): ((int, float), (0.0, 1e3)),
    ("training", "learning_rate"): ((int, float), (0.0, 10.0)),
    ("training", "weight_decay"): ((int, float), (0.0, 1.0)),
    ("training", "n_epochs"): (int, (0, 1_000_000)),
    ("triplet", "margin"): ((int, float), (0.0, 1e3)),
}

_KNOWN_SECTIONS = {
    "data", "encoding", "keyframe", "gnn", "retrieval", "system", "logging",
    "training", "triplet", "augmentation", "validation", "checkpoint",
    "resume", "wandb", "ablation", "targets", "model", "deployment",
    "database", "loop_closing", "monitoring", "visualization", "resources",
    "quality", "benchmark", "parallel", "ros", "gpu",
}


class ConfigError(ValueError):
    pass


def validate_config(cfg: Dict[str, Any]) -> None:
    for section in cfg:
        if section not in _KNOWN_SECTIONS:
            logger.warning("Unknown config section: %r", section)
    for (section, key), (types, rng) in _SCHEMA.items():
        if section not in cfg or key not in cfg.get(section, {}):
            continue
        val = cfg[section][key]
        if isinstance(val, bool) or not isinstance(val, types):
            raise ConfigError(
                f"{section}.{key}: expected {types}, got {type(val).__name__}")
        if rng is not None and not (rng[0] <= val <= rng[1]):
            raise ConfigError(
                f"{section}.{key}={val} outside valid range {rng}")
    enc = cfg.get("encoding", {})
    if "min_range" in enc and "max_range" in enc:
        if enc["min_range"] >= enc["max_range"]:
            raise ConfigError("encoding.min_range must be < max_range")


def get(cfg: Dict[str, Any], dotted: str, default: Optional[Any] = None):
    """Lookup by dotted path, e.g. ``get(cfg, "gnn.hidden_dim", 256)``."""
    node = cfg
    for part in dotted.split("."):
        if not isinstance(node, dict) or part not in node:
            return default
        node = node[part]
    return node
