"""Flax → PyTorch parameter conversion for ``SpectralGNN``.

The JAX package's parameters (``init_gnn`` or a trained checkpoint) are
nested dicts; pass them as numpy arrays (``np.asarray`` of each leaf, or
``jax.device_get``). Conventions that differ:

* a Flax Dense ``kernel`` is (in, out); ``nn.Linear.weight`` is (out, in),
  so kernels are transposed;
* Flax BatchNorm ``scale``/``bias`` and batch stats ``mean``/``var`` are
  ``weight``/``bias`` and ``running_mean``/``running_var``. Flax momentum
  0.9 is PyTorch momentum 0.1 (``SpectralGNN`` sets it); it matters only in
  training;
* GAT attention vectors are (1, C) in Flax and (C,) here.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch


def _t(a, transpose: bool = False) -> torch.Tensor:
    a = np.asarray(a, np.float32)
    return torch.tensor(a.T if transpose else a)


def _dense(out: dict, prefix: str, p: Mapping) -> None:
    out[f"{prefix}.weight"] = _t(p["kernel"], transpose=True)
    out[f"{prefix}.bias"] = _t(p["bias"])


def _bn(out: dict, prefix: str, p: Mapping, stats: Mapping) -> None:
    out[f"{prefix}.weight"] = _t(p["scale"])
    out[f"{prefix}.bias"] = _t(p["bias"])
    out[f"{prefix}.running_mean"] = _t(stats["mean"])
    out[f"{prefix}.running_var"] = _t(stats["var"])
    out[f"{prefix}.num_batches_tracked"] = torch.tensor(0)


def from_flax(params: Mapping, batch_stats: Mapping) -> Dict[str, torch.Tensor]:
    """Flax ``SpectralGNN`` (params, batch_stats) → a ``state_dict`` for
    ``models.gnn.SpectralGNN`` with the same widths and layer count."""
    n_layers = sum(1 for k in params if k.startswith("EdgeGATLayer_"))
    out: Dict[str, torch.Tensor] = {}
    _dense(out, "input_proj", params["Dense_0"])
    _bn(out, "input_bn", params["BatchNorm_0"], batch_stats["BatchNorm_0"])
    for i in range(n_layers):
        g = params[f"EdgeGATLayer_{i}"]
        pre = f"gat_layers.{i}"
        out[f"{pre}.lin.weight"] = _t(g["lin"], transpose=True)
        out[f"{pre}.att_src"] = _t(g["att_src"]).reshape(-1)
        out[f"{pre}.att_dst"] = _t(g["att_dst"]).reshape(-1)
        out[f"{pre}.bias"] = _t(g["bias"])
        if "lin_edge" in g:
            out[f"{pre}.lin_edge.weight"] = _t(g["lin_edge"], transpose=True)
            out[f"{pre}.att_edge"] = _t(g["att_edge"]).reshape(-1)
        _bn(out, f"gat_bns.{i}", params[f"BatchNorm_{i + 1}"],
            batch_stats[f"BatchNorm_{i + 1}"])
    _dense(out, "output_proj", params["Dense_1"])
    if "residual_proj" in params:
        _dense(out, "residual_proj", params["residual_proj"])
    return out
