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

``from_flax`` also maps a params-shaped tree alone (gradients, Adam
moments); ``from_optax_adam`` maps the state of the JAX package's
optimizer (``optax`` clip → decayed weights → adam) onto a
``torch.optim.Adam``. Reading an Orbax checkpoint needs jax and orbax,
which the port does not import: ``convert_orbax_checkpoint.py`` (at the
repository's root) restores one there and writes the port trainer's
``.pt`` through these two functions.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional

import numpy as np
import torch


def _t(a, transpose: bool = False) -> torch.Tensor:
    a = np.asarray(a, np.float32)
    return torch.tensor(a.T if transpose else a)


def _dense(out: dict, prefix: str, p: Mapping) -> None:
    out[f"{prefix}.weight"] = _t(p["kernel"], transpose=True)
    out[f"{prefix}.bias"] = _t(p["bias"])


def _bn(out: dict, prefix: str, p: Mapping,
        stats: Optional[Mapping]) -> None:
    out[f"{prefix}.weight"] = _t(p["scale"])
    out[f"{prefix}.bias"] = _t(p["bias"])
    if stats is not None:
        out[f"{prefix}.running_mean"] = _t(stats["mean"])
        out[f"{prefix}.running_var"] = _t(stats["var"])
        out[f"{prefix}.num_batches_tracked"] = torch.tensor(0)


def from_flax(params: Mapping, batch_stats: Optional[Mapping] = None
              ) -> Dict[str, torch.Tensor]:
    """Flax ``SpectralGNN`` (params, batch_stats) → a ``state_dict`` for
    ``models.gnn.SpectralGNN`` with the same widths and layer count.
    Without ``batch_stats`` only the parameters are mapped, so a tree
    shaped like ``params`` (gradients, optimizer moments) becomes a dict
    keyed like ``named_parameters()``."""
    n_layers = sum(1 for k in params if k.startswith("EdgeGATLayer_"))

    def stats(i):
        return None if batch_stats is None else batch_stats[f"BatchNorm_{i}"]

    out: Dict[str, torch.Tensor] = {}
    _dense(out, "input_proj", params["Dense_0"])
    _bn(out, "input_bn", params["BatchNorm_0"], stats(0))
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
        _bn(out, f"gat_bns.{i}", params[f"BatchNorm_{i + 1}"], stats(i + 1))
    _dense(out, "output_proj", params["Dense_1"])
    if "residual_proj" in params:
        _dense(out, "residual_proj", params["residual_proj"])
    return out


def from_optax_adam(count, mu: Mapping, nu: Mapping,
                    model: torch.nn.Module,
                    optimizer: torch.optim.Adam) -> dict:
    """optax ``ScaleByAdamState`` (``count``, ``mu``, ``nu``, the last
    two shaped like the Flax params) → a ``state_dict()`` for
    ``optimizer``, an Adam over ``model``'s parameters. ``count`` is the
    number of steps taken (torch's ``step``); ``mu`` and ``nu`` are the
    first and second moments (``exp_avg`` and ``exp_avg_sq``). The
    param groups and their hyperparameters are ``optimizer``'s own."""
    m, v = from_flax(mu), from_flax(nu)
    name_of = {id(p): n for n, p in model.named_parameters()}
    sd = optimizer.state_dict()
    state, index = {}, 0
    for group in optimizer.param_groups:
        for p in group["params"]:
            name = name_of[id(p)]
            if m[name].shape != p.shape or v[name].shape != p.shape:
                raise ValueError(f"{name}: optax moments {tuple(m[name].shape)}"
                                 f" do not fit the parameter "
                                 f"{tuple(p.shape)}")
            state[index] = {"step": torch.tensor(float(np.asarray(count))),
                            "exp_avg": m[name].to(p.device),
                            "exp_avg_sq": v[name].to(p.device)}
            index += 1
    if set(name_of.values()) - {name_of[id(p)] for g in optimizer.param_groups
                                for p in g["params"]}:
        raise ValueError("the optimizer does not hold every parameter of "
                         "the model")
    sd["state"] = state
    return sd
