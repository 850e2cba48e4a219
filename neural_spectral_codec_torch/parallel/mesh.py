"""Device meshes of one controller, and the placement helpers.

Port of ``neural_spectral_codec_tpu/parallel/mesh.py``. One process
drives every device, as one JAX process drives a ``jax.sharding.Mesh``:
a ``Mesh`` is an ordered tuple of ``torch.device``s along one ``"data"``
axis. Repeats are allowed, so ``Mesh([torch.device("cpu")] * 8)`` plays
the part of the 8 virtual XLA CPU devices of the JAX tests, and
``Mesh([torch.device("cuda", 0)] * 4)`` runs four shards on one card.

Collectives are device-to-device copies made by this process: an
all-gather is ``.to(devices[0])`` and a concatenation (``all_gather``), a
gradient ``psum`` is autograd's accumulation through differentiable
``.to`` copies of the master parameters. A launcher and one rank per
device (``torch.distributed``) would make every serving query need every
rank; the JAX entry points take a mesh inside one process instead.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from neural_spectral_codec_torch.device import DeviceLike, resolve_device


class Mesh:
    """A 1-D mesh: ``devices`` along the axis ``"data"``; ``shape`` reads
    as a JAX mesh's does."""

    def __init__(self, devices: Sequence[DeviceLike]):
        self.devices: Tuple[torch.device, ...] = tuple(
            resolve_device(d) for d in devices)
        if not self.devices:
            raise ValueError("a mesh needs at least one device")

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def shape(self) -> dict:
        return {"data": self.size}

    def __repr__(self) -> str:
        return f"Mesh({[str(d) for d in self.devices]})"


def devices_of(device_type: str) -> List[torch.device]:
    """Every device of a type, in order: ``cuda:0 .. cuda:N-1``; the CPU
    is one device."""
    if device_type == "cuda":
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    if device_type == "cpu":
        return [torch.device("cpu")]
    raise ValueError(f"unsupported device type {device_type!r}")


def create_mesh(n_devices: Optional[int] = None,
                device: DeviceLike = "cuda") -> Mesh:
    """A mesh over the first ``n_devices`` devices of ``device``'s type
    (all of them by default); more than exist raises."""
    devices = devices_of(torch.device(device).type)
    if n_devices is not None:
        if n_devices > len(devices):
            raise ValueError(f"requested {n_devices} devices, only "
                             f"{len(devices)} present")
        devices = devices[:n_devices]
    return Mesh(devices)


def data_sharding(mesh: Mesh, n: int) -> List[Tuple[torch.device, slice]]:
    """Where the rows of a leading dimension of ``n`` go: one contiguous
    slab of ``n / mesh.size`` rows per device, in mesh order. ``n`` must
    divide (pad first: ``parallel.train.pad_to_multiple``)."""
    if n % mesh.size:
        raise ValueError(f"leading dim {n} not divisible by mesh axis "
                         f"'data' of size {mesh.size}")
    step = n // mesh.size
    return [(d, slice(i * step, (i + 1) * step))
            for i, d in enumerate(mesh.devices)]


def shard_array(arr, mesh: Mesh) -> List[torch.Tensor]:
    """A numpy array or tensor split along its leading dimension into one
    slab per device, each moved to its device."""
    t = torch.as_tensor(arr)
    return [t[sl].to(d) for d, sl in data_sharding(mesh, t.shape[0])]


def replicate(tree, mesh: Mesh) -> list:
    """One copy of ``tree`` (a tensor, or a dict, list, tuple or
    NamedTuple of them) per device; the copy on a device the tensor
    already lives on is the tensor itself."""
    def place(x, d):
        if torch.is_tensor(x):
            return x.to(d)
        if isinstance(x, dict):
            return {k: place(v, d) for k, v in x.items()}
        if isinstance(x, tuple) and hasattr(x, "_fields"):   # NamedTuple
            return type(x)(*(place(v, d) for v in x))
        if isinstance(x, (list, tuple)):
            return type(x)(place(v, d) for v in x)
        return x
    return [place(tree, d) for d in mesh.devices]


def all_gather(parts: Sequence[torch.Tensor],
               device: torch.device) -> torch.Tensor:
    """Per-device slabs concatenated on ``device``, in order
    (differentiable)."""
    return torch.cat([p.to(device) for p in parts])
