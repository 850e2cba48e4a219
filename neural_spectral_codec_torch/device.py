"""Device selection for the PyTorch port.

The caller always names the device. There is no silent fallback: asking
for ``"cuda"`` on a host without a usable CUDA device raises instead of
quietly running on the CPU, so a measurement can never be taken on the
wrong device by accident.
"""

from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device]


def resolve_device(device: DeviceLike) -> torch.device:
    """Return the ``torch.device`` the caller named, checked.

    ``"cpu"`` always resolves. ``"cuda"`` / ``"cuda:N"`` resolves only when
    that CUDA device exists, else ``RuntimeError``. Selecting a CUDA device
    also turns TF32 off for float32 matmuls and cuDNN convolutions
    (``torch.backends.cuda.matmul.allow_tf32 = False`` and
    ``torch.backends.cudnn.allow_tf32 = False``): the port's parity bars
    assume full float32 products, as the JAX package's
    ``Precision.HIGHEST`` does. It also keeps bf16 products' split-K
    partial sums in float32
    (``allow_bf16_reduced_precision_reduction = False``), so a bf16
    product rounds once, as XLA's does. These are process-wide switches.
    """
    dev = torch.device(device)
    if dev.type == "cpu":
        return dev
    if dev.type != "cuda":
        raise ValueError(f"unsupported device type {dev.type!r}; "
                         "use 'cpu' or 'cuda'")
    if not torch.cuda.is_available():
        raise RuntimeError(f"device {str(device)!r} requested but no CUDA "
                           "device is available")
    index = 0 if dev.index is None else dev.index
    if index >= torch.cuda.device_count():
        raise RuntimeError(f"device {str(device)!r} requested but only "
                           f"{torch.cuda.device_count()} CUDA device(s) exist")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    return torch.device("cuda", index)
