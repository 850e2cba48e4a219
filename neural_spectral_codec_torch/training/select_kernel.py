"""Kernel S: for each row of a float32 block, the column at a given place
of the row's stable ascending order. Its plain PyTorch version and the
binding of its hand-written kernel, ``csrc/select.cu``.

It is no Pallas kernel's port: the JAX package leaves this work to XLA
inside its mining program (``neural_spectral_codec_tpu/training/miner.py``
``_mine_chunk`` with "semi-hard", :99-105), as ``jnp.argsort`` of each
anchor's masked W₁ row and the column at place ``count_neg // 2``. For a
(rows, n) block x and a per-row place k (int32, clamped to 0 .. n − 1) it
returns the column that ``torch.sort(x[r], stable=True).indices[k[r]]``
returns, which is also the order of JAX's ``jnp.argsort``: equal values
by the lower column, −0 equal to +0, +inf after every finite value and
every NaN last (NaNs equal to each other).

``select_plain`` ranks the order-mapped keys (``order_keys``: the float's
bits as a signed integer of the same order, as
``retrieval/retriever.smallest_k`` maps them, both zeros to 0 and NaN to
the largest) joined with their column into one int64 key, so the keys
are distinct and one sort of them is the stable order. A CPU tensor
takes the plain version, a CUDA tensor the kernel (or the binding
raises). The kernel's header has its design and bound.

The kernel has two regimes, chosen by the row length n alone
(``select_layout``): up to ``CLUSTER_MAX × SLICE_ONE`` columns a row
is held in the shared memory of a cluster of ``select_layout(n)`` CTAs,
one contiguous slice each; a longer row streams from device memory
through one CTA.
"""

from __future__ import annotations

import ctypes
import functools

import torch


CLUSTER_MAX = 8            # kClusterMax in csrc/select.cu
SLICE_TWO = 25_600         # kSliceTwo: columns a CTA at 2 CTAs an SM
SLICE_ONE = 54_784         # kSliceOne: columns a CTA at 1 CTA an SM


def select_layout(n: int) -> int:
    """The kernel's regime for rows of n columns: the cluster width C
    (CTAs a row, each holding a slice of ⌈n / C⌉ columns in its shared
    memory), ⌈n / SLICE_TWO⌉ while that is at most CLUSTER_MAX, else
    CLUSTER_MAX while ⌈n / CLUSTER_MAX⌉ ≤ SLICE_ONE; 0 (one CTA a row,
    streaming the row from device memory) past that."""
    for slice_max in (SLICE_TWO, SLICE_ONE):
        ctas = -(-n // slice_max)
        if ctas <= CLUSTER_MAX:
            return ctas if slice_max == SLICE_TWO else CLUSTER_MAX
    return 0


@functools.lru_cache(maxsize=None)
def _kernel():
    # bound at first use: the miner imports this module, and importing the
    # package loads no kernel machinery
    from neural_spectral_codec_torch._build import CudaKernel
    return CudaKernel("nsc_select_rows", [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p])


def __getattr__(name: str):
    # the kernel's entry, with its launch count
    if name == "KERNEL":
        return _kernel()
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def order_keys(x: torch.Tensor) -> torch.Tensor:
    """int32 keys of float32 ``x`` in the selection's order: the bits of a
    positive value as they are, those of a negative value with the 31 low
    bits flipped, both zeros 0, every NaN the largest int32."""
    bits = x.contiguous().view(torch.int32)
    keys = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits)
    keys = torch.where(x == 0, 0, keys)
    return torch.where(torch.isnan(x), torch.iinfo(torch.int32).max, keys)


def select_plain(x: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Kernel S's function with torch operations: x (rows, n) float32, k
    (rows,) integer places; (rows,) int32 columns."""
    n = x.shape[1]
    col = torch.arange(n, dtype=torch.int64, device=x.device)
    keys = (order_keys(x).to(torch.int64) << 32) | col
    kk = k.to(torch.int64).clamp(0, n - 1)
    ranked = torch.sort(keys, dim=1).values
    return (ranked.gather(1, kk[:, None])[:, 0] & 0xFFFFFFFF).to(torch.int32)


def select_cuda(x: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Launch kernel S on the card in the regime ``select_layout(n)``
    gives: x (rows, n) float32 with contiguous rows (any row stride ≥ n),
    k (rows,) int32 on the same card; (rows,) int32 out. Types, shapes and
    devices are checked first (``ValueError``, nothing launched)."""
    from neural_spectral_codec_torch._build import check_contiguous
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"select_cuda needs CUDA tensors, got {dev}")
    if x.dim() != 2 or x.dtype != torch.float32 or x.shape[0] < 1 \
            or x.shape[1] < 1 or x.stride(1) != 1 or x.stride(0) < x.shape[1]:
        raise ValueError(f"select_cuda: x must be a (rows, n) float32 block "
                         f"with contiguous rows, got {tuple(x.shape)} "
                         f"{x.dtype} strides {x.stride()}")
    rows = x.shape[0]
    if k.shape != (rows,) or k.dtype != torch.int32 or k.device != dev:
        raise ValueError(f"select_cuda: k must be ({rows},) int32 on {dev}, "
                         f"got {tuple(k.shape)} {k.dtype} on {k.device}")
    check_contiguous(k, "select_cuda k")
    out = torch.empty(rows, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        _kernel()(x.data_ptr(), rows, x.shape[1], x.stride(0), k.data_ptr(),
                  out.data_ptr(), select_layout(x.shape[1]),
                  torch.cuda.current_stream(dev).cuda_stream)
    return out


def select(x: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Kernel S on CUDA tensors, its plain version on CPU tensors."""
    if x.device.type == "cpu":
        return select_plain(x, k)
    return select_cuda(x, k)
