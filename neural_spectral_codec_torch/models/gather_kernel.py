"""Row gathers whose backward is kernel G (``csrc/gather_bwd.cu``): the
segment sum of the gradient rows into the gathered rows, without atomics.

It is no Pallas kernel's port: inside the JAX package's train step
(``neural_spectral_codec_tpu/training/trainer.py`` ``train_step``, :73)
XLA derives the transpose of the row gathers itself: the three triplet
gathers ``emb[anchor_idx]``, ``emb[pos_idx]``, ``emb[neg_idx]`` (:86) and
the GAT's neighbour gather ``jnp.take(h, neighbors)`` (``models/gnn.py``,
:70). PyTorch's
backward of ``index_select`` is ``index_add_``, which sums with atomics on
a card, in an order that changes from run to run; G sums each destination
row's segment in increasing order of position, in float32 (a bfloat16
row rounded once at the end), as the CPU's sequential ``index_add_`` sums
it, so a train step gives the same bits on every run and a replayed train
graph the same bits as its eager step.

``make_plan(idx, n_rows, valid)`` builds the segment table on the tensors'
device: a stable sort of the index (positions with ``valid`` False get the
key ``n_rows`` and fall out of every segment) and the segment starts by a
search of the sorted keys, no atomics and no host synchronisation, so it
captures. ``gather_rows(src, idx, plan)`` is the gather as a
``torch.autograd.Function``: forward ``index_select``, backward G. A CPU
tensor takes the plain version (``gather_bwd_plain``), which adds in the
same order and equals the CPU's ``index_add_`` into zeros bit for bit; a
CUDA tensor launches G or raises.

The GAT's neighbour gather passes its mask as ``valid``: its table is
of the valid slots only, built inside the train step like the triplet
gathers' tables. A masked slot carries a gradient of ±0 (its attention is
0 and its logit is masked), and a ±0 added to a sum that starts at +0
never changes its bits, so leaving those slots out gives ``index_add_``'s
result over all slots, while the padding slots (index 0) would otherwise
make row 0's segment as long as the graph.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import torch

DTYPES = {torch.float32: 0, torch.bfloat16: 1}


@functools.lru_cache(maxsize=None)
def _kernel():
    # bound at first use: the GNN imports this module, and importing the
    # package loads no kernel machinery
    from neural_spectral_codec_torch._build import CudaKernel
    return CudaKernel("nsc_gather_bwd", [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])


def __getattr__(name: str):
    if name == "KERNEL":        # kernel G's binding, with its launch count
        return _kernel()
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


class Plan(NamedTuple):
    """Segment table of an index into ``n_rows`` rows: ``order`` (P,) int32
    positions stably sorted by their row (left-out positions last),
    ``offsets`` (n_rows + 1,) int32, row r's positions being
    ``order[offsets[r]:offsets[r + 1]]``."""
    order: torch.Tensor
    offsets: torch.Tensor


def make_plan(idx: torch.Tensor, n_rows: int,
              valid: Optional[torch.Tensor] = None) -> Plan:
    """The segment table of ``idx`` (1-d, values in [0, n_rows)) on its
    device; positions whose ``valid`` is False are in no segment."""
    key = idx.reshape(-1).to(torch.int64)
    if valid is not None:
        key = torch.where(valid.reshape(-1), key, n_rows)
    sorted_key, order = torch.sort(key, stable=True)
    rows = torch.arange(n_rows + 1, device=key.device, dtype=torch.int64)
    offsets = torch.searchsorted(sorted_key, rows)
    return Plan(order.to(torch.int32), offsets.to(torch.int32))


def gather_bwd_plain(grad: torch.Tensor, plan: Plan,
                     n_rows: int) -> torch.Tensor:
    """(n_rows, C) segment sums of ``grad`` (P, C) of ``grad``'s type: step
    k adds every row's k-th position, so each row is summed in increasing
    order of position from +0, one rounded add at a time, in float32 for
    a bfloat16 gradient (rounded once at the end), as the CPU's
    ``index_add_`` sums it. Reads the longest segment's length on the
    host."""
    acc_dtype = (torch.float32 if grad.dtype == torch.bfloat16
                 else grad.dtype)
    out = torch.zeros((n_rows, grad.shape[1]), dtype=acc_dtype,
                      device=grad.device)
    starts = plan.offsets[:-1].to(torch.int64)
    counts = plan.offsets[1:].to(torch.int64) - starts
    order = plan.order.to(torch.int64)
    for k in range(int(counts.max()) if n_rows else 0):
        rows = torch.nonzero(counts > k)[:, 0]
        out[rows] = out[rows] + grad[order[starts[rows] + k]].to(acc_dtype)
    return out.to(grad.dtype)


def gather_bwd_cuda(grad: torch.Tensor, plan: Plan,
                    n_rows: int) -> torch.Tensor:
    """Launch kernel G: ``grad`` (P, C) float32 or bfloat16 and the plan's
    int32 tensors on one card → (n_rows, C) of ``grad``'s type. Types,
    shapes and contiguity are checked first (``ValueError``, nothing
    launched)."""
    if grad.dtype not in DTYPES:
        raise ValueError(f"gather_bwd_cuda: float32 or bfloat16 gradients, "
                         f"got {grad.dtype}")
    if grad.dim() != 2 or n_rows < 1 or grad.shape[1] < 1:
        raise ValueError(f"gather_bwd_cuda: a (P, C) gradient into n_rows "
                         f">= 1 rows, got {tuple(grad.shape)} into {n_rows}")
    if (plan.order.dtype != torch.int32 or plan.offsets.dtype != torch.int32
            or plan.offsets.shape != (n_rows + 1,)
            or plan.order.shape[0] > grad.shape[0]):
        raise ValueError("gather_bwd_cuda: the plan does not fit the "
                         "gradient (make_plan)")
    from neural_spectral_codec_torch._build import check_contiguous
    for t, what in ((grad, "grad"), (plan.order, "order"),
                    (plan.offsets, "offsets")):
        if t.device.type != "cuda" or t.device != grad.device:
            raise ValueError(f"gather_bwd_cuda: {what} on {t.device}, "
                             f"needs the card of grad ({grad.device})")
        check_contiguous(t, f"gather_bwd_cuda {what}")
    out = torch.empty((n_rows, grad.shape[1]), dtype=grad.dtype,
                      device=grad.device)
    with torch.cuda.device(grad.device):
        _kernel()(grad.data_ptr(), plan.order.data_ptr(),
                  plan.offsets.data_ptr(), out.data_ptr(), n_rows,
                  grad.shape[1], DTYPES[grad.dtype],
                  torch.cuda.current_stream(grad.device).cuda_stream)
    return out


def gather_bwd(grad: torch.Tensor, plan: Plan, n_rows: int) -> torch.Tensor:
    """Kernel G on CUDA tensors, its plain version on CPU tensors."""
    if grad.device.type == "cpu":
        return gather_bwd_plain(grad, plan, n_rows)
    return gather_bwd_cuda(grad.contiguous(), plan, n_rows)


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, src, idx, order, offsets):
        ctx.save_for_backward(order, offsets)
        ctx.n_rows = src.shape[0]
        return src.index_select(0, idx)

    @staticmethod
    def backward(ctx, grad):
        order, offsets = ctx.saved_tensors
        dsrc = gather_bwd(grad, Plan(order, offsets), ctx.n_rows)
        return dsrc, None, None, None


def gather_rows(src: torch.Tensor, idx: torch.Tensor,
                plan: Optional[Plan] = None,
                valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``src.index_select(0, idx)`` whose backward is G. ``plan`` is
    ``idx``'s table (built here from ``idx`` and ``valid`` when None;
    positions outside the plan must get a zero gradient). Without
    autograd it is ``index_select``."""
    if not (torch.is_grad_enabled() and src.requires_grad):
        return src.index_select(0, idx)
    if plan is None:
        plan = make_plan(idx, src.shape[0], valid)
    return _GatherRows.apply(src, idx, plan.order, plan.offsets)

