"""One chunk of the triplet miner's "hard" strategy: its plain PyTorch
version and the binding of its hand-written kernel, ``csrc/mine.cu``
(kernel M).

It is no Pallas kernel's port: the JAX package leaves this work to XLA
inside its mining program (``neural_spectral_codec_tpu/training/miner.py``
``_mine_chunk``, :54-98): the positive and negative masks of a chunk of
anchors against every frame of the sequence, the tiled W₁ running argmin
over each anchor's negatives, and a draw among its positives. Per anchor
a = start .. start + count − 1 of a sequence (positions (n, 3), CDFs (n, B)
float32) it gives the positive and negative counts, the hard negative (the
least W₁ = Σ_b |cdf_a,b − cdf_j,b| over the negatives, summed over b in
increasing order, the lower index on a tie, index 0 when there is none),
``valid`` (a positive and a negative exist) and the positive: with u in
[0, 1) from the miner's generator, the r-th positive in index order, r =
min(⌊u · count_pos⌋, count_pos − 1). JAX's ``jax.random.categorical``
draws cannot be reproduced, only their support; this draw is uniform over
the same support.

``mine_plain`` computes the same with torch operations, frames in tiles of
``tile`` rows so that only (count, tile) temporaries exist, and sums W₁
bin by bin in the kernel's order: the two agree bit for bit. A CPU tensor
takes the plain version, a CUDA tensor the kernel (or the binding raises).
The kernel's header has its design and bound.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Sequence, Union

import torch

ANCHORS_PER_CTA = 64       # kBA in csrc/mine.cu
ROWS_PER_TILE = 64         # kBJ
TILE = 4096                # mine_plain's frames a tile
CPU_BLOCK = 1024           # w1_in_order's rows a block on the CPU


@functools.lru_cache(maxsize=None)
def _kernels() -> tuple:
    # bound at first use: the trainer imports this module, and importing
    # the package loads no kernel machinery
    from neural_spectral_codec_torch._build import CudaKernel
    return (CudaKernel("nsc_mine_hard", [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, *[ctypes.c_float] * 5, ctypes.c_int,
        *[ctypes.c_void_p] * 7]),
        CudaKernel("nsc_mine_draw", [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
            *[ctypes.c_float] * 5, *[ctypes.c_void_p] * 4]))


def __getattr__(name: str):
    # kernel M's two entries, each with its launch count: HARD (counts and
    # hard negatives) and DRAW (the positive)
    if name in ("HARD", "DRAW"):
        return _kernels()[name == "DRAW"]
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


class Mined(NamedTuple):
    """One chunk's per-anchor results: int32 ``pos_idx``, ``neg_idx``,
    ``count_pos``, ``count_neg`` and bool ``valid``, each (count,)."""
    pos_idx: torch.Tensor
    neg_idx: torch.Tensor
    count_pos: torch.Tensor
    count_neg: torch.Tensor
    valid: torch.Tensor


def chunk_masks(positions: torch.Tensor, a: torch.Tensor, j0: int,
                j1: int, params: Sequence[float]):
    """(pos, neg) masks (len(a), j1 − j0) of the anchors at global indices
    ``a`` against frames j0 .. j1 − 1: ‖a − p‖ from per-coordinate
    differences, (dx² + dy²) + dz² each rounded, then sqrt; the temporal
    gap against the float32 thresholds."""
    rows = positions[j0:j1]
    pa = positions[a]
    d2 = None
    for c in range(positions.shape[1]):
        diff = pa[:, c, None] - rows[None, :, c]
        d2 = diff * diff if d2 is None else d2 + diff * diff
    d = torch.sqrt(d2)
    gap = (a.to(torch.int32)[:, None] - torch.arange(
        j0, j1, dtype=torch.int32, device=a.device)[None, :]).abs()
    fgap = gap.to(torch.float32)
    not_self = gap > 0
    pos = (d < params[0]) & (fgap >= params[1]) & not_self
    neg = ((d >= params[2]) & (d <= params[3]) & (fgap >= params[4])
           & not_self)
    return pos, neg


def w1_in_order(acdf: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """(len(acdf), len(rows)) W₁ sums, bin by bin in increasing order, each
    difference and sum rounded to float32 (the kernel's order). The bins
    become the leading axis once and the sum is added to in place; on the
    CPU the rows go in blocks of ``CPU_BLOCK``, so that the (count, block)
    sum stays in cache."""
    at = acdf.T.contiguous()
    block = CPU_BLOCK if acdf.device.type == "cpu" else max(len(rows), 1)
    out = []
    for r0 in range(0, len(rows), block):
        rt = rows[r0:r0 + block].T.contiguous()
        acc = (at[0][:, None] - rt[0][None, :]).abs_()
        tmp = torch.empty_like(acc)
        for b in range(1, at.shape[0]):
            acc.add_(torch.sub(at[b][:, None], rt[b][None, :],
                               out=tmp).abs_())
        out.append(acc)
    return out[0] if len(out) == 1 else torch.cat(out, dim=1)


def mine_plain(positions: torch.Tensor, cdfs: torch.Tensor,
               start: Union[int, torch.Tensor], count: int,
               params: Sequence[float], u: torch.Tensor,
               tile: int = TILE) -> Mined:
    """Kernel M's function with torch operations, over frame tiles of
    ``tile`` rows (a running (W₁, index) min, strict <, so the earlier tile
    keeps a tie; NaN sums are never taken, as in the kernel)."""
    n = positions.shape[0]
    dev = positions.device
    s = int(start)
    a = torch.arange(s, s + count, dtype=torch.int64, device=dev)
    acdf = cdfs[s:s + count]
    inf = torch.tensor(float("inf"), device=dev)
    best = torch.full((count,), float("inf"), device=dev)
    best_i = torch.zeros(count, dtype=torch.int64, device=dev)
    cpos = torch.zeros(count, dtype=torch.int64, device=dev)
    cneg = torch.zeros(count, dtype=torch.int64, device=dev)
    for j0 in range(0, n, tile):
        j1 = min(j0 + tile, n)
        pos, neg = chunk_masks(positions, a, j0, j1, params)
        cpos += pos.sum(dim=1)
        cneg += neg.sum(dim=1)
        w1 = w1_in_order(acdf, cdfs[j0:j1])
        w1 = torch.where(neg & (w1 == w1), w1, inf)
        targ = w1.argmin(dim=1)
        tmin = w1.gather(1, targ[:, None])[:, 0]
        upd = tmin < best
        best = torch.where(upd, tmin, best)
        best_i = torch.where(upd, targ + j0, best_i)
    # the r-th positive in index order
    cnt = cpos.to(torch.float32)
    r = torch.minimum(torch.floor(u * cnt).to(torch.int64), cpos - 1)
    pos_i = torch.zeros(count, dtype=torch.int64, device=dev)
    seen = torch.zeros(count, dtype=torch.int64, device=dev)
    found = cpos == 0
    for j0 in range(0, n, tile):
        j1 = min(j0 + tile, n)
        pos, _ = chunk_masks(positions, a, j0, j1, params)
        at = pos & (torch.cumsum(pos, dim=1) + seen[:, None] == r[:, None] + 1)
        hit = at.any(dim=1) & ~found
        pos_i = torch.where(hit, at.to(torch.uint8).argmax(dim=1) + j0, pos_i)
        found |= hit
        seen += pos.sum(dim=1)
    i32 = torch.int32
    return Mined(pos_i.to(i32), best_i.to(i32), cpos.to(i32), cneg.to(i32),
                 (cpos > 0) & (cneg > 0))


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def row_splits(n: int, count: int, sm_count: int) -> int:
    """The kernel's frame splits (grid.x): about two CTAs an SM over the
    chunk's anchor tiles, at most one split a frame tile. The answer does
    not depend on it."""
    tiles = -(-count // ANCHORS_PER_CTA)
    return max(1, min(-(-n // ROWS_PER_TILE), -(-2 * sm_count // tiles)))


def _check(t: torch.Tensor, shape: tuple, dtype, dev, what: str) -> None:
    from neural_spectral_codec_torch._build import check_contiguous
    if tuple(t.shape) != shape or t.dtype != dtype:
        raise ValueError(f"mine_cuda {what}: expected {shape} {dtype}, got "
                         f"{tuple(t.shape)} {t.dtype}")
    if t.device != dev:
        raise ValueError(f"mine_cuda {what} on {t.device}, positions on "
                         f"{dev}")
    check_contiguous(t, f"mine_cuda {what}")


def mine_cuda(positions: torch.Tensor, cdfs: torch.Tensor,
              start: torch.Tensor, count: int, params: Sequence[float],
              u: torch.Tensor) -> Mined:
    """Launch kernel M's two entries on the card: positions (n, 3), cdfs
    (n, B), u (count,) float32 and start (1,) int32 (start + count ≤ n, read
    on the device), all on one card. Types, shapes and contiguity are
    checked first (``ValueError``, nothing launched)."""
    dev = positions.device
    if dev.type != "cuda":
        raise ValueError(f"mine_cuda needs CUDA tensors, got {dev}")
    n = positions.shape[0]
    if not 1 <= count <= n:
        raise ValueError(f"mine_cuda: count {count} outside 1 .. {n}")
    f32 = torch.float32
    _check(positions, (n, 3), f32, dev, "positions")
    _check(cdfs, (n, cdfs.shape[1] if cdfs.dim() == 2 else -1), f32, dev,
           "cdfs")
    _check(start, (1,), torch.int32, dev, "start")
    _check(u, (count,), f32, dev, "u")
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    splits = row_splits(n, count, _sm_count(index))
    i32 = torch.int32
    partial = torch.empty((splits, count, 4), dtype=i32, device=dev)
    tickets = torch.zeros(-(-count // ANCHORS_PER_CTA), dtype=i32,
                          device=dev)
    out = Mined(*(torch.empty(count, dtype=i32, device=dev)
                  for _ in range(4)),
                torch.empty(count, dtype=torch.bool, device=dev))
    p = [float(v) for v in params]
    hard, draw = _kernels()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        hard(positions.data_ptr(), cdfs.data_ptr(), start.data_ptr(), n,
             count, cdfs.shape[1], *p, splits, partial.data_ptr(),
             tickets.data_ptr(), out.neg_idx.data_ptr(),
             out.count_pos.data_ptr(), out.count_neg.data_ptr(),
             out.valid.data_ptr(), stream)
        draw(positions.data_ptr(), start.data_ptr(), n, count, *p,
             u.data_ptr(), out.count_pos.data_ptr(), out.pos_idx.data_ptr(),
             stream)
    return out


def mine(positions: torch.Tensor, cdfs: torch.Tensor, start, count: int,
         params: Sequence[float], u: torch.Tensor,
         tile: int = TILE) -> Mined:
    """Kernel M on CUDA tensors (``start`` a (1,) int32 device tensor),
    its plain version on CPU tensors (``tile`` frames a tile)."""
    if positions.device.type == "cpu":
        return mine_plain(positions, cdfs, start, count, params, u, tile)
    return mine_cuda(positions, cdfs, start, count, params, u)
