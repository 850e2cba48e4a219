"""Probe kernels: the ring-fold phase ablation and the roll floors.

Ports of the three Pallas probes of the JAX repository's ``experiments/``,
each with its plain PyTorch version beside its wrapper:

- ``ring_fold_probe`` (``csrc/ring_probe.cu``) replaces
  ``ring_stage_probe._variant_kernel``: the ring fold on precomputed keys,
  laid out as ``ring_fold_pallas`` lays it out, with each phase of the
  Hopper kernel (``scan``, ``fold``, ``scatter``, ``write``) able to be
  switched off. Plain version: ``ring_fold_rows_plain``.
- ``roll_floor`` (``csrc/roll_floor.cu``) replaces
  ``ring_stage_probe._floor_kernel``: ``n_stages`` steps of circular shift,
  compare and select over one or two carried arrays.
- ``roll_min_chain`` (``csrc/roll_floor.cu``) replaces ``_roll_kernel`` of
  ``profile_hotpath.main``: y = x + 1, then ``n_stages`` steps of
  ``y = min(roll(y, 2^(s mod 11)), y)``.

Each roll chain is one circular window (``roll_window``). Where it
covers the row, as every entry point's schedule does, the kernels walk no
stage on a row without a NaN: P3 is the row minimum, P2 the first minimum
at or after each element. A row that holds a NaN, and every row of a
window shorter than the row, runs the stages inside the kernel.

A CPU tensor takes the plain version, a CUDA tensor launches the kernel
(a failed build or launch raises), any other device raises. Rolls follow
``np.roll``: ``roll(a, s)[i] = a[(i − s) mod W]``. Shift schedules are
computed on the host with Python ints and reduced mod the width before
they reach a kernel (the shift of ``_floor_kernel`` doubles every stage
and would overflow an int32 after 31 stages).
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Iterable, List, Sequence, Tuple

import torch

from neural_spectral_codec_torch._build import CudaKernel, check_contiguous
from neural_spectral_codec_torch.ops.range_image import ProjectionConfig
from neural_spectral_codec_torch.ops.ring_path import _ring_keys, wrap_folds

# the phases of csrc/ring_probe.cu: the first/last half of the chunk
# summary and its scan, the wrap-event half, the shared-memory atomicMin,
# the +inf -> 0 write (ring_fold_probe)
PHASES = ("scan", "fold", "scatter", "write")
# the TPU kernel's stage classes that each Hopper phase replaces
# (ring_stage_probe.CLASSES): the last valid bin before each point (the
# jump-fill), the wrap count before it (fold index, rank prefix), the
# per-slot min and its placement (run-min, compaction, expansion)
REPLACES = {"scan": ("jump",), "fold": ("fold", "rank"),
            "scatter": ("runmin", "compact", "expand"), "write": ()}
MAX_STAGES = 128                 # kMaxStages in csrc/roll_floor.cu

RING_PROBE = CudaKernel("nsc_ring_probe", [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ctypes.c_void_p])
ROLL_FLOOR = CudaKernel("nsc_roll_floor", [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ctypes.c_void_p])
ROLL_MIN_CHAIN = CudaKernel("nsc_roll_min_chain", [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
    ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p])


def folded_width(n_azim: int, n_folds: int) -> int:
    """``n_folds · n_azim`` rounded up to 128, the TPU kernel's ``wpad``."""
    return -(-(n_folds * n_azim) // 128) * 128


def _check_rows(what: str, *tensors: torch.Tensor) -> None:
    for t in tensors:
        if t.dim() != 2 or t.dtype != torch.float32:
            raise ValueError(f"{what}: expected 2-D float32 tensors, got "
                             f"{tuple(t.shape)} {t.dtype}")
        if t.shape != tensors[0].shape or t.device != tensors[0].device:
            raise ValueError(f"{what}: operands differ in shape or device")


def _kernel_device(what: str, t: torch.Tensor) -> bool:
    """True for a CUDA tensor (launch the kernel), False for a CPU tensor
    (plain version); any other device raises."""
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise ValueError(f"{what} needs a CPU or CUDA tensor, got "
                         f"{t.device}")
    check_contiguous(t, what)
    return True


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _shift_array(shifts: List[int]):
    if len(shifts) > MAX_STAGES:
        raise ValueError(f"at most {MAX_STAGES} stages, got {len(shifts)}")
    return (ctypes.c_int * max(len(shifts), 1))(*shifts)


# ---------------------------------------------------------------------------
# P1: the ring fold on precomputed keys, with phases that switch off
# ---------------------------------------------------------------------------

def ring_fold_rows_plain(key: torch.Tensor, vals: torch.Tensor,
                         n_azim: int, n_folds: int) -> torch.Tensor:
    """Plain version of the fold kernel: (N, P) float32 azimuth bins
    (−1 or any value outside [0, n_azim) = invalid or padding) and ranges
    (+inf there) → (N, wpad) folded rows. Slot ``f·n_azim + bin`` holds
    the min range over the kept valid points of fold ``f`` in that bin, 0
    when there is none; slots from ``n_folds·n_azim`` on are 0. The fold
    rule is ``ring_path.wrap_folds``; this is the output of
    ``pallas_ring.ring_fold_pallas`` before ``_fold_min``."""
    _check_rows("ring_fold_rows", key, vals)
    n = key.shape[0]
    wpad = folded_width(n_azim, n_folds)
    bins = torch.where((key >= 0) & (key < n_azim), key, -1.0).long()
    keep, fold = wrap_folds(bins, n_folds)
    base = torch.arange(n, device=key.device)[:, None] * wpad
    target = torch.where(keep, bins + fold * n_azim + base, n * wpad)
    buf = torch.full((n * wpad + 1,), math.inf, dtype=torch.float32,
                     device=key.device)
    buf.scatter_reduce_(0, target.reshape(-1),
                        torch.where(keep, vals, math.inf).reshape(-1), "amin")
    rows = buf[:-1].reshape(n, wpad)
    return torch.where(torch.isinf(rows), 0.0, rows)


def ring_keys_padded(points: torch.Tensor, config: ProjectionConfig):
    """(B, R, P, 4) scans → (B·R, Ppad) float32 keys (−1 = invalid or pad)
    and ranges (+inf there), Ppad = P rounded up to 128 (the JAX probe's
    padding, ring_stage_probe.py:260-266)."""
    vals, key = _ring_keys(points, config)
    p = points.shape[2]
    ppad = -(-p // 128) * 128
    key = torch.nn.functional.pad(key.float(), (0, ppad - p), value=-1.0)
    vals = torch.nn.functional.pad(vals, (0, ppad - p), value=math.inf)
    return (key.reshape(-1, ppad).contiguous(),
            vals.reshape(-1, ppad).contiguous())


def fold_min_rows(folded: torch.Tensor, batch: int, n_rings: int,
                  n_azim: int, n_folds: int) -> torch.Tensor:
    """(B·R, wpad) folded rows → (B, R, n_azim): min over folds, 0 = empty
    (JAX ``ring_path._fold_min``)."""
    x = folded[:, :n_folds * n_azim].reshape(batch, n_rings, n_folds, n_azim)
    x = torch.where(x > 0.0, x, math.inf).amin(dim=2)
    return torch.where(torch.isinf(x), 0.0, x)


def ring_fold_probe(key: torch.Tensor, vals: torch.Tensor, n_azim: int,
                    n_folds: int, skip: Iterable[str] = ()) -> torch.Tensor:
    """The fold kernel on precomputed keys: (N, P) float32 bins and ranges
    → (N, wpad) folded rows, as ``ring_fold_rows_plain``. Ranges must be
    >= 0 or +inf (the kernel orders them by their bits).

    Each thread of the kernel owns a contiguous chunk of a row and
    summarises it as {first valid bin, last valid bin, wrap events}; one
    exclusive scan of those summaries gives every chunk the bin of the
    valid point before it and the events before it. ``skip`` names phases
    to replace by a trivial stand-in, so that the others run the same
    instructions:
      * ``scan`` (the first/last half of the summary and its scan) →
        every chunk starts after bin −1;
      * ``fold`` (the wrap-event half) → every chunk starts at fold 0;
        with both off there is no scan at all;
      * ``scatter`` (shared-memory ``atomicMin`` on the range's bits into
        slot ``fold·n_azim + bin``) → a plain store;
      * ``write`` (+inf → 0 on the way out) → an integer clamp of +inf to
        the largest finite float.
    With ``skip=()`` the output equals ``ring_fold_rows_plain`` bit for
    bit. Switching phases off exists only in the kernel: a CPU tensor
    with ``skip`` raises. A thread of the kernel holds at most 12 points
    of a row in registers, at most 512 threads a row: rows up to 6,144
    points; the C entry point refuses wider ones with an error, which
    raises here."""
    skip = tuple(skip)
    unknown = set(skip) - set(PHASES)
    if unknown:
        raise ValueError(f"unknown phases {sorted(unknown)}; "
                         f"choose from {PHASES}")
    _check_rows("ring_fold_probe", key, vals)
    if n_folds < 1 or n_azim < 1:
        raise ValueError("n_folds and n_azim must be >= 1")
    if not _kernel_device("ring_fold_probe", key):
        if skip:
            raise ValueError("phases switch off only in the CUDA kernel")
        return ring_fold_rows_plain(key, vals, n_azim, n_folds)
    check_contiguous(vals, "ring_fold_probe")
    n, p = key.shape
    wpad = folded_width(n_azim, n_folds)
    out = torch.empty((n, wpad), dtype=torch.float32, device=key.device)
    if n == 0:
        return out
    mask = sum(1 << PHASES.index(ph) for ph in set(skip))
    with torch.cuda.device(key.device):
        RING_PROBE(key.data_ptr(), vals.data_ptr(), out.data_ptr(), n, p,
                   n_azim, n_folds, wpad, mask, _stream(key))
    return out


# ---------------------------------------------------------------------------
# P2, P3: roll + compare + select floors
# ---------------------------------------------------------------------------

def floor_shifts(width: int, n_stages: int) -> List[int]:
    """The roll amounts of ``_floor_kernel``: ``width − (sh mod width or
    1)`` with ``sh = 2^stage``, in Python ints."""
    out, sh = [], 1
    for _ in range(n_stages):
        out.append(width - (sh % width or 1))
        sh *= 2
    return out


def chain_shifts(width: int, n_stages: int) -> List[int]:
    """The roll amounts of ``_roll_kernel``: ``2^(s mod 11)`` mod width."""
    return [(1 << (s % 11)) % width for s in range(n_stages)]


def roll_window(offsets: Sequence[int], width: int) -> Tuple[int, bool]:
    """(L, saturated) of a roll chain whose stages reach ``offsets`` (each
    in [0, width)): P3's shifts, which look back, or P2's forward offsets
    ``(width − shift) mod width``. A chain of min-stages reaches every
    subset sum of its offsets; sorted, each offset at most 1 + the sum of
    those before it makes that set the range [0, Σ], so the chain is a
    circular window of ``L = min(Σ + 1, width)`` elements, and
    ``saturated`` says it covers the row (``L == width``). Raises where
    the set is not one range (no schedule of ``floor_shifts`` or
    ``chain_shifts`` does: ``tests/test_torch_roll_window.py``)."""
    offsets = sorted(offsets)
    if width < 1 or offsets and not 0 <= offsets[0] <= offsets[-1] < width:
        raise ValueError(f"roll_window: offsets {offsets} outside [0, "
                         f"{width})")
    total = 0
    for o in offsets:
        if o > total + 1:
            raise ValueError(f"roll_window: offsets {offsets} reach no "
                             f"single range (gap after {total})")
        total += o
    window = min(total + 1, width)
    return window, window == width


@functools.lru_cache(maxsize=256)
def _floor_plan(width: int, n_stages: int):
    """(window, ctypes shift array) of the floor kernel, per width and
    stage count, its offsets checked to form one range (the array is read
    by the C entry point, never written)."""
    shifts = floor_shifts(width, n_stages)
    window, _ = roll_window([(width - s) % width for s in shifts], width)
    return window, _shift_array(shifts)


@functools.lru_cache(maxsize=256)
def _chain_plan(width: int, n_stages: int):
    """(window, ctypes shift array) of the chain kernel."""
    shifts = chain_shifts(width, n_stages)
    return roll_window(shifts, width)[0], _shift_array(shifts)


def roll_floor_plain(x: torch.Tensor, y: torch.Tensor, n_stages: int,
                     n_arrays: int) -> torch.Tensor:
    """Plain version of the floor kernel: carry ``a = x`` (and ``b = y``
    when ``n_arrays == 2``) through ``n_stages`` steps of ``a_s =
    roll(a, s)``, ``take = a_s < a``, ``a = take ? a_s : a`` (and ``b``
    the same with ``b_s``); return ``a + b``."""
    a, b = x, y
    for s in floor_shifts(x.shape[1], n_stages):
        a_s = torch.roll(a, s, dims=1)
        take = a_s < a
        if n_arrays == 2:
            b = torch.where(take, torch.roll(b, s, dims=1), b)
        a = torch.where(take, a_s, a)
    return a + b


def roll_floor(x: torch.Tensor, y: torch.Tensor, n_stages: int,
               n_arrays: int) -> torch.Tensor:
    """(N, W) float32 ``x``, ``y`` → (N, W): ``roll_floor_plain`` on a CPU
    tensor, the floor kernel on a CUDA tensor (one pass per row where the
    window covers the row, the stages themselves on a row whose ``x``
    holds a NaN or where it does not). A row takes 16·W bytes of shared
    memory: on an H100 rows up to about 14,500 columns; the C entry point
    refuses wider ones with an error, which raises here."""
    _check_rows("roll_floor", x, y)
    if n_arrays not in (1, 2) or n_stages < 0:
        raise ValueError("roll_floor: n_arrays must be 1 or 2 and n_stages "
                         ">= 0")
    if not _kernel_device("roll_floor", x):
        return roll_floor_plain(x, y, n_stages, n_arrays)
    check_contiguous(y, "roll_floor")
    n, w = x.shape
    out = torch.empty_like(x)
    if n == 0 or w == 0:
        return out
    shifts = _floor_plan(w, n_stages)[1]
    with torch.cuda.device(x.device):
        ROLL_FLOOR(x.data_ptr(), y.data_ptr(), out.data_ptr(), n, w,
                   n_stages, n_arrays, shifts, _stream(x))
    return out


def roll_min_chain_plain(x: torch.Tensor, n_stages: int = 64) -> torch.Tensor:
    """Plain version of the chain kernel: ``y = x + 1``, then ``r =
    roll(y, 2^(s mod 11))``, ``y = r < y ? r : y`` for s < n_stages."""
    y = x + 1.0
    for s in chain_shifts(x.shape[1], n_stages):
        r = torch.roll(y, s, dims=1)
        y = torch.where(r < y, r, y)
    return y


def roll_min_chain(x: torch.Tensor, n_stages: int = 64) -> torch.Tensor:
    """(N, W) float32 → (N, W): ``roll_min_chain_plain`` on a CPU tensor,
    the chain kernel on a CUDA tensor (the row minimum where the window
    covers the row, the stages themselves on a row that holds a NaN or
    where it does not). A row takes 8·W bytes of shared memory: on an
    H100 rows up to about 29,000 columns; the C entry point refuses wider
    ones with an error, which raises here."""
    _check_rows("roll_min_chain", x)
    if n_stages < 0:
        raise ValueError("roll_min_chain: n_stages must be >= 0")
    if not _kernel_device("roll_min_chain", x):
        return roll_min_chain_plain(x, n_stages)
    n, w = x.shape
    out = torch.empty_like(x)
    if n == 0 or w == 0:
        return out
    shifts = _chain_plan(w, n_stages)[1]
    with torch.cuda.device(x.device):
        ROLL_MIN_CHAIN(x.data_ptr(), out.data_ptr(), n, w, n_stages, shifts,
                       _stream(x))
    return out
