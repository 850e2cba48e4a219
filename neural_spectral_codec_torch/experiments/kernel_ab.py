"""This tree's CUDA kernels against another build of the same C entry
points, on the same card, in turns.

    python -m neural_spectral_codec_torch.experiments.kernel_ab \\
        --other-csrc DIR [--cases nearest,knn,mine,...] [--json out.json]

``DIR`` holds another version of ``csrc/`` (for example a parent
commit's, unpacked with ``git archive <commit> neural_spectral_codec_torch/csrc``).
It is compiled with ``_build.NVCC_FLAGS`` into a second library beside
this tree's. Each serving kernel (K1 at B=8 and B=1, K2 at B=8 and B=1,
K3 at B=8 and B=1 on random-order scans), the ring-fold probe (P1 at
the probe shape), the verifier's searches (N at 4,096 × 4,096, K at
4,096 points with k = 20, on two prepared frames: ``prepared_frames``),
its k-NN PCA (C, covariances of the first frame at k = 20) and the
training path's kernels (M's two entries on a 2,048-anchor chunk of a
100,000-frame ``synthetic_city`` sequence; its mask draw on that chunk
over the negatives and the positives after the counts entry and over the
negatives after the rows entry; G on the GAT's neighbour table
of a 20,000-node one, float32 and bf16, and on 4,096 × 800 float32
triplet rows into its 20,000 rows, with and without a 16-position
segment; S on that chunk's W₁ block at count_neg // 2 and M's counts
entry on the chunk; Q, the stage-1 query's fused route, on 100,032 × 800
rows at Q = 1, 8 and 32 for float32 and uint16 W₁ and L2, k = 10, and on
float32 at k = 128, Q = 1 and 32, the spatial filter on: ``query_cases``)
is called once through its wrapper; then both
libraries' entry points are launched on those same arguments (both draw
entries without the tile boxes and with the five float thresholds in
place of ``mask_bounds``' five bounds when ``other_draw_abi`` says the
other side's draws take them), bare and queued behind a spin kernel
(``utils.timing.time_queued_ms``, 200 launches; M 3, its draw and S 20,
the counts entry, the mask draws and Q 50), in the order other, this,
this, other, twice. Q's other side runs on its own layout
(``nsc_query_layout`` of the other library; one that returns three
numbers has 8 candidate lists a CTA) and its own candidate scratch. For
N, K, M (each entry), G, S and Q the other side's last output must equal
the wrapper's bit for bit; for C it must lie within 1e-5 of it on the
rows whose relative
eigen-gap is at least 0.1, where a float64 solve is determined well below
that (``pca_within_bar``). Prints and returns each side's median device
µs; for N where the time of this tree's ``csrc/nearest.cu`` goes
(``nearest_stamps``: a build with ``-DNSC_NEAREST_STAMPS``), for S where
the time of its cluster regime goes (``select_stamps``: a build with
``-DNSC_SELECT_STAMPS``), and for K its merges a row on the same frames
(``knn_merge_counts``: a build with ``-DNSC_KNN_COUNT``). ``--cases``
keeps the named cases only. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
import tempfile
from pathlib import Path

import numpy as np
import torch


def build_other(csrc: Path, out_dir: Path) -> ctypes.CDLL:
    """Compile ``csrc/*.cu`` with this tree's flags into one library."""
    from neural_spectral_codec_torch import _build
    nvcc = _build.find_nvcc()
    objs = [out_dir / f"{cu.stem}.o" for cu in sorted(csrc.glob("*.cu"))]
    procs = [subprocess.Popen([nvcc, *_build.NVCC_FLAGS, "-c", "-o", str(o),
                               str(cu)])
             for cu, o in zip(sorted(csrc.glob("*.cu")), objs)]
    if any(p.wait() != 0 for p in procs):
        raise RuntimeError(f"nvcc failed on {csrc}")
    lib = out_dir / "libother.so"
    subprocess.run([nvcc, *_build.NVCC_FLAGS[:2], "-shared", "-o", str(lib),
                    *map(str, objs)], check=True)
    return ctypes.CDLL(str(lib))


def prepared_frames(device, seed: int = 41, n_points: int = 131_072,
                    max_points: int = 4096) -> tuple:
    """Two consecutive frames of a seeded synthetic stream as the verifier
    prepares them: 0.3 m voxel means (sorted by voxel key) padded to
    ``max_points``, on ``device``: (a, mask_a, b, mask_b)."""
    from neural_spectral_codec_torch.data.synthetic import SyntheticLoader
    from neural_spectral_codec_torch.retrieval.verification import (
        _pad, voxel_downsample)
    base = SyntheticLoader(n_frames=2, seed=seed, n_points=n_points)
    out = []
    for i in range(2):
        pts, mask = _pad(voxel_downsample(base[i]["points"], 0.3),
                         max_points)
        out += [torch.from_numpy(pts).to(device),
                torch.from_numpy(mask).to(device)]
    return tuple(out)


def build_diagnostic(source: str, define: str, out_dir: Path) -> ctypes.CDLL:
    """This tree's ``csrc/<source>`` alone, built with ``-D<define>`` (its
    diagnostic hooks on) into a library in ``out_dir``; the library the
    port loads is built without them."""
    from neural_spectral_codec_torch import _build
    lib = out_dir / f"lib{define.lower()}.so"
    subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS, f"-D{define}",
                    "-shared", "-o", str(lib), str(_build.CSRC_DIR / source)],
                   check=True)
    return ctypes.CDLL(str(lib))


COUNTS = ("tested", "passed", "inserted", "full_merges")


def knn_merge_counts(pts: torch.Tensor, mask: torch.Tensor, k: int,
                     out_dir: Path) -> dict:
    """Per row, what kernel K's merge step did on one cloud: batches that
    reached the exact test, batches that passed it, lanes inserted one by
    one, full (bitonic) merges; from ``csrc/knn.cu`` built with
    ``-DNSC_KNN_COUNT`` (device counters, one atomic a warp event) and
    launched once."""
    from neural_spectral_codec_torch.retrieval.knn_kernel import (
        KERNEL, knn_plain)
    lib = build_diagnostic("knn.cu", "NSC_KNN_COUNT", out_dir)
    lib.nsc_knn.argtypes = KERNEL.argtypes
    lib.nsc_knn_counts.argtypes = [ctypes.c_void_p]
    counts = (ctypes.c_ulonglong * len(COUNTS))()
    n = pts.shape[0]
    idx = torch.empty((n, k), dtype=torch.int64, device=pts.device)
    for err in (lib.nsc_knn_counts(counts),        # clears the counters
                lib.nsc_knn(pts.data_ptr(), mask.data_ptr(), idx.data_ptr(),
                            n, k, torch.cuda.current_stream().cuda_stream)):
        if err != 0:
            raise RuntimeError(f"knn (counting build): CUDA error {err}")
    torch.cuda.synchronize()
    err = lib.nsc_knn_counts(counts)
    if err != 0:
        raise RuntimeError(f"nsc_knn_counts: CUDA error {err}")
    if not torch.equal(idx, knn_plain(pts, mask, k)):
        raise RuntimeError("knn (counting build) != plain version")
    return {name: c / n for name, c in zip(COUNTS, counts)}


STAMPS = ("staging", "scan", "part_merge", "cluster_barrier", "write")


def nearest_stamps(moved: torch.Tensor, dst: torch.Tensor,
                   dst_mask: torch.Tensor, out_dir: Path) -> dict:
    """Where kernel N's time goes on one search: ``csrc/nearest.cu`` built
    with ``-DNSC_NEAREST_STAMPS`` (each CTA's global timer at six points)
    and launched 5 times; the last launch's mean µs of each phase over the
    CTAs, the start spread (the last CTA's start after the first's) and
    the span (first start to last end)."""
    from neural_spectral_codec_torch.retrieval.nearest_kernel import (
        CLUSTER, KERNEL, ROWS_PER_CTA, nearest_plain)
    lib = build_diagnostic("nearest.cu", "NSC_NEAREST_STAMPS", out_dir)
    lib.nsc_nearest.argtypes = KERNEL.argtypes
    lib.nsc_nearest_stamps.argtypes = [ctypes.c_void_p, ctypes.c_int]
    n_src, n_dst = moved.shape[0], dst.shape[0]
    j = torch.empty(n_src, dtype=torch.int64, device=moved.device)
    d2 = torch.empty(n_src, dtype=torch.float32, device=moved.device)
    for _ in range(5):
        err = lib.nsc_nearest(moved.data_ptr(), dst.data_ptr(),
                              dst_mask.data_ptr(), j.data_ptr(),
                              d2.data_ptr(), n_src, n_dst,
                              torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"nearest (stamped build): CUDA error {err}")
    torch.cuda.synchronize()
    jp, d2p = nearest_plain(moved, dst, dst_mask)
    if not (torch.equal(j, jp) and torch.equal(_bits(d2), _bits(d2p))):
        raise RuntimeError("nearest (stamped build) != plain version")
    n_ctas = -(-n_src // ROWS_PER_CTA) * CLUSTER
    buf = (ctypes.c_ulonglong * (n_ctas * (len(STAMPS) + 1)))()
    err = lib.nsc_nearest_stamps(buf, n_ctas)
    if err != 0:
        raise RuntimeError(f"nsc_nearest_stamps: CUDA error {err}")
    t = np.array(buf, dtype=np.float64).reshape(n_ctas, len(STAMPS) + 1)
    out = {name: float(np.diff(t, axis=1)[:, i].mean()) / 1e3
           for i, name in enumerate(STAMPS)}
    out["start_spread"] = float(t[:, 0].max() - t[:, 0].min()) / 1e3
    out["span"] = float(t[:, -1].max() - t[:, 0].min()) / 1e3
    return out


SELECT_STAMPS = ("load", "scan0", "exchange0", "scan1", "exchange1",
                 "passes_end", "finish")


def select_stamps(x: torch.Tensor, k: torch.Tensor, out_dir: Path) -> dict:
    """Where kernel S's time goes in its cluster regime on one block:
    ``csrc/select.cu`` built with ``-DNSC_SELECT_STAMPS`` (each cluster
    CTA's global timer at eight points) and launched 3 times; of the last
    launch, the mean µs over the CTAs of each phase (the slice's copy, the
    first pass's histogram, its choice with the cluster barrier before it,
    the second pass's, the rest of the passes with the last barrier, and
    the finish), the mean CTA life, the span, and the CTAs a phase was
    seen in (a CTA that ended before a stamp has none there)."""
    from neural_spectral_codec_torch.training.select_kernel import (
        KERNEL, select_layout, select_plain)
    lib = build_diagnostic("select.cu", "NSC_SELECT_STAMPS", out_dir)
    lib.nsc_select_rows.argtypes = KERNEL.argtypes
    lib.nsc_select_stamps.argtypes = [ctypes.c_void_p, ctypes.c_int]
    rows, n = x.shape
    ctas = select_layout(n)
    out = torch.empty(rows, dtype=torch.int32, device=x.device)
    for _ in range(3):
        err = lib.nsc_select_rows(x.data_ptr(), rows, n, x.stride(0),
                                  k.data_ptr(), out.data_ptr(), ctas,
                                  torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"select (stamped build): CUDA error {err}")
    torch.cuda.synchronize()
    if not torch.equal(out, select_plain(x, k)):
        raise RuntimeError("select (stamped build) != plain version")
    n_ctas = rows * ctas
    buf = (ctypes.c_ulonglong * (n_ctas * 8))()
    err = lib.nsc_select_stamps(buf, n_ctas)
    if err != 0:
        raise RuntimeError(f"nsc_select_stamps: CUDA error {err}")
    t = np.array(buf, dtype=np.float64).reshape(n_ctas, 8)
    seen = t >= t[:, :1]              # stamps of this launch
    res = {}
    for i, name in enumerate(SELECT_STAMPS):
        ok = seen[:, i] & seen[:, i + 1]
        res[name] = float((t[ok, i + 1] - t[ok, i]).mean()) / 1e3
        res[f"{name}_ctas"] = int(ok.sum())
    last = np.where(seen, t, -np.inf).max(axis=1)
    res["cta_life"] = float((last - t[:, 0]).mean()) / 1e3
    res["span"] = float(last.max() - t[:, 0].min()) / 1e3
    res["ctas"] = ctas
    return res


PCA_TOL = 1e-5       # kernel C against another build: covariances, on
PCA_GAP = 0.1        # the rows of relative eigen-gap >= PCA_GAP


def pca_within_bar(got: torch.Tensor, want: torch.Tensor, pts: torch.Tensor,
                   idx: torch.Tensor) -> float:
    """The largest difference of two (P, 3, 3) covariance outputs of
    kernel C on the rows whose relative eigen-gap (λ1 − λ0) / λ2 of the
    float64 k-NN covariance is at least PCA_GAP (elsewhere the eigenvector
    is not determined by the data)."""
    nbr = pts.double()[idx]
    c = nbr - nbr.mean(dim=1, keepdim=True)
    lam = torch.linalg.eigvalsh(torch.einsum("pki,pkj->pij", c, c))
    rows = lam[:, 1] - lam[:, 0] >= PCA_GAP * lam[:, 2].clamp(min=1e-300)
    return float((got - want)[rows].abs().max()) if rows.any() else 0.0


def _scans(n: int, n_points: int, seed: int) -> np.ndarray:
    """Random-order full-view scans with ranges on both sides of the
    gates (``chip_smoke._general_scans`` without the NaN tails)."""
    rng = np.random.default_rng(seed)
    az = rng.uniform(-np.pi, np.pi, (n, n_points))
    el = rng.uniform(np.deg2rad(-26.0), np.deg2rad(3.0), (n, n_points))
    r = rng.uniform(0.5, 90.0, (n, n_points))
    return np.stack([r * np.cos(el) * np.cos(az), r * np.cos(el) * np.sin(az),
                     r * np.sin(el), rng.uniform(0, 1, r.shape)],
                    axis=-1).astype(np.float32)


def _bits(t: torch.Tensor) -> torch.Tensor:
    """float32 as its bits (NaN equal to the same NaN), else as it is."""
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def _outputs(result) -> tuple:
    return tuple(t.clone() for t in (
        result if isinstance(result, tuple) else (result,)))


MINE_NODES, MINE_CHUNK = 100_000, 2048
MINE_PARAMS = (5.0, 30.0, 10.0, 100.0, 30.0)    # scale_100k's thresholds
GRAPH_NODES = 20_000
LAUNCHES = {"mine": 3, "mine_draw": 20, "select": 20, "mine_counts": 50,
            "mine_draw_mask": 50, "mine_draw_mask_pos": 50,
            "mine_draw_mask_rows": 50}           # else 200
TRAINING_CASES = ("mine", "mine_draw", "mine_draw_mask",
                  "mine_draw_mask_pos", "mine_draw_mask_rows", "gather_bwd",
                  "gather_bwd_bf16", "gather_bwd_triplets",
                  "gather_bwd_triplets_no16", "select", "mine_counts")


def other_draw_abi(csrc: Path) -> bool:
    """Whether kernel M's draw entries in ``csrc/mine.cu`` take the five
    float thresholds and no tile boxes (the warp-an-anchor draw, which
    tests a square root) in place of the boxes and ``mask_bounds``' three
    squared and two integer bounds."""
    text = (csrc / "mine.cu").read_text()
    entry = text[text.index('extern "C" int nsc_mine_draw('):]
    return "float pos_max" in entry[:entry.index(")")]


def mine_inputs(n: int, device) -> tuple:
    """(positions, CDFs) of an n-frame ``synthetic_city`` sequence on
    ``device``, the CDFs as the miner forms them."""
    from neural_spectral_codec_torch.experiments.scale_100k import (
        synthetic_city)
    desc, poses, _ = synthetic_city(n)
    cdfs = np.cumsum(desc / np.maximum(desc.sum(1, keepdims=True), 1e-12),
                     axis=1).astype(np.float32)
    return (torch.from_numpy(poses[:, :3, 3].astype(np.float32)).to(device),
            torch.from_numpy(cdfs).to(device))


def _training_cases(dev, old_draw: bool) -> tuple:
    """M's, G's and S's cases: {name: (kernel, call, other_args,
    other_argtypes)}, other_args mapping this side's last arguments to the
    other side's and other_argtypes the other entry's ctypes types (None:
    the same), and the tensors they use, kept alive by the caller. With
    ``old_draw`` the other side's draws take the five float thresholds."""
    from neural_spectral_codec_torch.experiments.scale_100k import (
        synthetic_city)
    from neural_spectral_codec_torch.keyframe.graph import (
        build_graph, graph_to_tensors)
    from neural_spectral_codec_torch.models import gather_kernel as gk
    from neural_spectral_codec_torch.training import mine_kernel as mk
    from neural_spectral_codec_torch.training import select_kernel as sk
    gen = torch.Generator(device=dev).manual_seed(7)
    params = tuple(float(v) for v in np.array(MINE_PARAMS, np.float32))
    pos, cdf = mine_inputs(MINE_NODES, dev)
    start = torch.tensor([MINE_NODES // 2], dtype=torch.int32, device=dev)
    u = torch.rand(MINE_CHUNK, generator=gen, device=dev)
    scratch = mk.mine_scratch(MINE_NODES, MINE_CHUNK, dev)
    boxes = mk.tile_boxes(pos)
    keep = [pos, cdf, start, u, scratch, boxes]

    def draw_other(args):
        # (pts, [boxes,] start, n, count, 3 squared + 2 integer bounds | 5
        #  thresholds, [which,] u, counts, splits, partial, idx, stream)
        return ((args[0], *args[2:5], *params, *args[10:]) if old_draw
                else args)

    def draw_types(kernel):
        t = kernel.argtypes
        return ([t[0], *t[2:5], *[ctypes.c_float] * 5, *t[10:]] if old_draw
                else None)

    def mine_call():
        return mk.mine_cuda(pos, cdf, start, MINE_CHUNK, params, u, boxes,
                            scratch)

    # S on the chunk's W₁ block at count_neg // 2 ("semi-hard"), and M's
    # counts entry ("random"), on the same chunk
    w1 = torch.empty((MINE_CHUNK, MINE_NODES), device=dev)
    place = mk.rows_cuda(pos, cdf, start, MINE_CHUNK, params, w1,
                         scratch).count_neg // 2

    # the mask draws ("random": both masks after the counts entry;
    # "semi-hard": the positives after the rows entry, here the negatives
    # there too), each on the partials its entry leaves in the scratch;
    # (the draw, the counts it read), so that the counts stay alive
    def counts_then_draw(which):
        def call():
            cnt = getattr(mk.counts_cuda(pos, start, MINE_CHUNK, params,
                                         scratch), f"count_{which}")
            return (mk.draw_cuda(pos, start, MINE_CHUNK, params, u, cnt,
                                 which, scratch, boxes), cnt)
        return call

    def rows_then_draw():
        cnt = mk.rows_cuda(pos, cdf, start, MINE_CHUNK, params, w1,
                           scratch).count_neg
        return (mk.draw_cuda(pos, start, MINE_CHUNK, params, u, cnt, "neg",
                             scratch, boxes), cnt)

    desc, poses, _ = synthetic_city(GRAPH_NODES)
    g = graph_to_tensors(build_graph(desc, poses, temporal_neighbors=5), dev)
    slots = g.mask.reshape(-1)
    nbr = g.neighbors.reshape(-1)
    plan = gk.make_plan(nbr, GRAPH_NODES, slots)
    g32 = torch.randn(nbr.numel(), 256, generator=gen, device=dev) * slots[
        :, None]
    b16 = g32.to(torch.bfloat16)
    tri = torch.randint(0, GRAPH_NODES, (4096,), generator=gen, device=dev)
    tri[:1024] = tri[1024:2048]                  # repeats
    tplan_free = gk.make_plan(tri, GRAPH_NODES)
    tri16 = tri.clone()
    tri16[:16] = 7                               # a 16-position segment
    tplan = gk.make_plan(tri16, GRAPH_NODES)
    tgrad = torch.randn(4096, 800, generator=gen, device=dev)
    keep += [g, plan, g32, b16, tplan, tplan_free, tgrad, w1, place]
    cases = {
        "mine": (mk.HARD, mine_call, None, None),
        "mine_draw": (mk.DRAW, mine_call, draw_other, draw_types(mk.DRAW)),
        "mine_draw_mask": (mk.DRAW_MASK, counts_then_draw("neg"),
                           draw_other, draw_types(mk.DRAW_MASK)),
        "mine_draw_mask_pos": (mk.DRAW_MASK, counts_then_draw("pos"),
                               draw_other, draw_types(mk.DRAW_MASK)),
        "mine_draw_mask_rows": (mk.DRAW_MASK, rows_then_draw, draw_other,
                                draw_types(mk.DRAW_MASK)),
        "gather_bwd": (gk.KERNEL, lambda: gk.gather_bwd_cuda(
            g32, plan, GRAPH_NODES), None, None),
        "gather_bwd_bf16": (gk.KERNEL, lambda: gk.gather_bwd_cuda(
            b16, plan, GRAPH_NODES), None, None),
        "gather_bwd_triplets": (gk.KERNEL, lambda: gk.gather_bwd_cuda(
            tgrad, tplan, GRAPH_NODES), None, None),
        "gather_bwd_triplets_no16": (gk.KERNEL, lambda: gk.gather_bwd_cuda(
            tgrad, tplan_free, GRAPH_NODES), None, None),
        "select": (sk.KERNEL, lambda: sk.select_cuda(w1, place), None,
                   None),
        "mine_counts": (mk.COUNTS, lambda: mk.counts_cuda(
            pos, start, MINE_CHUNK, params, scratch), None, None),
    }
    return cases, keep


QUERY_ROWS, QUERY_BINS, QUERY_K, QUERY_MIN_D = 100_032, 800, 10, 25.0
QUERY_CASES = tuple(f"query_{m}_q{n}" for m in ("f32", "u16", "l2")
                    for n in (1, 8, 32)) + ("query_f32_q1_k128",
                                            "query_f32_q32_k128")


def query_cases(dev, other: ctypes.CDLL) -> tuple:
    """Q's cases ({name: (kernel, call, other_args, None)}) on 100,032 ×
    800 rows of random histograms (W₁ over their CDFs as float32 rows and
    as uint16 codes, L2 over the histograms), positions over ±1 km, 32
    queries (a row's histogram plus noise near its position), the filter
    at QUERY_MIN_D, size 1,000 rows below the database's (a device int64);
    and the tensors they use. other_args maps this side's last arguments
    to the other side's: its layout and its own scratch, the same
    outputs."""
    from neural_spectral_codec_torch.ops.wasserstein import histogram_cdf
    from neural_spectral_codec_torch.retrieval import query_kernel as qk
    from neural_spectral_codec_torch.retrieval.retriever import quantize_cdf
    g = torch.Generator(device=dev).manual_seed(61)
    n, bins = QUERY_ROWS, QUERY_BINS
    h = torch.rand((n, bins), generator=g, device=dev) ** 4
    pos = (torch.rand((n, 3), generator=g, device=dev) - 0.5) * 2000.0
    src = torch.randint(0, n, (32,), generator=g, device=dev)
    qh = h[src] + 0.2 * torch.rand((32, bins), generator=g,
                                   device=dev) / bins
    filt = torch.cat([pos[src] + 1.0, torch.full((32, 1), QUERY_MIN_D,
                                                 device=dev)], 1)
    cdf = histogram_cdf(h, 1e-8)
    size = torch.tensor(n - 1000, dtype=torch.int64, device=dev)
    modes = {"f32": ("wasserstein", cdf, histogram_cdf(qh, 1e-8)),
             "u16": ("wasserstein", quantize_cdf(cdf),
                     histogram_cdf(qh, 1e-8)),
             "l2": ("l2", h, qh)}
    layout = other.nsc_query_layout
    layout.argtypes = [ctypes.c_int] * 6 + [ctypes.c_void_p]
    layout.restype = ctypes.c_int
    keep = [h, pos, filt, size, modes]
    cases = {}
    for name in QUERY_CASES:
        parts = name.split("_")
        mode, n_q = parts[1], int(parts[2][1:])
        k = int(parts[3][1:]) if len(parts) > 3 else QUERY_K
        metric, rows, queries = modes[mode]
        q, f = queries[:n_q].contiguous(), filt[:n_q].contiguous()
        storage, l2 = int(rows.dtype == torch.uint16), int(metric == "l2")
        out = (ctypes.c_int * 4)(0, 0, 0, -1)
        err = layout(storage, l2, n, bins, n_q, k, out)
        if err != 0:
            raise RuntimeError(f"nsc_query_layout (other): CUDA error {err}")
        ctas, group, smem, lists = out
        if lists < 0:                        # a layout of three numbers
            lists = ctas * 8
        cand = torch.empty((n_q, lists, k), dtype=torch.int64, device=dev)
        keep += [q, f, cand]

        def call(rows=rows, q=q, f=f, k=k, metric=metric):
            return qk.query_cuda(rows, pos, size, q, f, k, metric)

        def other_args(args, ctas=ctas, group=group, smem=smem, cand=cand):
            # (rows, storage, metric, pos, size_ptr, size_val, q, filters,
            #  n, bins, Q, k, scale | ctas, group, smem, cand | idx, dist,
            #  stream)
            return (*args[:13], ctas, group, smem, cand.data_ptr(),
                    *args[17:])
        cases[name] = (qk.KERNEL, call, other_args, None)
    return cases, keep


def run(other_csrc: str, cases_kept=None, log=print) -> dict:
    from neural_spectral_codec_torch import _build, resolve_device
    from neural_spectral_codec_torch.ops import (
        probe_kernels, projection_kernel, ring_kernel, spectral_kernel)
    from neural_spectral_codec_torch.retrieval import (
        knn_kernel, nearest_kernel, pca_kernel)
    from neural_spectral_codec_torch.ops.range_image import (
        project_points_batch_plain)
    from neural_spectral_codec_torch.ops.ring_path import (
        make_structured_ring_scans)
    from neural_spectral_codec_torch.ops.spectral import SpectralEncoderConfig
    from neural_spectral_codec_torch.utils.timing import (
        gpu_label, time_queued_ms)

    dev = resolve_device("cuda")
    log(gpu_label())
    out_dir = Path(tempfile.mkdtemp())
    other = build_other(Path(other_csrc), out_dir)
    _build.load_library()
    cfg = SpectralEncoderConfig()
    proj = cfg.projection
    rows = tuple(range(64))
    gen = torch.from_numpy(_scans(8, 64 * 2088, 1)).to(dev)
    rings = torch.from_numpy(make_structured_ring_scans(
        8, 64, 2088, proj, seed=2)).to(dev)
    imgs = project_points_batch_plain(gen, proj)
    key, vals = probe_kernels.ring_keys_padded(rings, proj)
    cases = {
        "spectral_b8": (spectral_kernel.KERNEL,
                        lambda: spectral_kernel.encode_images_cuda(
                            imgs, cfg.alpha, cfg)),
        "spectral_b1": (spectral_kernel.KERNEL,
                        lambda: spectral_kernel.encode_images_cuda(
                            imgs[:1].contiguous(), cfg.alpha, cfg)),
        "ring_fold_b8": (ring_kernel.KERNEL,
                         lambda: ring_kernel.project_rings_cuda(
                             rings, proj, rows)),
        "ring_fold_b1": (ring_kernel.KERNEL,
                         lambda: ring_kernel.project_rings_cuda(
                             rings[:1].contiguous(), proj, rows)),
        "project_b8": (projection_kernel.KERNEL,
                       lambda: projection_kernel.project_points_cuda(
                           gen, proj)),
        "project_b1": (projection_kernel.KERNEL,
                       lambda: projection_kernel.project_points_cuda(
                           gen[:1].contiguous(), proj)),
        "ring_probe_b8": (probe_kernels.RING_PROBE,
                          lambda: probe_kernels.ring_fold_probe(
                              key, vals, proj.n_azimuth, 2)),
    }
    scene_a, mask_a, scene_b, mask_b = prepared_frames(dev)
    searches = {
        "nearest": (nearest_kernel.KERNEL,
                    lambda: nearest_kernel.nearest_cuda(
                        scene_a, scene_b, mask_b)),
        "knn": (knn_kernel.KERNEL,
                lambda: knn_kernel.knn_cuda(scene_a, mask_a, 20)),
    }
    cases.update(searches)
    idx20 = knn_kernel.knn_cuda(scene_a, mask_a, 20)
    cases["knn_pca"] = (pca_kernel.KNN_PCA,
                        lambda: pca_kernel.knn_pca_cuda(
                            scene_a, idx20, "covariances", 1e-3))
    cases = {name: (kernel, call, None, None)
             for name, (kernel, call) in cases.items()}
    training, keep_training = {}, []
    if not cases_kept or set(cases_kept) & set(TRAINING_CASES):
        training, keep_training = _training_cases(
            dev, other_draw_abi(Path(other_csrc)))
    cases.update(training)
    queries, keep_queries = {}, []
    if not cases_kept or set(cases_kept) & set(QUERY_CASES):
        queries, keep_queries = query_cases(dev, other)
    cases.update(queries)
    if cases_kept:
        cases = {n: c for n, c in cases.items() if n in cases_kept}
    out = {}
    for name, (kernel, call, other_args, other_types) in cases.items():
        keep = call()            # the wrapper's arguments stay alive
        torch.cuda.synchronize()
        want = _outputs(keep)
        args = kernel.last_args
        oargs = other_args(args) if other_args else args
        fn = getattr(other, kernel.symbol)
        fn.argtypes = other_types or kernel.argtypes
        fn.restype = ctypes.c_int

        def launch_other():
            err = fn(*oargs)
            if err != 0:
                raise RuntimeError(f"{kernel.symbol} (other): CUDA error "
                                   f"{err}")
        sides = {"other": launch_other, "this": kernel.bare()}
        times = {"other": [], "this": []}
        launches = LAUNCHES.get(name, 50 if name in queries else 200)
        for side in ("other", "this", "this", "other") * 2:
            times[side].append(1e3 * time_queued_ms(
                sides[side], n=launches, repeats=3 if launches < 20 else 5))
        out[name] = {"other_us": statistics.median(times["other"]),
                     "this_us": statistics.median(times["this"]),
                     "runs_us": times}
        if name in searches or name in training or name in queries:
            torch.cuda.synchronize()
            got = _outputs(keep)
            same = all(torch.equal(_bits(a), _bits(b))
                       for a, b in zip(got, want))
            out[name]["same_bits"] = same
            if not same:
                raise RuntimeError(f"{name}: the two sides' outputs differ")
        if name == "knn_pca":    # the last launch was the other side's
            torch.cuda.synchronize()
            err = pca_within_bar(keep, want[0], scene_a, idx20)
            out[name]["max_abs_diff"] = err
            if not err <= PCA_TOL:
                raise RuntimeError(f"knn_pca: the two sides differ by "
                                   f"{err:.3e} > {PCA_TOL} on rows of "
                                   f"relative gap >= {PCA_GAP}")
        log(f"{name}: other {out[name]['other_us']:.3f} µs, this "
            f"{out[name]['this_us']:.3f} µs")
        del keep
    if "nearest" in cases:
        out["nearest_phases_us"] = nearest_stamps(scene_a, scene_b, mask_b,
                                                  out_dir)
        log("nearest phases, µs (mean over CTAs): " + ", ".join(
            f"{n} {v:.3f}" for n, v in out["nearest_phases_us"].items()))
    if "select" in cases:
        x, place = keep_training[-2:]
        out["select_phases_us"] = select_stamps(x, place, out_dir)
        log("select phases, µs (mean over the cluster CTAs): " + ", ".join(
            f"{n} {v:.3f}" for n, v in out["select_phases_us"].items()
            if not n.endswith("_ctas")))
    if "knn" in cases:
        for k in (20, 16):
            counts = knn_merge_counts(scene_a, mask_a, k, out_dir)
            out[f"knn_merges_k{k}"] = counts
            log(f"knn merges a row, k = {k}: " + ", ".join(
                f"{n} {v:.3f}" for n, v in counts.items()))
    del keep_training, keep_queries
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other-csrc", required=True)
    ap.add_argument("--cases", default=None,
                    help="comma-separated case names (default: all)")
    ap.add_argument("--json", default=None)
    args = ap.parse_args(argv)
    out = run(args.other_csrc,
              args.cases.split(",") if args.cases else None)
    if args.json:
        Path(args.json).write_text(json.dumps(out, indent=1))
    return out


if __name__ == "__main__":
    main()
