"""Stage-1 retrieval latency, float32 against uint16 storage, with the
ranking parity of the two: the port of ``experiments/retrieval_latency.py``.

    python -m neural_spectral_codec_torch.experiments.retrieval_latency \\
        [--size 100000] [--queries 256] [--iters 20] [--also-1m] \\
        [--single] [--int-domain] [--sweep] [--device cuda] [--json out]

A database of ``--size`` random normalised histograms (800 bins, the JAX
script's generator and chunks) is built in each storage mode. A query is
the production ranking (``retrieval.retriever.query_math``: W₁, the
mask, the tie-ordered ``smallest_k``); ``--int-domain`` adds the uint16
candidate that ranks by |code − query code| summed in int32 and scaled
once. Each measurement is a loop of ``--iters`` dependent queries (the
next query depends on this one's top distance): on a card the loop is
enqueued behind a spin kernel and timed with one pair of CUDA events
(``utils.timing.time_queued_ms``), the device time a query; the host
clock around the synchronised loop gives the wall time a query. Both
are the median over five loops. On the CPU only the host clock is read
and the device time is ``None``.

Ranking parity (``ranking_parity``) ranks the same queries against both
storages: the share of equal top-1 rows and the mean top-k overlap, as
the JAX script reports them, and the uint16 one-code rule: each row the
uint16 database returns must lie within n_bins/65535 (one code a bin) of
its float32 distance, and the j-th row it returns within twice that of
the j-th smallest float32 distance. ``--sweep`` runs 100k, 1M and 2M
rows (float32 up to 1M) and writes its table to ``--json``, not into
the repository.
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path
from typing import Callable, Dict, Optional

import numpy as np
import torch

N_BINS = 800
CODE = 65535.0


def build_db(storage: str, size: int, capacity: int, device):
    """A ``WassersteinRetriever`` with ``size`` random histograms (seed 0,
    chunks of 50,000, positions in a 1 km cube), as the JAX script's."""
    from neural_spectral_codec_torch.retrieval.retriever import (
        WassersteinRetriever)
    db = WassersteinRetriever(n_bins=N_BINS, capacity=capacity,
                              storage=storage, device=device)
    rng = np.random.default_rng(0)
    chunk = 50_000
    for s in range(0, size, chunk):
        m = min(chunk, size - s)
        h = rng.random((m, N_BINS), np.float32)
        db.add_to_database(h / h.sum(axis=1, keepdims=True),
                           rng.random((m, 3), np.float32) * 1000)
    return db


def _queries(n: int, seed: int = 1) -> np.ndarray:
    rng = np.random.default_rng(seed)
    q = rng.random((n, N_BINS), np.float32)
    return q / q.sum(axis=1, keepdims=True)


def _dependent(query: Callable[[torch.Tensor], torch.Tensor],
               q0: torch.Tensor) -> Callable[[], None]:
    """One step of the loop: a query whose input depends on the previous
    step's top distance (it stays the same unless that is NaN)."""
    state = {"q": q0, "acc": torch.zeros((), device=q0.device)}

    def step() -> None:
        state["acc"] = state["acc"] + query(state["q"])
        state["q"] = state["q"] + torch.where(torch.isnan(state["acc"]),
                                              1, 0).to(q0.dtype)
    return step


def _time(step: Callable[[], None], iters: int, device: torch.device,
          repeats: int = 5) -> Dict[str, Optional[float]]:
    """{"device_ms", "wall_ms"} of one step: each the median over
    ``repeats`` loops of ``iters`` steps."""
    step()
    walls = []
    for _ in range(repeats):
        if device.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            step()
        if device.type == "cuda":
            torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3 / iters)
    wall = float(np.median(walls))
    dev_ms = None
    if device.type == "cuda":
        from neural_spectral_codec_torch.utils.timing import time_queued_ms
        # the spin covers the host's enqueue of the whole loop
        dev_ms = time_queued_ms(step, n=iters, repeats=repeats,
                                hold_ms=max(20.0, 3.0 * wall * iters),
                                warmup=1)
    return {"device_ms": dev_ms, "wall_ms": wall}


def measure(db, n_queries: int, iters: int, top_k: int = 10) -> Dict:
    """Per-query times of ``n_queries`` queries ranked together against
    ``db`` (``n_queries`` = 1 is the online-serving shape)."""
    from neural_spectral_codec_torch.retrieval.retriever import query_math
    q0 = torch.from_numpy(_queries(n_queries)).to(db.device)
    qp = torch.zeros((n_queries, 4), dtype=torch.float32, device=db.device)
    size = db.database_size

    def query(q):
        _, dist = query_math(db._db_rows, db._db_pos, size, q, qp, top_k,
                             db.metric, db.epsilon)
        return dist[0, 0]
    t = _time(_dependent(query, q0), iters, db.device)
    return {k: (v / n_queries if v is not None else None)
            for k, v in t.items()}


def measure_int_domain(db, n_queries: int, iters: int,
                       top_k: int = 10) -> Dict:
    """uint16 storage ranked in the integer domain: the query CDFs
    quantised once to the same code grid, |int32(row) − int32(query)|
    summed in int32, one scale of 1/65535 on the distances (JAX
    ``measure_int_domain``)."""
    from neural_spectral_codec_torch.retrieval.retriever import smallest_k
    if db.storage != "uint16":
        raise ValueError("the integer-domain query needs uint16 storage")
    q = _queries(n_queries)
    qc0 = torch.from_numpy(np.round(np.cumsum(q, axis=1) * CODE).astype(
        np.int32)).to(db.device)
    rows = (db._db_rows[:db.database_size].view(torch.int16).to(torch.int32)
            & 0xFFFF)
    scale = torch.tensor(1.0 / CODE, dtype=torch.float32, device=db.device)

    def query(qc):
        d = torch.cat([(rows[None] - c[:, None]).abs().sum(dim=2)
                       for c in qc.split(max(1, (1 << 28) // rows.numel()))])
        td, _ = smallest_k(d.to(torch.float32) * scale, top_k)
        return td[0, 0]
    t = _time(_dependent(query, qc0), iters, db.device)
    return {k: (v / n_queries if v is not None else None)
            for k, v in t.items()}


def ranking_parity(size: int, device, n_queries: int = 64, top_k: int = 10,
                   seed: int = 7) -> Dict:
    """float32 against uint16 storage on the same rows and queries: top-1
    agreement, mean top-k overlap and the one-code rule's violations
    (module docstring)."""
    rng = np.random.default_rng(seed)
    q = rng.random((n_queries, N_BINS), np.float32)
    q = q / q.sum(axis=1, keepdims=True)
    ranked = {}
    for storage in ("float32", "uint16"):
        db = build_db(storage, size, size, device)
        ranked[storage] = db.query_batch(q, top_k=top_k)
        if storage == "float32":        # every row, ascending
            all_idx, all_f = db.query_batch(q, top_k=size)
        del db
    idx_f, _ = ranked["float32"]
    idx_u, dist_u = ranked["uint16"]
    by_row = np.empty((n_queries, size), np.float64)
    np.put_along_axis(by_row, all_idx, all_f, axis=1)
    tol = N_BINS / CODE
    rows_f = np.take_along_axis(by_row, idx_u, axis=1)
    violations = int((np.abs(dist_u - rows_f) > tol).sum()
                     + (rows_f > all_f[:, :top_k] + 2 * tol).sum())
    top1 = float(np.mean(idx_f[:, 0] == idx_u[:, 0]))
    overlap = float(np.mean([len(set(idx_f[i]) & set(idx_u[i])) / top_k
                             for i in range(n_queries)]))
    return {"top1_match": top1, f"top{top_k}_overlap": overlap,
            "n_queries": n_queries, "one_code_tol": tol,
            "one_code_violations": violations}


def _row(storage: str, size: int, args, device) -> Dict:
    db = build_db(storage, size, size, device)
    gb = size * N_BINS * (4 if storage == "float32" else 2) / 1e9
    row = {"size": size, "storage": storage, "db_gb": gb,
           "batched": measure(db, args.queries, args.iters)}
    if args.single or args.sweep:
        row["single"] = measure(db, 1, args.iters)
    if storage == "uint16" and (args.int_domain or args.sweep):
        row["int_batched"] = measure_int_domain(db, args.queries, args.iters)
        if args.single or args.sweep:
            row["int_single"] = measure_int_domain(db, 1, args.iters)
    print(json.dumps(row), flush=True)
    return row


def main(argv=None) -> Dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--size", type=int, default=100_000)
    p.add_argument("--queries", type=int, default=256)
    p.add_argument("--iters", type=int, default=20)
    p.add_argument("--also-1m", action="store_true",
                   help="also measure both storages at 1M rows")
    p.add_argument("--single", action="store_true",
                   help="also time one query at a time (the serving shape)")
    p.add_argument("--int-domain", action="store_true",
                   help="for uint16, also the integer-domain W1 query")
    p.add_argument("--sweep", action="store_true",
                   help="100k / 1M / 2M rows x storage x every query form, "
                        "and the parity at 1M rows")
    p.add_argument("--device", default="cuda")
    p.add_argument("--json", default=None)
    args = p.parse_args(argv)

    from neural_spectral_codec_torch.device import resolve_device
    device = resolve_device(args.device)
    out: Dict = {"device": str(device), "queries": args.queries,
                 "iters": args.iters, "rows": []}
    if device.type == "cuda":
        from neural_spectral_codec_torch.utils.timing import gpu_label
        out["gpu"] = gpu_label()
    if args.sweep:
        sizes, parity_size = (100_000, 1_000_000, 2_000_000), 1_000_000
    else:
        sizes = (args.size,) + ((1_000_000,) if args.also_1m else ())
        parity_size = args.size
    for size in sizes:
        for storage in ("float32", "uint16"):
            if args.sweep and storage == "float32" and size > 1_000_000:
                continue        # 6.4 GB of float32 rows: measured at 1M
            out["rows"].append(_row(storage, size, args, device))
    out["parity"] = ranking_parity(parity_size, device)
    print(json.dumps({"parity": out["parity"]}), flush=True)
    if args.json:
        Path(args.json).write_text(json.dumps(out, indent=2))
    return out


if __name__ == "__main__":
    main()
