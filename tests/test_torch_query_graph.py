"""The port's stage-1 query executable (``retrieval/retriever.py``
``QueryExecutable``) on the CPU, where its static step runs eagerly: the
step against JAX's one-dispatch ``_query_kernel`` and
``_query_batch_kernel`` on the same rows and queries, the absence of host
syncs in its body (which would break a CUDA-graph capture on a card), the
executable cache after ``clear_database``, and ``warm_query``.

Shapes: 480 rows of a 512-row database of 160 bins, k = 9. The JAX side
ranks the rows the port stored (uint16 codes as uint16), so the one-code
rule of uint16 rankings reduces to equal indices. Distances within
``DIST_RTOL`` relative, and ``DIST_ATOL`` absolute: the two frameworks'
query CDFs differ by ~1e-7 a bin (summed in other orders) and a distance
sums 160 such |differences| of values up to 1, so its rounding error
scales with that unit scale, not with the distance; a query near its
source row (distance ~0.4) differs by up to ~8e-6.
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "tests"))

import jax.numpy as jnp  # noqa: E402

from test_torch_serve_graph import HOST_SYNCS, _jax_rows, _Ops  # noqa: E402
from neural_spectral_codec_tpu.retrieval.retriever import (  # noqa: E402
    _query_batch_kernel, _query_kernel)
from neural_spectral_codec_torch.retrieval import (  # noqa: E402
    WassersteinRetriever, retriever as retriever_mod)

torch.set_num_threads(2)

DIM, CAP, N_ROWS, K = 160, 512, 480, 9
DIST_RTOL = 2e-5
DIST_ATOL = DIST_RTOL * 1.0    # DIST_RTOL of the rows' unit scale
MIN_D = 25.0
WINDOWS = {"exclude_last": {"exclude_last": 7},
           "as_of_size": {"as_of_size": 300, "exclude_last": 2}}


def _database(metric, storage, seed=0):
    rng = np.random.default_rng(seed)
    h = rng.random((N_ROWS, DIM)).astype(np.float32) ** 4
    h /= h.sum(axis=1, keepdims=True)
    pos = rng.uniform(-60, 60, (N_ROWS, 3)).astype(np.float32)
    ret = WassersteinRetriever(n_bins=DIM, capacity=CAP, metric=metric,
                               storage=storage, device="cpu")
    ret.add_to_database(h, pos)
    return ret, h, pos, rng


def _mine(ret):
    return [e for e in retriever_mod.cached_executables()
            if e._retriever() is ret]


@pytest.mark.parametrize("spatial", [False, True], ids=["nofilter", "filter"])
@pytest.mark.parametrize("window", sorted(WINDOWS))
@pytest.mark.parametrize("n_queries", [1, 3])
@pytest.mark.parametrize("metric,storage", [("wasserstein", "float32"),
                                            ("wasserstein", "uint16"),
                                            ("l2", "float32")])
def test_query_step_matches_jax(metric, storage, n_queries, window, spatial):
    """``query`` (Q = 1) and ``query_batch`` (Q = 3) through the static
    step against ``_query_kernel`` / ``_query_batch_kernel`` at the same
    effective size and filters: the step's raw (Q, k) outputs have equal
    indices (masked slots included) and distances within DIST_RTOL, and
    the public results are JAX's, trimmed (Q = 1) or with -1 on masked
    slots (Q = 3)."""
    ret, h, pos, rng = _database(metric, storage, seed=n_queries)
    rows = rng.choice(N_ROWS - 40, n_queries, replace=False)
    q = (h[rows] + 0.2 * rng.random((n_queries, DIM)).astype(np.float32)
         / DIM).astype(np.float32)
    qpos = pos[rows] + 1.0
    kw = dict(WINDOWS[window])
    eff = ret.effective_size(kw.get("exclude_last", 0), kw.get("as_of_size"))
    min_d = MIN_D if spatial else 0.0
    qp = np.concatenate([qpos, np.full((n_queries, 1), min_d, np.float32)],
                        axis=1)
    db, db_pos = _jax_rows(ret, N_ROWS)
    if n_queries == 1:
        got_i, got_d = ret.query(q[0], K, query_position=qpos[0],
                                 spatial_min_distance=min_d, **kw)
        want_i, want_d = (np.asarray(a)[None] for a in _query_kernel(
            db, db_pos, jnp.int32(eff), jnp.asarray(q[0]),
            jnp.asarray(qp[0]), K, metric))
        keep = np.isfinite(want_d[0])
        np.testing.assert_array_equal(got_i, want_i[0][keep])
        np.testing.assert_allclose(got_d, want_d[0][keep], rtol=DIST_RTOL,
                                   atol=DIST_ATOL)
    else:
        got_i, got_d = ret.query_batch(q, K, query_positions=qpos,
                                       spatial_min_distance=min_d, **kw)
        want_i, want_d = (np.asarray(a) for a in _query_batch_kernel(
            db, db_pos, jnp.int32(eff), jnp.asarray(q), jnp.asarray(qp), K,
            metric))
        np.testing.assert_array_equal(
            got_i, np.where(np.isfinite(want_d), want_i, -1))
        np.testing.assert_allclose(got_d, want_d, rtol=DIST_RTOL,
                                   atol=DIST_ATOL)
    (exe,) = _mine(ret)
    assert (exe.n_queries, exe.top_k) == (n_queries, K)
    assert int(exe.inputs.dev["size"]) == eff
    np.testing.assert_array_equal(exe.outputs.dev["idx"].numpy(), want_i)
    np.testing.assert_allclose(exe.outputs.dev["dist"].numpy(), want_d,
                               rtol=DIST_RTOL, atol=DIST_ATOL)
    # each query's source row: its top-1 unless the filter drops it
    for j, src in enumerate(rows):
        if src < eff:
            assert (want_i[j, 0] == src) != spatial
            assert (src in want_i[j][np.isfinite(want_d[j])]) != spatial


@pytest.mark.parametrize("metric,storage", [("wasserstein", "uint16"),
                                            ("l2", "float32")])
def test_query_step_has_no_host_sync(metric, storage):
    """The query step's body dispatches no operation that reads a value
    back to the host, and a second run leaves its outputs in the same
    static buffers."""
    ret, h, pos, _ = _database(metric, storage)
    ret.query_batch(h[:4], K, query_positions=pos[:4],
                    spatial_min_distance=MIN_D)
    (exe,) = _mine(ret)
    ptrs = {k: v.data_ptr() for k, v in exe.outputs.dev.items()}
    with _Ops() as rec:
        exe._step()
    syncs = [op for op in rec.ops if any(s in op for s in HOST_SYNCS)]
    assert rec.ops and not syncs, syncs
    ret.query_batch(h[4:8], K)
    assert {k: v.data_ptr() for k, v in exe.outputs.dev.items()} == ptrs


def test_cache_drops_the_executable_after_clear_database():
    """A repeated shape reuses its executable, another Q or k adds one;
    ``clear_database`` reallocates the buffers, so the next query builds
    anew and every entry on the old buffers is dropped, while another
    retriever's entry stays. A query against the cleared database ranks
    its new rows."""
    ret, h, pos, _ = _database("wasserstein", "float32")
    other, _, _, _ = _database("wasserstein", "uint16", seed=5)
    other.query(h[0], K)
    ret.query(h[0], K)
    ret.query(h[1], K)
    ret.query_batch(h[:2], K)
    ret.query(h[1], K + 1)
    old = _mine(ret)
    assert len(old) == 3
    ret.clear_database()
    ret.add_to_database(h[100:110], pos[100:110])
    idx, dist = ret.query(h[104], K)
    assert idx[0] == 4 and dist[0] < 1e-5
    left = retriever_mod.cached_executables()
    assert all(e not in left for e in old) and len(_mine(ret)) == 1
    assert len(_mine(other)) == 1


def test_warm_query_builds_the_step_and_inserts_nothing():
    """``warm_query`` builds the Q = 1 step that ``query`` and a
    one-query ``query_batch`` run, leaves the rows, positions and size as
    they were, and a later query builds nothing new."""
    ret, h, pos, _ = _database("wasserstein", "uint16", seed=3)
    rows, db_pos = ret._db_rows.clone(), ret._db_pos.clone()
    ret.warm_query(K)
    assert ret.database_size == N_ROWS
    assert torch.equal(ret._db_rows.view(torch.int16),
                       rows.view(torch.int16))
    assert torch.equal(ret._db_pos, db_pos)
    (exe,) = _mine(ret)
    assert (exe.n_queries, exe.top_k) == (1, K)
    eager = retriever_mod.STATS["eager_steps"]
    ret.query(h[7], K)
    ret.query_batch(h[7:8], K)
    assert _mine(ret) == [exe]
    assert retriever_mod.STATS["eager_steps"] == eager + 2


def test_entry_points_asked_for_cuda_fail_without_a_card():
    """On a machine without a card, a retriever and ``entry()`` asked for
    ``cuda`` raise instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the refusal applies without one")
    from neural_spectral_codec_torch.entry import entry
    with pytest.raises(RuntimeError, match="no CUDA device"):
        WassersteinRetriever(n_bins=DIM, capacity=8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        entry()
