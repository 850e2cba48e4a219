"""PyTorch port vs the JAX reference: the evaluation suite
(``neural_spectral_codec_torch/evaluation.py``) on the same numpy inputs.
``evaluate_place_recognition``: recall@k, precision@1 and the query count
exact, the P/R/F1 curve within 1e-6, with chunked queries, without
queries and with tied distances (the ranking breaks ties by the lower
index, as ``lax.top_k`` does). ``rotation_invariance_check`` within 1e-6,
``quantization_error_stats`` equal. ``run_benchmark`` on a synthetic
sequence: the same sequences, keyframes and queries, recall@k exact and
best F1 within 1e-6, without the GNN and with JAX's GNN weights carried
over by ``from_flax``."""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from neural_spectral_codec_tpu import evaluation as jeval  # noqa: E402
from neural_spectral_codec_tpu.data.synthetic import (  # noqa: E402
    SyntheticLoader as JaxSyntheticLoader)
from neural_spectral_codec_tpu.keyframe.graph import (  # noqa: E402
    build_graph_from_keyframes as jax_build_graph)
from neural_spectral_codec_tpu.models.gnn import (  # noqa: E402
    gnn_forward as jax_gnn_forward, init_gnn)
from neural_spectral_codec_tpu.ops.spectral import (  # noqa: E402
    SpectralEncoderConfig as JaxEncoderConfig)
from neural_spectral_codec_tpu.pipeline import (  # noqa: E402
    NeuralSpectralCodecPipeline as JaxPipeline)
from neural_spectral_codec_tpu.retrieval.retriever import (  # noqa: E402
    _topk_smallest)
from neural_spectral_codec_tpu.utils.config import load_config  # noqa: E402
from neural_spectral_codec_torch import evaluation as teval  # noqa: E402
from neural_spectral_codec_torch.data.synthetic import (  # noqa: E402
    SyntheticLoader)
from neural_spectral_codec_torch.models import from_flax  # noqa: E402
from neural_spectral_codec_torch.ops.spectral import (  # noqa: E402
    SpectralEncoderConfig)

torch.set_num_threads(2)
CURVE_TOL = 1e-6        # precision, recall, F1: port vs JAX
ROT_TOL = 1e-6          # rotation-invariance differences: port vs JAX
TAU2_ULPS = 16          # tau², in ulps of the largest squared norm
EXACT = ("n_queries", "recall@1", "recall@5", "recall@10", "precision@1",
         "f1@1")
CURVE = ("best_f1", "precision_at_best_f1", "recall_at_best_f1")


def assert_metrics_equal(got: dict, want: dict, emb: np.ndarray):
    """Recall@k, precision@1 and the query count exact; precision, recall
    and F1 along the curve within CURVE_TOL. The thresholds tau are top-1
    distances through |q|² + |e|² − 2 q·e in float32, which cancels near
    0, and XLA and PyTorch accumulate the product in different orders, so
    tau² is held to TAU2_ULPS ulps of the largest squared norm."""
    keys = [k for k in EXACT if k in want]
    assert {k: got[k] for k in keys} == {k: want[k] for k in keys}
    for k in CURVE:
        assert abs(got[k] - want[k]) <= CURVE_TOL, k
    gc, wc = got["precision_recall_curve"], want["precision_recall_curve"]
    for k in ("precision", "recall", "f1"):
        np.testing.assert_allclose(gc[k], wc[k], rtol=0, atol=CURVE_TOL,
                                   err_msg=k)
    tau2_tol = TAU2_ULPS * np.spacing(
        np.float32(np.sum(emb.astype(np.float64) ** 2, axis=1).max()))
    gt, wt = (np.array(c["tau"] + [got["best_f1_tau"]]) for c in (gc, wc))
    wt[-1] = want["best_f1_tau"]
    assert len(gt) == len(wt) and np.array_equal(np.isinf(gt), np.isinf(wt))
    fin = np.isfinite(wt)
    np.testing.assert_allclose(gt[fin] ** 2, wt[fin] ** 2, rtol=0,
                               atol=tau2_tol, err_msg="tau²")


def loop_poses(n: int, laps: float = 2.0, radius: float = 60.0):
    t = np.linspace(0, 2 * np.pi * laps, n)
    poses = np.tile(np.eye(4), (n, 1, 1))
    poses[:, 0, 3] = radius * np.cos(t)
    poses[:, 1, 3] = radius * np.sin(t)
    return poses


def test_place_recognition_equals_jax():
    """Seeded embeddings on two laps: revisits found, recall and curve as
    JAX's."""
    rng = np.random.default_rng(0)
    n = 260
    poses = loop_poses(n)
    emb = rng.random((n, 16)).astype(np.float32)
    emb[n // 2:] = emb[:n - n // 2] + 0.3 * rng.standard_normal(
        (n - n // 2, 16)).astype(np.float32)      # revisits look alike
    want = jeval.evaluate_place_recognition(emb, poses, (1, 5, 10), 5.0, 30)
    got = teval.evaluate_place_recognition(emb, poses, (1, 5, 10), 5.0, 30,
                                           device="cpu")
    assert want["n_queries"] > 40 and 0 < want["recall@1"] < 1
    assert_metrics_equal(got, want, emb)


def test_place_recognition_chunked_equals_jax():
    """Query chunks of 17 (JAX pads its last chunk) against JAX chunked
    and the port unchunked."""
    rng = np.random.default_rng(1)
    n = 260
    poses = loop_poses(n)
    emb = rng.random((n, 16)).astype(np.float32)
    want = jeval.evaluate_place_recognition(emb, poses, (1, 5), 5.0, 30,
                                            query_chunk=17)
    assert want["n_queries"] % 17 != 0
    for chunk in (17, 4096):
        got = teval.evaluate_place_recognition(emb, poses, (1, 5), 5.0, 30,
                                               query_chunk=chunk,
                                               device="cpu")
        assert_metrics_equal(got, want, emb)


def test_place_recognition_no_queries():
    poses = np.tile(np.eye(4), (50, 1, 1))
    poses[:, 0, 3] = np.arange(50) * 10.0          # a straight line
    emb = np.random.default_rng(2).random((50, 8)).astype(np.float32)
    got = teval.evaluate_place_recognition(emb, poses, (1,), device="cpu")
    assert got == jeval.evaluate_place_recognition(emb, poses, (1,))
    assert got["n_queries"] == 0 and got["recall@1"] == 0.0


@pytest.mark.parametrize("n_distinct", [1, 3])
def test_place_recognition_ties_equal_jax(n_distinct):
    """Degenerate scans encode to equal descriptors: with 1 or 3 distinct
    embeddings every distance ties, and which tied frame ranks first
    decides the hits: recall@k, precision@1 and the query count as JAX's.
    The top-1 distances are then the float32 rounding noise of
    |q|² + |e|² − 2 q·e between equal rows (a value per distinct row, at
    or near 0, which each library rounds its own way), so the curve's
    thresholds are that noise and are not compared here."""
    rng = np.random.default_rng(3)
    n = 240
    poses = loop_poses(n)
    base = rng.random((n_distinct, 12)).astype(np.float32)
    emb = base[rng.integers(0, n_distinct, n)]
    want = jeval.evaluate_place_recognition(emb, poses, (1, 5, 10), 5.0, 30)
    got = teval.evaluate_place_recognition(emb, poses, (1, 5, 10), 5.0, 30,
                                           device="cpu")
    assert want["n_queries"] > 40 and 0 < want["recall@10"] < 1
    assert {k: got[k] for k in EXACT} == {k: want[k] for k in EXACT}


@pytest.mark.parametrize("n", [300, 2500])
def test_smallest_k_order_equals_lax_top_k(n):
    """Indices and values of the k smallest, ties by the lower index, as
    the JAX ranking gives them (flat ``lax.top_k`` at 300 columns, its
    tiled two-phase form at 2500), with +inf and tied columns."""
    rng = np.random.default_rng(4)
    rows = rng.integers(0, 5, (6, n)).astype(np.float32) / 4
    rows[0] = 1.0                                  # one value everywhere
    rows[1, : n // 2] = np.inf
    rows[2, 7::11] = np.inf
    for k in (1, 10, 64):
        want_v, want_i = _topk_smallest(jnp.asarray(rows), k)
        got_v, got_i = teval.smallest_k(torch.from_numpy(rows), k)
        np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
        np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))


def test_rotation_invariance_equals_jax():
    scan = SyntheticLoader(n_frames=4, seed=5, n_points=4096)[1]["points"]
    pts = np.nan_to_num(scan)
    want = jeval.rotation_invariance_check(pts, JaxEncoderConfig(),
                                           max_points=4096)
    got = teval.rotation_invariance_check(pts, SpectralEncoderConfig(),
                                          max_points=4096, device="cpu")
    assert got["n_rotations"] == want["n_rotations"] == 8
    for k in ("max_difference", "mean_difference"):
        assert abs(got[k] - want[k]) <= ROT_TOL, k
    assert got["max_difference"] < 1e-3


def test_quantization_error_stats_equal_jax():
    h = np.random.default_rng(6).random(800).astype(np.float32)
    got = teval.quantization_error_stats(h, device="cpu")
    assert got == jeval.quantization_error_stats(h)
    assert got["sum_preserved"]


# ------------------------------------------------------------ run_benchmark

def bench_config(**sections):
    """tests/test_evaluation.py's run_benchmark configuration (16 x 90
    images, 20 bins, 8,192 points) with a 160 -> 32 -> 160 GNN."""
    cfg = load_config(str(REPO / "configs" / "inference.yaml"))
    cfg["encoding"].update({"n_elevation": 16, "n_azimuth": 90, "n_bins": 20,
                            "target_elevation_bins": 8, "max_points": 8192})
    cfg["gnn"].update({"input_dim": 160, "hidden_dim": 32,
                       "output_dim": 160})
    cfg["keyframe"].update({"distance_threshold": 2.0})
    cfg["validation"] = {"recall_distance_threshold": 5.0, "skip_frames": 20}
    for k, v in sections.items():
        cfg.setdefault(k, {}).update(v)
    return cfg


def _stream():
    return JaxSyntheticLoader(n_frames=100, seed=0, n_points=4096,
                              loops=2.0)


@pytest.fixture(scope="module")
def jax_bench(tmp_path_factory):
    """JAX's run_benchmark (with the rotation check) and JAX's GNN branch
    (``gnn_forward`` on the benchmark's keyframe graph, then
    ``evaluate_place_recognition``) once per module; the GNN weights
    saved as the port's checkpoint."""
    cfg = bench_config(quality={"check_rotation_invariance": True})
    res = jeval.run_benchmark([_stream()], cfg)
    pipe = JaxPipeline(bench_config())
    params, stats = init_gnn(pipe.model, jax.random.key(0))
    kfs = pipe._process_sequence(_stream())
    graph = jax_build_graph(kfs, temporal_neighbors=pipe.temporal_neighbors)
    emb = np.asarray(jax_gnn_forward(pipe.model, params, stats, graph))
    gnn = jeval.evaluate_place_recognition(
        emb, np.stack([kf.pose for kf in kfs]), [1, 5, 10], 5.0, 20)
    ckpt = tmp_path_factory.mktemp("ckpt") / "jax_weights.pt"
    torch.save({"model": from_flax(
        jax.tree_util.tree_map(np.asarray, params),
        jax.tree_util.tree_map(np.asarray, stats))}, ckpt)
    desc = np.stack([kf.descriptor for kf in kfs])
    return res, (gnn, emb), (len(kfs), desc), str(ckpt)


def _check_bench(got: dict, want_seq: dict, n_kf: int, emb: np.ndarray):
    assert list(got["sequences"]) == ["0"]
    m = got["sequences"]["0"]
    assert m["n_keyframes"] == n_kf
    assert m["n_queries"] == want_seq["n_queries"] > 0
    assert_metrics_equal(m, want_seq, emb)
    assert m["encode_time_s"] > 0 and m["avg_query_time_ms"] > 0
    assert got["mean"] == {"recall@1": m["recall@1"],
                           "recall@5": m["recall@5"],
                           "recall@10": m["recall@10"],
                           "best_f1": m["best_f1"]}


def test_run_benchmark_equals_jax(jax_bench, tmp_path):
    """Raw descriptors, the rotation check and the results JSON."""
    want, _, (n_kf, desc), _ = jax_bench
    out = tmp_path / "results.json"
    cfg = bench_config(quality={"check_rotation_invariance": True})
    got = teval.run_benchmark([SyntheticLoader(n_frames=100, seed=0,
                                               n_points=4096, loops=2.0)],
                              cfg, results_path=str(out), device="cpu")
    _check_bench(got, want["sequences"]["0"], n_kf, desc)
    assert got["config"] == want["config"]
    for k in ("max_difference", "mean_difference"):
        assert abs(got["rotation_invariance"][k]
                   - want["rotation_invariance"][k]) <= ROT_TOL
    assert got["rotation_invariance"]["passed"] == \
        want["rotation_invariance"]["passed"]
    import json
    assert json.loads(out.read_text())["mean"] == got["mean"]


@pytest.mark.parametrize("ablate", [False, True])
def test_run_benchmark_gnn_equals_jax(jax_bench, ablate):
    """With JAX's GNN weights in a ``.pt`` checkpoint: the embeddings'
    metrics as JAX's GNN branch; ``ablation.disable_gnn`` wins over the
    checkpoint and gives the raw-descriptor metrics."""
    want, (gnn, emb), (n_kf, desc), ckpt = jax_bench
    cfg = bench_config(ablation={"disable_gnn": ablate})
    got = teval.run_benchmark([SyntheticLoader(n_frames=100, seed=0,
                                               n_points=4096, loops=2.0)],
                              cfg, checkpoint_path=ckpt, device="cpu")
    if ablate:
        _check_bench(got, want["sequences"]["0"], n_kf, desc)
    else:
        _check_bench(got, gnn, n_kf, emb)


def test_run_benchmark_skips_short_sequences():
    """A sequence with fewer than 3 keyframes is skipped; no ``mean``."""
    got = teval.run_benchmark([SyntheticLoader(n_frames=2, seed=0,
                                               n_points=2048)],
                              bench_config(), device="cpu")
    assert got["sequences"] == {} and "mean" not in got
