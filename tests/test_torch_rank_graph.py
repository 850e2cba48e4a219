"""The evaluation's ranking as an executable (``evaluation.RankExecutable``)
on the CPU: ``evaluate_place_recognition`` through it against JAX's
(``neural_spectral_codec_tpu/evaluation.py``, whose ``_hit_chunk`` is one
jitted program a chunk, the last chunk padded), with a padded last chunk
and with tied distances; one executable a shape, the padding trimmed, the
eager step counted. Bars as ``tests/test_torch_evaluation.py`` states
them (``assert_metrics_equal``: counts and recalls exact, the curve within
1e-6, τ² within 16 ulps of the largest squared norm). Small shapes: up to
260 frames of 16-D embeddings."""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "tests"))

from neural_spectral_codec_tpu import evaluation as jeval  # noqa: E402
from neural_spectral_codec_torch import evaluation as teval  # noqa: E402
from test_torch_evaluation import (  # noqa: E402
    assert_metrics_equal, loop_poses)

torch.set_num_threads(2)


def _embeddings(n: int, seed: int, tied: bool = False) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if tied:                    # 3 values: every rank has ties
        return rng.integers(0, 3, (n, 1)).astype(np.float32) * np.ones(
            (1, 16), np.float32)
    emb = rng.random((n, 16)).astype(np.float32)
    emb[n // 2:] = emb[:n - n // 2] + 0.3 * rng.standard_normal(
        (n - n // 2, 16)).astype(np.float32)
    return emb


@pytest.mark.parametrize("tied", [False, True])
def test_ranking_executable_equals_jax_with_a_padded_last_chunk(tied):
    """Query chunks of 64 with a padded last chunk: the port's
    ``RankExecutable`` and JAX's chunked ranking give the same metrics,
    on untied and on tied embeddings (ties to the lower index)."""
    n = 260
    poses = loop_poses(n)
    emb = _embeddings(n, seed=11, tied=tied)
    want = jeval.evaluate_place_recognition(emb, poses, (1, 5, 10), 5.0, 30,
                                            query_chunk=64)
    assert want["n_queries"] > 64 and want["n_queries"] % 64 != 0
    teval.clear_cache()
    got = teval.evaluate_place_recognition(emb, poses, (1, 5, 10), 5.0, 30,
                                           query_chunk=64, device="cpu")
    assert_metrics_equal(got, want, emb)
    exe = teval.cached_executables()
    assert len(exe) == 1 and exe[0].graph is None
    assert exe[0].outputs.dev["hits"].shape == (64, 10)
    teval.clear_cache()


def test_one_executable_a_shape_and_the_eager_steps_counted():
    """Two evaluations of one shape share one executable (each chunk one
    eager step on the CPU, none captured); another chunk, another
    executable; ``use_graph=False`` gives the same metrics;
    ``clear_cache`` drops them."""
    n = 260
    poses = loop_poses(n)
    emb = _embeddings(n, seed=12)
    teval.clear_cache()
    before = dict(teval.STATS)
    runs = [teval.evaluate_place_recognition(emb, poses, (1, 5), 5.0, 30,
                                             query_chunk=50, device="cpu",
                                             use_graph=g)
            for g in (True, False)]
    assert runs[0] == runs[1]
    nq = runs[0]["n_queries"]
    assert nq > 50
    assert len(teval.cached_executables()) == 1
    assert teval.STATS["eager_steps"] - before["eager_steps"] == \
        2 * -(-nq // 50)
    assert teval.STATS["captures"] == before["captures"]
    teval.evaluate_place_recognition(emb, poses, (1, 5), 5.0, 30,
                                     query_chunk=4096, device="cpu")
    sizes = sorted(e.outputs.dev["top1"].shape[0]
                   for e in teval.cached_executables())
    assert sizes == [50, nq]
    teval.clear_cache()
    assert teval.cached_executables() == []


def test_padding_is_trimmed():
    """The padded queries (repeats of the last) never reach the metrics:
    chunks of 64 give the metrics of one chunk holding every query."""
    n = 260
    poses = loop_poses(n)
    emb = _embeddings(n, seed=13)
    one = teval.evaluate_place_recognition(emb, poses, (1, 5), 5.0, 30,
                                           query_chunk=4096, device="cpu")
    chunked = teval.evaluate_place_recognition(emb, poses, (1, 5), 5.0, 30,
                                               query_chunk=64, device="cpu")
    assert one["n_queries"] % 64 != 0
    assert one == chunked
    teval.clear_cache()
