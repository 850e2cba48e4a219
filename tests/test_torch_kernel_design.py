"""The host-side pieces of the Hopper kernel designs, on the CPU: the
spectral kernel's bin ranges, twiddle table, folded DFT and per-CTA row
ranges, the ring kernel's row-table cache, the kernel binding's bare
relaunch, and the rule that the port's entry points run on the card
unless the caller names the CPU."""

import inspect
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import jax.numpy as jnp  # noqa: E402

from neural_spectral_codec_tpu.ops import spectral as jsp  # noqa: E402
from neural_spectral_codec_torch import _build  # noqa: E402
from neural_spectral_codec_torch.ops import ring_kernel  # noqa: E402
from neural_spectral_codec_torch.ops import spectral_kernel as sk  # noqa: E402
from neural_spectral_codec_torch.ops import range_image as tri  # noqa: E402
from neural_spectral_codec_torch.ops import spectral as tsp  # noqa: E402

torch.set_num_threads(2)


@pytest.mark.parametrize("alpha", [0.5, 1.3, 2.0, 5.0])
def test_bin_ranges_sum_like_the_binning_matrix(alpha):
    """Summing |rfft| over each bin's [start, end) equals ``mags @
    binning_matrix`` (and the JAX package's matrix); at α = 5 some bins
    are empty ranges and give 0."""
    rng = np.random.default_rng(0)
    rows = torch.from_numpy(rng.uniform(0, 80, (16, 360)).astype(np.float32))
    mags = torch.fft.rfft(rows, dim=-1).abs()
    bounds = sk.bin_bounds(tsp.bin_assignment(alpha, 50, 181), 50)
    assert bounds.dtype == torch.int32 and bounds[0] == 0 and bounds[-1] == 181
    hist = torch.stack([mags[:, bounds[b]:bounds[b + 1]].sum(dim=1)
                        for b in range(50)], dim=1)
    want = mags @ tsp.binning_matrix(alpha, 50, 181)
    np.testing.assert_allclose(hist.numpy(), want.numpy(), rtol=1e-5, atol=0)
    jmat = np.asarray(jsp.binning_matrix(jnp.float32(alpha), 50, 181))
    np.testing.assert_array_equal(np.diff(bounds.numpy()), jmat.sum(axis=0))
    empty = (bounds[1:] == bounds[:-1]).numpy()
    if alpha == 5.0:
        assert empty.any() and np.all(hist.numpy()[:, empty] == 0.0)
    cached = sk.bounds_for(alpha, tsp.SpectralEncoderConfig(alpha=alpha),
                           torch.device("cpu"))
    assert torch.equal(cached, bounds)
    assert cached is sk.bounds_for(alpha, tsp.SpectralEncoderConfig(),
                                   torch.device("cpu"))
    tensor_alpha = sk.bounds_for(torch.tensor(alpha),
                                 tsp.SpectralEncoderConfig(),
                                 torch.device("cpu"))
    assert torch.equal(tensor_alpha, bounds)


@pytest.mark.parametrize("n_azim", [360, 384])
def test_twiddle_table_covers_the_dft_bases(n_azim):
    """Entry (a·k) mod A of the A-entry table is within 1e-6 of
    ``dft_bases``'s [a, k] for every column a and frequency k."""
    table = sk.twiddle_table(n_azim)
    assert table.shape == (n_azim, 2) and table.dtype == np.float32
    cos_b, sin_b = tsp.dft_bases(n_azim)
    a = np.arange(n_azim)[:, None]
    k = np.arange(n_azim // 2 + 1)[None, :]
    idx = (a * k) % n_azim
    assert np.abs(table[idx, 0] - cos_b).max() <= 1e-6
    assert np.abs(table[idx, 1] - sin_b).max() <= 1e-6


@pytest.mark.parametrize("n_elev,n_target,cluster",
                         [(64, 16, 8), (16, 16, 8), (20, 16, 8)])
def test_cta_rows_cover_the_pooling_windows(n_elev, n_target, cluster):
    """The CTAs of a scan own every pooled row once, and each CTA's input
    rows are exactly the union of its pooled rows' windows in
    ``pooling_matrix``."""
    pool = tsp.pooling_matrix(n_elev, n_target)
    owned = []
    for t_lo, t_hi, in_lo, in_hi in sk.cta_rows(n_elev, n_target, cluster):
        owned.extend(range(t_lo, t_hi))
        read = set(np.flatnonzero(pool[t_lo:t_hi].sum(axis=0)).tolist())
        assert read == set(range(in_lo, in_hi))
    assert owned == list(range(n_target))
    assert (sk.shared_bytes(n_elev, 360, n_target, 50)
            <= _build.MAX_SHARED_BYTES)


@pytest.mark.parametrize("n_azim", [360, 361])
def test_folded_dft_gives_the_rfft_magnitudes(n_azim):
    """The spectral kernel's DFT, mirrored in float64: column a folded
    with A − a (sums against cos, differences against sin, from the
    twiddle table at (a·k) mod A), plus column 0 and, for an even A, the
    middle column with sign (−1)^k, gives |rfft| (even and odd A)."""
    rng = np.random.default_rng(3)
    x = rng.uniform(0, 80, (2, n_azim))
    table = sk.twiddle_table(n_azim).astype(np.float64)
    half = (n_azim - 1) // 2
    a = np.arange(1, half + 1)
    sums, difs = x[:, a] + x[:, n_azim - a], x[:, a] - x[:, n_azim - a]
    k = np.arange(n_azim // 2 + 1)
    idx = (a[:, None] * k[None, :]) % n_azim
    re = x[:, :1] + sums @ table[idx, 0]
    if n_azim % 2 == 0:
        re += x[:, n_azim // 2:n_azim // 2 + 1] * np.where(k % 2, -1.0, 1.0)
    im = difs @ table[idx, 1]
    np.testing.assert_allclose(np.hypot(re, im),
                               np.abs(np.fft.rfft(x, axis=1)), rtol=1e-6,
                               atol=1e-3)


def test_row_table_is_cached_per_rows_and_device():
    cpu = torch.device("cpu")
    a = ring_kernel.row_table((0, 2, 5), cpu)
    assert a is ring_kernel.row_table((0, 2, 5), cpu)
    assert a.dtype == torch.int32 and a.tolist() == [0, 2, 5]
    assert ring_kernel.row_table((0, 2, 6), cpu) is not a


def test_bare_relaunches_the_last_call_uncounted():
    calls = []
    kernel = _build.CudaKernel("nsc_test_symbol", [])
    kernel.__dict__["_fn"] = lambda *args: calls.append(args) or 0
    kernel(1, 2, 3)
    launch = kernel.bare()
    launch()
    launch()
    assert calls == [(1, 2, 3)] * 3 and kernel.launches == 1


def _entry_points():
    from neural_spectral_codec_torch import pipeline, train_multi_dataset
    from neural_spectral_codec_torch.ops import ring_path
    from neural_spectral_codec_torch.retrieval import retriever
    from neural_spectral_codec_torch.training import (
        miner, trainer, validation)
    cfg = tsp.SpectralEncoderConfig()
    pts = np.zeros((8, 4), np.float32)
    poses = np.tile(np.eye(4), (3, 1, 1))
    return {
        "BatchEncoder": (pipeline.BatchEncoder.__init__,
                         lambda: pipeline.BatchEncoder(cfg)),
        "RingMajorBatchEncoder": (
            pipeline.RingMajorBatchEncoder.__init__,
            lambda: pipeline.RingMajorBatchEncoder(cfg)),
        "NeuralSpectralCodecPipeline": (
            pipeline.NeuralSpectralCodecPipeline.__init__,
            lambda: pipeline.NeuralSpectralCodecPipeline({})),
        "GNNTrainer": (trainer.GNNTrainer.__init__,
                       lambda: trainer.GNNTrainer()),
        "create_trainer": (trainer.GNNTrainer.__init__,
                           lambda: trainer.create_trainer()),
        "TripletMiner": (miner.TripletMiner.__init__,
                         lambda: miner.TripletMiner()),
        "create_triplet_miner": (miner.create_triplet_miner,
                                 lambda: miner.create_triplet_miner()),
        "find_revisit_queries": (
            validation.find_revisit_queries,
            lambda: validation.find_revisit_queries(poses[:, :3, 3])),
        "recall_loop_closure": (
            validation.recall_loop_closure,
            lambda: validation.recall_loop_closure(np.zeros((3, 4)), poses)),
        "WassersteinRetriever": (retriever.WassersteinRetriever.__init__,
                                 lambda: retriever.WassersteinRetriever()),
        "RangeImageProjector": (tri.RangeImageProjector.__init__,
                                lambda: tri.RangeImageProjector()),
        "encode_structured": (
            ring_path.encode_structured,
            lambda: ring_path.encode_structured(pts, np.zeros(8), 2.0, cfg)),
        "train_multi_dataset": (
            None, lambda: train_multi_dataset.main(["--synthetic", "4"],
                                                   config={})),
    }


@pytest.mark.parametrize("name", sorted(_entry_points()))
def test_entry_points_default_to_the_card(name, monkeypatch):
    """Every entry point of the port runs on the card unless the caller
    names the CPU: with no card (none here, and ``is_available`` patched
    to say so) a call that names no device raises, with no fallback."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    fn, call = _entry_points()[name]
    if fn is not None:
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        call()
