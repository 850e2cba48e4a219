"""Kernel S (``csrc/select.cu``, ``training/select_kernel.py``) on the
CPU: its plain version against ``torch.sort(stable=True)``, JAX's
``jnp.argsort`` (the order the miner's "semi-hard" strategy takes: −0
equal to +0, every NaN last) and numpy's stable sort of the order-mapped
keys, on rows with many ties, ±0, ±inf and NaN; and a numpy model of the
kernel's radix select (its digits and thread layout read from the CUDA
source) against the plain version, bit for bit. Small shapes: up to 64 ×
4,099.

The kernel runs only on a card (``chip_smoke.py`` phase 7k holds it
against ``select_plain`` there, bit for bit)."""

import re
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import jax.numpy as jnp  # noqa: E402

from neural_spectral_codec_torch.training import (  # noqa: E402
    select_kernel as sk)

torch.set_num_threads(2)
SRC = (REPO / "neural_spectral_codec_torch" / "csrc" / "select.cu").read_text()
S_SRC = {m[1]: int(m[2]) for m in re.finditer(
    r"constexpr int (k\w+) = (\d+);", SRC)}
LEVELS = np.array([-np.inf, -1.5, -0.0, 0.0, 0.25, 7.0, np.inf, np.nan],
                  np.float32)


def _rows(kind: str, rows: int, n: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if kind == "random":
        return rng.standard_normal((rows, n)).astype(np.float32)
    if kind == "ties":          # few values, each repeated many times
        return rng.choice(np.array([0.5, 0.25, 3.0, 0.125], np.float32),
                          (rows, n))
    if kind == "w1":            # the miner's block: sums, +inf outside
        x = rng.random((rows, n)).astype(np.float32) * 4
        x[rng.random((rows, n)) < 0.6] = np.inf
        return x
    x = LEVELS[rng.integers(0, len(LEVELS) - (kind == "special_no_nan"),
                            (rows, n))]
    return x


def _places(rows: int, n: int, seed: int) -> np.ndarray:
    k = np.random.default_rng(seed + 100).integers(0, n, rows)
    k[0], k[-1] = 0, n - 1
    return k.astype(np.int32)


def keys_u32(x: np.ndarray) -> np.ndarray:
    """The kernel's unsigned keys: bits ^ 0x80000000 for v > 0, ~bits for
    v < 0, 0x80000000 for ±0, 0xffffffff for NaN."""
    u = x.view(np.uint32)
    k = np.where(u & 0x80000000, ~u, u | 0x80000000).astype(np.uint32)
    k = np.where(x == 0, np.uint32(0x80000000), k)
    return np.where(np.isnan(x), np.uint32(0xFFFFFFFF), k)


def stable_model(x: np.ndarray, k: np.ndarray) -> np.ndarray:
    """numpy's stable argsort of the unsigned keys at place k."""
    order = np.argsort(keys_u32(x), axis=1, kind="stable")
    kk = np.clip(k, 0, x.shape[1] - 1)
    return order[np.arange(len(x)), kk]


@pytest.mark.parametrize("kind", ["random", "ties", "w1", "special",
                                  "special_no_nan"])
@pytest.mark.parametrize("rows,n", [(64, 257), (7, 4099), (3, 1), (2, 5)])
def test_plain_equals_the_stable_order(kind, rows, n):
    """``select_plain`` is the stable order of the order-mapped keys at
    each row's place, and equal to ``torch.sort(stable=True)`` and to
    ``jnp.argsort`` (JAX's reference order)."""
    x = _rows(kind, rows, n, seed=rows * 31 + n)
    k = _places(rows, n, seed=n)
    got = sk.select_plain(torch.from_numpy(x), torch.from_numpy(k)).numpy()
    np.testing.assert_array_equal(got, stable_model(x, k))
    assert got.dtype == np.int32
    ref = torch.sort(torch.from_numpy(x), dim=1, stable=True).indices
    np.testing.assert_array_equal(got, ref.numpy()[np.arange(rows), k])
    ref = np.asarray(jnp.argsort(jnp.asarray(x), axis=1))
    np.testing.assert_array_equal(got, ref[np.arange(rows), k])


def test_zero_signs_nan_and_places_out_of_range():
    """−0 equal to +0 (column order among the zeros), +inf after every
    finite value, every NaN last in column order, whatever its sign;
    places below 0 and past the row are clamped."""
    x = np.array([[0.0, np.nan, -0.0, np.inf, -np.nan, 1.0, -np.inf, 0.0]],
                 np.float32)
    order = [6, 0, 2, 7, 5, 3, 1, 4]
    for place, col in enumerate(order):
        got = sk.select_plain(torch.from_numpy(x),
                              torch.tensor([place], dtype=torch.int32))
        assert int(got[0]) == col, place
    for place, col in ((-3, 6), (8, 4), (1000, 4)):
        got = sk.select_plain(torch.from_numpy(x), torch.tensor([place]))
        assert int(got[0]) == col


def select_model(x: np.ndarray, k: np.ndarray) -> np.ndarray:
    """Kernel S as ``csrc/select.cu`` runs it: digit passes of 11, 11 and
    10 bits from the top, each a histogram of the entries that match the
    digits chosen so far, the digit whose bucket holds the remaining
    place chosen by a prefix count over the bins and the place narrowed
    to that bucket (a bucket of one entry ends the passes); then a walk in
    steps of kThreads × kPerThread columns, each thread's kPerThread
    consecutive columns counted, the place found by a prefix count over
    the threads."""
    threads, per = S_SRC["kThreads"], S_SRC["kPerThread"]
    bins = S_SRC["kBins"]
    assert S_SRC["kPasses"] == 3 and bins == 2048
    shifts, widths = (21, 10, 0), (11, 11, 10)
    out = np.zeros(len(x), np.int64)
    for r in range(len(x)):
        key = keys_u32(x[r]).astype(np.uint64)
        n = len(key)
        rank = int(np.clip(k[r], 0, n - 1))
        prefix = mask = 0
        for shift, width in zip(shifts, widths):
            dmask = (1 << width) - 1
            match = (key & mask) == prefix
            hist = np.bincount(((key[match] >> shift) & dmask).astype(
                np.int64), minlength=bins)
            cum = np.cumsum(hist)
            digit = int(np.searchsorted(cum, rank, side="right"))
            below = int(cum[digit] - hist[digit])
            prefix |= digit << shift
            mask |= dmask << shift
            rank -= below
            if hist[digit] == 1:
                break
        hits = (key & mask) == prefix
        step = threads * per
        for base in range(0, n, step):
            h = np.zeros(step, bool)
            h[:min(step, n - base)] = hits[base:base + step]
            c = h.reshape(threads, per).sum(1)
            total = int(c.sum())
            if rank < total:
                t = int(np.searchsorted(np.cumsum(c), rank, side="right"))
                left = rank - int(np.cumsum(c)[t] - c[t])
                cols = np.flatnonzero(h[t * per:(t + 1) * per])
                out[r] = base + t * per + cols[left]
                break
            rank -= total
    return out


@pytest.mark.parametrize("kind", ["random", "ties", "w1", "special"])
def test_radix_model_equals_plain(kind):
    """The kernel's radix select gives ``select_plain``'s column on every
    row: 16 rows of 4,099 columns (a partial last step of the walk), rows
    of many ties (buckets of thousands), the miner's +inf-heavy blocks,
    ±0, ±inf and NaN, places at both ends."""
    x = _rows(kind, 16, 4099, seed=7)
    k = _places(16, 4099, seed=8)
    want = sk.select_plain(torch.from_numpy(x), torch.from_numpy(k))
    np.testing.assert_array_equal(select_model(x, k), want.numpy())


def test_radix_model_on_close_values():
    """Values a few ulps apart (one digit pass does not separate them) and
    a row whose every entry is equal: the model still takes the stable
    order's column."""
    base = np.float32(1.0)
    x = np.stack([
        base + np.random.default_rng(3).integers(0, 9, 3000).astype(
            np.float32) * np.spacing(base),
        np.full(3000, np.float32(2.5))])
    k = np.array([1500, 2999], np.int32)
    want = sk.select_plain(torch.from_numpy(x), torch.from_numpy(k))
    np.testing.assert_array_equal(select_model(x, k), want.numpy())
    assert int(want[1]) == 2999


def test_model_digits_are_the_sources():
    """The model's digits (11, 11 and 10 bits from the top: shifts 21, 10
    and 0) and the walk's step are those of ``csrc/select.cu``."""
    assert "p == 0 ? 21 : p == 1 ? 10 : 0" in SRC
    assert "p == 2 ? 10 : 11" in SRC
    assert "kStep = kThreads * kPerThread" in SRC
    assert (S_SRC["kThreads"], S_SRC["kPerThread"]) == (512, 4)


def test_select_on_cpu_is_the_plain_version_and_cuda_raises():
    """``select`` on CPU tensors is ``select_plain``; ``select_cuda``
    refuses CPU tensors, and a CUDA tensor without a card raises."""
    x = torch.from_numpy(_rows("w1", 4, 50, seed=1))
    k = torch.tensor([0, 10, 25, 49], dtype=torch.int32)
    assert torch.equal(sk.select(x, k), sk.select_plain(x, k))
    with pytest.raises(ValueError):
        sk.select_cuda(x, k)
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError)):
            sk.select(x.to("cuda"), k)
