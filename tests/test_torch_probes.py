"""PyTorch port vs the JAX reference: the plain versions of the three probe
kernels (``ops/probe_kernels.py``) against the Pallas bodies they port.

- P1 ``ring_fold_rows_plain`` vs ``pallas_ring.ring_fold_pallas`` and vs
  ``experiments/ring_stage_probe._variant_kernel`` with nothing switched
  off and full stage depths, both in interpret mode; and, through
  ``ring_keys_padded`` and ``fold_min_rows``, vs the port's own ring
  projection;
- P2 ``roll_floor`` vs ``ring_stage_probe._floor_kernel`` in interpret
  mode;
- P3 ``roll_min_chain`` vs a numpy restatement of ``_roll_kernel``, the
  closure at ``experiments/profile_hotpath.py:244-250``.

Tolerance: none. Every comparison is bit-equal: each probe takes mins,
compares and selects on the same float32 values and adds once, in the
same order on both sides.
"""

import functools
import importlib.util
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.experimental import pallas as pl  # noqa: E402

from test_torch_ring import _sweep  # noqa: E402
from neural_spectral_codec_tpu.ops import ring_path as jrp  # noqa: E402
from neural_spectral_codec_tpu.ops.pallas_ring import (  # noqa: E402
    ring_fold_pallas)
from neural_spectral_codec_tpu.ops.range_image import (  # noqa: E402
    ProjectionConfig)
from neural_spectral_codec_torch.ops import probe_kernels as pk  # noqa: E402

torch.set_num_threads(2)

CFG = ProjectionConfig()
ROWS, WIDTH = 64, 256        # one 64-row block of the TPU probes


def _load_experiment(name):
    spec = importlib.util.spec_from_file_location(
        f"_jax_{name}", REPO / "experiments" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


RSP = _load_experiment("ring_stage_probe")


def _probe_keys(n_folds, seed):
    """(64, 256) float32 keys and ranges from JAX ``_ring_keys`` on rings
    sweeping more turns than the fold budget (extra wrap events), with
    scattered, leading and interior holes, a ring below the range gate
    in part, an empty ring, and the 200 → 256 padding."""
    turns = {1: 1.0, 2: 1.7, 3: 2.6}[n_folds]
    pts = _sweep(turns, tuple(range(ROWS)), 200, seed=seed)
    pts[0, :, ::7] = np.nan
    pts[0, 1:5, :30] = np.nan              # leading holes
    pts[0, 6, 80:120] = np.nan             # interior hole run
    pts[0, 9] = np.nan                     # no valid point
    pts[0, 10, ::3, :3] *= 0.01            # below min_range
    vals, key = jrp._ring_keys(jnp.asarray(pts), CFG)
    pad = ((0, 0), (0, 0), (0, WIDTH - 200))
    key = jnp.pad(key, pad, constant_values=-1.0).reshape(ROWS, WIDTH)
    vals = jnp.pad(vals, pad, constant_values=jnp.inf).reshape(ROWS, WIDTH)
    return key, vals


@pytest.mark.parametrize("n_folds", [1, 2, 3])
def test_ring_fold_rows_plain_matches_pallas(n_folds):
    key, vals = _probe_keys(n_folds, seed=n_folds)
    got = pk.ring_fold_rows_plain(torch.tensor(np.asarray(key)),
                                  torch.tensor(np.asarray(vals)),
                                  CFG.n_azimuth, n_folds).numpy()
    want = np.asarray(ring_fold_pallas(key, vals, CFG.n_azimuth, n_folds,
                                       interpret=True))
    wpad = pk.folded_width(CFG.n_azimuth, n_folds)
    full = max((WIDTH - 1).bit_length(), 1)
    full_e = max((n_folds * CFG.n_azimuth - 1).bit_length(), 1)
    variant = functools.partial(
        RSP._variant_kernel, p=WIDTH, n_azim=CFG.n_azimuth, n_folds=n_folds,
        wpad=wpad, skip=frozenset(), bounds=(full, full, full, full_e))
    want_variant = np.asarray(pl.pallas_call(
        variant, out_shape=jax.ShapeDtypeStruct((ROWS, wpad), jnp.float32),
        interpret=True)(key, vals))
    assert got.shape == (ROWS, wpad)
    assert (want > 0).sum() > 3000
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, want_variant)
    # the wrapper takes the plain version for a CPU tensor
    np.testing.assert_array_equal(pk.ring_fold_probe(
        torch.tensor(np.asarray(key)), torch.tensor(np.asarray(vals)),
        CFG.n_azimuth, n_folds).numpy(), got)


@pytest.mark.parametrize("n_folds", [1, 2, 3])
def test_padded_keys_and_fold_min_give_the_ring_image(n_folds):
    """``ring_keys_padded`` → ``ring_fold_rows_plain`` → ``fold_min_rows``
    is the probe entry point's route to an image; on all 64 rows it must
    equal the port's ring projection (``project_rings_batch_plain``), bit
    for bit. Two scans, 200 → 256 padded points per ring."""
    from neural_spectral_codec_torch.ops.range_image import (
        ProjectionConfig as TorchProjection)
    from neural_spectral_codec_torch.ops.ring_path import (
        project_rings_batch_plain)
    proj = TorchProjection()
    turns = {1: 1.0, 2: 1.7, 3: 2.6}[n_folds]
    pts = np.concatenate([_sweep(turns, tuple(range(ROWS)), 200, seed=s)
                          for s in (20 + n_folds, 30 + n_folds)])
    pts[1, 2:6, :40] = np.nan                           # leading holes
    pts = torch.from_numpy(pts)
    key, vals = pk.ring_keys_padded(pts, proj)
    assert key.shape == vals.shape == (2 * ROWS, WIDTH)
    assert bool((key[:, 200:] == -1).all()) and bool(
        torch.isinf(vals[:, 200:]).all())
    rows = pk.ring_fold_rows_plain(key, vals, proj.n_azimuth, n_folds)
    image = pk.fold_min_rows(rows, 2, ROWS, proj.n_azimuth, n_folds)
    want = project_rings_batch_plain(pts, proj, tuple(range(ROWS)), n_folds)
    assert image.shape == want.shape == (2, ROWS, proj.n_azimuth)
    assert int((want > 0).sum()) > 5000
    assert torch.equal(image, want)


def test_ring_fold_rows_fold_layout():
    """A hand-made row: bins 5, 6, 2 (wrap 1), 2, 3, 1 (wrap 2), 4; the
    ranges land in slot fold·360 + bin, from the second wrap on they are
    dropped at n_folds = 2, and equal bins of one fold take the min."""
    key = torch.tensor([[5., 6., -1., 2., 2., 3., 1., 4.]])
    vals = torch.tensor([[10., 11., np.inf, 12., 9., 13., 14., 15.]])
    rows = pk.ring_fold_rows_plain(key, vals, 360, 2)[0].numpy()
    assert rows.shape == (768,)
    assert dict(zip(np.flatnonzero(rows).tolist(), rows[rows > 0])) == {
        5: 10.0, 6: 11.0, 362: 9.0, 363: 13.0}
    rows3 = pk.ring_fold_rows_plain(key, vals, 360, 3)[0].numpy()
    assert rows3.shape == (1152,)
    assert rows3[721] == 14.0 and rows3[724] == 15.0


@pytest.mark.parametrize("n_stages,n_arrays", [(5, 1), (5, 2), (12, 1),
                                               (12, 2)])
def test_roll_floor_matches_pallas(n_stages, n_arrays):
    """12 stages run past the width (2^8 = 256): ``sh mod p`` is 0 there
    and the roll falls back to ``p − 1``. Quantised values give ties, and
    a NaN checks the compare."""
    rng = np.random.default_rng(10 * n_stages + n_arrays)
    x = (rng.integers(0, 40, (ROWS, WIDTH)) / 7).astype(np.float32)
    y = rng.uniform(0, 1, (ROWS, WIDTH)).astype(np.float32)
    x[3, 5] = np.nan
    kernel = functools.partial(RSP._floor_kernel, n_stages=n_stages,
                               n_arrays=n_arrays, p=WIDTH)
    want = np.asarray(pl.pallas_call(
        kernel, out_shape=jax.ShapeDtypeStruct((ROWS, WIDTH), jnp.float32),
        interpret=True)(x, y))
    got = pk.roll_floor(torch.from_numpy(x), torch.from_numpy(y), n_stages,
                        n_arrays).numpy()
    np.testing.assert_array_equal(got, want)


def _roll_kernel_np(x, stages):
    """numpy restatement of ``_roll_kernel`` (profile_hotpath.py:244-250);
    ``pltpu.roll`` has ``np.roll``'s sign convention."""
    y = x + np.float32(1.0)
    for s in range(stages):
        r = np.roll(y, 1 << (s % 11), axis=1)
        y = np.where(r < y, r, y)
    return y


@pytest.mark.parametrize("shape", [(ROWS, WIDTH), (8, 2112)])
def test_roll_min_chain_matches_numpy(shape):
    x = np.random.default_rng(1).uniform(0, 1, shape).astype(np.float32)
    got = pk.roll_min_chain(torch.from_numpy(x), 64).numpy()
    np.testing.assert_array_equal(got, _roll_kernel_np(x, 64))


def test_shift_schedules_are_python_ints():
    """Past 31 stages the doubling shift no longer fits an int32; the
    host schedule stays exact and inside [0, width)."""
    sh = pk.floor_shifts(2176, 40)
    assert sh == [2176 - ((1 << k) % 2176 or 1) for k in range(40)]
    assert all(0 <= s < 2176 for s in sh)
    assert pk.chain_shifts(256, 12) == [1, 2, 4, 8, 16, 32, 64, 128, 0, 0,
                                        0, 1]
    with pytest.raises(ValueError, match="at most"):
        pk._shift_array(list(range(pk.MAX_STAGES + 1)))


def test_probe_wrappers_route_by_device():
    """A CPU tensor takes the plain version and launches nothing; phases
    switch off only in the kernel; other devices and bad arguments
    raise."""
    counts = [k.launches for k in (pk.RING_PROBE, pk.ROLL_FLOOR,
                                   pk.ROLL_MIN_CHAIN)]
    key = torch.full((2, 8), -1.0)
    vals = torch.full((2, 8), float("inf"))
    assert torch.equal(pk.ring_fold_probe(key, vals, 360, 2),
                       torch.zeros((2, 768)))
    x = torch.rand((2, 16))
    pk.roll_floor(x, x, 3, 2)
    pk.roll_min_chain(x, 3)
    assert counts == [k.launches for k in (pk.RING_PROBE, pk.ROLL_FLOOR,
                                           pk.ROLL_MIN_CHAIN)]
    with pytest.raises(ValueError, match="only in the CUDA kernel"):
        pk.ring_fold_probe(key, vals, 360, 2, skip=("scan",))
    with pytest.raises(ValueError, match="unknown phases"):
        pk.ring_fold_probe(key, vals, 360, 2, skip=("jump",))
    with pytest.raises(ValueError, match="CPU or CUDA"):
        pk.ring_fold_probe(key.to("meta"), vals.to("meta"), 360, 2)
    with pytest.raises(ValueError, match="CPU or CUDA"):
        pk.roll_min_chain(x.to("meta"))
    with pytest.raises(ValueError, match="n_arrays"):
        pk.roll_floor(x, x, 3, 3)
    with pytest.raises(ValueError, match="float32"):
        pk.roll_floor(x.double(), x.double(), 3, 1)
