"""PyTorch port vs the JAX reference: the descriptor quantizer, the 7-DoF
pose codec, the fixed-size record store (byte-identical records, stores
read across packages both ways) and the g2o export."""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import jax.numpy as jnp  # noqa: E402

from neural_spectral_codec_tpu.ops import quantization as jq  # noqa: E402
from neural_spectral_codec_tpu.retrieval import g2o as jg2o  # noqa: E402
from neural_spectral_codec_tpu.retrieval.two_stage import (  # noqa: E402
    TwoStageRetrieval as JaxTwoStage)
from neural_spectral_codec_tpu.keyframe.selector import (  # noqa: E402
    Keyframe as JaxKeyframe)
from neural_spectral_codec_torch.keyframe.selector import Keyframe  # noqa: E402
from neural_spectral_codec_torch.ops import quantization as tq  # noqa: E402
from neural_spectral_codec_torch.retrieval import g2o as tg2o  # noqa: E402
from neural_spectral_codec_torch.retrieval.two_stage import (  # noqa: E402
    TwoStageRetrieval)

torch.set_num_threads(2)


def _hists(rng, n, width, power=4.0):
    h = rng.random((n, width)).astype(np.float32) ** power
    return (h / h.sum(axis=1, keepdims=True)).astype(np.float32)


def _poses(rng, n):
    """Random SE(3) poses: QR rotations with det +1, positions over 10 km."""
    out = np.tile(np.eye(4), (n, 1, 1))
    for i in range(n):
        q, r = np.linalg.qr(rng.normal(size=(3, 3)))
        q = q * np.sign(np.diag(r))
        out[i, :3, :3] = q * np.sign(np.linalg.det(q))
        out[i, :3, 3] = rng.uniform(-5000, 5000, 3)
    return out


@pytest.mark.parametrize("width", [20, 32, 50, 90, 160, 800])
def test_quantize_bits_equal_jax(width):
    """Codes bit-equal to JAX for batches and single rows (the row sum
    adds in XLA's CPU order: windows of 32, half the padding in front),
    dequantised values bit-equal."""
    rng = np.random.default_rng(width)
    h = np.concatenate([_hists(rng, 300, width), _hists(rng, 300, width, 1)])
    got = tq.quantize_numpy(h)
    np.testing.assert_array_equal(got, np.asarray(jq.quantize(
        jnp.asarray(h))))
    for row in h[:5]:
        np.testing.assert_array_equal(tq.quantize_numpy(row), np.asarray(
            jq.quantize(jnp.asarray(row))))
    assert got.dtype == np.uint16 and (got.astype(np.int64).sum(1)
                                       == 65535).all()
    np.testing.assert_array_equal(tq.dequantize_numpy(got), np.asarray(
        jq.dequantize(jnp.asarray(got))))


@pytest.mark.parametrize("case", ["ties", "all_zero", "sub_eps", "unnormed"])
def test_quantize_edge_cases_equal_jax(case):
    """Argmax ties (the first largest absorbs the error), an all-zero row
    (codes 0, uniform dequantisation), the pinned Hypothesis input of the
    reference's sub-ε defect (32 bins of 5.9604645e-08: sum 1.9e-6 > ε,
    first bin dequantises to 0.03643854 against 0.03125; kept bit for
    bit) and unnormalised rows."""
    rng = np.random.default_rng(7)
    h = {"ties": np.full((3, 20), 0.05, np.float32),
         "all_zero": np.zeros((2, 50), np.float32),
         "sub_eps": np.full((1, 32), 5.9604645e-08, np.float32),
         "unnormed": rng.random((4, 64)).astype(np.float32) * 7.0}[case]
    got = tq.quantize_numpy(h)
    want = np.asarray(jq.quantize(jnp.asarray(h)))
    np.testing.assert_array_equal(got, want)
    deq = tq.dequantize_numpy(got)
    np.testing.assert_array_equal(deq, np.asarray(jq.dequantize(
        jnp.asarray(want))))
    if case == "ties":
        assert got[0, 0] == got[0, 1:].min() - 5 and (got[0, 1:] == 3277).all()
    if case == "all_zero":
        assert (got == 0).all() and np.allclose(deq, 1.0 / 50)
    if case == "sub_eps":
        np.testing.assert_allclose(deq[0, 0], 0.03643854, rtol=1e-6)
    q = tq.HistogramQuantizer(n_bins=h.shape[1])
    np.testing.assert_array_equal(q.quantize(h), got)
    with pytest.raises(ValueError, match="bin"):
        q.quantize(h[:, :-1])


def test_pose_7dof_roundtrip_equals_jax():
    """The 7-DoF codec equals JAX's on random poses and on the four
    branches of Shepperd's method, and round-trips to 1e-12."""
    rng = np.random.default_rng(1)
    poses = _poses(rng, 40)
    for R in (np.diag([1.0, -1, -1]), np.diag([-1.0, 1, -1]),
              np.diag([-1.0, -1, 1])):
        T = np.eye(4)
        T[:3, :3] = R
        poses = np.concatenate([poses, T[None]])
    for T in poses:
        p7 = tq.pose_to_7dof(T)
        np.testing.assert_array_equal(p7, jq.pose_to_7dof(T))
        np.testing.assert_array_equal(tq.pose_from_7dof(p7),
                                      jq.pose_from_7dof(p7))
        np.testing.assert_allclose(tq.pose_from_7dof(p7), T, atol=1e-12)


def _keyframes(rng, n, width, cls):
    hist = _hists(rng, n, width)
    poses = _poses(rng, n)
    return [cls(keyframe_id=i, scan_id=i,
                points=rng.normal(0, 10, (50 + i, 4)).astype(np.float32),
                pose=poses[i], timestamp=0.1 * i + 1e9,
                descriptor=hist[i]) for i in range(n)]


@pytest.mark.parametrize("width", [50, 800])
def test_records_byte_identical_and_stores_cross_read(tmp_path, width):
    """The same keyframes give byte-identical records (1,720 B at 800
    bins) and stores; a store written by either package loads in the
    other with the same descriptors, poses, timestamps and ids."""
    rng = np.random.default_rng(width)
    kfs = _keyframes(rng, 30, width, Keyframe)
    assert tq.record_size(800) == 1720
    for kf in kfs[:3]:
        args = (kf.descriptor, kf.pose, kf.timestamp, kf.keyframe_id,
                kf.points)
        assert tq.compress_descriptor(*args).to_bytes() == \
            jq.compress_descriptor(*args).to_bytes()
    jax_kfs = [JaxKeyframe(k.keyframe_id, k.scan_id, k.points, k.pose,
                           k.timestamp, descriptor=k.descriptor)
               for k in kfs]
    tstore = TwoStageRetrieval(n_bins=width, capacity=64,
                               verification_backend="torch", device="cpu")
    jstore = JaxTwoStage(n_bins=width, capacity=64,
                         verification_backend="jax")
    for a, b in zip(kfs, jax_kfs):
        tstore.add_keyframe(a)
        jstore.add_keyframe(b)
    tpath, jpath = tmp_path / "t.bin", tmp_path / "j.bin"
    assert tstore.save_database(str(tpath)) == 30
    jstore.save_database(str(jpath))
    assert tpath.read_bytes() == jpath.read_bytes()
    assert tstore.database_file_records(str(tpath)) == 30

    t_from_j = TwoStageRetrieval(n_bins=width, capacity=64,
                                 verification_backend="torch", device="cpu")
    j_from_t = JaxTwoStage(n_bins=width, capacity=64,
                           verification_backend="jax")
    assert t_from_j.load_database(str(jpath)) == 30
    assert j_from_t.load_database(str(tpath)) == 30
    for a, b in zip(t_from_j.keyframes, j_from_t.keyframes):
        assert a.points is None and a.keyframe_id == b.keyframe_id
        assert a.timestamp == b.timestamp
        np.testing.assert_array_equal(a.descriptor, b.descriptor)
        np.testing.assert_array_equal(a.pose, b.pose)
    n = 30
    np.testing.assert_allclose(t_from_j.retriever._db_rows[:n].numpy(),
                               np.asarray(j_from_t.retriever._db_cdf[:n]),
                               rtol=0, atol=1e-6)
    # a torn final record is dropped; a small capacity keeps the first
    with open(tpath, "ab") as f:
        f.write(b"\x01" * 17)
    small = TwoStageRetrieval(n_bins=width, capacity=12,
                              verification_backend="torch", device="cpu")
    assert small.load_database(str(tpath)) == 12
    assert [k.keyframe_id for k in small.keyframes] == list(range(12))
    assert len(tq.DescriptorDatabaseFile(str(tpath), width).read_all()) == 30


def test_g2o_text_equals_jax(tmp_path):
    """The same edges give the same EDGE_SE3:QUAT text."""
    rng = np.random.default_rng(3)
    poses = _poses(rng, 6)
    edges = []
    for mod in (tg2o, jg2o):
        out = []
        for i in range(5):
            e = mod.compute_pose_graph_edge(poses[i], poses[i + 1],
                                            poses[i + 1],
                                            np.eye(6) * (i + 1))
            e["source_id"], e["target_id"] = i + 10, i
            out.append(e)
        edges.append(out)
    tg2o.save_loop_closures_g2o(edges[0], str(tmp_path / "t.g2o"))
    jg2o.save_loop_closures_g2o(edges[1], str(tmp_path / "j.g2o"))
    text = (tmp_path / "t.g2o").read_text()
    assert text == (tmp_path / "j.g2o").read_text()
    assert text.count("EDGE_SE3:QUAT") == 5
    assert len(text.splitlines()[0].split()) == 10 + 21
