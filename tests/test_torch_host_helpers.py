"""Host-side pieces of the port against the JAX package: the keyframe
helpers (``estimate_keyframe_rate``, ``analyze_keyframe_spacing``,
``select_keyframes_from_kitti``), the native voxel IoU
(``native.voxel_overlap``, ``compute_overlap(backend="native")``) and
``available()``, the verifier's ``"jax"`` backend name through a pipeline
config, and ``DegradedSyntheticLoader``'s byte stream.

Tolerances: keyframe statistics and selections exact; the native IoU
within 1e-6 of the numpy backend on the same stride-subsampled clouds
(float32 ratio, the voxel keys are the same); the verifier as
tests/test_torch_retrieval_online.py holds the torch backend to JAX's
(transforms 1e-4, fitness 1e-4); loader frames byte-equal.
"""

import hashlib
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

from neural_spectral_codec_tpu.data import pose_utils as jpose  # noqa: E402
from neural_spectral_codec_tpu.data import synthetic as jsyn  # noqa: E402
from neural_spectral_codec_tpu.keyframe import criteria as jcrit  # noqa: E402
from neural_spectral_codec_tpu.keyframe import selector as jsel  # noqa: E402
from neural_spectral_codec_tpu.retrieval import (  # noqa: E402
    verification as jver)
from neural_spectral_codec_torch import native  # noqa: E402
from neural_spectral_codec_torch.data import pose_utils as tpose  # noqa: E402
from neural_spectral_codec_torch.data import synthetic as tsyn  # noqa: E402
from neural_spectral_codec_torch.keyframe import criteria as tcrit  # noqa: E402
from neural_spectral_codec_torch.keyframe import selector as tsel  # noqa: E402
from neural_spectral_codec_torch.utils.config import load_config  # noqa: E402

torch.set_num_threads(2)
OVERLAP_TOL = 1e-6


@pytest.mark.parametrize("kw", [
    {}, {"distance_threshold": 2.0, "avg_velocity": 10.0},
    {"avg_velocity": 0.0}, {"avg_velocity": 0.0, "avg_angular_velocity": 0.0},
    {"rotation_threshold": 5.0, "avg_angular_velocity": 90.0}])
def test_estimate_keyframe_rate_equals_jax(kw):
    assert tcrit.estimate_keyframe_rate(**kw) == \
        jcrit.estimate_keyframe_rate(**kw)


@pytest.mark.parametrize("sel", [[], [3], [0, 4, 9, 17, 30], list(range(40))])
def test_analyze_keyframe_spacing_equals_jax(sel):
    poses = tsyn.loop_trajectory(40, radius=30.0)
    ts = np.cumsum(np.random.default_rng(1).uniform(0.05, 0.2, 40))
    got = tcrit.analyze_keyframe_spacing(poses, ts, np.array(sel, int))
    assert got == jcrit.analyze_keyframe_spacing(poses, ts,
                                                 np.array(sel, int))


class _Frames:
    """A creep stream (tests the IoU criterion) as a loader."""

    def __init__(self, n, step, seed=3, n_points=4096):
        world = tsyn.SyntheticWorld(seed=seed)
        rng = np.random.default_rng(seed)
        self.frames = []
        for i in range(n):
            pose = np.eye(4)
            pose[0, 3] = i * step
            self.frames.append({"points": world.scan(pose, n_points=n_points,
                                                     rng=rng),
                                "pose": pose, "timestamp": 0.1 * i})

    def __len__(self):
        return len(self.frames)

    def __getitem__(self, i):
        return self.frames[i]


@pytest.mark.parametrize("case", ["synthetic", "creep"])
def test_select_keyframes_from_kitti_equals_jax(case):
    """The same keyframe ids as JAX's on a synthetic loader
    (tests/test_keyframe.py:103) and on a creep where only the IoU
    criterion decides; the same as driving a selector by hand."""
    if case == "synthetic":
        loader = tsyn.SyntheticLoader(n_frames=40, seed=2, n_points=512)
        kw = dict(distance_threshold=0.5, rotation_threshold=15.0)
    else:
        loader = _Frames(30, 0.1)
        kw = dict(distance_threshold=1e6, rotation_threshold=361.0,
                  temporal_threshold=1e9, overlap_threshold=0.034)
    got = [k.scan_id for k in tsel.select_keyframes_from_kitti(loader, **kw)]
    want = [k.scan_id for k in jsel.select_keyframes_from_kitti(loader, **kw)]
    assert got == want and len(got) >= 2
    if case == "creep":
        assert 2 < len(got) < len(loader)       # the IoU both ways
    sel = tsel.KeyframeSelector(**kw)
    for i in range(len(loader)):
        d = loader[i]
        sel.process_scan(i, d["points"], d["pose"], d["timestamp"])
    assert got == [k.scan_id for k in sel.keyframes]


def _scans():
    world, rng = tsyn.SyntheticWorld(seed=3), np.random.default_rng(0)
    p0, p1 = np.eye(4), np.eye(4)
    p1[0, 3] = 1.0
    a = world.scan(p0, n_points=16384, rng=rng)[:, :3]
    b = world.scan(p1, n_points=16384, rng=rng)[:, :3]
    b[::37] = np.nan                    # skipped, as numpy skips them
    return a, b, tpose.relative_pose(p0, p1)


@pytest.mark.parametrize("voxel", [0.2, 0.5, 2.0])
def test_voxel_overlap_matches_numpy(voxel):
    """The native IoU (a fixed stride to at most 5,000 points a cloud)
    against the numpy backend on the same stride-subsampled clouds, as
    tests/test_native.py:118 holds JAX's; the same value as JAX's native
    backend, which builds the same source."""
    assert native.available()
    a, b, T = _scans()
    stride = -(-len(a) // 5000)
    want = tpose.compute_overlap(a[::stride], b[::stride], T,
                                 voxel_size=voxel)
    got = native.voxel_overlap(a, b, T, voxel=voxel)
    assert 0.0 < want < 1.0
    assert abs(got - want) <= OVERLAP_TOL
    assert tpose.compute_overlap(a, b, T, voxel_size=voxel,
                                 backend="native") == got
    assert got == jpose.compute_overlap(a, b, T, voxel_size=voxel,
                                        backend="native")
    assert tpose.compute_overlap(a, a, np.eye(4), backend="native") > 0.99


def test_compute_overlap_backends():
    """``backend="numpy"`` is the default and equals JAX's; a native
    library that cannot be built raises, it does not fall back; an
    unknown backend raises."""
    a, b, T = _scans()
    assert tpose.compute_overlap(a, b, T) == jpose.compute_overlap(a, b, T)
    with pytest.raises(ValueError, match="backend"):
        tpose.compute_overlap(a, b, T, backend="jax")


def test_native_voxel_overlap_raises_without_library(monkeypatch, tmp_path):
    """A library that cannot be built: ``available()`` says so and the
    native overlap raises."""
    from neural_spectral_codec_torch.native import geom
    monkeypatch.setattr(geom._LIB, "_lib", None)
    monkeypatch.setattr(geom._LIB, "source", tmp_path / "missing.cpp")
    a, b, T = _scans()
    assert not geom.available()
    with pytest.raises(RuntimeError, match="missing"):
        tpose.compute_overlap(a, b, T, backend="native")


def test_native_names_and_available():
    """JAX ``native/__init__.py``'s names, and ``available()`` in the
    geometry and IO modules."""
    from neural_spectral_codec_torch.native import geom, io
    for name in ("available", "voxel_downsample", "estimate_normals", "icp",
                 "estimate_covariances", "gicp", "voxel_overlap"):
        assert getattr(native, name) is getattr(geom, name)
    assert geom.available() and io.available()


def _pair():
    rng = np.random.default_rng(8)
    g = rng.uniform(-20, 20, (666, 2))
    cloud = np.vstack([
        np.column_stack([g, np.zeros(len(g))]),
        np.column_stack([rng.uniform(-20, 20, 667), np.full(667, 8.0),
                         rng.uniform(0, 5, 667)]),
        np.column_stack([np.full(667, -12.0), rng.uniform(-20, 20, 667),
                         rng.uniform(0, 5, 667)])]).astype(np.float32)
    T = np.eye(4)
    c, s = np.cos(0.05), np.sin(0.05)
    T[:2, :2] = [[c, -s], [s, c]]
    T[:3, 3] = (0.4, -0.3, 0.1)
    return ((cloud - T[:3, 3]) @ T[:3, :3]).astype(np.float32), cloud, T


def test_jax_backend_name_builds_pipeline_and_verifies():
    """A JAX config with ``retrieval.verification_backend: jax`` builds the
    port's pipeline (its torch backend) and verifies a pair as JAX's
    ``"jax"`` backend does."""
    from neural_spectral_codec_torch.pipeline import (
        NeuralSpectralCodecPipeline)
    from neural_spectral_codec_torch.retrieval import verification as tver
    cfg = load_config(str(REPO / "configs" / "training.yaml"))
    cfg["retrieval"].update({"verification_backend": "jax",
                             "verification_max_points": 512,
                             "voxel_downsample": 0.8,
                             "icp_max_iterations": 15})
    pipe = NeuralSpectralCodecPipeline(cfg, device="cpu")
    verifier = pipe.retrieval.verifier
    assert verifier.backend == "torch" and verifier.device.type == "cpu"
    src, dst, T_true = _pair()
    ok, T, info = verifier.verify(src, dst)
    jv = jver.GeometricVerifier(backend="jax", method=verifier.method,
                                voxel_downsample=0.8, max_points=512,
                                max_iterations=15)
    jok, jT, jinfo = jv.verify(src, dst)
    assert ok and jok
    np.testing.assert_allclose(T, jT, rtol=0, atol=1e-4)
    np.testing.assert_allclose(T, T_true, atol=0.1)
    assert abs(info["fitness"] - jinfo["fitness"]) <= 1e-4
    assert tver.GeometricVerifier(backend="jax", device="cpu").backend == \
        "torch"
    with pytest.raises(ValueError, match="backend"):
        tver.GeometricVerifier(backend="xla", device="cpu")


def test_degraded_loader_stream_pinned():
    """tests/test_data_loaders.py:146's two SHA-1 pins hold for the port's
    ``DegradedSyntheticLoader``, and frames 0-3 are byte-equal to JAX's."""
    ld = tsyn.DegradedSyntheticLoader(n_frames=4, seed=3, n_points=4096)
    pins = {0: (1198, "4e7e9dcfc60ae406df3a600c8e5733072b30a602"),
            3: (1239, "72ad6c9e18da8b58d01b5ce2d0afc3e086c4812a")}
    for idx, (n, sha) in pins.items():
        pts = ld[idx]["points"]
        assert pts.shape == (n, 4)
        assert hashlib.sha1(pts.tobytes()).hexdigest() == sha
    jld = jsyn.DegradedSyntheticLoader(n_frames=4, seed=3, n_points=4096)
    for i in range(4):
        a, b = ld[i], jld[i]
        assert a["points"].tobytes() == b["points"].tobytes()
        np.testing.assert_array_equal(a["pose"], b["pose"])
        assert a["timestamp"] == b["timestamp"]


@pytest.mark.parametrize("kw", [{"wedge_deg": 90.0, "dropout": 0.0},
                                {"wedge_deg": 360.0, "dropout": 0.6}])
def test_degraded_loader_options_equal_jax(kw):
    ld = tsyn.DegradedSyntheticLoader(n_frames=3, seed=5, n_points=2048, **kw)
    jld = jsyn.DegradedSyntheticLoader(n_frames=3, seed=5, n_points=2048,
                                       **kw)
    for i in range(3):
        assert ld[i]["points"].tobytes() == jld[i]["points"].tobytes()
