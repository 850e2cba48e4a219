"""PyTorch port vs the JAX reference: the rest of the stage-1 database
(uint16 storage, update_rows, warm_query, clear_database, the serving
step's fused_dispatch, concurrent query and insert), geometric
verification (both backends) and two-stage loop closing."""

import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import jax.numpy as jnp  # noqa: E402

from neural_spectral_codec_tpu.data.synthetic import (  # noqa: E402
    SyntheticWorld, loop_trajectory)
from neural_spectral_codec_tpu.keyframe.selector import (  # noqa: E402
    Keyframe as JaxKeyframe)
from neural_spectral_codec_tpu.retrieval import (  # noqa: E402
    verification as jver)
from neural_spectral_codec_tpu.retrieval.retriever import (  # noqa: E402
    WassersteinRetriever as JaxRetriever)
from neural_spectral_codec_tpu.retrieval.two_stage import (  # noqa: E402
    batch_loop_closing as jax_batch_loop_closing)
from neural_spectral_codec_torch.keyframe.selector import Keyframe  # noqa: E402
from neural_spectral_codec_torch.native import geom  # noqa: E402
from neural_spectral_codec_torch.ops.range_image import pad_points  # noqa: E402
from neural_spectral_codec_torch.ops.spectral import (  # noqa: E402
    SpectralEncoderConfig, encode_points_batch)
from neural_spectral_codec_torch.retrieval import (  # noqa: E402
    verification as tver)
from neural_spectral_codec_torch.retrieval.retriever import (  # noqa: E402
    WassersteinRetriever)
from neural_spectral_codec_torch.retrieval.two_stage import (  # noqa: E402
    TwoStageRetrieval, batch_loop_closing)

torch.set_num_threads(2)

T_TOL = 1e-4            # registration transforms, port vs JAX
COV_TOL = 1e-5          # GICP covariances, port vs JAX


def _hists(rng, n, d=50):
    h = rng.uniform(0, 1, (n, d)).astype(np.float32) ** 4
    return (h / h.sum(1, keepdims=True)).astype(np.float32)


def _pair(**kw):
    return (WassersteinRetriever(device="cpu", **kw), JaxRetriever(**kw))


def _rows(r):
    if r._db_rows.dtype == torch.uint16:
        return r._db_rows.view(torch.int16).numpy().view(np.uint16)
    return r._db_rows.numpy()


# ---------------------------------------------------------------- uint16

def test_quantized_storage_topk_parity():
    """uint16 rows rank like float32 rows, within n_bins·0.5/65535 in
    distance, single and batched, and like JAX's uint16 database."""
    rng = np.random.default_rng(0)
    db, q = _hists(rng, 400, 800), _hists(rng, 8, 800)
    pos = rng.random((400, 3)).astype(np.float32) * 500
    r32 = WassersteinRetriever(n_bins=800, capacity=512, device="cpu")
    r16, j16 = _pair(n_bins=800, capacity=512, storage="uint16")
    for r in (r32, r16, j16):
        r.add_to_database(db, pos)
    assert np.abs(_rows(r16).astype(np.int64)
                  - np.asarray(j16._db_cdf)).max() <= 1
    i32, d32 = r32.query_batch(q, top_k=5)
    i16, d16 = r16.query_batch(q, top_k=5)
    ji, jd = j16.query_batch(q, top_k=5)
    np.testing.assert_array_equal(i32, i16)
    np.testing.assert_array_equal(i16, ji)
    bound = 800 * 0.5 / 65535.0
    assert np.max(np.abs(d32 - d16)) <= bound + 1e-6
    np.testing.assert_allclose(d16, jd, rtol=2e-5, atol=4 / 65535)
    si, sd = r16.query(q[0], top_k=5)
    np.testing.assert_array_equal(si, i32[0])


def test_quantized_storage_memory_halved():
    r32 = WassersteinRetriever(n_bins=800, capacity=1000, device="cpu")
    r16 = WassersteinRetriever(n_bins=800, capacity=1000, storage="uint16",
                               device="cpu")
    assert r16._db_rows.dtype == torch.uint16
    assert r16._db_rows.nbytes * 2 == r32._db_rows.nbytes
    r16.clear_database()
    assert r16._db_rows.dtype == torch.uint16


def test_quantized_storage_l2_rejected():
    with pytest.raises(ValueError, match="uint16"):
        WassersteinRetriever(n_bins=64, capacity=16, metric="l2",
                             storage="uint16", device="cpu")
    with pytest.raises(ValueError, match="storage"):
        WassersteinRetriever(n_bins=64, capacity=16, storage="int8",
                             device="cpu")


@pytest.mark.parametrize("storage,metric", [("uint16", "wasserstein"),
                                            ("float32", "wasserstein"),
                                            ("float32", "l2")])
def test_update_rows_equals_jax(storage, metric):
    """Overwriting rows gives JAX's rows (uint16: within one code) and
    JAX's answers; a row past the size raises."""
    rng = np.random.default_rng(1)
    db = _hists(rng, 50, 100)
    t, j = _pair(n_bins=100, capacity=64, storage=storage, metric=metric)
    for r in (t, j):
        r.add_to_database(db)
        r.update_rows(np.array([7, 30]), db[[0, 1]])
    diff = np.abs(_rows(t).astype(np.float64)
                  - np.asarray(j._db_cdf, np.float64)).max()
    assert diff <= (1 if storage == "uint16" else 1e-6)
    ti, td = t.query(db[0], top_k=2)
    ji, jd = j.query(db[0], top_k=2)
    assert set(ti.tolist()) == set(ji.tolist()) == {0, 7}
    assert np.max(td) <= 100 * 0.5 / 65535.0 + 1e-6
    with pytest.raises(IndexError):
        t.update_rows([50], db[:1])
    t.update_rows([], db[:0])


def test_quantized_storage_spatial_filter_and_exclude():
    """Masking (spatial exclusion, exclude_last, as_of_size) is
    independent of storage and equals JAX's."""
    rng = np.random.default_rng(2)
    db = _hists(rng, 60, 50)
    pos = np.zeros((60, 3), np.float32)
    pos[:, 0] = np.arange(60)
    t, j = _pair(n_bins=50, capacity=64, storage="uint16")
    for r in (t, j):
        r.add_to_database(db, pos)
    for kw in (dict(top_k=3, query_position=pos[10],
                    spatial_min_distance=5.0),
               dict(top_k=60, exclude_last=10),
               dict(top_k=60, exclude_last=4, as_of_size=30)):
        ti, _ = t.query(db[10], **kw)
        ji, _ = j.query(db[10], **kw)
        np.testing.assert_array_equal(ti, ji)
    ti, _ = t.query(db[10], top_k=3, query_position=pos[10],
                    spatial_min_distance=5.0)
    assert all(abs(i - 10) >= 5 for i in ti)


def test_warm_query_and_clear_database():
    """warm_query leaves size and rows as they were; clear_database
    empties the database and a new insert lands at row 0."""
    rng = np.random.default_rng(3)
    h = _hists(rng, 3, 20)
    r = WassersteinRetriever(n_bins=20, capacity=50, device="cpu")
    r.warm_query(top_k=5)
    assert r.database_size == 0 and not r._db_rows.any()
    r.add_to_database(h)
    before = r._db_rows.clone()
    r.warm_query(top_k=5)
    assert r.database_size == 3 and torch.equal(r._db_rows, before)
    assert r.query(h[1], top_k=1)[0][0] == 1
    r.clear_database()
    assert r.database_size == 0 and r.query(h[1])[0].size == 0
    r.add_to_database(h[2:])
    assert r.query(h[2], top_k=1)[0][0] == 0


def test_fused_dispatch_query_before_insert():
    """fused_dispatch hands out insert_at = size and eff = size −
    exclude_last under the lock and commits the insert only when the
    step returns; a step that raises leaves the size as it was; a full
    database refuses an insert."""
    rng = np.random.default_rng(4)
    h = _hists(rng, 6, 20)
    r = WassersteinRetriever(n_bins=20, capacity=6, device="cpu")
    r.add_to_database(h[:4])
    seen = []

    def step(insert_at, eff):
        seen.append((insert_at, eff))
        r.write_rows(insert_at, r.encode_rows(torch.from_numpy(h[4:5])))
        return "ok"

    assert r.fused_dispatch(step, insert=True, exclude_last=2) == "ok"
    assert seen == [(4, 2)] and r.database_size == 5

    def bad(insert_at, eff):
        raise RuntimeError("step failed")

    with pytest.raises(RuntimeError):
        r.fused_dispatch(bad)
    assert r.database_size == 5
    r.fused_dispatch(step, insert=False)
    assert r.database_size == 5
    r.add_to_database(h[5:])
    with pytest.raises(ValueError, match="capacity"):
        r.fused_dispatch(step)


def test_concurrent_query_and_insert():
    """A worker thread querying snapshots while the main thread inserts:
    no error, and every snapshot answer equals the one the same snapshot
    gives after the run."""
    rng = np.random.default_rng(5)
    ret = WassersteinRetriever(n_bins=64, capacity=4096, device="cpu")
    base = _hists(rng, 16, 64)
    ret.add_to_database(base)
    errors, answers = [], []

    def worker():
        try:
            for _ in range(100):
                with ret._buffer_lock:
                    size = ret.database_size
                answers.append((size, ret.query(base[3], top_k=5,
                                                as_of_size=size)))
        except Exception as e:          # pragma: no cover
            errors.append(e)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        th = threading.Thread(target=worker)
        th.start()
        for _ in range(200):
            ret.add_to_database(_hists(rng, 1, 64))
        th.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not th.is_alive() and len(answers) == 100
    assert not errors, errors[0]
    assert ret.database_size == 216
    for size, (idx, dist) in answers[::10]:
        i2, d2 = ret.query(base[3], top_k=5, as_of_size=size)
        np.testing.assert_array_equal(idx, i2)
        np.testing.assert_array_equal(dist, d2)


def test_capacity_degrades_gracefully():
    """A full stage-1 database rejects new keyframes but keeps serving."""
    rng = np.random.default_rng(6)
    r = TwoStageRetrieval(n_bins=30, capacity=4, spatial_filter_distance=0.0,
                          verification_backend="torch", device="cpu")

    def kf(i):
        pose = np.eye(4)
        pose[:3, 3] = [i * 10.0, 0, 0]
        return Keyframe(i, i, rng.random((50, 4)).astype(np.float32), pose,
                        float(i), descriptor=_hists(rng, 1, 30)[0])

    assert all(r.add_keyframe(kf(i)) for i in range(4))
    assert r.add_keyframe(kf(4)) is False and len(r.keyframes) == 4
    assert not r.can_fuse_serving()
    assert r.retriever.query(r.keyframes[2].descriptor, top_k=2)[0][0] == 2
    r.clear_database()
    assert r.add_keyframe(kf(9)) is True


# ---------------------------------------------------------- verification

def _cloud(rng, n=3000):
    g = rng.uniform(-20, 20, (n // 3, 2))
    ground = np.column_stack([g, np.zeros(len(g))])
    w1 = np.column_stack([rng.uniform(-20, 20, n // 3),
                          np.full(n // 3, 8.0), rng.uniform(0, 5, n // 3)])
    w2 = np.column_stack([np.full(n - 2 * (n // 3), -12.0),
                          rng.uniform(-20, 20, n - 2 * (n // 3)),
                          rng.uniform(0, 5, n - 2 * (n // 3))])
    return np.vstack([ground, w1, w2]).astype(np.float32)


def _se3(yaw=0.0, t=(0, 0, 0)):
    T = np.eye(4)
    c, s = np.cos(yaw), np.sin(yaw)
    T[:2, :2] = [[c, -s], [s, c]]
    T[:3, 3] = t
    return T


def _moved(cloud, T):
    return ((cloud - T[:3, 3]) @ T[:3, :3]).astype(np.float32)


def test_voxel_downsample_and_knn_geometry_equal_jax():
    """voxel_downsample equal to JAX's; k-NN GICP covariances within 1e-5
    of JAX's ``_knn_covariances``; normals equal up to sign."""
    rng = np.random.default_rng(7)
    pts = _cloud(rng, 1500)
    pts[::97] = np.nan
    ds = tver.voxel_downsample(pts, 0.3)
    np.testing.assert_array_equal(ds, jver.voxel_downsample(pts, 0.3))
    padded, mask = tver._pad(ds, 512)
    jp, jm = jver._pad(ds, 512)
    np.testing.assert_array_equal(padded, jp)
    p, m = torch.from_numpy(padded), torch.from_numpy(mask)
    cov = tver.knn_covariances(p, m).numpy()
    np.testing.assert_allclose(cov, np.asarray(jver._knn_covariances(
        jnp.asarray(padded), jnp.asarray(mask))), rtol=0, atol=COV_TOL)
    n_t = tver.knn_normals(p, m).numpy()[mask]
    n_j = np.asarray(jver._knn_normals(jnp.asarray(padded),
                                       jnp.asarray(mask)))[mask]
    np.testing.assert_allclose(np.abs((n_t * n_j).sum(1)), 1.0, atol=1e-4)


@pytest.mark.parametrize("method", ["icp", "point_to_plane", "gicp"])
def test_torch_backend_registration_equals_jax(method):
    """The torch backend (P = 512) against JAX's ``"jax"`` backend on a
    known motion and on unrelated clouds: transforms within 1e-4, the
    same accept decision, fitness and RMSE within 1e-4; prepared clouds
    give the same answer as raw ones."""
    rng = np.random.default_rng(8)
    cloud = _cloud(rng, 2000)
    T_true = _se3(yaw=0.05, t=(0.4, -0.3, 0.1))
    src = _moved(cloud, T_true)
    kw = dict(method=method, voxel_downsample=0.8, max_points=512,
              max_iterations=15)
    tv = tver.GeometricVerifier(backend="torch", device="cpu", **kw)
    jv = jver.GeometricVerifier(backend="jax", **kw)
    far = rng.uniform(-20, 20, (1500, 3)).astype(np.float32) + [500, 0, 0]
    for a, b, want_ok in ((src, cloud, True), (cloud, far, False)):
        ok, T, info = tv.verify(a, b)
        jok, jT, jinfo = jv.verify(a, b)
        assert ok == jok == want_ok
        assert abs(info["fitness"] - jinfo["fitness"]) <= 1e-4
        if ok:
            np.testing.assert_allclose(T, jT, rtol=0, atol=T_TOL)
            np.testing.assert_allclose(T, T_true, atol=0.1)
            assert abs(info["rmse"] - jinfo["rmse"]) <= 1e-4
            np.testing.assert_array_equal(info["information_matrix"],
                                          jinfo["information_matrix"])
    ok2, T2, _ = tv.verify(tv.prepare(src), tv.prepare(cloud))
    ok1, T1, _ = tv.verify(src, cloud)
    assert ok1 == ok2 and np.array_equal(T1, T2)


def test_native_backend_equals_jax_native():
    """The port's g++ build of ``native/nsc_geom.cpp`` through its own
    ctypes binding gives JAX's native path bit for bit: downsample,
    covariances, normals, GICP and ICP; ``"auto"`` picks it; parallel
    verification equals serial; ``"jax"`` names the torch backend."""
    from neural_spectral_codec_tpu import native as jnative
    assert jnative.available()
    rng = np.random.default_rng(9)
    cloud = _cloud(rng)
    src = _moved(cloud, _se3(yaw=0.05, t=(0.4, -0.3, 0.1)))
    assert geom.build() == geom.library_path()
    assert geom.library_path().parent == \
        REPO / "neural_spectral_codec_torch" / "_build"
    np.testing.assert_array_equal(geom.voxel_downsample(cloud, 0.3),
                                  jnative.voxel_downsample(cloud, 0.3))
    np.testing.assert_array_equal(geom.estimate_covariances(cloud[:800]),
                                  jnative.estimate_covariances(cloud[:800]))
    np.testing.assert_array_equal(geom.estimate_normals(cloud[:800]),
                                  jnative.estimate_normals(cloud[:800]))
    for method in ("gicp", "icp", "point_to_plane"):
        tv = tver.GeometricVerifier(method=method)
        jv = jver.GeometricVerifier(method=method, backend="native")
        assert tv.backend == "native"
        ok, T, info = tv.verify(src, cloud)
        jok, jT, jinfo = jv.verify(src, cloud)
        assert ok and jok and info["fitness"] == jinfo["fitness"]
        np.testing.assert_array_equal(T, jT)
    clouds = [_moved(cloud, _se3(yaw=0.02 * i, t=(0.1 * i, 0, 0)))
              for i in range(4)] + [cloud + [300, 0, 0]]
    serial = tver.batch_verify_candidates(cloud, clouds)
    parallel = tver.batch_verify_candidates(cloud, clouds, parallel=True)
    assert [r[0] for r in serial] == [r[0] for r in parallel] == \
        [True] * 4 + [False]
    for a, b in zip(serial, parallel):
        assert a[2]["fitness"] == b[2]["fitness"]
    ok, _, _ = tver.verify_loop_closure(src, cloud)
    assert ok
    # "jax" names the torch backend (the JAX package's name for it)
    assert tver.GeometricVerifier(backend="jax", device="cpu").backend == \
        "torch"
    with pytest.raises(ValueError, match="backend"):
        tver.GeometricVerifier(backend="xla")


def test_two_stage_on_synthetic_world():
    """A lap-2 revisit is found and verified (JAX
    tests/test_retrieval.py:258 on the port), the candidates and edges
    equal JAX's ``batch_loop_closing`` on the same descriptors, and the
    verified transform equals the reference's to 1e-4."""
    world = SyntheticWorld(seed=11)
    n = 40
    poses = loop_trajectory(n, radius=100.0, loops=2.0)
    cfg = SpectralEncoderConfig(n_elevation=16,
                                elevation_range_deg=(-20.0, 15.0))
    scans = [world.scan(poses[i], n_points=4096,
                        rng=np.random.default_rng(i)) for i in range(n)]
    desc = encode_points_batch(torch.from_numpy(np.stack(
        [pad_points(s, 4096) for s in scans])), 2.0, cfg).numpy()
    ts = TwoStageRetrieval(top_k=3, spatial_filter_distance=0.0,
                           n_bins=cfg.output_dim, capacity=64,
                           verification_method="icp", device="cpu")
    for i in range(n // 2):
        ts.add_keyframe(Keyframe(i, i, scans[i], poses[i], i * 0.1,
                                 descriptor=desc[i]))
    qi = n // 2 + 5
    qkf = Keyframe(qi, qi, scans[qi], poses[qi], qi * 0.1,
                   descriptor=desc[qi])
    lcs = ts.get_loop_closures(qkf, scans[qi])
    assert len(lcs) >= 1
    qpos = poses[qi][:3, 3]
    assert min(np.linalg.norm(poses[lc["target_id"]][:3, 3] - qpos)
               for lc in lcs) < 30.0

    db = [Keyframe(i, i, scans[i], poses[i], i * 0.1, descriptor=desc[i])
          for i in range(n // 2)]
    jdb = [JaxKeyframe(k.keyframe_id, k.scan_id, k.points, k.pose,
                       k.timestamp, descriptor=k.descriptor) for k in db]
    qs = [Keyframe(q, q, scans[q], poses[q], q * 0.1, descriptor=desc[q])
          for q in (qi, qi + 3)]
    jqs = [JaxKeyframe(k.keyframe_id, k.scan_id, k.points, k.pose,
                       k.timestamp, descriptor=k.descriptor) for k in qs]
    for verify in (False, True):
        got = batch_loop_closing(qs, db, top_k=3, spatial_filter_distance=0.0,
                                 verify=verify, device="cpu")
        want = jax_batch_loop_closing(jqs, jdb, top_k=3,
                                      spatial_filter_distance=0.0,
                                      verify=verify)
        for i in range(len(qs)):
            key = "database_idx" if not verify else "target_id"
            assert [e[key] for e in got[i]] == [e[key] for e in want[i]]
            for a, b in zip(got[i], want[i]):
                if verify:
                    np.testing.assert_allclose(
                        a["relative_pose"], b["relative_pose"], atol=T_TOL)
    assert any(got[i] for i in range(len(qs)))
