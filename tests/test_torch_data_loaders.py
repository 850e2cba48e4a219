"""PyTorch port vs the JAX reference: the dataset readers (KITTI, NCLT,
HeLiPR, the multi-dataset loader) on the same fabricated on-disk
sequences. Points, ring ids, poses and timestamps must be bit-equal, in
lazy and eager mode; errors raise the same exception types; NCLT's
nearest-timestamp ground truth and its empty-cloud recovery, HeLiPR's
100 ms association and the config factories behave the same."""

import sys
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

from test_data_loaders import (  # noqa: E402
    _make_helipr, _make_kitti, _make_nclt)

from neural_spectral_codec_tpu import data as jdata  # noqa: E402
from neural_spectral_codec_tpu.data import multi_dataset as jmulti  # noqa: E402
from neural_spectral_codec_tpu.data import nclt as jnclt  # noqa: E402
from neural_spectral_codec_tpu.pipeline import (  # noqa: E402
    _loaders_from_config as jax_loaders_from_config)
from neural_spectral_codec_torch import data as tdata  # noqa: E402
from neural_spectral_codec_torch.data import multi_dataset as tmulti  # noqa: E402
from neural_spectral_codec_torch.data import nclt as tnclt  # noqa: E402
from neural_spectral_codec_torch.pipeline import (  # noqa: E402
    _loaders_from_config)

NCLT_DATE = "2012-01-08"
_NCLT_DTYPE = np.dtype([("x", "<u2"), ("y", "<u2"), ("z", "<u2"),
                        ("i", "u1"), ("p", "u1"), ("e", "<u4")])
_HELIPR_DTYPE = np.dtype([("x", np.float32), ("y", np.float32),
                          ("z", np.float32), ("i", np.float32),
                          ("r", np.uint16), ("t", np.float32)])


def make_kitti(root: Path, seq: str = "00", n: int = 5, seed: int = 0):
    """Random float32 scans (odd sizes) and rotated poses."""
    rng = np.random.default_rng(seed)
    d = root / "sequences" / seq / "velodyne"
    d.mkdir(parents=True)
    rows = []
    for i in range(n):
        rng.normal(size=(97 + 13 * i, 4)).astype(np.float32).tofile(
            d / f"{i:06d}.bin")
        c, s = np.cos(0.3 * i), np.sin(0.3 * i)
        T = np.array([[c, -s, 0, 1.7 * i], [s, c, 0, -0.3 * i],
                      [0, 0, 1, 0.01 * i]])
        rows.append(" ".join(f"{v:.17g}" for v in T.reshape(-1)))
    (root / "sequences" / seq / "poses.txt").write_text(
        "\n".join(rows) + "\n")


def make_nclt(root: Path, date: str = NCLT_DATE, n: int = 6, seed: int = 1):
    """Full-range uint16 records (some beyond the 200 m gate), a trailing
    partial record, and a ground-truth CSV sampled between the scans with
    one malformed row."""
    rng = np.random.default_rng(seed)
    d = root / date / "velodyne_sync"
    d.mkdir(parents=True)
    base = 1326059182636482
    for k in range(n):
        rec = np.zeros(300 + 17 * k, dtype=_NCLT_DTYPE)
        for f in ("x", "y", "z"):
            rec[f] = rng.integers(0, 65536, len(rec), dtype=np.uint16)
        rec["i"] = rng.integers(0, 256, len(rec), dtype=np.uint8)
        (d / f"{base + k * 100_000}.bin").write_bytes(
            rec.tobytes() + b"\x01" * (k % 3))
    lines = []
    for j in range(3 * n):
        ts = base - 40_000 + j * 37_000
        x, y, z, r, p, yaw = rng.normal(size=6)
        lines.append(",".join(f"{v:.17g}" for v in (ts, x, y, z, r, p, yaw)))
    lines.insert(4, f"garbage,{",".join(["1.0"] * 6)}")
    (root / date / f"groundtruth_{date}.csv").write_text("\n".join(lines))


def make_helipr(root: Path, n: int = 5, seed: int = 2):
    """Random 22-byte records with ring ids, ground truth every 70 ms,
    one scan 1 s past the last ground truth (dropped)."""
    rng = np.random.default_rng(seed)
    d = root / "LiDAR" / "Velodyne"
    d.mkdir(parents=True)
    g = root / "LiDAR_GT"
    g.mkdir(parents=True)
    base = 1_600_000_000_000_000_000
    for k in range(n):
        rec = np.zeros(200 + 9 * k, dtype=_HELIPR_DTYPE)
        for f in ("x", "y", "z", "i", "t"):
            rec[f] = rng.normal(size=len(rec)).astype(np.float32) * 20
        rec["r"] = rng.integers(0, 16, len(rec), dtype=np.uint16)
        rec.tofile(d / f"{base + k * 100_000_000 + 3_000}.bin")
    rec.tofile(d / f"{base + n * 100_000_000 + 1_000_000_000}.bin")
    lines = []
    for j in range(2 * n):
        q = rng.normal(size=4)
        t = rng.normal(size=3) * 10
        lines.append(" ".join([str(base + j * 70_000_000)]
                              + [f"{v:.17g}" for v in (*t, *q)]))
    (g / "Velodyne_gt.txt").write_text("\n".join(lines))


def assert_items_equal(a: dict, b: dict):
    """Same keys; arrays bit-equal with the same dtype; scalars equal."""
    assert set(a) == set(b)
    for k in a:
        x, y = a[k], b[k]
        if x is None or y is None:
            assert x is None and y is None, k
        elif isinstance(x, np.ndarray):
            assert x.dtype == y.dtype and x.shape == y.shape, k
            np.testing.assert_array_equal(x, y, err_msg=k)
        else:
            assert type(x) is type(y) and x == y, k


def assert_loaders_equal(jl, tl):
    assert len(jl) == len(tl) > 0
    for i in range(len(jl)):
        assert_items_equal(jl[i], tl[i])


@pytest.mark.parametrize("lazy", [True, False])
def test_kitti_equals_jax(tmp_path, lazy):
    make_kitti(tmp_path)
    jl = jdata.KITTILoader(str(tmp_path), "00", lazy_load=lazy)
    tl = tdata.KITTILoader(str(tmp_path), "00", lazy_load=lazy)
    assert_loaders_equal(jl, tl)
    np.testing.assert_array_equal(jl.poses, tl.poses)
    np.testing.assert_array_equal(jl.timestamps, tl.timestamps)
    np.testing.assert_array_equal(jl.get_relative_pose(1, 3),
                                  tl.get_relative_pose(1, 3))
    assert jl.get_distance(0, 4) == tl.get_distance(0, 4)
    assert jl.get_frames_in_range(2, 1.0, 4.0) == \
        tl.get_frames_in_range(2, 1.0, 4.0) != []
    for ld in (jl, tl):
        with pytest.raises(IndexError):
            ld[len(ld)]


def test_kitti_pre_port_fixture_and_no_poses(tmp_path):
    """The pre-port fixture (tests/test_data_loaders.py) and a sequence
    without poses.txt."""
    _make_kitti(tmp_path / "a")
    assert_loaders_equal(jdata.KITTILoader(str(tmp_path / "a"), "00"),
                         tdata.KITTILoader(str(tmp_path / "a"), "00"))
    make_kitti(tmp_path / "b", n=3)
    (tmp_path / "b" / "sequences" / "00" / "poses.txt").unlink()
    jl = jdata.KITTILoader(str(tmp_path / "b"), "00")
    tl = tdata.KITTILoader(str(tmp_path / "b"), "00")
    assert tl.poses is None and tl.get_distance(0, 1) is None
    assert_loaders_equal(jl, tl)


@pytest.mark.parametrize("lazy", [True, False])
def test_nclt_equals_jax(tmp_path, lazy):
    make_nclt(tmp_path)
    jl = jdata.NCLTLoader(str(tmp_path), NCLT_DATE, lazy_load=lazy)
    tl = tdata.NCLTLoader(str(tmp_path), NCLT_DATE, lazy_load=lazy)
    assert tl.poses is not None
    assert_loaders_equal(jl, tl)
    # the 200 m gate and the trailing partial record are live
    raw = np.fromfile(tl.frame_files[0], dtype=_NCLT_DTYPE)
    assert 0 < len(tl[0]["points"]) < len(raw) == 300
    assert jl.get_sequence_info() == tl.get_sequence_info()


def test_nclt_gt_association_and_recovery(tmp_path):
    """Nearest-timestamp association picks the closer neighbour (ties to
    the earlier); an unreadable scan is an empty cloud; an unreadable
    ground truth gives identity poses; the pre-port fixture agrees."""
    make_nclt(tmp_path, n=4)
    tl = tdata.NCLTLoader(str(tmp_path), NCLT_DATE)
    gt = np.genfromtxt(tl.gt_file, delimiter=",")
    gt = gt[np.isfinite(gt).all(axis=1)]
    for i, t in enumerate(tl._vel_timestamps_us):
        j = int(np.argmin(np.abs(gt[:, 0].astype(np.int64) - t)))
        np.testing.assert_array_equal(
            tl[i]["pose"], tnclt.euler_zyx_to_se3(*gt[j, 1:7]))
    np.testing.assert_array_equal(tnclt.euler_zyx_to_se3(1, 2, 3, .1, .2, .3),
                                  jnclt.euler_zyx_to_se3(1, 2, 3, .1, .2, .3))

    # a scan that cannot be opened: np.fromfile raises, both recover
    bad = tl.frame_files[0].parent / f"{tl._vel_timestamps_us[-1] + 1}.bin"
    bad.symlink_to(tmp_path / "gone.bin")
    (tl.gt_file).write_text("not,a,csv\n")
    jl = jdata.NCLTLoader(str(tmp_path), NCLT_DATE)
    tl = tdata.NCLTLoader(str(tmp_path), NCLT_DATE)
    assert tl.poses is None and jl.poses is None
    item = tl[len(tl) - 1]
    assert item["points"].shape == (0, 4)
    np.testing.assert_array_equal(item["pose"], np.eye(4))
    assert_loaders_equal(jl, tl)

    _make_nclt(tmp_path / "pre")
    assert_loaders_equal(jdata.NCLTLoader(str(tmp_path / "pre"), NCLT_DATE),
                         tdata.NCLTLoader(str(tmp_path / "pre"), NCLT_DATE))


@pytest.mark.parametrize("lazy", [True, False])
def test_helipr_equals_jax(tmp_path, lazy):
    make_helipr(tmp_path)
    jl = jdata.HeLiPRLoader(str(tmp_path), lazy_load=lazy)
    tl = tdata.HeLiPRLoader(str(tmp_path), lazy_load=lazy)
    assert len(tl) == 5                       # the late scan is dropped
    assert tl[0]["ring_ids"].dtype == np.int64
    assert_loaders_equal(jl, tl)
    np.testing.assert_array_equal(jl.get_all_poses(), tl.get_all_poses())
    assert jl.scan_pose_indices == tl.scan_pose_indices
    _make_helipr(tmp_path / "pre")
    assert_loaders_equal(jdata.HeLiPRLoader(str(tmp_path / "pre")),
                         tdata.HeLiPRLoader(str(tmp_path / "pre")))


def _layout(root: Path):
    make_kitti(root / "kitti", "00", n=4)
    make_kitti(root / "kitti", "01", n=3, seed=5)
    make_nclt(root / "nclt", n=3)
    make_helipr(root / "helipr" / "seqA", n=3)
    return [
        {"type": "kitti", "root": str(root / "kitti"),
         "sequences": ["00", "01"], "weight": 0.5},
        {"type": "nclt", "root": str(root / "nclt"),
         "sequences": [NCLT_DATE]},
        {"type": "helipr", "root": str(root / "helipr"),
         "sequences": ["seqA"]},
        {"type": "synthetic", "sequences": [3]},
    ]


def test_multi_dataset_equals_jax(tmp_path):
    """One index space over all four types: items, ``sequence_id_of``,
    ``split_by_dataset``, ``get_frames_by_dataset``, the config
    factories and ``_loaders_from_config``."""
    specs = _layout(tmp_path)
    jl = jmulti.MultiDatasetLoader(specs)
    tl = tmulti.MultiDatasetLoader(specs)
    assert len(tl) == 4 + 3 + 3 + 3 + 200
    for i in list(range(13)) + [13, 212]:
        assert_items_equal(jl[i], tl[i])
    assert [tl.sequence_id_of(i) for i in range(len(tl))] == \
        [jl.sequence_id_of(i) for i in range(len(jl))]
    assert tl.split_by_dataset() == jl.split_by_dataset()
    assert tl.split_by_dataset()["kitti"] == list(range(7))
    assert tl.get_frames_by_dataset("helipr") == list(range(10, 13))
    assert tl.get_all_info() == jl.get_all_info()
    with pytest.raises(IndexError):
        tl[len(tl)]

    cfg = {"data": {"datasets": {"train": specs[:3], "val": specs[1:2]}}}
    for mode in ("train", "val"):
        a = jmulti.create_multi_dataset_loader(cfg, mode)
        b = tmulti.create_multi_dataset_loader(cfg, mode)
        assert type(b).__name__ == type(a).__name__ == "MultiDatasetLoader"
        assert len(a) == len(b)
    for m in (jmulti, tmulti):
        with pytest.raises(ValueError):
            m.create_multi_dataset_loader(cfg, "test")
    legacy = {"data": {"kitti_root": str(tmp_path / "kitti"),
                       "sequences_train": [0, 1], "sequences_val": [1],
                       "sequences_test": [0]}}
    for mode, want in (("train", "MultiDatasetLoader"),
                       ("val", "KITTILoader"), ("test", "KITTILoader")):
        b = tmulti.create_multi_dataset_loader(legacy, mode)
        a = jmulti.create_multi_dataset_loader(legacy, mode)
        assert type(b).__name__ == type(a).__name__ == want
        assert len(a) == len(b)

    for split in ("train", "val", "test"):
        a = jax_loaders_from_config(cfg, split)
        b = _loaders_from_config(cfg, split)
        assert [type(x).__name__ for x in a] == \
            [type(x).__name__ for x in b]
        for x, y in zip(a, b):
            assert_loaders_equal(x, y)


@pytest.mark.parametrize("kind", ["kitti", "nclt", "helipr", "synthetic",
                                  "unknown"])
def test_errors_match_jax(tmp_path, kind):
    """A missing sequence, an empty sequence directory and an unknown
    dataset type raise the same exception type in both packages."""
    def both(fn):
        got = []
        for m in (jmulti, tmulti):
            try:
                fn(m)
                got.append(None)
            except Exception as e:  # noqa: BLE001 - the type is compared
                got.append(type(e))
        return got

    seq = {"kitti": "00", "nclt": NCLT_DATE, "helipr": "x",
           "synthetic": "0", "unknown": "0"}[kind]
    missing = both(lambda m: m._make_loader(kind, str(tmp_path / "none"),
                                            seq, True))
    assert missing[0] is missing[1]
    if kind in ("kitti", "nclt", "helipr"):
        assert missing[1] is (ValueError if kind == "helipr"
                              else FileNotFoundError)
    if kind == "unknown":
        assert missing[1] is ValueError
    empty = tmp_path / "empty"
    (empty / "sequences" / "00" / "velodyne").mkdir(parents=True)
    (empty / NCLT_DATE / "velodyne_sync").mkdir(parents=True)
    (empty / "x" / "LiDAR" / "Velodyne").mkdir(parents=True)
    got = both(lambda m: m._make_loader(kind, str(empty), seq, True))
    assert got[0] is got[1]
    if kind in ("kitti", "nclt", "helipr"):
        assert got[1] is ValueError
    assert both(lambda m: m.MultiDatasetLoader([])) == [ValueError] * 2
