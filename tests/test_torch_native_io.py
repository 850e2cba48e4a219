"""The port's native IO (``neural_spectral_codec_torch/native/io.py``,
``data/native_io.py``): the library is built by the port with g++ into
``_build/`` (no pre-built ``native/*.so`` is needed or read); decode is
bit-identical to the port's numpy loaders for all four formats; the
read-ahead gives ``loader[idx]`` frame for frame, falls back to the loader
on a bad file, keeps its order and closes cleanly; ``frame_source`` reads
``system.io_prefetch``; and ``_process_sequence`` and ``run_online`` give
the same keyframes and descriptors with read-ahead on and off."""

import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

from test_torch_data_loaders import (  # noqa: E402
    NCLT_DATE, _HELIPR_DTYPE, _NCLT_DTYPE, assert_items_equal, make_helipr,
    make_kitti, make_nclt)
from test_torch_online import ListLoader, small_config  # noqa: E402

from neural_spectral_codec_torch.data import (  # noqa: E402
    HeLiPRLoader, KITTILoader, NCLTLoader)
from neural_spectral_codec_torch.data.native_io import (  # noqa: E402
    FramePrefetcher, frame_source)
from neural_spectral_codec_torch.data.synthetic import (  # noqa: E402
    SyntheticLoader)
from neural_spectral_codec_torch.native import _gxx  # noqa: E402
from neural_spectral_codec_torch.native import io as native_io  # noqa: E402
from neural_spectral_codec_torch.pipeline import (  # noqa: E402
    NeuralSpectralCodecPipeline)

torch.set_num_threads(2)

LOADERS = {
    "kitti": (make_kitti, lambda r: KITTILoader(str(r), "00")),
    "nclt": (make_nclt, lambda r: NCLTLoader(str(r), NCLT_DATE)),
    "helipr": (make_helipr, lambda r: HeLiPRLoader(str(r))),
}


# ---------------------------------------------------------------- build

def test_build_goes_to_build_dir_and_failure_raises(tmp_path, monkeypatch):
    """The library lands in ``_build/`` under a hash of source, flags and
    CPU; a fresh build elsewhere writes nothing into ``native/``; a
    compiler that cannot run raises, and so does the read-ahead then."""
    path = native_io.build()
    assert path == native_io.library_path()
    assert path.parent == REPO / "neural_spectral_codec_torch" / "_build"
    assert path.name.startswith("libnsc_io_")
    assert "-ffp-contract=off" in native_io._LIB.flags
    native = REPO / "native"
    before = {p.name: p.stat().st_mtime_ns for p in native.iterdir()}
    monkeypatch.setattr(_gxx, "BUILD_DIR", tmp_path / "b")
    fresh = _gxx.NativeLibrary("libnsc_io", "nsc_io.cpp",
                               native_io._LIB.flags, native_io._configure,
                               link=native_io._LIB.link)
    out = fresh.build()
    assert out.parent == tmp_path / "b" and out.exists()
    assert fresh.load().nsc_decode is not None
    assert {p.name: p.stat().st_mtime_ns for p in native.iterdir()} == before

    monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
    broken = _gxx.NativeLibrary("libnsc_io_x", "nsc_io.cpp",
                                native_io._LIB.flags, native_io._configure)
    with pytest.raises(RuntimeError, match="cannot build"):
        broken.load()
    make_nclt(tmp_path / "n", n=2)
    monkeypatch.setattr(native_io, "load", broken.load)
    with pytest.raises(RuntimeError):
        FramePrefetcher.create(NCLTLoader(str(tmp_path / "n"), NCLT_DATE),
                               mode="always")


# ---------------------------------------------------------------- decode

def test_decode_bit_identical_to_loaders(tmp_path):
    """Each format's native decode equals the port's numpy loader on the
    same file (HeLiPR5 with its ring column), bit for bit."""
    make_kitti(tmp_path / "k", n=1)
    make_nclt(tmp_path / "n", n=3)
    make_helipr(tmp_path / "h", n=1)
    k = KITTILoader(str(tmp_path / "k"), "00")
    raw = k.frame_files[0].read_bytes()
    np.testing.assert_array_equal(
        native_io.decode(native_io.FORMAT_KITTI, raw), k[0]["points"])
    with pytest.raises(ValueError):
        native_io.decode(native_io.FORMAT_KITTI, raw[:-4])

    n = NCLTLoader(str(tmp_path / "n"), NCLT_DATE)
    for i in range(len(n)):     # trailing partial records of 0-2 bytes
        raw = n.frame_files[i].read_bytes()
        got = native_io.decode(native_io.FORMAT_NCLT, raw)
        assert got.dtype == np.float32 and 0 < len(got) < len(raw) // 12
        np.testing.assert_array_equal(got, n[i]["points"])

    h = HeLiPRLoader(str(tmp_path / "h"))
    raw = h.scan_files[0].read_bytes()
    np.testing.assert_array_equal(
        native_io.decode(native_io.FORMAT_HELIPR, raw), h[0]["points"])
    got = native_io.decode(native_io.FORMAT_HELIPR5, raw)
    assert got.shape == (len(raw) // 22, 5)
    np.testing.assert_array_equal(got[:, :4], h[0]["points"])
    np.testing.assert_array_equal(got[:, 4].astype(np.int64),
                                  h[0]["ring_ids"])


def test_decode_full_ranges():
    """NCLT over the whole uint16 range (the 200 m gate live) and HeLiPR5
    rings up to 63, against the numpy formulas."""
    rng = np.random.default_rng(7)
    rec = np.zeros(4096, dtype=_NCLT_DTYPE)
    for f in ("x", "y", "z"):
        rec[f] = rng.integers(0, 65536, len(rec), dtype=np.uint16)
    rec["i"] = rng.integers(0, 256, len(rec), dtype=np.uint8)
    pts = np.column_stack([rec["x"].astype(np.float32) * 0.005 - 100.0,
                           rec["y"].astype(np.float32) * 0.005 - 100.0,
                           rec["z"].astype(np.float32) * 0.005 - 100.0,
                           rec["i"].astype(np.float32) / 255.0])
    want = pts[(np.abs(pts[:, :3]) < 200.0).all(axis=1)]
    assert 0 < len(want) < len(rec)
    np.testing.assert_array_equal(
        native_io.decode(native_io.FORMAT_NCLT, rec.tobytes() + b"\x07" * 5),
        want)
    h = np.zeros(300, dtype=_HELIPR_DTYPE)
    for f in ("x", "y", "z", "i", "t"):
        h[f] = rng.normal(size=len(h)).astype(np.float32)
    h["r"] = rng.integers(0, 64, len(h), dtype=np.uint16)
    out = native_io.decode(native_io.FORMAT_HELIPR5, h.tobytes())
    np.testing.assert_array_equal(out[:, 4].astype(np.uint16), h["r"])
    np.testing.assert_array_equal(
        out[:, :4], np.stack([h["x"], h["y"], h["z"], h["i"]], axis=-1))


# ------------------------------------------------------------- prefetch

@pytest.mark.parametrize("kind", sorted(LOADERS))
def test_prefetcher_matches_loader(tmp_path, kind):
    make, open_loader = LOADERS[kind]
    make(tmp_path)
    loader = open_loader(tmp_path)
    with FramePrefetcher.create(loader, n_threads=2, depth=2,
                                mode="always") as pf:
        for i in range(len(loader)):
            assert_items_equal(pf.get(i), loader[i])


def test_prefetcher_bad_files_match_python(tmp_path):
    """A misaligned KITTI file raises as ``loader[idx]`` does; an NCLT
    scan that cannot be opened is the loader's empty cloud."""
    make_kitti(tmp_path / "k", n=4)
    (tmp_path / "k" / "sequences" / "00" / "velodyne" /
     "000001.bin").write_bytes(b"\x00" * 10)
    loader = KITTILoader(str(tmp_path / "k"), "00")
    with pytest.raises(ValueError):
        loader[1]
    with FramePrefetcher.create(loader, mode="always") as pf:
        assert_items_equal(pf.get(0), loader[0])
        with pytest.raises(ValueError):
            pf.get(1)
        assert_items_equal(pf.get(2), loader[2])
        assert_items_equal(pf.get(3), loader[3])

    make_nclt(tmp_path / "n", n=3)
    vel = tmp_path / "n" / NCLT_DATE / "velodyne_sync"
    (vel / f"{int(sorted(vel.iterdir())[-1].stem) + 5}.bin").symlink_to(
        tmp_path / "gone.bin")                  # a dangling link
    nclt = NCLTLoader(str(tmp_path / "n"), NCLT_DATE)
    with FramePrefetcher.create(nclt, mode="always") as pf:
        items = [pf.get(i) for i in range(len(nclt))]
    assert items[-1]["points"].shape == (0, 4)
    for i, item in enumerate(items):
        assert_items_equal(item, nclt[i])


def test_prefetcher_order_and_close(tmp_path):
    """An out-of-order ``get`` raises without consuming; a close with
    workers blocked on a full ring returns; a closed prefetcher raises."""
    make_kitti(tmp_path, n=6)
    loader = KITTILoader(str(tmp_path), "00")
    with FramePrefetcher.create(loader, mode="always") as pf:
        pf.get(0)
        with pytest.raises(RuntimeError):
            pf.get(2)
        assert_items_equal(pf.get(1), loader[1])
    pf = FramePrefetcher.create(loader, n_threads=3, depth=1, mode="always")
    pf.get(0)
    t = threading.Thread(target=pf.close)
    t.start()
    t.join(timeout=20)
    assert not t.is_alive()
    with pytest.raises(RuntimeError):
        pf.get(1)


def test_frame_source_modes(tmp_path):
    """"auto" reads KITTI through the loader and NCLT/HeLiPR ahead;
    "always" includes KITTI; "off" and False read none ahead, True reads
    all; preloaded and unknown loaders are indexed."""
    for kind, (make, _) in LOADERS.items():
        make(tmp_path / kind)
    kitti = LOADERS["kitti"][1](tmp_path / "kitti")
    nclt = LOADERS["nclt"][1](tmp_path / "nclt")
    helipr = LOADERS["helipr"][1](tmp_path / "helipr")
    native = lambda ld, cfg: _is_native(ld, cfg)  # noqa: E731
    assert not native(kitti, None)
    assert native(nclt, None) and native(helipr, None)
    assert native(kitti, {"system": {"io_prefetch": "always"}})
    assert native(kitti, {"system": {"io_prefetch": True}})
    for off in ("off", False):
        assert not native(nclt, {"system": {"io_prefetch": off}})
    eager = NCLTLoader(str(tmp_path / "nclt"), NCLT_DATE, lazy_load=False)
    assert not native(eager, {"system": {"io_prefetch": "always"}})
    frames = ListLoader([{"points": np.zeros((1, 4), np.float32)}])
    assert not native(frames, {"system": {"io_prefetch": "always"}})


def _is_native(loader, config) -> bool:
    with frame_source(loader, config) as get:
        native = getattr(get, "__self__", None) is not loader
        assert_items_equal(get(0), loader[0])
    return native


# --------------------------------------------------------------- pipeline

def _write_kitti_stream(root: Path, n_frames: int, seq: str = "00"):
    """A two-lap synthetic stream (seed ``int(seq)``, 4,096 points a scan)
    as KITTI sequence ``seq`` under ``root``."""
    src = SyntheticLoader(n_frames=n_frames, seed=int(seq), n_points=4096,
                          loops=2.0)
    seq = root / "sequences" / seq
    (seq / "velodyne").mkdir(parents=True)
    rows = []
    for i in range(len(src)):
        item = src[i]
        item["points"].astype(np.float32).tofile(
            seq / "velodyne" / f"{i:06d}.bin")
        rows.append(" ".join(f"{v:.17g}"
                             for v in item["pose"][:3].reshape(-1)))
    (seq / "poses.txt").write_text("\n".join(rows))


@pytest.mark.parametrize("path", ["process_sequence", "run_online"])
def test_pipeline_same_with_read_ahead_on_and_off(tmp_path, path):
    """Keyframes (scan ids, points) and descriptors of ``_process_sequence``
    and ``run_online`` over a KITTI sequence on disk are the same with
    ``system.io_prefetch`` "always" and "off"."""
    _write_kitti_stream(tmp_path / "data", 30)
    results = []
    for mode in ("always", "off"):
        cfg = small_config(tmp_path / mode, system={"io_prefetch": mode})
        pipe = NeuralSpectralCodecPipeline(cfg, device="cpu")
        loader = KITTILoader(str(tmp_path / "data"), "00")
        if path == "run_online":
            pipe.run_online(loader, loop_closure_interval=10)
            results.append(list(pipe.selector.keyframes))
        else:
            results.append(pipe._process_sequence(loader))
    on, off = results
    assert len(on) == len(off) > 3
    for a, b in zip(on, off):
        assert a.scan_id == b.scan_id
        np.testing.assert_array_equal(a.points, b.points)
        np.testing.assert_array_equal(a.descriptor, b.descriptor)
