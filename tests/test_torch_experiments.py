"""The port's root experiments on the CPU at tiny sizes, against the JAX
scripts (``experiments/*.py``, loaded from their files) where those run
at the same size: ``retrieval_latency``, ``density_defense`` and
``selection_divergence``. (``degraded_recall`` and
``cross_sensor_uplift`` train a GNN: tests/test_torch_degraded_recall.py
and tests/test_torch_cross_sensor_uplift.py.)

Tolerances: the fp32/uint16 ranking parity equal to the JAX script's
(top-1 share and top-k overlap exactly) with no one-code violation;
ray-cast scans bit-equal to the JAX script's; keyframe ids exact. The port's own runs must print finite numbers and write nothing
under docs/.
"""

import hashlib
import importlib.util
import math
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

from neural_spectral_codec_torch.experiments import (  # noqa: E402
    cross_sensor_uplift, degraded_recall, density_defense, retrieval_latency,
    selection_divergence)

torch.set_num_threads(2)


def jax_script(name: str):
    spec = importlib.util.spec_from_file_location(
        f"_jax_exp_{name}", REPO / "experiments" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def finite(obj) -> bool:
    if isinstance(obj, dict):
        return all(finite(v) for v in obj.values())
    if isinstance(obj, (list, tuple)):
        return all(finite(v) for v in obj)
    return not isinstance(obj, float) or math.isfinite(obj)


def docs_digest() -> str:
    h = hashlib.sha1()
    for p in sorted((REPO / "docs").rglob("*")):
        if p.is_file():
            h.update(str(p).encode() + p.read_bytes())
    return h.hexdigest()


@pytest.mark.parametrize("mod", [retrieval_latency, degraded_recall,
                                 cross_sensor_uplift, density_defense])
def test_device_defaults_to_cuda_without_fallback(mod):
    """With no ``--device`` an experiment asks for the card, and without
    one it raises before any work."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default would run")
    with pytest.raises(RuntimeError, match="no CUDA"):
        mod.main([])


def test_retrieval_latency_parity_equals_jax():
    """``ranking_parity`` on 3,000 rows: the same top-1 share and top-10
    overlap as the JAX script's, and every uint16 row within the
    one-code rule."""
    jrl = jax_script("retrieval_latency")
    want = jrl.ranking_parity(3000, n_queries=16)
    got = retrieval_latency.ranking_parity(3000, "cpu", n_queries=16)
    assert got["top1_match"] == want["top1_match"]
    assert got["top10_overlap"] == want["top10_overlap"]
    assert got["n_queries"] == 16 and got["one_code_violations"] == 0


def test_retrieval_latency_runs_on_cpu(tmp_path):
    before = docs_digest()
    out = retrieval_latency.main([
        "--size", "2000", "--queries", "4", "--iters", "2", "--single",
        "--int-domain", "--device", "cpu",
        "--json", str(tmp_path / "r.json")])
    assert [(r["size"], r["storage"]) for r in out["rows"]] == [
        (2000, "float32"), (2000, "uint16")]
    for r in out["rows"]:
        keys = {"batched", "single"} | (
            {"int_batched", "int_single"} if r["storage"] == "uint16"
            else set())
        assert keys <= set(r)
        for k in keys:
            assert r[k]["device_ms"] is None and r[k]["wall_ms"] > 0
    assert out["parity"]["one_code_violations"] == 0 and finite(out)
    assert (tmp_path / "r.json").exists() and docs_digest() == before


def test_integer_domain_ranks_like_dequantised():
    """The integer-domain uint16 query ranks the rows as the production
    uint16 query does on well-separated distances (its top-1)."""
    db = retrieval_latency.build_db("uint16", 500, 500, "cpu")
    q = retrieval_latency._queries(3)
    idx, _ = db.query_batch(q, top_k=1)
    qc = np.round(np.cumsum(q, axis=1) * 65535.0).astype(np.int64)
    rows = db._db_rows[:500].view(torch.int16).numpy().astype(np.int64) \
        & 0xFFFF
    d = np.abs(rows[None] - qc[:, None]).sum(axis=2)
    np.testing.assert_array_equal(d.argmin(axis=1), idx[:, 0])


def test_density_defense_scenes_and_raycast_equal_jax():
    """Scenes and loop worlds are drawn as the JAX script draws them, and
    the ray cast (boxes intersected in float64 in torch) gives its scan
    bit for bit at the full 64 × 2088 grid."""
    jdd = jax_script("density_defense")
    for make in ("scene", "loop"):
        r1, r2 = np.random.default_rng(11), np.random.default_rng(11)
        if make == "scene":
            (lo, hi), (tlo, thi) = jdd.make_scene(r1), \
                density_defense.make_scene(r2)
        else:
            (lo, hi) = jdd.make_world_for_loop(r1, 60.0)
            (tlo, thi) = density_defense.make_world_for_loop(r2, 60.0)
        np.testing.assert_array_equal(lo, tlo)
        np.testing.assert_array_equal(hi, thi)
        want = jdd.raycast(lo, hi, 0.7, r1, pos=(3.0, -2.0))
        got = density_defense.raycast(tlo, thi, 0.7, r2, pos=(3.0, -2.0),
                                      device="cpu")
        assert got.shape == (64 * 2088, 4) and got.dtype == np.float32
        assert got.tobytes() == want.tobytes()


def test_density_defense_runs_on_cpu(tmp_path, monkeypatch):
    """The whole script at a 64 × 360 ray grid, 3 scenes, strides 1 and
    4: finite numbers, and the output names every stride and recall mode;
    nothing under docs/."""
    monkeypatch.setattr(density_defense, "N_AZIM_FULL", 360)
    before = docs_digest()
    out = density_defense.main(["--scenes", "3", "--strides", "1", "4",
                                "--device", "cpu",
                                "--json", str(tmp_path / "d.json")])
    assert [r["stride"] for r in out["strides"]] == [4]
    assert out["strides"][0]["points"] == 64 * 360 // 4
    assert set(out["recall"]) == {"pure_stride1", "pure_stride4",
                                  "mixed_stride4"}
    assert out["recall_queries"] > 0 and finite(out)
    assert len(out["scales"]["different_places_w1"]) == 3
    assert docs_digest() == before


def test_selection_divergence_equals_jax():
    """The IoU-decided creep stream and both selectors' keyframes equal
    the JAX script's at 40 frames of 4,096 points (its reference column
    needs the reference's sources, which are absent); the port's run
    reports the IoU table at every offset."""
    jsd = jax_script("selection_divergence")
    frames = jsd.make_stream(n_frames=40, n_points=4096)
    tframes = selection_divergence.make_stream(n_frames=40, n_points=4096)
    for a, b in zip(frames, tframes):
        assert a[1].tobytes() == b[1].tobytes()
    from neural_spectral_codec_tpu.keyframe.selector import (
        KeyframeSelector as JaxSelector)
    th = selection_divergence.THRESHOLDS
    want = jsd.run_selector(frames, JaxSelector(**th))
    jrc = JaxSelector(**th)
    jrc.criteria = jsd._RefConventionCriteria(**th)
    want_rc = jsd.run_selector(frames, jrc)
    out = selection_divergence.main(["--frames", "40", "--points", "4096"])
    assert out["selected"]["ours"] == want
    assert out["selected"]["ours+refconv"] == want_rc
    assert len(want) < len(want_rc)
    assert finite(out) and set(out["iou_vs_motion"]) == {
        str(o) for o in selection_divergence.OFFSETS}
