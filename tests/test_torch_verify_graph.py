"""The verifier's registration executable and its two searches
(``retrieval/verification.py``, ``nearest_kernel.py``, ``knn_kernel.py``)
on the CPU, where the static step runs eagerly with the searches' plain
versions: the k-NN tie order against ``lax.top_k``, the nearest
neighbour against the argmin of JAX's ``_icp_kernel``, the static step
against ``_icp_kernel``, restaging, the absence of host syncs (which would
break the step's CUDA-graph capture on a card), the bindings' refusals and
``warmup()`` with the torch verifier. The kernels themselves run only on a
card: ``chip_smoke.py`` phase 3 holds them against these plain versions
bit for bit."""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "tests"))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from test_torch_online import small_config  # noqa: E402
from test_torch_search_design import (  # noqa: E402
    KNN_CASES, NEAREST_CASES, knn_inputs, nearest_inputs)
from neural_spectral_codec_tpu.retrieval import (  # noqa: E402
    verification as jver)
from neural_spectral_codec_torch.pipeline import (  # noqa: E402
    NeuralSpectralCodecPipeline)
from neural_spectral_codec_torch.retrieval import (  # noqa: E402
    knn_kernel, nearest_kernel, pca_kernel, verification as tver)

torch.set_num_threads(2)

T_TOL = 1e-4            # registration transforms, port vs JAX (as
                        # test_torch_retrieval_online.py)
FIT_TOL = 1e-4          # fitness and RMSE, port vs JAX
COV_TOL = 1e-5          # GICP covariances, port vs JAX
NORMAL_TOL = 1e-4       # |cos| of the angle between normals, from 1
CPU = torch.device("cpu")
HOST_SYNCS = ("_local_scalar_dense", "is_nonzero", "nonzero", ".item",
              "_linalg_check_errors")


def _lattice(n_pad=256):
    """An 8 × 8 × 2 lattice at 0.5 m (128 points, every distance tied
    many times over), padded to ``n_pad``."""
    g = np.stack(np.meshgrid(np.arange(8), np.arange(8), np.arange(2),
                             indexing="ij"), -1).reshape(-1, 3) * 0.5
    return tver._pad(g.astype(np.float32), n_pad)


def _jax_d2(a, b, mask):
    """JAX's own masked distance expression (verification.py:66-67,
    :126-127)."""
    d2 = jnp.sum((jnp.asarray(a)[:, None, :] - jnp.asarray(b)[None, :, :])
                 ** 2, axis=-1)
    return jnp.where(jnp.asarray(mask)[None, :], d2, jnp.inf)


@pytest.mark.parametrize("case", ["lattice", *KNN_CASES])
def test_knn_tie_order_equals_jax(case):
    """On a lattice (ties everywhere) the k-NN picks the neighbours
    ``lax.top_k`` picks, index for index (the lower index first among
    equal distances; ``torch.topk`` promises no order and picked another
    neighbour set for 81 of the 128 points, covariances up to 0.255
    apart); the GICP covariances then agree with ``_knn_covariances`` and
    the normals with ``_knn_normals`` up to sign. The other cases are the
    inputs where kernel K splits its work (``test_torch_search_design``:
    k = 1 to 32, exactly k valid points, a partial last batch, NaN
    candidates within a row's k, NaN rows, duplicates, few valid points),
    index for index against ``lax.top_k``."""
    if case != "lattice":
        pts, mask, k = knn_inputs(case)
        _, want = jax.lax.top_k(-_jax_d2(pts, pts, mask), k)
        np.testing.assert_array_equal(
            knn_kernel.knn(torch.from_numpy(pts), torch.from_numpy(mask),
                           k).numpy(), np.asarray(want))
        return
    padded, mask = _lattice()
    p, m = torch.from_numpy(padded), torch.from_numpy(mask)
    _, want = jax.lax.top_k(-_jax_d2(padded, padded, mask), 20)
    np.testing.assert_array_equal(knn_kernel.knn(p, m, 20).numpy(),
                                  np.asarray(want))
    cov = tver.knn_covariances(p, m).numpy()
    np.testing.assert_allclose(cov, np.asarray(jver._knn_covariances(
        jnp.asarray(padded), jnp.asarray(mask))), rtol=0, atol=COV_TOL)
    n_t = tver.knn_normals(p, m).numpy()[mask]
    n_j = np.asarray(jver._knn_normals(jnp.asarray(padded),
                                       jnp.asarray(mask)))[mask]
    np.testing.assert_allclose(np.abs((n_t * n_j).sum(1)), 1.0,
                               atol=NORMAL_TOL)


def test_knn_with_fewer_than_k_valid_points():
    """A cloud with 5 valid points of 64 and k = 20: each row holds the 5
    valid points nearest first, then masked indices in ascending order,
    as ``lax.top_k`` orders them."""
    rng = np.random.default_rng(1)
    pts = rng.uniform(-5, 5, (64, 3)).astype(np.float32)
    mask = np.zeros(64, bool)
    mask[[3, 17, 18, 40, 63]] = True
    got = knn_kernel.knn(torch.from_numpy(pts), torch.from_numpy(mask), 20)
    _, want = jax.lax.top_k(-_jax_d2(pts, pts, mask), 20)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    masked = np.flatnonzero(~mask)[:15]
    assert all(set(r[:5]) == {3, 17, 18, 40, 63} for r in got.numpy())
    np.testing.assert_array_equal(got.numpy()[:, 5:],
                                  np.broadcast_to(masked, (64, 15)))


@pytest.mark.parametrize("case", ["lattice", "nan_row", "masked", "p_ne_q",
                                  *NEAREST_CASES])
def test_nearest_plain_equals_jax_argmin(case):
    """The plain nearest neighbour (the CPU path of kernel N) against the
    argmin of ``_icp_kernel``'s correspondence expression: ties to the
    lower index, masked targets skipped, and a NaN source row matched to
    the first valid target (argmin returns the first NaN); the distance
    equal where it is a number. The cases after the first four are the
    inputs where kernel N splits its work (``test_torch_search_design``:
    NaN before and after the finite minimum, NaN under the mask, ties
    across group, half and rank boundaries, Q below the cluster split,
    P = 1, P off a CTA's rows, inf and overflowing points, no valid
    target)."""
    rng = np.random.default_rng(2)
    if case in NEAREST_CASES:
        src, dst, mask = nearest_inputs(case)
    elif case == "lattice":
        dst, mask = _lattice(160)
        src = dst[rng.permutation(160)] + np.float32(0.25)
    else:
        n_dst = 300 if case == "p_ne_q" else 128
        dst = rng.uniform(-4, 4, (n_dst, 3)).astype(np.float32)
        dst[::7] = dst[1::7][:len(dst[::7])]      # duplicate targets
        mask = rng.random(n_dst) < (0.3 if case == "masked" else 0.9)
        src = rng.uniform(-4, 4, (128, 3)).astype(np.float32)
    if case == "nan_row":
        src[[5, 77]] = np.nan
        src[9, 2] = np.nan
    j, d2 = nearest_kernel.nearest(torch.from_numpy(src),
                                   torch.from_numpy(dst),
                                   torch.from_numpy(mask))
    jd2 = _jax_d2(src, dst, mask)
    want_j = np.asarray(jnp.argmin(jd2, axis=1))
    np.testing.assert_array_equal(j.numpy(), want_j)
    want_d2 = np.asarray(jnp.take_along_axis(jd2, want_j[:, None], 1))[:, 0]
    np.testing.assert_array_equal(np.isnan(d2.numpy()), np.isnan(want_d2))
    ok = ~np.isnan(want_d2)
    np.testing.assert_allclose(d2.numpy()[ok], want_d2[ok], rtol=1e-6)
    if case == "nan_row":
        assert (j.numpy()[[5, 9, 77]] == np.flatnonzero(mask)[0]).all()


def _pair(method, n_pad=256, seed=3):
    """Two prepared clouds of a synthetic scene (ground and two walls),
    the source moved by a known motion, and the verifier that made them."""
    rng = np.random.default_rng(seed)
    n = 1500
    g = rng.uniform(-15, 15, (n // 3, 2))
    cloud = np.vstack([
        np.column_stack([g, np.zeros(len(g))]),
        np.column_stack([rng.uniform(-15, 15, n // 3), np.full(n // 3, 6.0),
                         rng.uniform(0, 4, n // 3)]),
        np.column_stack([np.full(n // 3, -9.0), rng.uniform(-15, 15, n // 3),
                         rng.uniform(0, 4, n // 3)])]).astype(np.float32)
    yaw, t = 0.04, np.array([0.3, -0.2, 0.05])
    R = np.array([[np.cos(yaw), -np.sin(yaw), 0], [np.sin(yaw), np.cos(yaw),
                                                   0], [0, 0, 1]])
    src = ((cloud - t) @ R).astype(np.float32)
    v = tver.GeometricVerifier(method=method, backend="torch", device="cpu",
                               max_points=n_pad, voxel_downsample=0.8,
                               max_iterations=12)
    return v, v.prepare(src), v.prepare(cloud)


def _direct(v, a, b, init):
    """``icp_kernel`` called directly on the prepared tensors."""
    with torch.no_grad():
        T, fit, rmse = tver.icp_kernel(
            a.padded, a.mask, b.padded, b.mask, b.normals, a.cov, b.cov,
            torch.from_numpy(init), v.max_iterations, tver.MODES[v.method],
            v.max_correspondence_distance)
    return np.concatenate([T.reshape(-1).numpy(), [fit.item(), rmse.item()]])


@pytest.mark.parametrize("method", ["gicp", "point_to_plane", "icp"])
def test_registration_step_equals_jax(method):
    """The executable's static step, run eagerly on the CPU, against JAX's
    ``_icp_kernel`` on the same padded clouds, covariances and normals
    (T within 1e-4, fitness and RMSE within 1e-4), and bit-equal to
    ``icp_kernel`` called directly; the verifier returns the same."""
    v, a, b = _pair(method)
    init = np.eye(4, dtype=np.float32)
    init[:3, 3] = (0.1, 0.0, 0.0)
    exe = tver.registration_executable(
        CPU, tver.MODES[method], 256, 256, v.max_iterations,
        v.max_correspondence_distance)
    assert not exe.graphed and exe.graph is None
    out, captured = exe.run(a, b, init)
    assert not captured
    np.testing.assert_array_equal(out, _direct(v, a, b, init))
    zc = jnp.zeros((256, 3, 3), jnp.float32)
    jT, jfit, jrmse = jver._icp_kernel(
        jnp.asarray(a.padded.numpy()), jnp.asarray(a.mask.numpy()),
        jnp.asarray(b.padded.numpy()), jnp.asarray(b.mask.numpy()),
        jnp.asarray(b.normals.numpy()) if b.normals is not None
        else jnp.zeros((256, 3), jnp.float32),
        jnp.asarray(a.cov.numpy()) if a.cov is not None else zc,
        jnp.asarray(b.cov.numpy()) if b.cov is not None else zc,
        jnp.asarray(init), v.max_iterations, tver.MODES[method],
        v.max_correspondence_distance)
    np.testing.assert_allclose(out[:16].reshape(4, 4), np.asarray(jT),
                               rtol=0, atol=T_TOL)
    assert abs(out[16] - float(jfit)) <= FIT_TOL
    assert abs(out[17] - float(jrmse)) <= FIT_TOL
    T, fit, rmse = v._register_torch(a, b, init)
    np.testing.assert_array_equal(T, out[:16].reshape(4, 4).astype(
        np.float64))
    assert (fit, rmse) == (float(out[16]), float(out[17]))
    _, _, info = v.verify(a, b, init)
    assert (info["fitness"], info["rmse"]) == (fit, rmse)


def test_restaged_arena_gives_each_pairs_answer():
    """One executable registers pair A, then pair B, then A again: each
    answer is that pair's own (``icp_kernel`` on it directly)."""
    v, a, b = _pair("gicp", seed=4)
    _, c, d = _pair("gicp", seed=5)
    init = np.eye(4, dtype=np.float32)
    exe = tver.registration_executable(CPU, "gicp", 256, 256,
                                       v.max_iterations,
                                       v.max_correspondence_distance)
    want_ab, want_cd = _direct(v, a, b, init), _direct(v, c, d, init)
    assert not np.array_equal(want_ab, want_cd)
    for (s, t), want in (((a, b), want_ab), ((c, d), want_cd),
                         ((a, b), want_ab)):
        np.testing.assert_array_equal(exe.run(s, t, init)[0], want)


def test_executable_refuses_a_mismatched_pair():
    """A prepared cloud of another size, or one that lacks the mode's
    covariances, is refused with a ``ValueError``, and so is a graph on
    the CPU; every mode has a graph on a card."""
    v, a, b = _pair("gicp")
    exe = tver.registration_executable(CPU, "gicp", 128, 256,
                                       v.max_iterations, 1.0)
    with pytest.raises(ValueError, match="src"):
        exe.run(a, b, np.eye(4, dtype=np.float32))
    _, pa, pb = _pair("point_to_plane")
    exe = tver.registration_executable(CPU, "gicp", 256, 256,
                                       v.max_iterations, 1.0)
    with pytest.raises(ValueError, match="cov_src"):
        exe.run(pa, pb, np.eye(4, dtype=np.float32))
    for mode in ("p2p", "gicp"):
        with pytest.raises(ValueError, match="no graph"):
            tver.RegistrationExecutable(CPU, mode, 8, 8, 3, 1.0, True)
    assert tver.GRAPH_MODES == ("p2p", "p2l", "gicp")


class _Ops(TorchDispatchMode):
    """Records the name of every aten operation dispatched."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(str(func))
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("method", ["gicp", "point_to_plane", "icp"])
def test_registration_step_has_no_host_sync(monkeypatch, method):
    """The static step of every mode dispatches no operation that reads a
    value back to the host (``_local_scalar_dense``, ``item``,
    ``nonzero``, a solver's error check): on a card any of them would
    break the capture. Point-to-point's Kabsch solve is kernel R on a card;
    its plain version (``svd`` and ``det``, which check their errors on
    the host) is replaced here by a recording stand-in, called once an
    iteration. Both runs write the one static output buffer."""
    calls = []

    def stand_in(h, p_c, q_c):
        calls.append(tuple(h.shape))
        return torch.eye(4)

    v, a, b = _pair(method)
    exe = tver.registration_executable(
        CPU, tver.MODES[method], 256, 256, v.max_iterations,
        v.max_correspondence_distance)
    exe.run(a, b, np.eye(4, dtype=np.float32))
    ptr = exe.outputs.dev["out"].data_ptr()
    monkeypatch.setattr(pca_kernel, "kabsch_plain", stand_in)
    with _Ops() as rec:
        exe._step()
    syncs = [op for op in rec.ops if any(s in op for s in HOST_SYNCS)]
    assert rec.ops and not syncs, syncs
    assert sum("argmin" in op for op in rec.ops) == v.max_iterations + 1
    assert calls == ([(3, 3)] * v.max_iterations if method == "icp" else [])
    assert exe.outputs.dev["out"].data_ptr() == ptr


def test_bindings_refuse_bad_inputs_before_any_launch():
    """The kernels' bindings refuse k > 32 (or k > P, k < 1), non-
    contiguous inputs, mismatched shapes, other dtypes and CPU tensors
    with a ``ValueError``, and launch nothing."""
    pts = torch.zeros(40, 3)
    mask = torch.ones(40, dtype=torch.bool)
    n0, k0 = nearest_kernel.KERNEL.launches, knn_kernel.KERNEL.launches
    bad_knn = [
        ((pts, mask, 33), "k = 33"), ((pts[:20], mask[:20], 21), "k = 21"),
        ((pts, mask, 0), "k = 0"),
        ((torch.zeros(3, 40).T, mask, 4), "contiguous"),
        ((pts, mask[:39], 4), r"\(40,\) bool"),
        ((pts, mask.to(torch.uint8), 4), r"\(40,\) bool"),
        ((pts.double(), mask, 4), "float32"),
        ((torch.zeros(40, 4), mask, 4), r"\(n, 3\)"),
        ((pts, mask, 4), "needs CUDA")]
    for args, match in bad_knn:
        with pytest.raises(ValueError, match=match):
            knn_kernel.knn_cuda(*args)
    bad_nearest = [
        ((pts[::2], pts, mask), "contiguous"),
        ((pts, pts[:30], mask), r"\(30,\) bool"),
        ((pts[:0], pts, mask), r"n >= 1"),
        ((pts, pts, mask), "needs CUDA")]
    for args, match in bad_nearest:
        with pytest.raises(ValueError, match=match):
            nearest_kernel.nearest_cuda(*args)
    assert (nearest_kernel.KERNEL.launches, knn_kernel.KERNEL.launches) == \
        (n0, k0)


def test_warmup_with_the_torch_verifier_leaves_the_state():
    """``warmup()`` with ``verification_backend: torch`` on the CPU builds
    the registration executable of the configured method on a scratch
    pair (no graph: a CPU runs the step eagerly) and leaves the live
    database and graph as they were; a session afterwards counts no
    registration graph captured mid-stream."""
    cfg = small_config(retrieval={"verification_backend": "torch",
                                  "verification_max_points": 128,
                                  "icp_max_iterations": 3},
                       deployment={"warmup": False})
    pipe = NeuralSpectralCodecPipeline(cfg, device="cpu")
    ret = pipe.retrieval.retriever
    rng = np.random.default_rng(0)
    ret.add_to_database(rng.random((5, 160)).astype(np.float32),
                        rng.normal(size=(5, 3)).astype(np.float32))
    rows, pos = ret._db_rows.clone(), ret._db_pos.clone()
    eager0 = tver.STATS["eager_steps"]
    pipe.warmup()
    assert ret.database_size == 5 and not pipe.graph_manager.keyframes
    assert torch.equal(ret._db_rows, rows) and torch.equal(ret._db_pos, pos)
    assert tver.STATS["eager_steps"] == eager0 + 1
    key = ("cpu", "gicp", 128, 128, 3, 1.0, False)
    assert any((str(e.device), e.mode, e.clouds.dev["src"].shape[0],
                e.clouds.dev["dst"].shape[0], e.iterations, e.max_corr,
                e.graphed) == key for e in tver.cached_executables())
    verifier = pipe.retrieval.verifier
    assert verifier.captures == 0
    from neural_spectral_codec_torch.data.synthetic import SyntheticLoader
    pipe.run_online(SyntheticLoader(n_frames=30, seed=0, n_points=4096,
                                    loops=2.0), loop_closure_interval=10)
    assert pipe.profiler.events.get("verifier_midstream_captures", 0) == 0
