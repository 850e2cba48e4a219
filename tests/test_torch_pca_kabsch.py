"""Numpy models of the verifier's two eigen-solve kernels,
``csrc/knn_pca.cu`` (kernel C: k-NN PCA → normal or GICP covariance, a
group of lanes a point) and ``csrc/kabsch.cu`` (kernel R: the whole
point-to-point update after the correspondence search, one cluster a
step, and its Kabsch solve alone), both on the cyclic Jacobi solve of
``csrc/sym3.cuh``, against the plain versions
(``pca_kernel.knn_pca_plain``, ``p2p_update_plain``, ``kabsch_plain``)
and against the JAX package (``_knn_covariances``, ``_knn_normals``,
``_icp_kernel``); then the prepare step
(``verification.PrepareExecutable``) on the CPU, and the bindings'
refusals.

The kernels run only on a card: ``chip_smoke.py`` phase 3 holds them
against the plain versions there under the same bars and gap rule. The
models hold their arithmetic here: float64 from the float32 inputs, the
rotation, convergence test and sweep bound of ``sym3.cuh`` (constants
read from it), C's lane split and fixed-order group sums and R's
per-thread, warp, CTA and rank sums (layouts read from the sources), the
eigenvector of the first of equal extreme eigenvalues, the normal's sign
fixed (its largest-magnitude component positive), one rounding to
float32.

The gap rule. The plain version and JAX solve the 3 × 3 problem in
float32; the eigenvector of the smallest eigenvalue then moves by about
u · λ2 / (λ1 − λ0) (u the float32 unit roundoff), so with the relative
gap g = (λ1 − λ0) / λ2 the covariance I − (1 − ε) n nᵀ moves by about
GAP_ERR / g, GAP_ERR = 1e-6 (the scene case below checks
|Δ covariance| · g ≤ GAP_ERR on every row of a 4,096-point prepared
cloud, float32 ``eigh`` against the float64 model). A row is held
to a bar where the float32 error cannot reach it: covariances within
COV_TOL where g ≥ GAP_ERR / COV_TOL = 0.1, normals within 1 − |cos| ≤
NORMAL_TOL where g ≥ GAP_ERR / sqrt(2 · NORMAL_TOL) (1 − |cos| ≈ |Δn|² / 2).
Below that (collinear neighbourhoods, λ0 = λ1; equal points, all λ = 0)
the eigenvector is not determined by the data, and only invariants are
checked: the covariance symmetric with eigenvalues {ε, 1, 1} within 1e-5,
the normal a unit vector in the span of the two smallest eigenvectors
(nᵀ C n ≤ λ1 + 1e-5 λ2), every row finite.
"""

import math
import re
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import jax.numpy as jnp  # noqa: E402

from neural_spectral_codec_tpu.retrieval import (  # noqa: E402
    verification as jver)
from neural_spectral_codec_torch.retrieval import (  # noqa: E402
    knn_kernel, nearest_kernel, pca_kernel, verification as tver)

torch.set_num_threads(2)

CSRC = REPO / "neural_spectral_codec_torch" / "csrc"


def _constant(source: str, name: str) -> float:
    """A ``constexpr int`` or ``double`` of a ``csrc/`` file."""
    text = (CSRC / source).read_text()
    return float(re.search(rf"constexpr (?:int|double) {name} = ([0-9.e+-]+);",
                           text)[1])


MAX_SWEEPS = int(_constant("sym3.cuh", "kJacobiMaxSweeps"))
HUGE = _constant("sym3.cuh", "kJacobiHuge")
TINY = _constant("sym3.cuh", "kJacobiTiny")
GROUP = int(_constant("knn_pca.cu", "kGroup"))        # kernel C's lanes
REGS = int(_constant("knn_pca.cu", "kRegs"))          # a point
P2P_THREADS = int(_constant("kabsch.cu", "kThreads"))
P2P_MAX_CTAS = int(_constant("kabsch.cu", "kMaxCtas"))
P2P_PER = int(_constant("kabsch.cu", "kPer"))
# sym3.cuh's documented convergence: sweeps that rotate, at most
ROTATING_SWEEPS = {3: 5, 4: 6}
T_TOL = 1e-4            # a step's transform, port vs JAX
COV_TOL = 1e-5          # GICP covariances (test_torch_verify_graph.py)
NORMAL_TOL = 1e-4       # 1 − |cos| between normals (the same)
R_TOL = 1e-5            # Kabsch R and t, model vs JAX's float32 SVD
INV_TOL = 1e-5          # the invariants of rows below the gap
ORTHO_TOL = 4e-6        # RᵀR = I and det R = 1 for a float32 rotation
VEC_TOL = 1e-14         # float64 eigenvector vs eigh, times max|λ| / gap
GAP_ERR = 1e-6          # float32 solve: |Δ covariance| · relative gap
COV_GAP = GAP_ERR / COV_TOL
NORMAL_GAP = GAP_ERR / math.sqrt(2 * NORMAL_TOL)
EPS = 1e-3
HOST_SYNCS = ("_local_scalar_dense", "is_nonzero", "nonzero", ".item",
              "_linalg_check_errors")


# -- the models -------------------------------------------------------------

def jacobi(a: np.ndarray, max_sweeps: int = MAX_SWEEPS):
    """sym3.cuh jacobi_eigen on a batch (B, N, N) of symmetric float64
    matrices: (the rotated matrices, whose diagonals are the eigenvalues;
    V, eigenvectors in columns; the sweeps that rotated a pair). A pair
    whose |a_pq| is below half an ulp of both diagonal entries is skipped;
    a matrix stops after a sweep that rotated nothing."""
    a = np.array(a, np.float64)
    n = a.shape[1]
    v = np.broadcast_to(np.eye(n), a.shape).copy()
    live_rows = np.ones(len(a), bool)
    sweeps = np.zeros(len(a), int)
    for _ in range(max_sweeps):
        rotated = np.zeros(len(a), bool)
        for p in range(n - 1):
            for q in range(p + 1, n):
                apq = a[:, p, q].copy()
                app, aqq = a[:, p, p].copy(), a[:, q, q].copy()
                g = np.abs(apq)
                with np.errstate(all="ignore"):
                    skip = ((np.abs(app) + g == np.abs(app))
                            & (np.abs(aqq) + g == np.abs(aqq)))
                    live = ~skip & live_rows
                    d = aqq - app
                    u = np.abs(d)
                    sgn = np.where(d >= 0.0, 1.0, -1.0)
                    big = np.fmax(u, 2.0 * g)
                    scale = np.where((big <= HUGE) & (big >= TINY), 1.0, big)
                    un, dn, an = u / scale, d / scale, 2.0 * apq / scale
                    root = np.sqrt(dn * dn + an * an)
                    m = 1.0 / np.sqrt(2.0 * root * (un + root))
                    c = np.where(live, (un + root) * m, 1.0)
                    s = np.where(live, an * sgn * m, 0.0)
                    ta = sgn * s * s * root * scale
                rotated |= live
                a[:, p, p] = np.where(live, app - ta, app)
                a[:, q, q] = np.where(live, aqq + ta, aqq)
                a[:, p, q] = a[:, q, p] = np.where(live, 0.0, apq)
                for r in range(n):
                    if r in (p, q):
                        continue
                    arp, arq = a[:, r, p].copy(), a[:, r, q].copy()
                    a[:, r, p] = a[:, p, r] = np.where(live, c * arp - s * arq,
                                                       arp)
                    a[:, r, q] = a[:, q, r] = np.where(live, s * arp + c * arq,
                                                       arq)
                vp, vq = v[:, :, p].copy(), v[:, :, q].copy()
                keep = live[:, None]
                v[:, :, p] = np.where(keep, c[:, None] * vp - s[:, None] * vq,
                                      vp)
                v[:, :, q] = np.where(keep, s[:, None] * vp + c[:, None] * vq,
                                      vq)
        sweeps += rotated
        live_rows &= rotated
    return a, v, sweeps


def _first(values: np.ndarray, better) -> np.ndarray:
    """Index of the first best entry of each row (ties to the lower)."""
    pick = np.zeros(len(values), int)
    rows = np.arange(len(values))
    for j in range(1, values.shape[1]):
        pick = np.where(better(values[:, j], values[rows, pick]), j, pick)
    return pick


def lane_order(k: int) -> list:
    """Kernel C's split of a row's k neighbours over its GROUP lanes: lane
    s takes s, s + GROUP, ... (the first REGS from registers, the rest
    gathered again), each lane in that order."""
    return [list(range(s, k, GROUP)) for s in range(GROUP)]


def butterfly(lanes: np.ndarray) -> np.ndarray:
    """Each lane's result of a xor-butterfly sum over the last axis (its
    length a power of two): at each level lane l adds lane l ^ off."""
    v = np.array(lanes, np.float64)
    ids = np.arange(v.shape[-1])
    off = 1
    while off < v.shape[-1]:
        v = v + v[..., ids ^ off]
        off *= 2
    return v


def group_sum(terms: np.ndarray) -> np.ndarray:
    """Kernel C's group_sum of per-neighbour float64 terms (P, k, ...):
    each lane's sum in its order, then the butterfly (lane 0's result)."""
    k = terms.shape[1]
    lanes = []
    for order in lane_order(k):
        acc = np.zeros(terms.shape[:1] + terms.shape[2:])
        for j in order:
            acc = acc + terms[:, j]
        lanes.append(acc)
    return butterfly(np.stack(lanes, -1))[..., 0]


def model_cov64(pts: np.ndarray, idx: np.ndarray) -> np.ndarray:
    """Kernel C's raw covariance in float64: the mean and the 6 centred
    sums Σ c cᵀ, each a group sum, divided by k."""
    k = idx.shape[1]
    nbr = pts.astype(np.float64)[idx]                     # (P, k, 3)
    c = nbr - (group_sum(nbr) / k)[:, None, :]
    cov = group_sum(c[:, :, :, None] * c[:, :, None, :]) / k
    return cov


def model_knn_pca(pts: np.ndarray, idx: np.ndarray, mode: str,
                  eps: float = EPS) -> np.ndarray:
    """Kernel C: the normal (the least eigenvalue's eigenvector, the first
    of equal ones, its largest-magnitude component positive) or I −
    (1 − ε) n nᵀ, from float64 and rounded once."""
    a, v, _ = jacobi(model_cov64(pts, idx))
    rows = np.arange(len(a))
    low = _first(np.diagonal(a, 0, 1, 2), np.less)
    n = v[rows, :, low]
    lead = n[rows, _first(np.abs(n), np.greater)]
    n = n * (np.where(lead < 0, -1.0, 1.0)
             / np.sqrt((n * n).sum(1)))[:, None]
    if mode == "normals":
        return n.astype(np.float32)
    squash = 1.0 - np.float64(np.float32(eps))
    return (np.eye(3) - squash * n[:, :, None] * n[:, None, :]).astype(
        np.float32)


def horn_matrix(h: np.ndarray) -> np.ndarray:
    """Horn's symmetric 4 × 4 of S = H (kabsch.cu), batched."""
    h = np.asarray(h, np.float64)
    (sxx, sxy, sxz), (syx, syy, syz), (szx, szy, szz) = (
        np.moveaxis(h, (1, 2), (0, 1)))
    rows = [[sxx + syy + szz, syz - szy, szx - sxz, sxy - syx],
            [syz - szy, sxx - syy - szz, sxy + syx, szx + sxz],
            [szx - sxz, sxy + syx, -sxx + syy - szz, syz + szy],
            [sxy - syx, szx + sxz, syz + szy, -sxx - syy + szz]]
    return np.stack([np.stack(r, -1) for r in rows], 1)


def model_kabsch(h: np.ndarray, p_c: np.ndarray, q_c: np.ndarray
                 ) -> np.ndarray:
    """Kernel R's solve (horn_solve) on a batch: the unit eigenvector of
    the largest eigenvalue of Horn's matrix (the first of equal ones), its
    rotation, t = q_c − R p_c in float64; (B, 4, 4) float32."""
    a, v, _ = jacobi(horn_matrix(h))
    rows = np.arange(len(a))
    q = v[rows, :, _first(np.diagonal(a, 0, 1, 2), np.greater)]
    w, x, y, z = (q / np.sqrt((q * q).sum(1, keepdims=True))).T
    R = np.stack([
        np.stack([w * w + x * x - y * y - z * z, 2 * (x * y - w * z),
                  2 * (x * z + w * y)], -1),
        np.stack([2 * (y * x + w * z), w * w - x * x + y * y - z * z,
                  2 * (y * z - w * x)], -1),
        np.stack([2 * (z * x - w * y), 2 * (z * y + w * x),
                  w * w - x * x - y * y + z * z], -1)], 1)
    T = np.zeros((len(a), 4, 4))
    T[:, :3, :3] = R
    T[:, :3, 3] = (np.asarray(q_c, np.float64)
                   - np.einsum("bij,bj->bi", R, np.asarray(p_c, np.float64)))
    T[:, 3, 3] = 1.0
    return T.astype(np.float32)


def jax_kabsch(h, p_c, q_c) -> np.ndarray:
    """JAX's formula (verification.py:140-146) on one H, float32."""
    H, p_c, q_c = jnp.asarray(h), jnp.asarray(p_c), jnp.asarray(q_c)
    U, _, Vt = jnp.linalg.svd(H)
    d = jnp.sign(jnp.linalg.det(Vt.T @ U.T))
    D = jnp.diag(jnp.array([1.0, 1.0, 1.0]) * jnp.array([1.0, 1.0, d]))
    R = Vt.T @ D @ U.T
    return np.asarray(jnp.eye(4).at[:3, :3].set(R).at[:3, 3].set(
        q_c - R @ p_c))


def model_p2p_update(src, src_mask, dst, j, d2, max_corr: float,
                     layout: tuple) -> np.ndarray:
    """Kernel R's update (p2p_update_kernel) at ``layout`` = (CTAs,
    threads): w from the float32 compare, then in float64 each thread's
    sums over its points (global thread g takes g, g + G, ...; G = CTAs ×
    threads) in point order, the warp's butterfly, warp 0's butterfly over
    the warps' sums, the ranks' sums in rank order; the 7 centroid sums,
    then H's 9; then the solve. (4, 4) float32."""
    ctas, threads = layout
    n = len(src)
    total = ctas * threads
    rounds = -(-n // total)
    with np.errstate(invalid="ignore"):
        w = (src_mask & (np.sqrt(np.asarray(d2, np.float32))
                         <= np.float32(max_corr))).astype(np.float64)
    p = np.asarray(src, np.float64)
    q = np.asarray(dst, np.float64)[j]

    def reduce(terms):                                    # (n, K) → (K,)
        width = terms.shape[1]
        pad = np.zeros((rounds * total, width))
        pad[:n] = terms
        acc = np.zeros((total, width))
        for per in pad.reshape(rounds, total, width):
            acc = acc + per
        warps = threads // 32
        lanes = acc.reshape(ctas, warps, 32, width)
        warp_sums = butterfly(np.moveaxis(lanes, 2, -1))[..., 0]
        first = np.zeros((ctas, 32, width))
        first[:, :warps] = warp_sums
        rank_sums = butterfly(np.moveaxis(first, 1, -1))[..., 0]
        out = np.zeros(width)
        for r in range(ctas):
            out = out + rank_sums[r]
        return out

    with np.errstate(invalid="ignore"):
        s1 = reduce(np.column_stack([w, p * w[:, None], q * w[:, None]]))
        sw = np.fmax(s1[0], 1e-6)
        p_c, q_c = s1[1:4] / sw, s1[4:7] / sw
        a = (p - p_c) * w[:, None]
        h = reduce((a[:, :, None] * (q - q_c)[:, None, :]).reshape(n, 9))
    return model_kabsch(h.reshape(1, 3, 3), p_c[None], q_c[None])[0]


# -- the solve itself --------------------------------------------------------

def jacobi_inputs(n: int, kind: str) -> np.ndarray:
    """4,000 symmetric n × n float64 matrices of one kind, seeded."""
    rng = np.random.default_rng(n)
    b = 4000
    if kind == "random":
        m = rng.normal(size=(b, n, n))
        return m + m.transpose(0, 2, 1)
    if kind == "zero":
        return np.zeros((b, n, n))
    if kind == "nan":                       # one NaN pair, the rest random
        m = rng.normal(size=(b, n, n))
        m = m + m.transpose(0, 2, 1)
        m[:, 0, n - 1] = m[:, n - 1, 0] = np.nan
        return m
    q, _ = np.linalg.qr(rng.normal(size=(b, n, n)))
    ev = rng.normal(size=(b, n)) * np.array([1, 1e-6, 1e3, 1][:n])
    if kind == "near_degenerate":           # pairs 1e-12 apart, 6 orders
        ev[:, 1] = ev[:, 0] * (1 + 1e-12)
    elif kind == "repeated":                # equal pairs, all equal, rank
        ev[: b // 2, 1] = ev[: b // 2, 0]   # deficient (zeros)
        ev[b // 2: 3 * b // 4] = 1.5
        ev[3 * b // 4:, : n - 1] = 0.0
    else:
        raise ValueError(kind)
    return np.einsum("bij,bj,bkj->bik", q, ev, q)


@pytest.mark.parametrize("kind", ["random", "near_degenerate", "repeated",
                                  "zero", "nan"])
@pytest.mark.parametrize("n", [3, 4])
def test_jacobi_sweeps_converge(n, kind):
    """sym3.cuh's solve, modelled: every matrix of random, near-degenerate
    (eigenvalue pairs 1e-12 apart, six orders of scale) and repeated-
    eigenvalue kinds stops after a sweep that rotated nothing, within
    ROTATING_SWEEPS (5 for 3 × 3, 6 for 4 × 4) sweeps that rotate and
    inside the sweep bound read from the header; at exit every pair meets
    the solver's own skip rule (|a_pp| + |a_pq| == |a_pp| and the same for
    a_qq); its output, solved again, rotates nothing; eigenvalues and
    V diag(λ) Vᵀ agree with ``numpy.linalg.eigh`` to 1e-14 of the largest
    |λ|, V is orthonormal to 1e-14, and the eigenvector of the smallest
    eigenvalue (the one kernel C's normal is) is within
    VEC_TOL · max|λ| / (λ1 − λ0) of eigh's, up to sign, on every row where
    that bar is below 1 (every random row; where the gap is smaller the
    vector is not determined by the matrix). A zero matrix rotates nothing
    and keeps V = I; a NaN entry runs to the bound and makes every
    eigenvalue and eigenvector entry NaN."""
    x = jacobi_inputs(n, kind)
    a, v, sweeps = jacobi(x)
    if kind == "nan":
        assert (sweeps == MAX_SWEEPS).all()
        assert np.isnan(np.diagonal(a, 0, 1, 2)).all()
        assert np.isnan(v).all()
        return
    assert sweeps.max() <= ROTATING_SWEEPS[n] and sweeps.max() < MAX_SWEEPS
    again, v2, none = jacobi(a)
    assert (none == 0).all()
    np.testing.assert_array_equal(again, a)
    np.testing.assert_array_equal(v2, np.broadcast_to(np.eye(n), v2.shape))
    if kind == "zero":
        assert (sweeps == 0).all() and not a.any()
        np.testing.assert_array_equal(v, np.broadcast_to(np.eye(n), v.shape))
        return
    for p in range(n - 1):
        for q in range(p + 1, n):
            g = np.abs(a[:, p, q])
            for r in (p, q):
                assert (np.abs(a[:, r, r]) + g == np.abs(a[:, r, r])).all()
    lam, vec = np.linalg.eigh(x)
    scale = np.abs(lam).max(1)
    w = np.diagonal(a, 0, 1, 2)
    low = v[np.arange(len(v)), :, _first(w, np.less)]
    dist = np.minimum(np.abs(low - vec[:, :, 0]).max(1),
                      np.abs(low + vec[:, :, 0]).max(1))
    with np.errstate(divide="ignore"):
        bar = VEC_TOL * scale / (lam[:, 1] - lam[:, 0])
    held = bar < 1
    assert held.all() if kind == "random" else held.sum() > len(x) // 4
    assert (dist[held] <= bar[held]).all()
    assert (np.abs(np.sort(w, 1) - lam).max(1) / scale).max() < 1e-14
    rebuilt = np.einsum("bij,bj,bkj->bik", v, w, v)
    assert (np.abs(rebuilt - x).max((1, 2)) / scale).max() < 1e-14
    np.testing.assert_allclose(v.transpose(0, 2, 1) @ v,
                               np.broadcast_to(np.eye(n), v.shape),
                               rtol=0, atol=1e-14)


# -- kernel C ------------------------------------------------------------------

def _scene(n_pad: int, seed: int) -> tuple:
    """Ground and two walls at random spacing, voxel-downsampled and padded
    as ``prepare`` does (GeometricVerifier defaults: 0.3 m voxels)."""
    rng = np.random.default_rng(seed)
    g = rng.uniform(-25, 25, (6000, 2))
    cloud = np.vstack([
        np.column_stack([g, rng.normal(0, 0.02, len(g))]),
        np.column_stack([rng.uniform(-25, 25, 2000), np.full(2000, 8.0),
                         rng.uniform(0, 4, 2000)]),
        np.column_stack([np.full(2000, -11.0), rng.uniform(-25, 25, 2000),
                         rng.uniform(0, 4, 2000)])]).astype(np.float32)
    return tver._pad(tver.voxel_downsample(cloud, 0.3), n_pad)


def pca_inputs(case: str) -> tuple:
    """(padded points, mask) of one case, from a fixed seed."""
    rng = np.random.default_rng(7)
    if case == "lattice":               # 8 x 8 x 2 at 0.5 m, ties everywhere
        g = np.stack(np.meshgrid(np.arange(8), np.arange(8), np.arange(2),
                                 indexing="ij"), -1).reshape(-1, 3) * 0.5
        return tver._pad(g.astype(np.float32), 256)
    if case == "random":
        pts = rng.uniform(-20, 20, (1024, 3)).astype(np.float32)
        return pts, rng.random(1024) < 0.8
    if case == "scene":
        return _scene(4096, 8)
    if case == "few_valid":             # 5 valid: the rest of k is padding
        pts, mask = tver._pad(rng.uniform(-5, 5, (5, 3)).astype(np.float32),
                              256)
        return pts, mask
    if case == "duplicates":            # 24 copies of each of 16 points,
        base = rng.uniform(-9, 9, (16, 3)).astype(np.float32)  # and a plane
        plane = np.column_stack([rng.uniform(-3, 3, (128, 2)),
                                 np.zeros(128)]).astype(np.float32) + 30
        return tver._pad(np.vstack([np.repeat(base, 24, 0), plane]), 512)
    if case == "collinear":             # points on three lines
        t = rng.uniform(-10, 10, (3, 100))
        dirs = np.array([[1, 0, 0], [0.6, 0.8, 0], [0, 0.6, 0.8]])
        pts = (t[:, :, None] * dirs[:, None, :]
               + np.array([[0, 0, 0], [40, 0, 0], [0, 40, 0]])[:, None, :])
        return tver._pad(pts.reshape(-1, 3).astype(np.float32), 384)
    raise ValueError(case)


PCA_CASES = ["lattice", "random", "scene", "few_valid", "duplicates",
             "collinear"]


def _gaps(cov64: np.ndarray) -> tuple:
    """(relative gap (λ1 − λ0) / λ2, 0 where λ2 = 0; eigenvalues)."""
    lam = np.linalg.eigvalsh(cov64)
    with np.errstate(divide="ignore", invalid="ignore"):
        g = np.where(lam[:, 2] > 0, (lam[:, 1] - lam[:, 0]) / lam[:, 2], 0.0)
    return g, lam


def check_pca_invariants(got: np.ndarray, mode: str, cov64: np.ndarray,
                         what: str) -> None:
    """Rows of any gap: finite; a covariance symmetric with eigenvalues
    {ε, 1, 1}; a normal a unit vector in the span of the two smallest
    eigenvectors of its raw covariance."""
    assert np.isfinite(got).all(), what
    if mode == "covariances":
        np.testing.assert_allclose(got, got.transpose(0, 2, 1), rtol=0,
                                   atol=1e-6, err_msg=what)
        lam = np.linalg.eigvalsh(got.astype(np.float64))
        np.testing.assert_allclose(
            lam, np.broadcast_to([EPS, 1.0, 1.0], lam.shape), rtol=0,
            atol=INV_TOL, err_msg=what)
        return
    n = got.astype(np.float64)
    np.testing.assert_allclose((n * n).sum(1), 1.0, rtol=0, atol=1e-6,
                               err_msg=what)
    _, lam = _gaps(cov64)
    ray = np.einsum("pi,pij,pj->p", n, cov64, n)
    assert (ray <= lam[:, 1] + INV_TOL * lam[:, 2] + 1e-30).all(), what


def compare_pca(got: np.ndarray, want: np.ndarray, mode: str,
                gap: np.ndarray, what: str) -> None:
    """``got`` against ``want`` on the rows above the mode's gap."""
    if mode == "covariances":
        rows = gap >= COV_GAP
        np.testing.assert_allclose(got[rows], want[rows], rtol=0,
                                   atol=COV_TOL, err_msg=what)
    else:
        rows = gap >= NORMAL_GAP
        cos = np.abs((got[rows].astype(np.float64) * want[rows]).sum(1))
        assert (cos >= 1 - NORMAL_TOL).all(), (what, cos.min())


@pytest.mark.parametrize("mode", ["covariances", "normals"])
@pytest.mark.parametrize("case", PCA_CASES)
def test_knn_pca_model_equals_plain_and_jax(case, mode):
    """Kernel C's model against the plain version (float32 ``eigh`` on the
    same neighbours) and against JAX's ``_knn_covariances`` (k 20, ε 1e-3)
    or ``_knn_normals`` (k 16) on the rows above the gap rule's threshold;
    invariants on every row of all three; every row finite (padded rows,
    rows whose neighbours are padding, equal points, collinear
    neighbourhoods)."""
    pts, mask = pca_inputs(case)
    k = 20 if mode == "covariances" else 16
    p, m = torch.from_numpy(pts), torch.from_numpy(mask)
    idx = knn_kernel.knn_plain(p, m, k).numpy()
    cov64 = model_cov64(pts, idx)
    gap, _ = _gaps(cov64)
    got = model_knn_pca(pts, idx, mode)
    plain = pca_kernel.knn_pca_plain(p, torch.from_numpy(idx), mode,
                                     EPS).numpy()
    jax_fn = jver._knn_covariances if mode == "covariances" \
        else jver._knn_normals
    want = np.asarray(jax_fn(jnp.asarray(pts), jnp.asarray(mask), k))
    for name, out in (("model", got), ("plain", plain), ("jax", want)):
        check_pca_invariants(out, mode, cov64, f"{case} {mode} {name}")
    compare_pca(got, plain, mode, gap, f"{case} {mode}: model vs plain")
    compare_pca(got, want, mode, gap, f"{case} {mode}: model vs JAX")
    if case in ("duplicates", "collinear"):
        assert (gap < COV_GAP).sum() > 0      # the invariants were needed
    if case == "scene":
        assert (gap >= COV_GAP).mean() > 0.5  # and the bars were too
    if case == "scene" and mode == "covariances":   # the rule's premise
        assert (np.abs(got - plain).max((1, 2)) * gap).max() <= GAP_ERR


def test_knn_pca_model_fixes_the_normal_sign():
    """The model's normal (as the kernel's) has its largest-magnitude
    component positive, so it does not depend on the solver's sign; the
    plain normal equals it up to that sign; a zero covariance (k equal
    points) gives e_x, as ``eigh`` does."""
    pts, mask = pca_inputs("scene")
    idx = knn_kernel.knn_plain(torch.from_numpy(pts), torch.from_numpy(mask),
                               16).numpy()
    n = model_knn_pca(pts, idx, "normals").astype(np.float64)
    lead = n[np.arange(len(n)), np.abs(n).argmax(1)]
    assert (lead > 0).all()
    same = np.zeros((24, 3), np.float32) + np.float32(3.5)
    got = model_knn_pca(same, np.zeros((24, 20), np.int64), "normals")
    np.testing.assert_array_equal(got, np.broadcast_to([1, 0, 0], got.shape))
    plain = pca_kernel.knn_pca_plain(torch.from_numpy(same),
                                     torch.zeros(24, 20, dtype=torch.int64),
                                     "normals").numpy()
    np.testing.assert_array_equal(plain, got)


@pytest.mark.parametrize("k", [1, 3, 16, 20, 32, 33, 45])
def test_knn_pca_group_sums(k):
    """Kernel C's lane split and group sums: the GROUP lanes of a point
    take every one of its k neighbours exactly once (REGS a lane from
    registers, the rest gathered again), each lane in index order; the
    xor butterfly gives every lane of the group the same bits, so the
    order is fixed and the result deterministic; the grouped float64
    covariance equals the float64 covariance summed in neighbour order to
    1e-13 of its largest entry, and the plain float32 version on rows above
    the gap rule's threshold (the invariants on every row)."""
    orders = lane_order(k)
    taken = sorted(j for order in orders for j in order)
    assert taken == list(range(k))
    assert all(order == sorted(order) for order in orders)
    held = [j for order in orders for j in order[:REGS]]
    assert len(held) == min(k, GROUP * REGS)
    pts, mask = pca_inputs("random")
    p, m = torch.from_numpy(pts), torch.from_numpy(mask)
    idx = knn_kernel.knn_plain(p, m, k).numpy()
    nbr = pts.astype(np.float64)[idx]
    lanes = np.stack([nbr[:, order].sum(1) if order else np.zeros(
        (len(pts), 3)) for order in orders], -1)
    every = butterfly(lanes)
    assert (every == every[..., :1]).all()
    got = model_cov64(pts, idx)
    c = nbr - nbr.mean(1, keepdims=True)
    ref = np.einsum("pki,pkj->pij", c, c) / k
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=1e-13 * np.abs(ref).max())
    if k < 3:
        return
    gap, _ = _gaps(got)
    out = model_knn_pca(pts, idx, "covariances")
    check_pca_invariants(out, "covariances", got, f"k {k}")
    plain = pca_kernel.knn_pca_plain(p, torch.from_numpy(idx),
                                     "covariances", EPS).numpy()
    compare_pca(out, plain, "covariances", gap, f"k {k}: model vs plain")


# -- kernel R ------------------------------------------------------------------

def kabsch_inputs(case: str) -> tuple:
    """(H (B, 3, 3), p_c, q_c (B, 3)) float32 of one case, as a step forms
    them: centroids of clouds tens of metres out."""
    rng = np.random.default_rng(13)
    b = 64
    p_c = rng.uniform(-30, 30, (b, 3)).astype(np.float32)
    q_c = (p_c + rng.normal(0, 1, (b, 3))).astype(np.float32)
    if case == "random":
        h = rng.normal(size=(b, 3, 3))
    elif case == "reflection":              # det(V Uᵀ) = -1 in every one
        h = rng.normal(size=(b, 3, 3))
        h[np.linalg.det(h) > 0, :, 2] *= -1
    elif case == "rotation":                # a true step: H = Σ p pᵀ Rᵀ
        src = rng.normal(0, 3, (b, 200, 3))
        ang = rng.uniform(-0.3, 0.3, (b, 3))
        h = np.stack([np.einsum("ni,nj->ij", s, s @ _rotation(a).T)
                      for s, a in zip(src, ang)])
    elif case == "rank2":                   # planar correspondences
        h = rng.normal(size=(b, 3, 2)) @ rng.normal(size=(b, 2, 3))
    elif case == "rank1":                   # collinear correspondences
        h = rng.normal(size=(b, 3, 1)) @ rng.normal(size=(b, 1, 3))
    elif case == "zero":                    # no point matched
        h = np.zeros((b, 3, 3))
    else:
        raise ValueError(case)
    return h.astype(np.float32), p_c, q_c


def _rotation(a):
    cx, cy, cz = np.cos(a)
    sx, sy, sz = np.sin(a)
    return (np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]])
            @ np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
            @ np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]]))


def assert_same_transform(got: np.ndarray, want: np.ndarray, p_c,
                          what: str) -> None:
    """R within R_TOL; t within R_TOL · max(1, |p_c|₁), since an error δ in
    R moves t = q_c − R p_c by up to δ |p_c|₁ (two float32 SVDs of one H
    already differ by 1.5e-5 in t at |p_c| ~ 60 m)."""
    np.testing.assert_allclose(got[:, :3, :3], want[:, :3, :3], rtol=0,
                               atol=R_TOL, err_msg=what)
    scale = np.maximum(1.0, np.abs(p_c).sum(1))[:, None]
    assert (np.abs(got[:, :3, 3] - want[:, :3, 3]) <= R_TOL * scale).all(), \
        (what, np.abs(got[:, :3, 3] - want[:, :3, 3]).max())
    np.testing.assert_array_equal(got[:, 3], want[:, 3])


def check_proper(T: np.ndarray, h, p_c, q_c, what: str) -> None:
    """R a proper rotation, t = q_c − R p_c, the last row [0, 0, 0, 1]."""
    R = T[:, :3, :3].astype(np.float64)
    np.testing.assert_allclose(R @ R.transpose(0, 2, 1),
                               np.broadcast_to(np.eye(3), R.shape),
                               atol=ORTHO_TOL, err_msg=what)
    np.testing.assert_allclose(np.linalg.det(R), 1.0, atol=ORTHO_TOL,
                               err_msg=what)
    assert (np.abs(T[:, :3, 3] - (q_c - np.einsum("bij,bj->bi", R, p_c)))
            <= R_TOL * np.maximum(1.0, np.abs(p_c).sum(1))[:, None]).all(), \
        what
    np.testing.assert_array_equal(T[:, 3], np.broadcast_to(
        [0, 0, 0, 1], (len(T), 4)))


@pytest.mark.parametrize("case", ["random", "reflection", "rotation",
                                  "rank2", "rank1", "zero"])
def test_kabsch_model_equals_jax(case):
    """Kernel R's model (Horn's quaternion on the Jacobi solve) against
    JAX's SVD formula, and the plain version against JAX: R within 1e-5
    and t within 1e-5 · max(1, |p_c|₁) where the optimal rotation is
    unique (random H, reflections, a true step's H,
    rank 2); for rank 1, where every rotation that maps the one direction
    onto the other is optimal, the same trace(R H); H = 0 gives R = I
    exactly. Every answer a proper rotation with t = q_c − R p_c."""
    h, p_c, q_c = kabsch_inputs(case)
    got = model_kabsch(h, p_c, q_c)
    want = np.stack([jax_kabsch(*x) for x in zip(h, p_c, q_c)])
    plain = np.stack([pca_kernel.kabsch_plain(
        *(torch.from_numpy(np.ascontiguousarray(v)) for v in x)).numpy()
        for x in zip(h, p_c, q_c)])
    for name, T in (("model", got), ("jax", want), ("plain", plain)):
        check_proper(T, h, p_c, q_c, f"{case} {name}")
    if case == "rank1":
        obj = [np.einsum("bij,bji->b", T[:, :3, :3].astype(np.float64), h)
               for T in (got, want, plain)]
        np.testing.assert_allclose(obj[0], obj[1], rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(obj[2], obj[1], rtol=1e-5, atol=1e-6)
        return
    for name, T in (("model", got), ("plain", plain)):
        assert_same_transform(T, want, p_c, f"{case}: {name} vs JAX")
    if case == "zero":
        np.testing.assert_array_equal(got[:, :3, :3], np.broadcast_to(
            np.eye(3, dtype=np.float32), (len(got), 3, 3)))


def p2p_inputs(case: str, n: int = 2048) -> tuple:
    """(src, src_mask, dst, dst_mask, init_T, max_corr) float32 / bool of
    one case: a voxelised scene and its copy moved by a small rotation and
    0.4 m, with noise, padded to ``n``; ``partial`` masks half the source,
    ``far`` takes a correspondence distance no pair meets (w = 0)."""
    src, src_mask = _scene(n, 21)
    rng = np.random.default_rng(22)
    moved = (src[src_mask] @ _rotation(np.array([0.01, -0.02, 0.03])).T
             + np.array([0.4, -0.1, 0.05])
             + rng.normal(0, 0.01, (int(src_mask.sum()), 3)))
    dst, dst_mask = tver._pad(moved.astype(np.float32), n)
    if case == "partial":
        src_mask = src_mask & (np.arange(n) % 2 == 0)
    init = np.eye(4, dtype=np.float32)
    init[:3, 3] = (0.3, 0.0, 0.0)
    max_corr = {"scene": 1.0, "partial": 1.0, "far": 1e-6}[case]
    return src, src_mask, dst, dst_mask, init, max_corr


def _correspondences(src, dst, dst_mask, init) -> tuple:
    """Kernel N's (j, d2) as the step takes them, from the plain search."""
    moved = torch.from_numpy(src) @ torch.from_numpy(init[:3, :3]).T \
        + torch.from_numpy(init[:3, 3])
    return nearest_kernel.nearest_plain(moved, torch.from_numpy(dst),
                                        torch.from_numpy(dst_mask))


def torch_step_tail(src, src_mask, dst, j, d2, max_corr):
    """The tail of JAX's ``p2p_step`` after the argmin, op for op in torch:
    ``correspondences``' distance and weights, then the weighted
    centroids, H and the Kabsch solve."""
    dist = torch.sqrt(d2)
    w = (src_mask & (dist <= max_corr)).to(torch.float32)
    q = dst[j]
    sw = w.sum().clamp(min=1e-6)
    p_c = (src * w[:, None]).sum(0) / sw
    q_c = (q * w[:, None]).sum(0) / sw
    H = torch.einsum("ni,nj->ij", (src - p_c) * w[:, None], q - q_c)
    return pca_kernel.kabsch_plain(H, p_c, q_c)


@pytest.mark.parametrize("case", ["scene", "partial", "far", "nan"])
def test_p2p_update_plain_equals_the_step_tail(case):
    """``p2p_update_plain`` (kernel R's plain version) equals the step's
    tail written op for op after the search, bit for bit, on a step's
    (j, d2), with half the source masked, with no pair in range, and with
    NaN distances (a NaN point: its weight is 0)."""
    src, src_mask, dst, dst_mask, init, max_corr = p2p_inputs(
        "scene" if case == "nan" else case)
    j, d2 = _correspondences(src, dst, dst_mask, init)
    if case == "nan":
        d2[::7] = float("nan")
    args = (torch.from_numpy(src), torch.from_numpy(src_mask),
            torch.from_numpy(dst), j, d2, max_corr)
    got = pca_kernel.p2p_update_plain(*args)
    assert torch.equal(got, torch_step_tail(*args))
    assert torch.equal(pca_kernel.p2p_update(*args), got)
    if case == "far":
        assert torch.equal(got, torch.eye(4))


@pytest.mark.parametrize("layout", [(8, 256), (4, 256), (1, 256)])
@pytest.mark.parametrize("case", ["scene", "partial", "far"])
def test_p2p_update_model_equals_plain_and_jax(case, layout):
    """Kernel R's update, modelled as clusters of 8 CTAs of 256 (a point
    or none a thread here), 4 (the cluster ``p2p_layout`` launches for
    these 2,048 points: 2 a thread) and 1 (8 points a thread, 4 of them
    gathered again), against the float32 plain version (R within 1e-5, t within
    1e-5 · max(1, |p_c|₁)), the plain version in float64 (1e-6) and JAX's
    ``_icp_kernel`` run for one point-to-point iteration on the same
    clouds (T within T_TOL); no pair in range gives T = I exactly."""
    src, src_mask, dst, dst_mask, init, max_corr = p2p_inputs(case)
    j, d2 = _correspondences(src, dst, dst_mask, init)
    got = model_p2p_update(src, src_mask, dst, j.numpy(), d2.numpy(),
                           max_corr, layout)
    plain = pca_kernel.p2p_update_plain(
        torch.from_numpy(src), torch.from_numpy(src_mask),
        torch.from_numpy(dst), j, d2, max_corr).numpy()
    plain64 = pca_kernel.p2p_update_plain(
        torch.from_numpy(src).double(), torch.from_numpy(src_mask),
        torch.from_numpy(dst).double(), j, d2, max_corr).numpy()
    w = src_mask & (np.sqrt(d2.numpy()) <= np.float32(max_corr))
    p_c = (src.astype(np.float64) * w[:, None]).sum(0) / max(w.sum(), 1e-6)
    assert_same_transform(got[None], plain[None], p_c[None],
                          f"{case} {layout}: model vs plain")
    np.testing.assert_allclose(got, plain64, rtol=0, atol=1e-6)
    zc = jnp.zeros((len(src), 3, 3), jnp.float32)
    jT, _, _ = jver._icp_kernel(
        jnp.asarray(src), jnp.asarray(src_mask), jnp.asarray(dst),
        jnp.asarray(dst_mask), jnp.zeros((len(dst), 3), jnp.float32), zc,
        zc, jnp.asarray(init), 1, "p2p", max_corr)
    np.testing.assert_allclose(got, np.asarray(jT), rtol=0, atol=T_TOL)
    if case == "far":
        np.testing.assert_array_equal(got, np.eye(4, dtype=np.float32))
    else:
        assert w.sum() > len(src) // 4        # the step had work


def test_p2p_layout_matches_the_kernel():
    """The binding's layout constants are kabsch.cu's; at the verifier's
    4,096 points the main path launches 8 CTAs of 256 threads, 2 points a
    thread, all held in registers; one point takes one CTA, and the
    cluster never exceeds 8 CTAs."""
    assert (pca_kernel.P2P_THREADS, pca_kernel.P2P_MAX_CTAS) == (
        P2P_THREADS, P2P_MAX_CTAS)
    assert pca_kernel.P2P_POINTS <= P2P_PER
    assert pca_kernel.p2p_layout(4096) == 8
    for n in (1, 511, 512, 513, 4096, 8192, 100_000):
        ctas = pca_kernel.p2p_layout(n)
        assert 1 <= ctas <= P2P_MAX_CTAS
        assert ctas == P2P_MAX_CTAS or ctas * P2P_THREADS * 2 >= n
    assert 8 * P2P_THREADS * P2P_PER >= 4096


# -- the prepare step ----------------------------------------------------------

def _verifier(method: str, n_pad: int = 512):
    return tver.GeometricVerifier(method=method, backend="torch",
                                  device="cpu", max_points=n_pad,
                                  voxel_downsample=0.3)


def _cloud(seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    g = rng.uniform(-8, 8, (900, 2))
    return np.vstack([np.column_stack([g, np.zeros(len(g))]),
                      np.column_stack([rng.uniform(-8, 8, 300),
                                       np.full(300, 3.0),
                                       rng.uniform(0, 3, 300)])]
                     ).astype(np.float32)


@pytest.mark.parametrize("method", ["gicp", "point_to_plane", "icp"])
def test_prepare_step_equals_direct_calls(method):
    """``prepare`` through its ``PrepareExecutable`` on the CPU equals
    ``knn_covariances`` / ``knn_normals`` called directly on the padded
    cloud, bit for bit; one executable prepares cloud A, then B, then A
    again, each its own answer; the ``PreparedCloud``'s tensors are its
    own (no arena's memory), so the later runs leave the first cloud's as
    they were."""
    v = _verifier(method)
    clouds = [_cloud(1), _cloud(2)]
    wants = []
    for c in clouds:
        padded, mask = tver._pad(tver.voxel_downsample(c, 0.3), 512)
        p, m = torch.from_numpy(padded), torch.from_numpy(mask)
        aux = {"gicp": lambda: tver.knn_covariances(p, m),
               "point_to_plane": lambda: tver.knn_normals(p, m),
               "icp": lambda: None}[method]()
        wants.append((padded, mask, aux))
    eager0 = tver.PREPARE_STATS["eager_steps"]
    preps = [v.prepare(c) for c in (clouds[0], clouds[1], clouds[0])]
    assert tver.PREPARE_STATS["eager_steps"] - eager0 == (
        0 if method == "icp" else 3)
    exe = tver.prepare_executable(torch.device("cpu"), method, 512, 20,
                                  1e-3)
    assert exe.graph is None and not exe.use_graph and v.captures == 0
    arena = {t.untyped_storage().data_ptr() for t in (
        exe.inputs.dev_bytes, exe.outputs.dev_bytes)}
    first = preps[0].cov if method == "gicp" else preps[0].normals
    first = None if first is None else first.clone()
    for prep, (padded, mask, aux) in zip(preps, wants + wants[:1]):
        np.testing.assert_array_equal(prep.padded.numpy(), padded)
        np.testing.assert_array_equal(prep.mask.numpy(), mask)
        got = prep.cov if method == "gicp" else prep.normals
        assert (got is None) == (aux is None)
        if aux is not None:
            assert torch.equal(got, aux)
        for t in (prep.padded, prep.mask, got):
            assert t is None or t.untyped_storage().data_ptr() not in arena
        assert (prep.cov is None or method == "gicp") and (
            prep.normals is None or method == "point_to_plane")
    if first is not None:
        assert torch.equal(preps[0].cov if method == "gicp"
                           else preps[0].normals, first)


class _Ops(TorchDispatchMode):
    """Records the name of every aten operation dispatched."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(str(func))
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("method", ["gicp", "point_to_plane"])
def test_prepare_step_has_no_host_sync(monkeypatch, method):
    """The prepare step (kernel K, then kernel C into the output section)
    dispatches no operation that reads a value back to the host: on a card
    any would break its capture. Kernel C's plain solve (``eigh``, which
    checks its errors on the host) is on a card a kernel launch, so here a
    recording stand-in takes its place; it is called once, and the step
    writes the one static output section."""
    calls = []

    def stand_in(pts, idx, mode, eps=1e-3):
        calls.append((tuple(idx.shape), mode))
        return pts.new_zeros(pca_kernel._out_shape(pts.shape[0], mode))

    v = _verifier(method, 256)
    v.prepare(_cloud(3))
    exe = next(e for e in tver.cached_prepares()
               if e.mode == tver.PREPARE_MODES[method]
               and e.inputs.dev["pts"].shape[0] == 256)
    ptr = exe.outputs.dev["out"].data_ptr()
    monkeypatch.setattr(pca_kernel, "knn_pca_plain", stand_in)
    with _Ops() as rec:
        exe._step()
    syncs = [op for op in rec.ops if any(s in op for s in HOST_SYNCS)]
    assert rec.ops and not syncs, syncs
    k = 20 if method == "gicp" else tver.NORMALS_KNN
    assert calls == [((256, k), tver.PREPARE_MODES[method])]
    assert exe.outputs.dev["out"].data_ptr() == ptr


def test_pca_bindings_refuse_bad_inputs_before_any_launch():
    """Kernels C and R refuse CPU tensors, other dtypes and shapes,
    non-contiguous inputs, a wrong ``out`` and an unknown mode with a
    ``ValueError``, and launch nothing."""
    pts = torch.zeros(40, 3)
    idx = torch.zeros(40, 8, dtype=torch.int64)
    h, c = torch.zeros(3, 3), torch.zeros(3)
    n0 = (pca_kernel.KNN_PCA.launches, pca_kernel.KABSCH_SOLVE.launches)
    bad_pca = [
        ((pts, idx, "normals"), "needs CUDA"),
        ((pts, idx, "planes"), "mode 'planes'"),
        ((pts.double(), idx, "normals"), "float32"),
        ((pts, idx.int(), "normals"), "int64"),
        ((pts, idx[:30], "normals"), r"\(40, k\)"),
        ((pts, torch.zeros(8, 40, dtype=torch.int64).T, "normals"),
         r"\(40, k\)"),
        ((pts, idx[:, :0], "normals"), "k >= 1"),
        ((torch.zeros(3, 40).T, idx, "covariances"), "contiguous")]
    for args, match in bad_pca:
        with pytest.raises(ValueError, match=match):
            pca_kernel.knn_pca_cuda(*args)
    with pytest.raises(ValueError, match="needs CUDA"):
        pca_kernel.knn_pca_cuda(pts, idx, "normals",
                                out=torch.zeros(40, 3))
    bad_kabsch = [
        ((h, c, c), "needs CUDA"), ((h.double(), c, c), "float32"),
        ((h[:2], c, c), r"\(3, 3\)"), ((h, c[:2], c), r"\(3,\)"),
        ((h.T.contiguous().T, c, c), "contiguous")]
    for args, match in bad_kabsch:
        with pytest.raises(ValueError, match=match):
            pca_kernel.kabsch_cuda(*args)
    assert (pca_kernel.KNN_PCA.launches,
            pca_kernel.KABSCH_SOLVE.launches) == n0


def test_p2p_update_binding_refuses_bad_inputs_before_any_launch():
    """Kernel R's update binding refuses CPU tensors, other dtypes and
    shapes and non-contiguous inputs with a ``ValueError``, and launches
    nothing."""
    src, dst = torch.zeros(40, 3), torch.zeros(30, 3)
    mask = torch.ones(40, dtype=torch.bool)
    j = torch.zeros(40, dtype=torch.int64)
    d2 = torch.zeros(40)
    n0 = pca_kernel.KABSCH.launches
    bad = [
        ((src, mask, dst, j, d2), "needs CUDA"),
        ((src.double(), mask, dst, j, d2), "float32"),
        ((src, mask, torch.zeros(30, 4), j, d2), r"\(n, 3\)"),
        ((src, mask[:39], dst, j, d2), r"\(40,\) bool"),
        ((src, mask.to(torch.uint8), dst, j, d2), r"\(40,\) bool"),
        ((src, mask, dst, j.int(), d2), "j: expected"),
        ((src, mask, dst, j[:39], d2), "j: expected"),
        ((src, mask, dst, j, d2.double()), "d2: expected"),
        ((src, mask, dst, j, torch.zeros(40, 2)[:, 0]), "d2: expected"),
        ((torch.zeros(3, 40).T, mask, dst, j, d2), "contiguous")]
    for args, match in bad:
        with pytest.raises(ValueError, match=match):
            pca_kernel.p2p_update_cuda(*args, 1.0)
    assert pca_kernel.KABSCH.launches == n0
