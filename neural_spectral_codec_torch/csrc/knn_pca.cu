// Kernel C: the k-NN PCA of every point of one cloud, to its unit normal
// or its GICP disk covariance.
//
// Not a Pallas kernel: the hand-written form of the XLA work that follows
// the k-NN selection in the JAX package's per-cloud preparation,
// neural_spectral_codec_tpu/retrieval/verification.py _knn_cov_matrices
// (:64-73) and the jitted _knn_normals (:77) and _knn_covariances (:85):
//     nbr  = pts[idx]                          (P, k, 3), idx from kernel K
//     c    = nbr - mean(nbr over k)
//     cov  = sum_k c c^T / k                    (P, 3, 3)
//     V    = eigh(cov) (ascending eigenvalues)
//     normals:      n = V[:, 0]                 (P, 3)
//     covariances:  V diag(eps, 1, 1) V^T       (P, 3, 3)
// The covariance depends on V only through n: V diag(eps, 1, 1) V^T =
// I - (1 - eps) n n^T, whatever the sign of n or the choice of the other
// two eigenvectors. A normal's sign is arbitrary in JAX too (and point-to-
// plane is blind to it: r and J flip together), so the kernel fixes one:
// the largest-magnitude component of n (the first of equal ones) is
// positive. Eigenvalues that tie (a collinear neighbourhood, k equal
// points) give the eigenvector of the first of them, which is e_x for a
// zero covariance, as LAPACK's eigh gives.
//
// The plain version is retrieval/pca_kernel.py knn_pca_plain: the same
// formulas in float32 with torch.linalg.eigh. The kernel works in float64
// from the float32 points, solves with sym3.cuh's Jacobi, normalises n and
// rounds the output once. So the kernel is the more exact of the two; they
// differ by the float32 solve's error, which grows as lambda_max /
// (lambda_1 - lambda_0): tests and chip_smoke.py hold them to 1e-5
// (covariances) and 1 - |cos| <= 1e-4 (normals) on rows whose relative
// eigen-gap makes that error small, and rows below it to the invariants
// (symmetric, eigenvalues {eps, 1, 1}, n a unit vector in the span of the
// two smallest eigenvectors). Every row of a prepared cloud is finite:
// padded rows (their neighbours are the valid points nearest the origin),
// rows with masked neighbours (padding zeros), equal points and collinear
// neighbourhoods. A NaN point gives NaN rows.
//
// What bounds it on the H100: bytes, at the verifier's P = 4,096 and
// k = 20: idx 655 KB, pts 49 KB, out 147 KB (covariances), 0.25 us at
// 3.35 TB/s; the float32 operations of the covariances (mean, centring,
// 6 products and sums a neighbour) are 1.5 M, 0.02 us. What limits it is
// latency: two dependent loads (the index, then the point) and a chain of
// float64 rotations a point.
//
// Design: a group of kGroup = 4 lanes a point, so P = 4,096 is 16,384
// threads, 128 CTAs of 128 for 132 SMs.
//   * Loads. Lane s of a group takes neighbours s, s + 4, s + 8, ... of its
//     row: at each step the group reads 32 contiguous bytes of its index
//     row and a warp 8 such runs, whole sectors. All of a lane's index
//     loads, then all of its gathers, are issued before the first sum; the
//     coordinates of up to kRegs = 8 neighbours a lane (k <= 32) stay in
//     registers for the second pass, and neighbours past them (k > 32) are
//     gathered again.
//   * Sums. Each lane sums its neighbours in float64 in index order; the
//     group adds its lanes' sums by a xor butterfly of shuffles (group_sum):
//     every level adds two partial sums that commute exactly, so every lane
//     of the group holds the same bits and the order is fixed. First the
//     mean, then the 6 centred sums. No atomics, no scratch: deterministic.
//   * Solve. Every lane of the group runs the same 3 x 3 solve (sym3.cuh:
//     one root and one rsqrt a rotation, stopped a sweep after the last
//     rotation); a warp issues it once for its 8 points.
//   * Store. Lane s writes outputs s, s + 4, s + 8 of its point's 3 or 9,
//     so a warp's store is one contiguous run.
// A group past the last point works on the last point and stores nothing,
// so that every lane of a warp takes part in the shuffles.
#include "sym3.cuh"

namespace {

constexpr int kGroup = 4;                        // lanes a point
constexpr int kThreads = 128;
constexpr int kPointsPerCta = kThreads / kGroup;
constexpr int kRegs = 8;                         // neighbours a lane holds
constexpr unsigned kFullMask = 0xffffffffu;
static_assert(32 % kGroup == 0 && (kGroup & (kGroup - 1)) == 0,
              "a group is a power-of-two run of lanes of one warp");

// The sum of v over the lane's group, the same bits in every lane.
__device__ __forceinline__ double group_sum(double v) {
#pragma unroll
  for (int off = 1; off < kGroup; off <<= 1)
    v += __shfl_xor_sync(kFullMask, v, off);
  return v;
}

__device__ __forceinline__ void gather(const float* __restrict__ pts,
                                       const long long* __restrict__ nb,
                                       int j, float* x, float* y, float* z) {
  const float* p = pts + 3 * __ldg(nb + j);
  *x = __ldg(p);
  *y = __ldg(p + 1);
  *z = __ldg(p + 2);
}

__global__ void __launch_bounds__(kThreads)
    knn_pca_kernel(const float* __restrict__ pts,
                   const long long* __restrict__ idx,
                   float* __restrict__ out, int n, int k, int normals,
                   float eps) {
  const int point = blockIdx.x * kPointsPerCta + threadIdx.x / kGroup;
  const int sub = threadIdx.x % kGroup;
  const int row = min(point, n - 1);
  const long long* nb = idx + static_cast<long long>(row) * k;
  // neighbours sub + kGroup * m, m < kRegs, in registers
  float x[kRegs], y[kRegs], z[kRegs];
#pragma unroll
  for (int m = 0; m < kRegs; ++m) {
    x[m] = y[m] = z[m] = 0.0f;
    if (sub + kGroup * m < k)
      gather(pts, nb, sub + kGroup * m, &x[m], &y[m], &z[m]);
  }
  double sx = 0.0, sy = 0.0, sz = 0.0;
#pragma unroll
  for (int m = 0; m < kRegs; ++m) {
    if (sub + kGroup * m < k) {
      sx += x[m];
      sy += y[m];
      sz += z[m];
    }
  }
  for (int j = sub + kGroup * kRegs; j < k; j += kGroup) {
    float px, py, pz;
    gather(pts, nb, j, &px, &py, &pz);
    sx += px;
    sy += py;
    sz += pz;
  }
  const double mx = group_sum(sx) / k, my = group_sum(sy) / k,
               mz = group_sum(sz) / k;
  double c00 = 0.0, c01 = 0.0, c02 = 0.0, c11 = 0.0, c12 = 0.0, c22 = 0.0;
#pragma unroll
  for (int m = 0; m < kRegs; ++m) {
    if (sub + kGroup * m < k) {
      const double cx = x[m] - mx, cy = y[m] - my, cz = z[m] - mz;
      c00 += cx * cx;
      c01 += cx * cy;
      c02 += cx * cz;
      c11 += cy * cy;
      c12 += cy * cz;
      c22 += cz * cz;
    }
  }
  for (int j = sub + kGroup * kRegs; j < k; j += kGroup) {
    float px, py, pz;
    gather(pts, nb, j, &px, &py, &pz);
    const double cx = px - mx, cy = py - my, cz = pz - mz;
    c00 += cx * cx;
    c01 += cx * cy;
    c02 += cx * cz;
    c11 += cy * cy;
    c12 += cy * cz;
    c22 += cz * cz;
  }
  c00 = group_sum(c00) / k;
  c01 = group_sum(c01) / k;
  c02 = group_sum(c02) / k;
  c11 = group_sum(c11) / k;
  c12 = group_sum(c12) / k;
  c22 = group_sum(c22) / k;
  double a[3][3] = {{c00, c01, c02}, {c01, c11, c12}, {c02, c12, c22}};
  double v[3][3];
  nsc::jacobi_eigen<3>(a, v);
  // the eigenvector of the least eigenvalue, the first of equal ones;
  // selects, not indexing, so that a and v stay in registers
  const double w0 = a[0][0], w1 = a[1][1], w2 = a[2][2];
  const int low = w1 < w0 ? (w2 < w1 ? 2 : 1) : (w2 < w0 ? 2 : 0);
  double nv[3];
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    nv[r] = low == 0 ? v[r][0] : (low == 1 ? v[r][1] : v[r][2]);
  }
  // its sign: the first component of the largest magnitude positive
  const double m0 = fabs(nv[0]), m1 = fabs(nv[1]), m2 = fabs(nv[2]);
  const double lead =
      m1 > m0 ? (m2 > m1 ? nv[2] : nv[1]) : (m2 > m0 ? nv[2] : nv[0]);
  const double scale = (lead < 0.0 ? -1.0 : 1.0) /
                       sqrt(nv[0] * nv[0] + nv[1] * nv[1] + nv[2] * nv[2]);
#pragma unroll
  for (int r = 0; r < 3; ++r) nv[r] *= scale;
  if (point >= n) return;
  if (normals) {
    float* o = out + 3 * static_cast<long long>(point);
#pragma unroll
    for (int e = 0; e < 3; ++e) {
      if (e % kGroup == sub) o[e] = static_cast<float>(nv[e]);
    }
    return;
  }
  const double squash = 1.0 - static_cast<double>(eps);
  float* o = out + 9 * static_cast<long long>(point);
#pragma unroll
  for (int e = 0; e < 9; ++e) {
    if (e % kGroup == sub) {
      o[e] = static_cast<float>((e / 3 == e % 3 ? 1.0 : 0.0) -
                                squash * nv[e / 3] * nv[e % 3]);
    }
  }
}

}  // namespace

// pts (n, 3) float32, idx (n, k) int64 (indices into pts, each row the
// point's k nearest), out (n, 3) float32 when normals is set, else
// (n, 3, 3) float32. All on the current device; launched on `stream`:
// ceil(n / 32) CTAs of 128 threads.
extern "C" int nsc_knn_pca(const void* pts, const void* idx, void* out,
                           int n, int k, int normals, float eps,
                           void* stream) {
  if (n < 1 || k < 1) return (int)cudaErrorInvalidValue;
  knn_pca_kernel<<<(n + kPointsPerCta - 1) / kPointsPerCta, kThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(pts), static_cast<const long long*>(idx),
      static_cast<float*>(out), n, k, normals, eps);
  return (int)cudaGetLastError();
}

// The kernel's function, for the census of captured graphs
// (nsc_graph_census in project.cu).
extern "C" const void* nsc_knn_pca_kernel_handle() {
  return reinterpret_cast<const void*>(knn_pca_kernel);
}
