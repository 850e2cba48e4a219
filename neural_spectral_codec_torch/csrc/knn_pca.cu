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
// formulas in float32 with torch.linalg.eigh. Here one thread takes one
// point and works in float64 from the float32 points: the mean and the
// centred sum in JAX's order, the 3 x 3 Jacobi solve of sym3.cuh in
// registers, n normalised, the output rounded once. So the kernel is the
// more exact of the two; they differ by the float32 solve's error, which
// grows as lambda_max / (lambda_1 - lambda_0): tests and chip_smoke.py
// hold them to 1e-5 (covariances) and 1 - |cos| <= 1e-4 (normals) on rows
// whose relative eigen-gap makes that error small, and rows below it to
// the invariants (symmetric, eigenvalues {eps, 1, 1}, n a unit vector in
// the span of the two smallest eigenvectors). Every row of a prepared
// cloud is finite: padded rows (their neighbours are the valid points
// nearest the origin), rows with masked neighbours (padding zeros), equal
// points and collinear neighbourhoods. A NaN point gives NaN rows.
//
// What bounds it on the H100: bytes, at the verifier's P = 4,096 and
// k = 20: idx 655 KB, pts 49 KB, out 147 KB (covariances), 0.25 us at
// 3.35 TB/s; the float32 operations of the covariances (mean, centring,
// 6 products and sums a neighbour) are 1.5 M, 0.02 us. What limits it is
// latency: one launch of 4,096 threads on 64 CTAs, each a chain of
// dependent float64 divisions and square roots (24 rotations, 2 roots and
// 2 divisions each, most skipped once the matrix has converged). One
// launch a prepared cloud, no atomics, no scratch: deterministic.
#include "sym3.cuh"

namespace {

constexpr int kThreads = 64;

__global__ void __launch_bounds__(kThreads)
    knn_pca_kernel(const float* __restrict__ pts,
                   const long long* __restrict__ idx,
                   float* __restrict__ out, int n, int k, int normals,
                   float eps) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const long long* row = idx + static_cast<long long>(i) * k;
  double mean[3] = {0.0, 0.0, 0.0};
  for (int j = 0; j < k; ++j) {
    const float* p = pts + 3 * row[j];
    mean[0] += p[0];
    mean[1] += p[1];
    mean[2] += p[2];
  }
#pragma unroll
  for (int r = 0; r < 3; ++r) mean[r] /= k;
  double a[3][3] = {};
  for (int j = 0; j < k; ++j) {
    const float* p = pts + 3 * row[j];
    const double c[3] = {p[0] - mean[0], p[1] - mean[1], p[2] - mean[2]};
#pragma unroll
    for (int r = 0; r < 3; ++r) {
#pragma unroll
      for (int s = r; s < 3; ++s) a[r][s] += c[r] * c[s];
    }
  }
#pragma unroll
  for (int r = 0; r < 3; ++r) {
#pragma unroll
    for (int s = r; s < 3; ++s) {
      a[r][s] /= k;
      a[s][r] = a[r][s];
    }
  }
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
  if (normals) {
    float* o = out + 3 * static_cast<long long>(i);
#pragma unroll
    for (int r = 0; r < 3; ++r) o[r] = static_cast<float>(nv[r]);
    return;
  }
  const double squash = 1.0 - static_cast<double>(eps);
  float* o = out + 9 * static_cast<long long>(i);
#pragma unroll
  for (int r = 0; r < 3; ++r) {
#pragma unroll
    for (int s = 0; s < 3; ++s) {
      o[3 * r + s] =
          static_cast<float>((r == s ? 1.0 : 0.0) - squash * nv[r] * nv[s]);
    }
  }
}

}  // namespace

// pts (n, 3) float32, idx (n, k) int64 (indices into pts, each row the
// point's k nearest), out (n, 3) float32 when normals is set, else
// (n, 3, 3) float32. All on the current device; launched on `stream`.
extern "C" int nsc_knn_pca(const void* pts, const void* idx, void* out,
                           int n, int k, int normals, float eps,
                           void* stream) {
  if (n < 1 || k < 1) return (int)cudaErrorInvalidValue;
  knn_pca_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0,
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
