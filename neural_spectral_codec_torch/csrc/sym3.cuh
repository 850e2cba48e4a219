// A symmetric eigen-solve in one thread's registers, shared by kernel C
// (knn_pca.cu: the 3 x 3 k-NN covariance of a point) and kernel R
// (kabsch.cu: Horn's 4 x 4 quaternion matrix of a point-to-point step).
//
// Cyclic Jacobi in float64 with a fixed number of sweeps: each sweep
// rotates the pairs (p, q), p < q, in row order, each rotation zeroing
// a[p][q] (Golub and Van Loan, sym.schur2; the numbers of Numerical
// Recipes' jacobi):
//     theta = (a_qq - a_pp) / (2 a_pq),
//     t = sign(theta) / (|theta| + sqrt(theta^2 + 1))   (sign(0) = +1),
//     c = 1 / sqrt(t^2 + 1), s = t c,
//     a_pp -= t a_pq, a_qq += t a_pq, a_pq = 0,
//     a_rp, a_rq = c a_rp - s a_rq, s a_rp + c a_rq       (r != p, q),
//     v_rp, v_rq = c v_rp - s v_rq, s v_rp + c v_rq       (every r).
// A pair whose a_pq is already 0 is skipped, so a converged matrix costs
// only the compares, and a zero matrix keeps V = I (kernel R's H = 0 gives
// the identity rotation). |theta| > 1e150 takes t = 1 / (2 theta), where
// theta^2 would overflow. A 3 x 3 matrix converges in 4 sweeps and a 4 x 4
// in 6 on random and near-degenerate inputs (off-diagonal 0 to the last
// bit; the numpy model in tests/test_torch_pca_kabsch.py reads
// kJacobiSweeps from here and checks it); 8 leave a margin. A NaN entry
// makes every output NaN.
//
// The loops over (p, q) and r unroll, so every index is known at compile
// time and the matrices stay in registers.
#pragma once

#include <cuda_runtime.h>

namespace nsc {

constexpr int kJacobiSweeps = 8;

template <int N>
__device__ __forceinline__ void jacobi_rotate(double (&a)[N][N],
                                              double (&v)[N][N], int p,
                                              int q) {
  const double apq = a[p][q];
  if (apq == 0.0) return;
  const double theta = (a[q][q] - a[p][p]) / (2.0 * apq);
  double t;
  if (fabs(theta) > 1e150) {
    t = 0.5 / theta;
  } else {
    t = (theta >= 0.0 ? 1.0 : -1.0) /
        (fabs(theta) + sqrt(theta * theta + 1.0));
  }
  const double c = 1.0 / sqrt(t * t + 1.0);
  const double s = t * c;
  a[p][p] -= t * apq;
  a[q][q] += t * apq;
  a[p][q] = 0.0;
  a[q][p] = 0.0;
#pragma unroll
  for (int r = 0; r < N; ++r) {
    if (r == p || r == q) continue;
    const double arp = a[r][p], arq = a[r][q];
    a[r][p] = a[p][r] = c * arp - s * arq;
    a[r][q] = a[q][r] = s * arp + c * arq;
  }
#pragma unroll
  for (int r = 0; r < N; ++r) {
    const double vrp = v[r][p], vrq = v[r][q];
    v[r][p] = c * vrp - s * vrq;
    v[r][q] = s * vrp + c * vrq;
  }
}

// Eigenvalues of the symmetric a left on its diagonal, eigenvectors in the
// columns of v (v[r][j] is component r of eigenvector j), unsorted.
template <int N>
__device__ __forceinline__ void jacobi_eigen(double (&a)[N][N],
                                             double (&v)[N][N]) {
#pragma unroll
  for (int r = 0; r < N; ++r) {
#pragma unroll
    for (int c = 0; c < N; ++c) v[r][c] = r == c ? 1.0 : 0.0;
  }
#pragma unroll 1
  for (int sweep = 0; sweep < kJacobiSweeps; ++sweep) {
#pragma unroll
    for (int p = 0; p < N - 1; ++p) {
#pragma unroll
      for (int q = p + 1; q < N; ++q) jacobi_rotate<N>(a, v, p, q);
    }
  }
}

}  // namespace nsc
