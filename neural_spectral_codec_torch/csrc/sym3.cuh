// A symmetric eigen-solve in one thread's registers, shared by kernel C
// (knn_pca.cu: the 3 x 3 k-NN covariance of a point) and kernel R
// (kabsch.cu: Horn's 4 x 4 quaternion matrix of a point-to-point step).
//
// Cyclic Jacobi in float64: each sweep visits the pairs (p, q), p < q, in
// row order, and a rotation zeroes a[p][q] (Golub and Van Loan,
// sym.schur2). The rotation costs one square root and one reciprocal
// square root, no division. With d = a_qq - a_pp, u = |d|,
// sgn = +1 where d >= 0, else -1:
//     r = sqrt(d^2 + 4 a_pq^2),  m = rsqrt(2 r (u + r)),
//     c = (u + r) m,  s = 2 a_pq sgn m,  (t a_pq =) ta = sgn s^2 r,
// which is the textbook t = sgn(theta) / (|theta| + sqrt(theta^2 + 1)),
// theta = d / (2 a_pq), c = 1 / sqrt(t^2 + 1), s = t c, written without
// theta (c^2 = (u + r) / (2 r), t a_pq = 2 a_pq^2 sgn / (u + r)); then
//     a_pp -= ta, a_qq += ta, a_pq = 0,
//     a_rp, a_rq = c a_rp - s a_rq, s a_rp + c a_rq       (r != p, q),
//     v_rp, v_rq = c v_rp - s v_rq, s v_rp + c v_rq       (every r).
// Where max(u, 2 |a_pq|) lies outside [kJacobiTiny, kJacobiHuge], d^2 or
// the product under the rsqrt could overflow or underflow: d and 2 a_pq
// are divided by that maximum first (the overflow guard; r and ta scaled
// back).
//
// Convergence: a pair whose |a_pq| is negligible against both of its
// diagonal entries in float64 (|a_pp| + |a_pq| == |a_pp| and the same for
// a_qq: below half an ulp of each, the test of Numerical Recipes' jacobi
// after its first sweeps) is skipped, and the sweeps stop after the first
// one that rotated no pair. On random, near-degenerate, repeated-
// eigenvalue, rank-deficient and planar or collinear inputs a 3 x 3
// matrix rotates in at most 5 sweeps and a 4 x 4 in at most 6, then one
// sweep of compares ends the solve (the numpy model in
// tests/test_torch_pca_kabsch.py reads kJacobiMaxSweeps, kJacobiHuge and
// kJacobiTiny from here and checks it). kJacobiMaxSweeps bounds the
// sweeps for inputs that never converge (a NaN entry, which is never
// negligible and makes every output NaN).
//
// The contract of the earlier fixed-sweep solve stands: a zero matrix
// keeps V = I (every pair is negligible, so kernel R's H = 0 gives the
// identity rotation), the callers take the first of equal eigenvalues,
// and a NaN entry gives NaN outputs. Inputs are float32 values widened to
// float64, and the callers round their outputs once.
//
// The loops over (p, q) and r unroll, so every index is known at compile
// time and the matrices stay in registers.
#pragma once

#include <cuda_runtime.h>

namespace nsc {

constexpr int kJacobiMaxSweeps = 10;
constexpr double kJacobiHuge = 1e150;
constexpr double kJacobiTiny = 1e-150;

// One rotation of the pair (p, q); false (nothing done) where a_pq is
// negligible against both diagonal entries.
template <int N>
__device__ __forceinline__ bool jacobi_rotate(double (&a)[N][N],
                                              double (&v)[N][N], int p,
                                              int q) {
  const double apq = a[p][q];
  const double app = a[p][p], aqq = a[q][q];
  const double g = fabs(apq);
  // written so that a NaN anywhere rotates (and spreads)
  if (fabs(app) + g == fabs(app) && fabs(aqq) + g == fabs(aqq)) return false;
  const double d = aqq - app;
  const double u = fabs(d);
  const double sgn = d >= 0.0 ? 1.0 : -1.0;
  const double big = fmax(u, 2.0 * g);
  double un = u, dn = d, an = 2.0 * apq, scale = 1.0;
  if (!(big <= kJacobiHuge && big >= kJacobiTiny)) {
    scale = big;
    un = u / big;
    dn = d / big;
    an = an / big;
  }
  const double root = sqrt(dn * dn + an * an);      // r / scale
  const double m = rsqrt(2.0 * root * (un + root));  // m * scale
  const double c = (un + root) * m;
  const double s = an * sgn * m;
  const double ta = sgn * s * s * root * scale;
  a[p][p] = app - ta;
  a[q][q] = aqq + ta;
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
  return true;
}

// Eigenvalues of the symmetric a left on its diagonal, eigenvectors in the
// columns of v (v[r][j] is component r of eigenvector j), unsorted.
// Returns the sweeps that rotated at least one pair.
template <int N>
__device__ __forceinline__ int jacobi_eigen(double (&a)[N][N],
                                            double (&v)[N][N]) {
#pragma unroll
  for (int r = 0; r < N; ++r) {
#pragma unroll
    for (int c = 0; c < N; ++c) v[r][c] = r == c ? 1.0 : 0.0;
  }
  int sweep = 0;
#pragma unroll 1
  for (; sweep < kJacobiMaxSweeps; ++sweep) {
    bool rotated = false;
#pragma unroll
    for (int p = 0; p < N - 1; ++p) {
#pragma unroll
      for (int q = p + 1; q < N; ++q)
        rotated = jacobi_rotate<N>(a, v, p, q) || rotated;
    }
    if (!rotated) break;
  }
  return sweep;
}

}  // namespace nsc
