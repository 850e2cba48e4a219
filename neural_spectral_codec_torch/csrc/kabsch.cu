// Kernel R: the whole point-to-point ICP update after the correspondence
// search, from kernel N's (j, d2) to the step's transform.
//
// Not a Pallas kernel: the hand-written form of the XLA work of the JAX
// package's registration program after its argmin,
// neural_spectral_codec_tpu/retrieval/verification.py _icp_kernel
// (correspondences :129-131 and p2p_step :133-146):
//     w    = src_mask & (sqrt(d2) <= max_corr)        (float32 compare)
//     q    = dst[j]
//     sw   = max(sum w, 1e-6)
//     p_c  = sum w src / sw,  q_c = sum w q / sw
//     H    = sum ((src - p_c) w) (q - q_c)^T          (3 x 3)
//     U, S, V^T = svd(H),  d = sign(det(V U^T)),
//     R = V diag(1, 1, d) U^T,  t = q_c - R p_c,  Tn = [R t; 0 0 0 1].
// That R is the proper rotation that maximises trace(R H). So is the one
// of Horn's unit quaternion (Horn 1987, "Closed-form solution of absolute
// orientation using unit quaternions"): the eigenvector of the largest
// eigenvalue of the symmetric 4 x 4
//     [ Sxx+Syy+Szz  Syz-Szy      Szx-Sxz      Sxy-Syx     ]
//     [ Syz-Szy      Sxx-Syy-Szz  Sxy+Syx      Szx+Sxz     ]
//     [ Szx-Sxz      Sxy+Syx     -Sxx+Syy-Szz  Syz+Szy     ]
//     [ Sxy-Syx      Szx+Sxz      Syz+Szy     -Sxx-Syy+Szz ]
// with S = H, solved with sym3.cuh's Jacobi in float64 in one thread's
// registers (horn_solve), so that neither svd nor det (both of which copy
// through the host in PyTorch's CUDA path) is left in the step. Where the
// optimum is unique (H of rank 2 or 3 whose two smaller singular values
// differ, a reflection included) the two formulas give the same R; for
// H = 0 (no point matched) the Jacobi solve leaves the identity and the
// first of the four equal eigenvalues is taken, q = (1, 0, 0, 0), R = I,
// as JAX's SVD of 0 gives; for H of rank 1 every rotation that maps the
// one direction onto the other is optimal and the kernel returns one of
// them, a proper rotation.
//
// Everything after the compare is float64 from the float32 inputs, and T
// is rounded once; the products are formed as the plain version forms
// them (w src, w q, (src - p_c) w times q - q_c), so a NaN where w = 0
// spreads as it does there. The plain version is retrieval/pca_kernel.py
// p2p_update_plain: the same step in float32, ending in kabsch_plain
// (JAX's formula with torch.linalg.svd and det). The two differ by the
// float32 sums' and solve's error.
//
// What bounds it on the H100: bytes. At P = Q = 4,096 it reads src 48 KB,
// the mask 4 KB, j 32 KB, d2 16 KB and the 48 KB gather of dst, and writes
// T's 64 B: 150 KB, 0.045 us at 3.35 TB/s; its operations (~40 a point)
// are 0.16 M, 0.005 us. What limits it is latency: the dependent loads
// (j, then dst[j]), two reductions across the CTAs and one thread's chain
// of float64 rotations (4 x 4: at most 6 sweeps that rotate, about 30
// rotations, one root and one rsqrt each).
//
// Design: one launch a step, a thread-block cluster of `ctas` CTAs of
// kThreads threads (8 CTAs of 256 at P = 4,096, so 2 points a thread, on
// neighbouring SMs).
//   * Points. Thread t of rank r (global g = r * kThreads + t) takes points
//     g, g + G, g + 2 G, ... (G = ctas * kThreads), the first kPer of them
//     held in registers across both passes (P <= 8,192 at 8 CTAs); points
//     past them are loaded again for the second pass.
//   * Pass 1: sw, sum w src and sum w q, 7 float64 sums a thread in point
//     order, then the CTA's: a xor butterfly over the warp, the warps'
//     sums by warp 0 in the same way, in fixed order. Warp 0 stores the
//     rank's 7 sums into every rank's shared memory (distributed shared
//     memory); after one cluster barrier each rank adds the ranks' sums in
//     rank order, so every rank holds the same p_c and q_c.
//   * Pass 2: the 9 sums of H from the registers, reduced the same way;
//     each rank stores its 9 into rank 0, one more cluster barrier, and
//     rank 0 adds them in rank order.
//   * Solve: one thread of rank 0 builds Horn's matrix, solves it
//     (sym3.cuh), forms R and t = q_c - R p_c and writes T.
// A rank stores into another's shared memory only after the barrier that
// shows every rank has started (cluster_arrive at entry, cluster_wait
// before the first remote store), and rank 0 reads its own shared memory
// only. No atomics, no scratch: deterministic, so a graph replay equals
// the eager step bit for bit.
//
// A second entry point, nsc_kabsch_solve, runs the same horn_solve on a
// given H, p_c and q_c (one warp, lane 0 working). It is not on the main
// path: tests and chip_smoke.py hold the solve on its edge cases with it.
#include <cooperative_groups.h>

#include "sym3.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;           // a CTA of the update
constexpr int kMaxCtas = 8;             // a portable cluster
constexpr int kPer = 4;                 // points a thread holds
constexpr int kSums1 = 7;               // sw, sum w src, sum w q
constexpr int kSums2 = 9;               // H
constexpr unsigned kFullMask = 0xffffffffu;

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// T (4 x 4 row-major float32) from S = H, p_c and q_c in float64.
__device__ __forceinline__ void horn_solve(const double (&h)[9],
                                           const double (&pc)[3],
                                           const double (&qc)[3],
                                           float* __restrict__ t_out) {
  const double sxx = h[0], sxy = h[1], sxz = h[2];
  const double syx = h[3], syy = h[4], syz = h[5];
  const double szx = h[6], szy = h[7], szz = h[8];
  double a[4][4] = {
      {sxx + syy + szz, syz - szy, szx - sxz, sxy - syx},
      {syz - szy, sxx - syy - szz, sxy + syx, szx + sxz},
      {szx - sxz, sxy + syx, -sxx + syy - szz, syz + szy},
      {sxy - syx, szx + sxz, syz + szy, -sxx - syy + szz}};
  double v[4][4];
  nsc::jacobi_eigen<4>(a, v);
  // the eigenvector of the largest eigenvalue, the first of equal ones
  int top = 0;
  double best = a[0][0];
#pragma unroll
  for (int j = 1; j < 4; ++j) {
    if (a[j][j] > best) {
      best = a[j][j];
      top = j;
    }
  }
  double q[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    q[r] = top == 0 ? v[r][0]
                    : (top == 1 ? v[r][1] : (top == 2 ? v[r][2] : v[r][3]));
  }
  const double inv =
      1.0 / sqrt(q[0] * q[0] + q[1] * q[1] + q[2] * q[2] + q[3] * q[3]);
  const double w = q[0] * inv, x = q[1] * inv, y = q[2] * inv,
               z = q[3] * inv;
  const double rot[3][3] = {
      {w * w + x * x - y * y - z * z, 2.0 * (x * y - w * z),
       2.0 * (x * z + w * y)},
      {2.0 * (y * x + w * z), w * w - x * x + y * y - z * z,
       2.0 * (y * z - w * x)},
      {2.0 * (z * x - w * y), 2.0 * (z * y + w * x),
       w * w - x * x - y * y + z * z}};
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    const double tr =
        qc[r] - (rot[r][0] * pc[0] + rot[r][1] * pc[1] + rot[r][2] * pc[2]);
#pragma unroll
    for (int s = 0; s < 3; ++s) {
      t_out[4 * r + s] = static_cast<float>(rot[r][s]);
    }
    t_out[4 * r + 3] = static_cast<float>(tr);
  }
  t_out[12] = 0.0f;
  t_out[13] = 0.0f;
  t_out[14] = 0.0f;
  t_out[15] = 1.0f;
}

// The sum of each v[i] over the warp, the same bits in every lane.
template <int K>
__device__ __forceinline__ void warp_sums(double (&v)[K]) {
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
#pragma unroll
    for (int i = 0; i < K; ++i) v[i] += __shfl_xor_sync(kFullMask, v[i], off);
  }
}

// The CTA's sums of v (every thread's), in warp 0's registers: each
// warp's butterfly, then warp 0's over the warps' sums (zeros past
// kWarps). `part` is kWarps * K doubles of shared memory, free on entry.
template <int kWarps, int K>
__device__ __forceinline__ void cta_sums(double (&v)[K], double* part) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  warp_sums<K>(v);
  if (lane == 0) {
#pragma unroll
    for (int i = 0; i < K; ++i) part[warp * K + i] = v[i];
  }
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int i = 0; i < K; ++i) v[i] = lane < kWarps ? part[lane * K + i] : 0.0;
    warp_sums<K>(v);
  }
}

struct Point {
  float w, px, py, pz, qx, qy, qz;
};

__device__ __forceinline__ Point load_point(
    const float* __restrict__ src, const bool* __restrict__ mask,
    const float* __restrict__ dst, const long long* __restrict__ j,
    const float* __restrict__ d2, float max_corr, int i) {
  const long long jj = __ldg(j + i);
  const float dist = sqrtf(__ldg(d2 + i));
  Point p;
  p.w = (mask[i] && dist <= max_corr) ? 1.0f : 0.0f;
  p.px = __ldg(src + 3 * i);
  p.py = __ldg(src + 3 * i + 1);
  p.pz = __ldg(src + 3 * i + 2);
  p.qx = __ldg(dst + 3 * jj);
  p.qy = __ldg(dst + 3 * jj + 1);
  p.qz = __ldg(dst + 3 * jj + 2);
  return p;
}

__device__ __forceinline__ void add_first(double (&s)[kSums1],
                                          const Point& p) {
  const double w = p.w;
  s[0] += w;
  s[1] += static_cast<double>(p.px) * w;
  s[2] += static_cast<double>(p.py) * w;
  s[3] += static_cast<double>(p.pz) * w;
  s[4] += static_cast<double>(p.qx) * w;
  s[5] += static_cast<double>(p.qy) * w;
  s[6] += static_cast<double>(p.qz) * w;
}

__device__ __forceinline__ void add_second(double (&s)[kSums2],
                                           const Point& p,
                                           const double (&pc)[3],
                                           const double (&qc)[3]) {
  const double w = p.w;
  const double a[3] = {(p.px - pc[0]) * w, (p.py - pc[1]) * w,
                       (p.pz - pc[2]) * w};
  const double b[3] = {p.qx - qc[0], p.qy - qc[1], p.qz - qc[2]};
#pragma unroll
  for (int r = 0; r < 3; ++r) {
#pragma unroll
    for (int s2 = 0; s2 < 3; ++s2) s[3 * r + s2] += a[r] * b[s2];
  }
}

// v[i] without indexing registers by a run-time i.
template <int K>
__device__ __forceinline__ double pick(const double (&v)[K], int i) {
  double out = 0.0;
#pragma unroll
  for (int k = 0; k < K; ++k) out = i == k ? v[k] : out;
  return out;
}

__global__ void __launch_bounds__(kThreads, 1)
    p2p_update_kernel(const float* __restrict__ src,
                      const bool* __restrict__ mask,
                      const float* __restrict__ dst,
                      const long long* __restrict__ j,
                      const float* __restrict__ d2,
                      float* __restrict__ t_out, int n, float max_corr) {
  constexpr int kWarps = kThreads / 32;
  __shared__ double part[kWarps * kSums2];
  __shared__ double ranks1[kMaxCtas * kSums1];  // every rank's pass-1 sums
  __shared__ double ranks2[kMaxCtas * kSums2];  // rank 0: pass-2 sums
  __shared__ double centre[kSums1];             // the cluster's pass-1 sums
  cluster_arrive();                   // waited for before the first store
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int ctas = (int)gridDim.x;              // the grid is one cluster
  const int stride = ctas * kThreads;
  const int first = rank * kThreads + threadIdx.x;

  Point pts[kPer];
#pragma unroll
  for (int m = 0; m < kPer; ++m) {
    const int i = first + m * stride;
    pts[m] = Point{0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    if (i < n) pts[m] = load_point(src, mask, dst, j, d2, max_corr, i);
  }
  double s1[kSums1] = {};
#pragma unroll
  for (int m = 0; m < kPer; ++m) {
    if (first + m * stride < n) add_first(s1, pts[m]);
  }
  for (int i = first + kPer * stride; i < n; i += stride)
    add_first(s1, load_point(src, mask, dst, j, d2, max_corr, i));
  cta_sums<kWarps, kSums1>(s1, part);
  cluster_wait();
  if (threadIdx.x < kSums1) {        // warp 0: the rank's sums to every rank
    const double mine = pick<kSums1>(s1, threadIdx.x);
    for (int r = 0; r < ctas; ++r)
      cluster.map_shared_rank(ranks1, r)[rank * kSums1 + threadIdx.x] = mine;
  }
  cluster.sync();
  if (threadIdx.x < kSums1) {
    double total = 0.0;
    for (int r = 0; r < ctas; ++r) total += ranks1[r * kSums1 + threadIdx.x];
    centre[threadIdx.x] = total;
  }
  __syncthreads();
  const double sw = fmax(centre[0], 1e-6);
  double pc[3], qc[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    pc[i] = centre[1 + i] / sw;
    qc[i] = centre[4 + i] / sw;
  }

  double s2[kSums2] = {};
#pragma unroll
  for (int m = 0; m < kPer; ++m) {
    if (first + m * stride < n) add_second(s2, pts[m], pc, qc);
  }
  for (int i = first + kPer * stride; i < n; i += stride)
    add_second(s2, load_point(src, mask, dst, j, d2, max_corr, i), pc, qc);
  cta_sums<kWarps, kSums2>(s2, part);
  if (threadIdx.x < kSums2)
    cluster.map_shared_rank(ranks2, 0)[rank * kSums2 + threadIdx.x] =
        pick<kSums2>(s2, threadIdx.x);
  cluster.sync();
  if (rank != 0) return;
  if (threadIdx.x < kSums2) {
    double total = 0.0;
    for (int r = 0; r < ctas; ++r) total += ranks2[r * kSums2 + threadIdx.x];
    part[threadIdx.x] = total;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    double h[9];
#pragma unroll
    for (int i = 0; i < 9; ++i) h[i] = part[i];
    horn_solve(h, pc, qc, t_out);
  }
}

__global__ void __launch_bounds__(32)
    kabsch_solve_kernel(const float* __restrict__ h,
                        const float* __restrict__ pc,
                        const float* __restrict__ qc,
                        float* __restrict__ t_out) {
  if (threadIdx.x != 0) return;
  double hh[9], p[3], q[3];
#pragma unroll
  for (int i = 0; i < 9; ++i) hh[i] = h[i];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    p[i] = pc[i];
    q[i] = qc[i];
  }
  horn_solve(hh, p, q, t_out);
}

}  // namespace

// The point-to-point update: src (n, 3) float32, mask (n,) bool (one byte
// each), dst (>= 1, 3) float32, j (n,) int64 (indices into dst: kernel N's
// output), d2 (n,) float32, t_out (4, 4) float32 row-major, all contiguous
// on the current device; n >= 1. One cluster of `ctas` (1 to 8) CTAs of
// kThreads threads, launched on `stream`. Returns cudaGetLastError() after
// the launch (a refused cluster is an error, never a fallback).
extern "C" int nsc_kabsch(const void* src, const void* mask, const void* dst,
                          const void* j, const void* d2, void* t_out, int n,
                          float max_corr, int ctas, void* stream) {
  if (n < 1 || ctas < 1 || ctas > kMaxCtas) return (int)cudaErrorInvalidValue;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(ctas, 1, 1);
  config.blockDim = dim3(kThreads, 1, 1);
  config.dynamicSmemBytes = 0;
  config.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = ctas;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  config.attrs = attr;
  config.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &config, p2p_update_kernel, static_cast<const float*>(src),
      static_cast<const bool*>(mask), static_cast<const float*>(dst),
      static_cast<const long long*>(j), static_cast<const float*>(d2),
      static_cast<float*>(t_out), n, max_corr);
  const cudaError_t last = cudaGetLastError();      // and clear it
  return (int)(err != cudaSuccess ? err : last);
}

// The solve alone: h (3, 3), pc (3,), qc (3,) float32 in, t_out (4, 4)
// float32 row-major out, all on the current device; launched on `stream`.
extern "C" int nsc_kabsch_solve(const void* h, const void* pc, const void* qc,
                                void* t_out, void* stream) {
  kabsch_solve_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(h), static_cast<const float*>(pc),
      static_cast<const float*>(qc), static_cast<float*>(t_out));
  return (int)cudaGetLastError();
}

// The update's function, for the census of captured graphs
// (nsc_graph_census in project.cu).
extern "C" const void* nsc_kabsch_kernel_handle() {
  return reinterpret_cast<const void*>(p2p_update_kernel);
}
