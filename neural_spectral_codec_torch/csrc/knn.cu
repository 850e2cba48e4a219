// Kernel K: the k nearest valid points of every point of one cloud.
//
// Not a Pallas kernel: the hand-written form of the k-NN selection inside
// the JAX package's per-cloud preparation,
// neural_spectral_codec_tpu/retrieval/verification.py _knn_cov_matrices
// (:64-73, run by the jitted _knn_covariances and _knn_normals): an
// all-pairs (P, P) distance matrix, masked columns at +inf, and
// lax.top_k(-d2, k). Its function, for pts (P, 3), mask (P,) and k <= 32:
//     d2[i, j] = mask[j] ? (dx^2 + dy^2) + dz^2 : +inf
//     idx[i, :] = the first k of row i in ascending d2, ties to the lower
//                 index (NaN after +inf)
// which is the order of lax.top_k and of a stable ascending sort. A row
// with fewer than k valid points is filled with masked indices in
// ascending order. The plain version is retrieval/knn_kernel.py knn_plain;
// this kernel gives its idx index for index.
//
// What bounds it on the H100: operations, as for kernel N (nearest.cu):
// P^2 distances of 9 operations, 151 M at P = 4,096, 4.5 us at 33.5 T
// non-FMA operations a second; the selection work depends on the data and
// is not counted in the bound. It runs once a prepared cloud (k = 20 for
// GICP covariances, 16 for normals).
//
// Design: one warp a row, 8 warps a CTA (512 CTAs at P = 4,096). The CTA
// stages the cloud in tiles of 1,024 float4 (x, y, z, valid) in shared
// memory. The warp keeps the 32 least 64-bit keys seen so far (pairwise.cuh),
// one a lane in ascending order, and walks its tile 32 candidates at a time
// (one a lane). A batch in which no lane's key is below the current k-th key
// (a ballot) is skipped; otherwise the batch is sorted across the lanes (a
// bitonic network of shuffles), merged with the list (the least of the list
// and the reversed batch, lane by lane, is bitonic) and cleaned (five
// shuffle steps). The skip keeps the common case at the cost of the
// distances. Deterministic: no atomics, one launch, no scratch.
#include <cstdint>

#include "pairwise.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kTile = 1024;
constexpr int kMaxK = 32;

// Ascending order: the distance (+inf after every finite one, NaN after
// +inf), then the index.
__device__ __forceinline__ unsigned long long order_key(float d2, int j) {
  return nsc::pack_key(isnan(d2) ? 0x7f800001u : __float_as_uint(d2), j);
}

__device__ __forceinline__ unsigned long long kmin(unsigned long long a,
                                                   unsigned long long b) {
  return a < b ? a : b;
}

__device__ __forceinline__ unsigned long long kmax(unsigned long long a,
                                                   unsigned long long b) {
  return a < b ? b : a;
}

// Sort one key a lane ascending across the warp (bitonic network).
__device__ __forceinline__ unsigned long long warp_sort(unsigned long long key,
                                                        int lane) {
#pragma unroll
  for (int size = 2; size <= 32; size <<= 1) {
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      const unsigned long long other =
          __shfl_xor_sync(nsc::kFullMask, key, stride);
      const bool ascending = (lane & size) == 0;   // size 32: every lane
      const bool lower = (lane & stride) == 0;
      key = lower == ascending ? kmin(key, other) : kmax(key, other);
    }
  }
  return key;
}

// A bitonic sequence across the warp, sorted ascending.
__device__ __forceinline__ unsigned long long warp_clean(unsigned long long key,
                                                         int lane) {
#pragma unroll
  for (int stride = 16; stride > 0; stride >>= 1) {
    const unsigned long long other =
        __shfl_xor_sync(nsc::kFullMask, key, stride);
    key = (lane & stride) == 0 ? kmin(key, other) : kmax(key, other);
  }
  return key;
}

__global__ void __launch_bounds__(kThreads)
knn_kernel(const float* __restrict__ pts, const uint8_t* __restrict__ mask,
           long long* __restrict__ idx, int n, int k) {
  __shared__ float4 tile[kTile];
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const bool active = row < n;       // warp-uniform
  float px = 0.0f, py = 0.0f, pz = 0.0f;
  if (active) {
    px = __ldg(pts + 3 * row);
    py = __ldg(pts + 3 * row + 1);
    pz = __ldg(pts + 3 * row + 2);
  }
  unsigned long long list = ~0ull;   // lane i: the i-th least key so far
  unsigned long long kth = ~0ull;    // the k-th least key so far
  for (int base = 0; base < n; base += kTile) {
    const int m = min(kTile, n - base);
    __syncthreads();                 // the last tile is consumed
    for (int t = threadIdx.x; t < m; t += kThreads)
      tile[t] = nsc::tile_entry(pts, mask, base + t);
    __syncthreads();
    if (!active) continue;
    for (int t0 = 0; t0 < m; t0 += 32) {   // warp-uniform bounds
      const int t = t0 + lane;
      unsigned long long key = ~0ull;
      if (t < m) {
        const float4 q = tile[t];
        const float d2 =
            q.w != 0.0f ? nsc::sq_dist(px, py, pz, q.x, q.y, q.z) : INFINITY;
        key = order_key(d2, base + t);
      }
      if (__ballot_sync(nsc::kFullMask, key < kth) == 0u) continue;
      key = warp_sort(key, lane);
      const unsigned long long reversed =
          __shfl_sync(nsc::kFullMask, key, 31 - lane);
      list = warp_clean(kmin(list, reversed), lane);
      kth = __shfl_sync(nsc::kFullMask, list, k - 1);
    }
  }
  if (active && lane < k) idx[(long long)row * k + lane] = nsc::key_index(list);
}

}  // namespace

// pts (n, 3) float32, mask (n,) bool (one byte each), idx (n, k) int64, all
// contiguous on the current device; 1 <= k <= min(32, n). Returns
// cudaGetLastError() after the launch.
extern "C" int nsc_knn(const void* pts, const void* mask, void* idx, int n,
                       int k, void* stream) {
  if (n < 1 || k < 1 || k > kMaxK || k > n) return (int)cudaErrorInvalidValue;
  knn_kernel<<<(n + kWarps - 1) / kWarps, kThreads, 0,
               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(pts), static_cast<const uint8_t*>(mask),
      static_cast<long long*>(idx), n, k);
  return (int)cudaGetLastError();
}

// The kernel's function, for the census of captured graphs
// (nsc_graph_census in project.cu).
extern "C" const void* nsc_knn_kernel_handle() {
  return reinterpret_cast<const void*>(knn_kernel);
}
