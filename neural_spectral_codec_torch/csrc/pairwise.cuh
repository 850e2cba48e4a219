// Shared device helpers of the verifier's two searches (nearest.cu, knn.cu).
//
// A squared distance is computed as the plain PyTorch version computes it
// (retrieval/nearest_kernel.py pairwise_d2): the three differences, their
// squares, then (dx^2 + dy^2) + dz^2, every operation rounded on its own
// (__fsub_rn / __fmul_rn / __fadd_rn). nvcc would otherwise contract a
// square and a sum into an FMA, which PyTorch's separate elementwise
// kernels never do, and the searches must pick the same index as the plain
// version bit for bit.
//
// A candidate is ordered by a 64-bit key: 32 bits that order its squared
// distance above, its index below. Squared distances are >= 0 or +inf (a
// masked candidate) or NaN, and the bits of non-negative floats order like
// the floats, so an integer comparison of keys orders by distance and then
// by the lower index, which is the tie rule of torch.argmin, jnp.argmin,
// lax.top_k and a stable sort.
//
// Both searches stage their candidates in shared memory as float4 entries
// (search_entry) that fold the mask into the point, so that the common path
// computes a distance with no select:
//   valid j:   (x, y, z, bits j)          bits of w >= 0
//   masked j:  (+inf, 0, 0, bits j | 1<<31)
//   padding:   (NaN, NaN, NaN, bits 0x7fffffff)
// From a finite point, a masked entry lies at +inf (x - inf = -inf, squared
// +inf), which is the masked distance. From a non-finite point that is not
// so (inf - inf is NaN), and a valid entry with a non-finite coordinate can
// give NaN; the kernels take an exact path there that tests w's sign
// (entry_valid). The index is w's low 31 bits (entry_index).
#pragma once

#include <cstdint>

#include <cuda_runtime.h>

namespace nsc {

constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kPadIndex = 0x7fffffff;

__device__ __forceinline__ float sq_dist(float ax, float ay, float az,
                                         float bx, float by, float bz) {
  const float dx = __fsub_rn(ax, bx);
  const float dy = __fsub_rn(ay, by);
  const float dz = __fsub_rn(az, bz);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                   __fmul_rn(dz, dz));
}

__device__ __forceinline__ unsigned long long pack_key(unsigned hi, int j) {
  return (static_cast<unsigned long long>(hi) << 32) | static_cast<unsigned>(j);
}

__device__ __forceinline__ int key_index(unsigned long long key) {
  return static_cast<int>(key & 0xffffffffull);
}

__device__ __forceinline__ bool finite3(float x, float y, float z) {
  return isfinite(x) && isfinite(y) && isfinite(z);
}

// Candidate j's shared-memory entry (see the header comment).
// All four loads are issued whatever the mask, so that a thread's loads of
// several entries are in flight together.
__device__ __forceinline__ float4 search_entry(const float* __restrict__ pts,
                                               const uint8_t* __restrict__ mask,
                                               int j) {
  const bool valid = __ldg(mask + j) != 0;
  const float x = __ldg(pts + 3 * j);
  const float y = __ldg(pts + 3 * j + 1);
  const float z = __ldg(pts + 3 * j + 2);
  return valid ? make_float4(x, y, z, __int_as_float(j))
               : make_float4(__int_as_float(0x7f800000), 0.0f, 0.0f,
                             __int_as_float(static_cast<int>(j | 0x80000000u)));
}

// The entry that fills a tile up to a whole group or batch: a valid point
// at NaN with the largest index, so that it orders after every candidate.
__device__ __forceinline__ float4 pad_entry() {
  const float nan = __int_as_float(0x7fffffff);
  return make_float4(nan, nan, nan, __int_as_float(kPadIndex));
}

__device__ __forceinline__ bool entry_valid(float4 e) {
  return __float_as_int(e.w) >= 0;
}

__device__ __forceinline__ int entry_index(float4 e) {
  return __float_as_int(e.w) & 0x7fffffff;
}

// Stages a tile: entries [0, padded) are candidates base .. base + n - 1,
// then padding (padded <= kPer * kThreads). A thread issues all its loads
// before its first store, so they are in flight together. Returns whether
// one of this thread's valid entries has a non-finite coordinate.
template <int kPer, int kThreads>
__device__ __forceinline__ bool stage_tile(float4* tile,
                                           const float* __restrict__ pts,
                                           const uint8_t* __restrict__ mask,
                                           int base, int n, int padded) {
  float4 e[kPer];
#pragma unroll
  for (int u = 0; u < kPer; ++u) {
    const int i = threadIdx.x + u * kThreads;
    e[u] = i < n ? search_entry(pts, mask, base + i) : pad_entry();
  }
  bool nonfinite = false;
#pragma unroll
  for (int u = 0; u < kPer; ++u) {
    const int i = threadIdx.x + u * kThreads;
    if (i < padded) tile[i] = e[u];
    nonfinite |= i < n && entry_valid(e[u]) && !finite3(e[u].x, e[u].y, e[u].z);
  }
  return nonfinite;
}

// The entry's distance from (px, py, pz) as the plain version has it: +inf
// for a masked entry. Exact from any point (the common path's sq_dist on
// the entry is exact only from a finite point).
__device__ __forceinline__ float entry_d2(float px, float py, float pz,
                                          float4 e) {
  return entry_valid(e) ? sq_dist(px, py, pz, e.x, e.y, e.z) : INFINITY;
}

}  // namespace nsc
