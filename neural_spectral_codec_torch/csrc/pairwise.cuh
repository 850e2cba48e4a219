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
#pragma once

#include <cstdint>

#include <cuda_runtime.h>

namespace nsc {

constexpr unsigned kFullMask = 0xffffffffu;

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

// One candidate tile entry: the point and 1 (valid) or 0 (masked).
__device__ __forceinline__ float4 tile_entry(const float* __restrict__ pts,
                                             const uint8_t* __restrict__ mask,
                                             int j) {
  return make_float4(__ldg(pts + 3 * j), __ldg(pts + 3 * j + 1),
                     __ldg(pts + 3 * j + 2), __ldg(mask + j) ? 1.0f : 0.0f);
}

}  // namespace nsc
