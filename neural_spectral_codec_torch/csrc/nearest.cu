// Kernel N: the nearest valid target of every source point.
//
// Not a Pallas kernel: the hand-written form of the correspondence search
// inside the JAX package's registration program,
// neural_spectral_codec_tpu/retrieval/verification.py _icp_kernel
// (correspondences, :124-131): an all-pairs (P, Q) distance matrix, masked
// targets at +inf, and a row argmin. Its function, for moved (P, 3), dst
// (Q, 3) and dst_mask (Q,):
//     d2[i, j] = dst_mask[j] ? (dx^2 + dy^2) + dz^2 : +inf
//     j_out[i] = argmin_j d2[i, j]   (first NaN, else the least, ties to the
//                                     lower index: torch.argmin, jnp.argmin)
//     d2_out[i] = d2[i, j_out[i]]
// The plain version is retrieval/nearest_kernel.py nearest_plain; this
// kernel gives its j_out and d2_out bit for bit (a NaN distance as the
// card's canonical NaN).
//
// What bounds it on the H100: operations. At P = Q = 4,096 (the verifier's
// default) it reads 114,688 B and writes 49,152 B, but computes 16.8 M
// distances of 9 operations each (3 subtractions, 3 products, 2 sums, 1
// comparison), none of which may fuse into an FMA: 151 M operations,
// 4.5 us at the fp32 rate of 33.5 T non-FMA operations a second. A
// registration runs it 31 times (30 Gauss-Newton steps and the final
// fitness), all inside one captured CUDA graph.
//
// Design: one warp a source point, 8 warps (256 threads) a CTA, so P = 4,096
// makes 512 CTAs for 132 SMs (one thread a source point would make 32 CTAs of
// 128 and leave most SMs idle). The CTA stages the targets in tiles of 1,024
// float4 (x, y, z, valid) in shared memory; each lane of a warp takes every
// 32nd target of a tile and keeps the least 64-bit key (pairwise.cuh; NaN
// maps below every distance so that the first NaN wins, as in argmin); five
// shuffles reduce the warp's keys to the row's answer. Deterministic: no
// atomics, one launch, no scratch.
#include <cstdint>

#include "pairwise.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kTile = 1024;

// Argmin order: NaN first (bits 0), then the distance (its bits + 1), then
// the index.
__device__ __forceinline__ unsigned long long argmin_key(float d2, int j) {
  return nsc::pack_key(isnan(d2) ? 0u : __float_as_uint(d2) + 1u, j);
}

__global__ void __launch_bounds__(kThreads)
nearest_kernel(const float* __restrict__ moved, const float* __restrict__ dst,
               const uint8_t* __restrict__ dst_mask,
               long long* __restrict__ j_out, float* __restrict__ d2_out,
               int n_src, int n_dst) {
  __shared__ float4 tile[kTile];
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const bool active = row < n_src;   // warp-uniform
  float mx = 0.0f, my = 0.0f, mz = 0.0f;
  if (active) {
    mx = __ldg(moved + 3 * row);
    my = __ldg(moved + 3 * row + 1);
    mz = __ldg(moved + 3 * row + 2);
  }
  unsigned long long best = ~0ull;
  for (int base = 0; base < n_dst; base += kTile) {
    const int n = min(kTile, n_dst - base);
    __syncthreads();                 // the last tile is consumed
    for (int t = threadIdx.x; t < n; t += kThreads)
      tile[t] = nsc::tile_entry(dst, dst_mask, base + t);
    __syncthreads();
    if (active) {
#pragma unroll 4
      for (int t = lane; t < n; t += 32) {
        const float4 q = tile[t];
        const float d2 =
            q.w != 0.0f ? nsc::sq_dist(mx, my, mz, q.x, q.y, q.z) : INFINITY;
        const unsigned long long key = argmin_key(d2, base + t);
        best = key < best ? key : best;
      }
    }
  }
  if (!active) return;               // after the last barrier
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const unsigned long long other = __shfl_xor_sync(nsc::kFullMask, best, off);
    best = other < best ? other : best;
  }
  if (lane == 0) {
    const unsigned hi = static_cast<unsigned>(best >> 32);
    j_out[row] = nsc::key_index(best);
    d2_out[row] = hi == 0u ? __int_as_float(0x7fffffff)
                           : __uint_as_float(hi - 1u);
  }
}

}  // namespace

// moved (n_src, 3) and dst (n_dst, 3) float32, dst_mask (n_dst,) bool (one
// byte each), j_out (n_src,) int64 and d2_out (n_src,) float32, all
// contiguous on the current device; n_src, n_dst >= 1. Returns
// cudaGetLastError() after the launch.
extern "C" int nsc_nearest(const void* moved, const void* dst,
                           const void* dst_mask, void* j_out, void* d2_out,
                           int n_src, int n_dst, void* stream) {
  if (n_src < 1 || n_dst < 1) return (int)cudaErrorInvalidValue;
  nearest_kernel<<<(n_src + kWarps - 1) / kWarps, kThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(moved), static_cast<const float*>(dst),
      static_cast<const uint8_t*>(dst_mask), static_cast<long long*>(j_out),
      static_cast<float*>(d2_out), n_src, n_dst);
  return (int)cudaGetLastError();
}

// The kernel's function, for the census of captured graphs
// (nsc_graph_census in project.cu).
extern "C" const void* nsc_nearest_kernel_handle() {
  return reinterpret_cast<const void*>(nearest_kernel);
}
