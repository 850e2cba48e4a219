// Kernel G: the backward of a row gather, summed without atomics.
//
// Not a Pallas kernel: the hand-written form of the transpose that XLA
// derives for the row gathers inside the JAX package's train step,
// neural_spectral_codec_tpu/training/trainer.py train_step (:73; the
// triplet gathers emb[anchor_idx], emb[pos_idx], emb[neg_idx], :86) and
// models/gnn.py EdgeGATLayer (the neighbour gather jnp.take(h, neighbors),
// :70). Its
// function, for the gradient grad (P, C) of out = src.index_select(0, idx)
// and a segment table of idx (models/gather_kernel.py make_plan):
//     dsrc[r, :] = sum over the positions p with idx[p] == r, in increasing
//                  order of p, of grad[p, :]
// summed in float32 from +0, one rounded add at a time, and rounded once to
// the row's type at the end (float32, or bfloat16): the same float additions
// in the same order as the CPU's sequential index_add_ into zeros (which
// also sums bfloat16 rows in float32 and rounds once), so the result is
// bit-equal to it, and to the plain version
// (gather_kernel.gather_bwd_plain), on every run. On the card PyTorch's
// index_add_ adds with atomics in an order that changes from run to run
// (bfloat16 atomics round every add).
//
// The segment table (order, offsets): order holds the positions p stably
// sorted by idx[p], offsets[r] .. offsets[r + 1] the part of order whose
// positions gather row r. Positions left out of every segment (a plan may
// drop those whose gradient is known to be zero, gather_kernel.make_plan's
// `valid`) are not read.
//
// What bounds it on the H100: bytes. It reads each gathered gradient row
// once (P_valid * C elements), the table (4 bytes a position and a row) and
// writes each destination row once (n * C elements), with one add an
// element read: at 20,000 nodes the GAT layer's 4 neighbour slots a node
// that hold an edge, C = 256 float32, move 82 MB + 20 MB, 31 us at
// 3.35 TB/s; the (4,096, 800) float32 triplet gradient into 20,000 rows
// 13 MB + 64 MB.
//
// Design: one warp a destination row, lanes across the row's columns (lane
// l takes columns l, l + 32, ..., up to kCols of them a pass, held in
// registers), the warp walking the row's segment in order: for each
// position, one broadcast read of order[k] and one coalesced read of the
// gradient row's part. A row with an empty segment writes +0. No shared
// memory, no atomics, no scratch; one launch.
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;                  // 8 warps, 8 rows a CTA
constexpr int kWarps = kThreads / 32;
constexpr int kCols = 8;                       // columns a lane holds a pass

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);   // the one rounding to bfloat16
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
gather_bwd_kernel(const T* __restrict__ grad, const int* __restrict__ order,
                  const int* __restrict__ offsets, T* __restrict__ out,
                  int n_rows, int n_cols) {
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= n_rows) return;
  const int lo = offsets[row];
  const int hi = offsets[row + 1];
  T* dst = out + (long long)row * n_cols;
  for (int c0 = 0; c0 < n_cols; c0 += 32 * kCols) {
    float acc[kCols];
#pragma unroll
    for (int i = 0; i < kCols; ++i) acc[i] = 0.0f;
    for (int k = lo; k < hi; ++k) {
      const T* src = grad + (long long)order[k] * n_cols;
#pragma unroll
      for (int i = 0; i < kCols; ++i) {
        const int c = c0 + lane + 32 * i;
        if (c < n_cols) acc[i] = __fadd_rn(acc[i], to_float(src[c]));
      }
    }
#pragma unroll
    for (int i = 0; i < kCols; ++i) {
      const int c = c0 + lane + 32 * i;
      if (c < n_cols) store(dst + c, acc[i]);
    }
  }
}

}  // namespace

// grad (P, n_cols) of type dtype (0 float32, 1 bfloat16), order (P_valid,)
// and offsets (n_rows + 1,) int32 on the device; out (n_rows, n_cols) of the
// same type. Returns cudaGetLastError() after the launch
// (cudaErrorInvalidValue, nothing launched, for sizes out of range).
extern "C" int nsc_gather_bwd(const void* grad, const void* order,
                              const void* offsets, void* out, int n_rows,
                              int n_cols, int dtype, void* stream) {
  if (n_rows < 1 || n_cols < 1 || dtype < 0 || dtype > 1)
    return (int)cudaErrorInvalidValue;
  const int blocks = (n_rows + kWarps - 1) / kWarps;
  const auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    gather_bwd_kernel<float><<<blocks, kThreads, 0, s>>>(
        static_cast<const float*>(grad), static_cast<const int*>(order),
        static_cast<const int*>(offsets), static_cast<float*>(out), n_rows,
        n_cols);
  } else {
    gather_bwd_kernel<__nv_bfloat16><<<blocks, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(grad),
        static_cast<const int*>(order), static_cast<const int*>(offsets),
        static_cast<__nv_bfloat16*>(out), n_rows, n_cols);
  }
  return (int)cudaGetLastError();
}

// The kernel's two instances (0 float32, 1 bfloat16), for the census of
// captured graphs (nsc_graph_census in project.cu).
extern "C" const void* nsc_gather_bwd_kernel_handle(int dtype) {
  return dtype == 0
             ? reinterpret_cast<const void*>(gather_bwd_kernel<float>)
             : reinterpret_cast<const void*>(gather_bwd_kernel<__nv_bfloat16>);
}
