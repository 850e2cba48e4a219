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
// 13 MB + 64 MB, 23 us, most of it the empty rows' zeros.
//
// Design: a work item is a (row, slice) pair, a slice being 32 chunks of
// 16 bytes (128 float32 or 256 bfloat16 columns; a 4-byte or 2-byte element
// a chunk when a row is not a whole number of 16-byte chunks or the
// tensors are not 16-byte aligned), one chunk a lane, so a warp reads and
// writes each row of its slice in one pass of 16-byte accesses, and a row
// wider than a slice (an 800-float32 triplet row is 7 slices) is summed by
// as many warps at once, each over the whole segment for its columns: every
// column still adds its positions in order. The grid is the CTAs that fit
// the card at once; warp w takes the items w, w + W, w + 2W, ... (W warps
// in all), 32 at a time: lane l reads the segment bounds of the batch's
// l-th item, so one load brings 32 items' bounds. The batch's empty items
// write their zeros first (16-byte stores). Its other items' (item,
// position) pairs are then one list, the items with more than kDepth
// positions first (so that a long segment starts with its batch, not at
// its end), each item's positions in order: 32 pairs at a time, each lane
// finds its pair's item (warp prefix sums of the segment lengths) and
// loads its position (one load of order for 32 pairs, made before the
// previous 32 pairs' rows are loaded); the warp then loads
// kDepth gradient rows' chunks before the adds that use them, across item
// boundaries, so a batch of one-position items keeps kDepth loads in
// flight as a long segment does, and it writes an item's sums when the
// list moves to the next item. No shared memory, no atomics, no scratch;
// one launch.
#include <climits>
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;                  // 8 warps, 8 items at once
constexpr int kWarps = kThreads / 32;
constexpr int kDepth = 8;                      // gradient rows in flight
constexpr int kCtasPerSm = 3;

// A chunk of V elements of type T, loaded and stored as one access of its
// raw type (16 bytes, or one element): add() adds its elements to V float
// sums in column order, pack() rounds V sums into a chunk.
template <typename T, int V>
struct Chunk;

template <>
struct Chunk<float, 4> {
  using Raw = uint4;
  static __device__ __forceinline__ void add(float* acc, Raw r) {
    acc[0] = __fadd_rn(acc[0], __uint_as_float(r.x));
    acc[1] = __fadd_rn(acc[1], __uint_as_float(r.y));
    acc[2] = __fadd_rn(acc[2], __uint_as_float(r.z));
    acc[3] = __fadd_rn(acc[3], __uint_as_float(r.w));
  }
  static __device__ __forceinline__ Raw pack(const float* acc) {
    return make_uint4(__float_as_uint(acc[0]), __float_as_uint(acc[1]),
                      __float_as_uint(acc[2]), __float_as_uint(acc[3]));
  }
};

template <>
struct Chunk<float, 1> {
  using Raw = unsigned;
  static __device__ __forceinline__ void add(float* acc, Raw r) {
    acc[0] = __fadd_rn(acc[0], __uint_as_float(r));
  }
  static __device__ __forceinline__ Raw pack(const float* acc) {
    return __float_as_uint(acc[0]);
  }
};

// bfloat16: the upper half of a float32's bits; rounded once at the end
__device__ __forceinline__ unsigned bf16_bits(float v) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(v));
}

template <>
struct Chunk<__nv_bfloat16, 8> {
  using Raw = uint4;
  static __device__ __forceinline__ void add2(float* acc, unsigned w) {
    acc[0] = __fadd_rn(acc[0], __uint_as_float(w << 16));
    acc[1] = __fadd_rn(acc[1], __uint_as_float(w & 0xffff0000u));
  }
  static __device__ __forceinline__ void add(float* acc, Raw r) {
    add2(acc, r.x);
    add2(acc + 2, r.y);
    add2(acc + 4, r.z);
    add2(acc + 6, r.w);
  }
  static __device__ __forceinline__ unsigned pack2(const float* acc) {
    return bf16_bits(acc[0]) | bf16_bits(acc[1]) << 16;
  }
  static __device__ __forceinline__ Raw pack(const float* acc) {
    return make_uint4(pack2(acc), pack2(acc + 2), pack2(acc + 4),
                      pack2(acc + 6));
  }
};

template <>
struct Chunk<__nv_bfloat16, 1> {
  using Raw = unsigned short;
  static __device__ __forceinline__ void add(float* acc, Raw r) {
    acc[0] = __fadd_rn(acc[0], __uint_as_float((unsigned)r << 16));
  }
  static __device__ __forceinline__ Raw pack(const float* acc) {
    return (Raw)bf16_bits(acc[0]);
  }
};

template <typename T, int V>
__global__ void __launch_bounds__(kThreads, kCtasPerSm)
gather_bwd_kernel(const T* __restrict__ grad, const int* __restrict__ order,
                  const int* __restrict__ offsets, T* __restrict__ out,
                  int n_rows, int n_cols) {
  using C = Chunk<T, V>;
  using Raw = typename C::Raw;
  const unsigned full = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  const int chunks = n_cols / V;
  const int slices = (chunks + 31) / 32;
  const int items = n_rows * slices;             // < 2^31 (the entry's rule)
  const long long warps = (long long)gridDim.x * kWarps;
  const Raw* src = reinterpret_cast<const Raw*>(grad);
  Raw* dst = reinterpret_cast<Raw*>(out);

  for (long long base = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
       base < items; base += 32 * warps) {
    // lane l: the batch's l-th item, base + l * warps: its row, the first
    // chunk of its slice, its segment
    const long long mine = base + lane * warps;
    int row = 0, col = 0, lo = 0, len = 0;
    if (mine < items) {
      row = (int)mine / slices;
      col = ((int)mine - row * slices) * 32;
      lo = offsets[row];
      len = offsets[row + 1] - lo;
    }
    // the empty items' zeros
    for (unsigned m = __ballot_sync(full, mine < items && len == 0); m;
         m &= m - 1) {
      const int l = __ffs(m) - 1;
      const int r = __shfl_sync(full, row, l);
      const int c = __shfl_sync(full, col, l) + lane;
      if (c < chunks) dst[(long long)r * chunks + c] = Raw();
    }
    // the others' (item, position) pairs as one list, the items with more
    // than kDepth positions first, each item's positions in order: lane
    // l's pairs are begin .. end - 1 of it
    const bool longer = len > kDepth;
    int x = longer ? len : 0, y = longer ? 0 : len;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int xs = __shfl_up_sync(full, x, o);
      const int ys = __shfl_up_sync(full, y, o);
      if (lane >= o) {
        x += xs;
        y += ys;
      }
    }
    const int n_long = __shfl_sync(full, x, 31);
    const int total = n_long + __shfl_sync(full, y, 31);
    const int end = longer ? x : n_long + y;
    const int begin = end - len;

    int cur = -1;                    // the lane of the item being summed
    float acc[V];
#pragma unroll
    for (int e = 0; e < V; ++e) acc[e] = 0.0f;
    auto store = [&]() {
      const int r = __shfl_sync(full, row, cur);
      const int c = __shfl_sync(full, col, cur) + lane;
      if (c < chunks) dst[(long long)r * chunks + c] = C::pack(acc);
    };
    // pairs f0 .. f0 + 31: lane i's item (own), its position (p) and its
    // slice's first chunk (pc); one load of order for the 32
    auto group = [&](int f0, int* own, int* p, int* pc) {
      *own = 0;
      for (unsigned m = __ballot_sync(full, len > 0 && begin < f0 + 32 &&
                                                end > f0);
           m; m &= m - 1) {
        const int l = __ffs(m) - 1;
        const int b = __shfl_sync(full, begin, l);
        const int e = __shfl_sync(full, end, l);
        if (f0 + lane >= b && f0 + lane < e) *own = l;
      }
      const int at = __shfl_sync(full, lo, *own) + f0 + lane -
                     __shfl_sync(full, begin, *own);
      *p = f0 + lane < total ? order[at] : 0;
      *pc = __shfl_sync(full, col, *own);
    };
    int own = 0, p = 0, pc = 0;
    if (total > 0) group(0, &own, &p, &pc);
    for (int f0 = 0; f0 < total; f0 += 32) {
      // the next 32 pairs' positions, loaded ahead of these 32's rows
      int own_n = 0, p_n = 0, pc_n = 0;
      if (f0 + 32 < total) group(f0 + 32, &own_n, &p_n, &pc_n);
      const int pairs = min(32, total - f0);
      for (int d0 = 0; d0 < pairs; d0 += kDepth) {
        Raw v[kDepth];
#pragma unroll
        for (int d = 0; d < kDepth; ++d) {
          const int q = __shfl_sync(full, p, d0 + d);
          const int c = __shfl_sync(full, pc, d0 + d) + lane;
          v[d] = d0 + d < pairs && c < chunks
                     ? src[(long long)q * chunks + c] : Raw();
        }
#pragma unroll
        for (int d = 0; d < kDepth; ++d) {
          if (d0 + d < pairs) {
            const int o = __shfl_sync(full, own, d0 + d);
            if (o != cur) {          // the next item: the last one is done
              if (cur >= 0) store();
              cur = o;
#pragma unroll
              for (int e = 0; e < V; ++e) acc[e] = 0.0f;
            }
            C::add(acc, v[d]);
          }
        }
      }
      own = own_n;
      p = p_n;
      pc = pc_n;
    }
    if (cur >= 0) store();
  }
}

// 16 / sizeof(T) elements a chunk when every row is a whole number of
// aligned 16-byte chunks, else one.
template <typename T>
const void* instance(bool vec) {
  return vec ? reinterpret_cast<const void*>(
                   gather_bwd_kernel<T, 16 / sizeof(T)>)
             : reinterpret_cast<const void*>(gather_bwd_kernel<T, 1>);
}

// resident CTAs of each instance (float32, bfloat16) x (scalar, 16-byte),
// per device, read once
int g_grid[nsc::kMaxDevices][4] = {};

}  // namespace

// grad (P, n_cols) of type dtype (0 float32, 1 bfloat16), order (P_valid,)
// and offsets (n_rows + 1,) int32 on the device; out (n_rows, n_cols) of the
// same type. Launches at most the CTAs of 256 threads that fit the card at
// once. Returns cudaGetLastError() after the launch (cudaErrorInvalidValue,
// nothing launched, for sizes out of range).
extern "C" int nsc_gather_bwd(const void* grad, const void* order,
                              const void* offsets, void* out, int n_rows,
                              int n_cols, int dtype, void* stream) {
  if (n_rows < 1 || n_cols < 1 || dtype < 0 || dtype > 1)
    return (int)cudaErrorInvalidValue;
  const int width = dtype == 0 ? 4 : 8;          // elements in 16 bytes
  const bool vec = n_cols % width == 0 &&
                   reinterpret_cast<uintptr_t>(grad) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const long long slices = ((vec ? n_cols / width : n_cols) + 31) / 32;
  if ((long long)n_rows * slices > INT_MAX) return (int)cudaErrorInvalidValue;
  int dev = 0;
  cudaError_t err = nsc::current_device(&dev);
  if (err != cudaSuccess) return (int)err;
  const int which = 2 * dtype + vec;
  const void* fn = dtype == 0 ? instance<float>(vec)
                              : instance<__nv_bfloat16>(vec);
  if (g_grid[dev][which] == 0) {
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn,
                                                        kThreads, 0);
    if (err != cudaSuccess) return (int)err;
    g_grid[dev][which] = sms * (per_sm > 0 ? per_sm : 1);
  }
  const long long need = ((long long)n_rows * slices + kWarps - 1) / kWarps;
  const int blocks = need < g_grid[dev][which] ? (int)need
                                                : g_grid[dev][which];
  const auto s = static_cast<cudaStream_t>(stream);
  const auto o = static_cast<const int*>(order);
  const auto f = static_cast<const int*>(offsets);
  if (dtype == 0) {
    const auto g = static_cast<const float*>(grad);
    const auto d = static_cast<float*>(out);
    if (vec)
      gather_bwd_kernel<float, 4><<<blocks, kThreads, 0, s>>>(
          g, o, f, d, n_rows, n_cols);
    else
      gather_bwd_kernel<float, 1><<<blocks, kThreads, 0, s>>>(
          g, o, f, d, n_rows, n_cols);
  } else {
    const auto g = static_cast<const __nv_bfloat16*>(grad);
    const auto d = static_cast<__nv_bfloat16*>(out);
    if (vec)
      gather_bwd_kernel<__nv_bfloat16, 8><<<blocks, kThreads, 0, s>>>(
          g, o, f, d, n_rows, n_cols);
    else
      gather_bwd_kernel<__nv_bfloat16, 1><<<blocks, kThreads, 0, s>>>(
          g, o, f, d, n_rows, n_cols);
  }
  return (int)cudaGetLastError();
}

// The kernel's four instances (2 * dtype + vec: float32 or bfloat16, one
// element or 16 bytes a chunk), for the census of captured graphs
// (nsc_graph_census in project.cu).
extern "C" const void* nsc_gather_bwd_kernel_handle(int which) {
  return (which >> 1) == 0 ? instance<float>(which & 1)
                           : instance<__nv_bfloat16>(which & 1);
}
