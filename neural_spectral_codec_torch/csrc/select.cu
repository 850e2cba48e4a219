// Kernel S: one column of each row of a float32 block by its rank in the
// row's stable ascending order.
//
// Not a Pallas kernel: the hand-written form of the XLA sort inside the JAX
// package's mining program, neural_spectral_codec_tpu/training/miner.py
// _mine_chunk with "semi-hard" (:99-105): order = jnp.argsort(masked) and
// neg_idx = order[cnt // 2]. For each row r of x (rows, n) float32 (row
// stride ld) and k[r] (int32 on the device, clamped to 0 .. n - 1):
//     out[r] = the column at place k[r] of the row sorted ascending, equal
//              values by the lower column (a stable sort)
// in the total order of the 32-bit keys key(v) = bits(v) ^ 0x80000000 for
// v > 0 and ~bits(v) for v < 0, both zeros mapped to +0's key (-0 equal to
// +0, as jnp.argsort and torch.sort hold them), every NaN to 0xffffffff
// (after +inf, equal to each other): the order of jnp.argsort and of
// torch.sort(stable=True). The plain version is training/select_kernel.py
// select_plain; the two agree bit for bit.
//
// What bounds it on the H100: bytes. The block is read once: 2,048 rows x
// 100,000 columns (the miner's W1 block) are 819.2 MB, 0.245 ms at 3.35
// TB/s. The design reads each row up to 4 times (3 digit passes and the
// walk), so it runs at best at a quarter of that rate from HBM; the passes
// of one row follow each other closely, so the later ones mostly hit L2.
//
// Design (a radix select, one CTA of 512 threads a row). Three passes over
// the row build a histogram of one digit of the keys (11, 11 and 10 bits,
// most significant first) among the entries whose higher digits match the
// digits chosen so far, in shared memory; a block scan of the histogram
// finds the digit whose bucket holds the remaining rank, which it then
// narrows to the rank inside that bucket. A bucket of one entry ends the
// passes early. Then one walk in column order finds the entry of that
// rank among those that match the chosen digits: each thread takes 4
// consecutive columns a step (a float4 where the row is 16-byte aligned), a
// block scan of the threads' match counts places each thread's matches, and
// the walk stops at the step that holds the rank. Histogram updates are
// aggregated per warp (__match_any_sync: one shared atomic for the lanes
// with the same digit), so a row of equal keys (+inf outside the miner's
// negatives) costs one atomic a warp and step.
#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kPerThread = 4;           // consecutive columns a thread a step
constexpr int kStep = kThreads * kPerThread;
constexpr int kPasses = 3;
constexpr int kBins = 2048;             // the widest digit: 11 bits
constexpr unsigned kNoDigit = 0xffffffffu;

static_assert(kBins % kThreads == 0, "bins per thread");
static_assert(kWarps <= 32, "one warp scans the warp sums");

// digit p: its lowest bit and its width (11, 11, 10 bits from the top)
__host__ __device__ constexpr int digit_shift(int p) {
  return p == 0 ? 21 : p == 1 ? 10 : 0;
}
__host__ __device__ constexpr int digit_bits(int p) { return p == 2 ? 10 : 11; }

__device__ __forceinline__ unsigned order_key(float v) {
  const unsigned u = __float_as_uint(v);
  if (v != v) return 0xffffffffu;
  if (v == 0.0f) return 0x80000000u;    // -0 equal to +0
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// kPerThread consecutive values from column j (values past n are never
// used: the callers test j + q < n)
__device__ __forceinline__ void load_values(const float* __restrict__ x,
                                            int n, int j, bool vec,
                                            float v[kPerThread]) {
  if (vec && j + kPerThread <= n) {
    const float4 f = __ldg(reinterpret_cast<const float4*>(x + j));
    v[0] = f.x; v[1] = f.y; v[2] = f.z; v[3] = f.w;
  } else {
#pragma unroll
    for (int q = 0; q < kPerThread; ++q)
      v[q] = j + q < n ? __ldg(x + j + q) : 0.0f;
  }
}

// The block's exclusive prefix sum of v in thread order, and (total) the
// sum over the block. Every thread of the block calls it.
__device__ __forceinline__ unsigned block_scan(unsigned v, unsigned* sums,
                                               unsigned* total) {
  const unsigned full = 0xffffffffu;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  unsigned incl = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const unsigned t = __shfl_up_sync(full, incl, o);
    if (lane >= o) incl += t;
  }
  __syncthreads();                      // sums of an earlier scan are read
  if (lane == 31) sums[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    unsigned w = lane < kWarps ? sums[lane] : 0u;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const unsigned t = __shfl_up_sync(full, w, o);
      if (lane >= o) w += t;
    }
    if (lane < kWarps) sums[lane] = w;
  }
  __syncthreads();
  *total = sums[kWarps - 1];
  return (warp ? sums[warp - 1] : 0u) + incl - v;
}

__global__ void __launch_bounds__(kThreads)
select_rows_kernel(const float* __restrict__ x, int n, long long ld,
                   const int* __restrict__ k, int* __restrict__ out) {
  __shared__ unsigned hist[kBins];
  __shared__ unsigned sums[kWarps];
  __shared__ unsigned chosen[3];        // digit, entries below it, in it
  const unsigned full = 0xffffffffu;
  const int tid = threadIdx.x, lane = tid & 31;
  const int row = blockIdx.x;
  const float* xr = x + (long long)row * ld;
  const bool vec = reinterpret_cast<uintptr_t>(xr) % 16 == 0;
  unsigned rank = (unsigned)min(max(k[row], 0), n - 1);
  unsigned prefix = 0, mask = 0;        // the digits chosen so far

  for (int p = 0; p < kPasses; ++p) {
    const int shift = digit_shift(p);
    const unsigned dmask = (1u << digit_bits(p)) - 1u;
    for (int b = tid; b < kBins; b += kThreads) hist[b] = 0;
    __syncthreads();
    for (int base = 0; base < n; base += kStep) {
      const int j = base + kPerThread * tid;
      float v[kPerThread];
      load_values(xr, n, j, vec, v);
#pragma unroll
      for (int q = 0; q < kPerThread; ++q) {
        const unsigned key = order_key(v[q]);
        const unsigned d = j + q < n && (key & mask) == prefix
                               ? (key >> shift) & dmask : kNoDigit;
        if (!__any_sync(full, d != kNoDigit)) continue;
        const unsigned peers = __match_any_sync(full, d);
        if (d != kNoDigit && lane == __ffs(peers) - 1)
          atomicAdd(&hist[d], (unsigned)__popc(peers));
      }
    }
    __syncthreads();
    // the digit whose bucket holds the rank: thread t owns bins
    // t * kBins / kThreads .. (t + 1) * kBins / kThreads - 1
    constexpr int kOwn = kBins / kThreads;
    unsigned local = 0;
#pragma unroll
    for (int b = 0; b < kOwn; ++b) local += hist[kOwn * tid + b];
    unsigned total;
    unsigned below = block_scan(local, sums, &total);
    if (below <= rank && rank < below + local) {
#pragma unroll 1
      for (int b = 0; b < kOwn; ++b) {
        const unsigned h = hist[kOwn * tid + b];
        if (rank < below + h) {
          chosen[0] = kOwn * tid + b;
          chosen[1] = below;
          chosen[2] = h;
          break;
        }
        below += h;
      }
    }
    __syncthreads();
    prefix |= chosen[0] << shift;
    mask |= dmask << shift;
    rank -= chosen[1];
    if (chosen[2] == 1) break;          // a bucket of one: no more digits
    __syncthreads();                    // chosen is read before it changes
  }

  // the entry of place `rank` among those matching the chosen digits, in
  // column order
  for (int base = 0; base < n; base += kStep) {
    const int j = base + kPerThread * tid;
    float v[kPerThread];
    load_values(xr, n, j, vec, v);
    unsigned hits = 0;
#pragma unroll
    for (int q = 0; q < kPerThread; ++q)
      hits |= (j + q < n && (order_key(v[q]) & mask) == prefix) << q;
    const unsigned c = __popc(hits);
    unsigned total;
    const unsigned before = block_scan(c, sums, &total);
    if (rank < total) {
      if (before <= rank && rank < before + c) {
        unsigned left = rank - before;
#pragma unroll
        for (int q = 0; q < kPerThread; ++q) {
          if ((hits >> q) & 1u) {
            if (left == 0) { out[row] = j + q; break; }
            --left;
          }
        }
      }
      return;
    }
    rank -= total;
  }
  if (tid == 0) out[row] = 0;           // unreachable while the counts hold
}

}  // namespace

// For each of `rows` rows of x (float32, row stride ld >= n elements) the
// column at place k[row] (int32 on the device, clamped to 0 .. n - 1) of
// the row's stable ascending order; out (rows,) int32. Launches one CTA of
// 512 threads a row. Returns cudaGetLastError() after the launch
// (cudaErrorInvalidValue, nothing launched, for sizes out of range).
extern "C" int nsc_select_rows(const void* x, int rows, int n, long long ld,
                               const void* k, void* out, void* stream) {
  if (rows < 1 || n < 1 || ld < n || rows > INT_MAX / 2)
    return (int)cudaErrorInvalidValue;
  select_rows_kernel<<<rows, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), n, ld, static_cast<const int*>(k),
      static_cast<int*>(out));
  return (int)cudaGetLastError();
}

// The kernel, for the census of captured graphs (nsc_graph_census in
// project.cu).
extern "C" const void* nsc_select_kernel_handle() {
  return reinterpret_cast<const void*>(select_rows_kernel);
}
