// Spectral encoder: range images -> normalised spectral histograms.
//
// Replaces the TPU kernel neural_spectral_codec_tpu/ops/pallas_spectral.py
// (_kernel with _interpolate_block; pallas_call at :169). Per scan, in order:
//   1. circular linear interpolation of empty (<= 0 or NaN) pixels per row,
//      from the nearest valid pixel left and right, weighted by distance
//      (rows with no valid pixel stay as they are);
//   2. empty-row fill: an empty row takes the nearest originally non-empty
//      row above it, else the nearest below;
//   3. adaptive average pooling of the rows (E -> T), row t averaging input
//      rows [floor(t*E/T), ceil((t+1)*E/T));
//   4. unnormalised real-DFT magnitudes, fp32 FMA (no TF32, no tensor cores);
//   5. exponential-alpha binning: the bin index rises with the frequency, so
//      bin b is the contiguous frequency range [bounds[b], bounds[b+1]),
//      possibly empty, computed once by the wrapper from alpha;
//   6. sum-to-1 over the scan's whole histogram, or a uniform 1/(T*n_bins)
//      when the total is <= epsilon.
// Steps 1-2 run only when `interpolate` is set (config.interpolate_empty).
//
// What bounds it on the H100, at B = 8 (E 64, A 360, T 16, 50 bins): it reads
// 8*64*360*4 = 737,280 B of images and writes 25,600 B (0.23 us at
// 3.35 TB/s). The operations the function needs, with columns a and A - a
// of a row folded as below: 2 FMAs per (pooled row, frequency, column pair),
// 8*16*181*179*4 = 16.6 MFLOP, plus the middle column, the magnitudes, the
// bins, the fold and the pooling, 17.1 MFLOP in all (0.26 us at 67 TFLOP/s
// fp32; chip_smoke.py counts them from each run's shapes and data). So it is
// compute-bound at 0.26 us (0.03 us at B = 1, where the launch latency is
// the real floor).
//
// Design. One thread-block cluster of kCluster = 8 CTAs of 768 threads per
// scan, so that B = 1 runs on 8 SMs and B = 8 on 64 (one CTA per scan left
// 131 of 132 SMs idle at B = 1, and its one SM ran the whole 2.1 M-FMA DFT).
//   * CTA `rank` owns the pooled rows [rank*T/8, (rank+1)*T/8) and loads
//     only the input rows their pooling windows read (a window that
//     straddles two CTAs is loaded by both). The scan is read from global
//     memory once.
//   * Row fill: every input row is some CTA's, so each CTA flags its loaded
//     rows (any pixel > 0) and stores the flags into every CTA of the
//     cluster (distributed shared memory), then one cluster barrier. An
//     empty row takes its source's raw row, from shared memory when the
//     CTA holds it, else from global memory, and is interpolated like it:
//     the same values.
//   * Interpolation: one warp per row; one ballot per 32-column chunk, and
//     the nearest valid column left and right of an empty one from bit
//     scans of the chunk masks (no shuffle chains). The blend
//     (v_l * d_r + v_r * d_l) / (d_l + d_r) is rounded step by step as the
//     JAX reference computes it.
//   * DFT: one A-entry (cos, sin) table in shared memory (2.9 KB at A = 360)
//     in place of the (A, A/2+1) bases (521 KB, which did not stay in L1);
//     entry (a*k) mod A, the index advanced by k per column, stored at a
//     padded position (m + m/16) so that a half-warp's reads at stride k do
//     not meet in one bank. A real row's DFT pairs column a with A - a (the
//     same cos, the opposite sin), so each pooled row is folded onto its
//     first half (sums and differences), which halves the iterations; the
//     pooled rows are held in pairs, so one broadcast float4 read feeds
//     both. A thread owns one frequency of a pair over one of four column
//     segments (724 of 768 threads busy), four FMAs per table read; column
//     0, the middle column and the segments' sums are added before the
//     magnitude.
//   * Binning by ranges, in frequency order. Each CTA stores its share of
//     the scan's total into every CTA of the cluster; after one cluster
//     barrier each sums the shares in rank order, so all divide by the
//     same total, and no CTA reads another's memory after the barrier.
// The wrapper caches the table and the bin ranges, so a call enqueues the
// output allocation and this kernel and nothing else;
// cudaFuncSetAttribute runs only when a launch needs more dynamic shared
// memory than any launch before it on the same device.
//
// ptxas (nvcc -Xptxas -v with _build.NVCC_FLAGS, sm_90a, CUDA 12.8, on an
// H100): 79 registers, 0 bytes of stack, 0 spill stores or loads, one
// barrier; dynamic shared memory 34,348 B per CTA at E 64 / T 16 / A 360 /
// 50 bins (25,516 B at E 16, 26,972 B at E 20). Device time on an H100
// 80GB HBM3 at 700 W: PERF.md, kernel table.
#include <climits>

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 768;
constexpr int kWarps = kThreads / 32;
constexpr int kCluster = 8;         // CTAs per scan (the portable maximum)
constexpr int kSegments = 4;        // column segments of one DFT sum
constexpr int kMaxChunks = 12;      // n_azim <= 32 * kMaxChunks = 384
constexpr unsigned kFull = 0xffffffffu;

// Twiddle entry m sits at m + m/16: the float2 reads of one half-warp,
// (a*k) mod A for 16 frequencies k, then fall in distinct banks for the
// power-of-two strides that conflict without the padding.
__device__ __forceinline__ int padded(int m) { return m + (m >> 4); }

// Cluster barrier halves: every CTA of the cluster has started once all
// have arrived, and only then may one touch another's shared memory.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// Interpolates one row in place (whole warp). One ballot per 32-column
// chunk gives the valid columns; the nearest valid column left and right
// of each empty one comes from bit scans of those masks (the row's last
// and first valid columns, shifted a turn, across the wrap). Valid pixels
// are never written and empty pixels never read.
__device__ void interpolate_row(float* row, int n_azim, int lane) {
  const int n_chunks = (n_azim + 31) / 32;
  unsigned mask[kMaxChunks];
  int first = INT_MAX, last = -1;
#pragma unroll
  for (int c = 0; c < kMaxChunks; ++c) {
    const int idx = c * 32 + lane;
    mask[c] = c < n_chunks
                  ? __ballot_sync(kFull, idx < n_azim && row[idx] > 0.0f)
                  : 0u;
    if (mask[c]) {
      if (first == INT_MAX) first = c * 32 + __ffs(mask[c]) - 1;
      last = c * 32 + 31 - __clz(mask[c]);
    }
  }
  if (last < 0) return;
  int left_of[kMaxChunks];            // last valid column before chunk c
  int carry = last - n_azim;          // < 0: the previous turn
#pragma unroll
  for (int c = 0; c < kMaxChunks; ++c) {
    left_of[c] = carry;
    if (mask[c]) carry = c * 32 + 31 - __clz(mask[c]);
  }
  carry = first + n_azim;             // first valid column after chunk c
#pragma unroll
  for (int c = kMaxChunks - 1; c >= 0; --c) {
    const int idx = c * 32 + lane;
    if (c < n_chunks && idx < n_azim && !((mask[c] >> lane) & 1u)) {
      const unsigned below = mask[c] & ((1u << lane) - 1u);
      const unsigned above = lane == 31 ? 0u : mask[c] & (~0u << (lane + 1));
      const int l = below ? c * 32 + 31 - __clz(below) : left_of[c];
      const int r = above ? c * 32 + __ffs(above) - 1 : carry;
      const int dl = idx - l;
      const int dr = r - idx;
      const float vl = row[l < 0 ? l + n_azim : l];
      const float vr = row[r >= n_azim ? r - n_azim : r];
      row[idx] = __fdiv_rn(
          __fadd_rn(__fmul_rn(vl, (float)dr), __fmul_rn(vr, (float)dl)),
          (float)(dl + dr));
    }
    if (mask[c]) carry = c * 32 + __ffs(mask[c]) - 1;
  }
}

// Input rows [lo, hi) of pooled rows [t_lo, t_hi) (adaptive pooling).
__device__ __forceinline__ int window_lo(int t, int n_elev, int n_target) {
  return (t * n_elev) / n_target;
}
__device__ __forceinline__ int window_hi(int t, int n_elev, int n_target) {
  return ((t + 1) * n_elev + n_target - 1) / n_target;
}

__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads)
spectral_encode_kernel(const float* __restrict__ imgs,
                       const int* __restrict__ bounds,
                       const float2* __restrict__ twiddle,
                       float* __restrict__ out, int n_elev, int n_azim,
                       int n_target, int n_bins, int n_freqs, int max_in,
                       int max_t, float eps, int interpolate) {
  cg::cluster_group cluster = cg::this_cluster();
  cluster_arrive();       // waited for before the first DSMEM store

  const int max_pairs = (max_t + 1) / 2;
  const int half = (n_azim - 1) / 2;  // column pairs (a, A - a), a = 1..half
  extern __shared__ float4 sm4[];
  float4* folded = sm4;                               // max_pairs * half
  float2* tw = reinterpret_cast<float2*>(folded + max_pairs * half);
                                                      // padded(n_azim) + 1
  float2* seg_sum = tw + padded(n_azim) + 1;  // kSegments * max_t * n_freqs
  float2* pooled = seg_sum + kSegments * max_t * n_freqs;
                                    // max_pairs * n_azim: rows (2p, 2p + 1)
  float* rows = reinterpret_cast<float*>(pooled + max_pairs * n_azim);
                                                      // max_in * n_azim
  float* mags = rows + max_in * n_azim;               // max_t * n_freqs
  float* hist = mags + max_t * n_freqs;               // max_t * n_bins
  float* red = hist + max_t * n_bins;                 // kWarps
  float* totals = red + kWarps;                       // kCluster
  int* bnd = reinterpret_cast<int*>(totals + kCluster);  // n_bins + 1
  int* flags = bnd + n_bins + 1;                      // n_elev

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int rank = (int)cluster.block_rank();
  const int scan = blockIdx.x / kCluster;
  const float* src = imgs + (long long)scan * n_elev * n_azim;

  const int t_lo = rank * n_target / kCluster;
  const int t_hi = (rank + 1) * n_target / kCluster;
  const int n_t = t_hi - t_lo;
  const int in_lo = n_t > 0 ? window_lo(t_lo, n_elev, n_target) : 0;
  const int in_hi = n_t > 0 ? window_hi(t_hi - 1, n_elev, n_target) : 0;
  const int n_in = in_hi - in_lo;

  for (int i = tid; i < n_azim; i += kThreads) tw[padded(i)] = twiddle[i];
  for (int i = tid; i <= n_bins; i += kThreads) bnd[i] = bounds[i];
  const float* in = src + in_lo * n_azim;
  for (int i = tid; i < n_in * n_azim; i += kThreads) rows[i] = __ldg(in + i);
  __syncthreads();
  cluster_wait();

  if (interpolate) {
    // Flag the loaded rows (every row is some CTA's input row) and store
    // the flags into every CTA of the cluster.
    for (int e = in_lo + warp; e < in_hi; e += kWarps) {
      const float* row = rows + (e - in_lo) * n_azim;
      bool any = false;
      for (int a = lane; a < n_azim; a += 32) any |= row[a] > 0.0f;
      any = __any_sync(kFull, any);
      if (lane < kCluster) cluster.map_shared_rank(flags, lane)[e] = any;
    }
    cluster.sync();
    // an empty row takes its fill source's raw row: from shared memory
    // when this CTA loaded it (sources are never written), else from global
    for (int e = in_lo + warp; e < in_hi; e += kWarps) {
      if (flags[e]) continue;
      int from = -1;
      for (int u = e - 1; u >= 0 && from < 0; --u)
        if (flags[u]) from = u;
      for (int u = e + 1; u < n_elev && from < 0; ++u)
        if (flags[u]) from = u;
      if (from < 0) continue;
      const float* s = from >= in_lo && from < in_hi
                           ? rows + (from - in_lo) * n_azim
                           : src + from * n_azim;
      float* d = rows + (e - in_lo) * n_azim;
      for (int a = lane; a < n_azim; a += 32) d[a] = s[a];
    }
    __syncthreads();
    for (int e = in_lo + warp; e < in_hi; e += kWarps)
      interpolate_row(rows + (e - in_lo) * n_azim, n_azim, lane);
    __syncthreads();
  }

  // adaptive average pooling into row pairs (a missing odd row is 0)
  const int n_pairs = (n_t + 1) / 2;
  float* pooled_f = reinterpret_cast<float*>(pooled);
  for (int i = tid; i < 2 * n_pairs * n_azim; i += kThreads) {
    const int j = i / n_azim;
    const int a = i - j * n_azim;
    float acc = 0.0f;
    if (j < n_t) {
      const int e0 = window_lo(t_lo + j, n_elev, n_target);
      const int e1 = window_hi(t_lo + j, n_elev, n_target);
      const float w = 1.0f / (float)(e1 - e0);
      for (int e = e0; e < e1; ++e)
        acc = fmaf(w, rows[(e - in_lo) * n_azim + a], acc);
    }
    pooled_f[((j >> 1) * n_azim + a) * 2 + (j & 1)] = acc;
  }
  __syncthreads();

  // A real row's DFT pairs column a with A - a: cos is the same there and
  // sin changes sign, so fold each pooled row onto its first half, the
  // sums (cos) and differences (sin) of the two rows of a pair in a float4
  for (int i = tid; i < n_pairs * half; i += kThreads) {
    const int pair = i / half;
    const int a = 1 + i - pair * half;
    const float2 u = pooled[pair * n_azim + a];
    const float2 w = pooled[pair * n_azim + n_azim - a];
    folded[i] = make_float4(u.x + w.x, u.x - w.x, u.y + w.y, u.y - w.y);
  }
  __syncthreads();

  // rfft partial sums over columns 1..half: a thread owns one frequency of
  // a pair of pooled rows over one of kSegments column segments
  const int seg_len = (half + kSegments - 1) / kSegments;
  for (int job = tid; job < n_freqs * n_pairs * kSegments; job += kThreads) {
    const int k = job % n_freqs;
    const int seg = (job / n_freqs) % kSegments;
    const int pair = job / (n_freqs * kSegments);
    const float4* f = folded + pair * half;           // f[a - 1], a >= 1
    const int a0 = 1 + seg * seg_len;
    const int a1 = min(a0 + seg_len, half + 1);
    float re0 = 0.0f, im0 = 0.0f, re1 = 0.0f, im1 = 0.0f;
    int idx = (a0 * k) % n_azim;
#pragma unroll 4
    for (int a = a0; a < a1; ++a) {
      const float2 w = tw[padded(idx)];
      const float4 v = f[a - 1];
      re0 = fmaf(v.x, w.x, re0);
      im0 = fmaf(v.y, w.y, im0);
      re1 = fmaf(v.z, w.x, re1);
      im1 = fmaf(v.w, w.y, im1);
      idx += k;
      if (idx >= n_azim) idx -= n_azim;
    }
    const int j0 = 2 * pair;
    seg_sum[(seg * max_t + j0) * n_freqs + k] = make_float2(re0, im0);
    if (j0 + 1 < n_t)
      seg_sum[(seg * max_t + j0 + 1) * n_freqs + k] = make_float2(re1, im1);
  }
  __syncthreads();
  // column 0, the middle column of an even A (cos = (-1)^k, sin = 0), and
  // the segments
  const float* pooled_row = reinterpret_cast<const float*>(pooled);
  for (int i = tid; i < n_t * n_freqs; i += kThreads) {
    const int j = i / n_freqs;
    const int k = i - j * n_freqs;
    const float* x = pooled_row + (j >> 1) * 2 * n_azim + (j & 1);  // stride 2
    float re = x[0], im = 0.0f;
    if ((n_azim & 1) == 0) {
      const float mid = x[2 * (n_azim / 2)];
      re += (k & 1) ? -mid : mid;
    }
    for (int seg = 0; seg < kSegments; ++seg) {
      const float2 v = seg_sum[seg * max_t * n_freqs + i];
      re += v.x;
      im += v.y;
    }
    mags[i] = sqrtf(re * re + im * im);
  }
  __syncthreads();

  // binning by frequency ranges, and this CTA's share of the total
  float share = 0.0f;
  for (int i = tid; i < n_t * n_bins; i += kThreads) {
    const int j = i / n_bins;
    const int b = i - j * n_bins;
    float acc = 0.0f;
    for (int k = bnd[b]; k < bnd[b + 1]; ++k) acc += mags[j * n_freqs + k];
    hist[i] = acc;
    share += acc;
  }
  for (int off = 16; off > 0; off >>= 1)
    share += __shfl_down_sync(kFull, share, off);
  if (lane == 0) red[warp] = share;
  __syncthreads();
  if (warp == 0) {
    float v = lane < kWarps ? red[lane] : 0.0f;
    for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(kFull, v, off);
    v = __shfl_sync(kFull, v, 0);
    if (lane < kCluster) cluster.map_shared_rank(totals, lane)[rank] = v;
  }
  // every CTA now holds every share; summed in rank order, the totals agree
  cluster.sync();
  float total = 0.0f;
  for (int r = 0; r < kCluster; ++r) total += totals[r];

  const int n_out = n_target * n_bins;
  float* dst = out + (long long)scan * n_out + t_lo * n_bins;
  for (int i = tid; i < n_t * n_bins; i += kThreads)
    dst[i] = total > eps ? hist[i] / (total + eps) : 1.0f / (float)n_out;
}

size_t smem_bytes(int n_elev, int n_azim, int n_bins, int n_freqs,
                  int max_in, int max_t) {
  const size_t max_pairs = (max_t + 1) / 2;
  const size_t half = (n_azim - 1) / 2;
  return sizeof(float2) * ((size_t)n_azim + n_azim / 16 + 1 +
                           (size_t)kSegments * max_t * n_freqs +
                           max_pairs * n_azim) +
         sizeof(float4) * max_pairs * half +
         sizeof(float) * ((size_t)max_in * n_azim + (size_t)max_t * n_freqs +
                          (size_t)max_t * n_bins + kWarps + kCluster) +
         sizeof(int) * ((size_t)n_bins + 1 + n_elev);
}

// dynamic shared memory allowed so far, per device (0: the default 48 KB)
int g_smem_allowed[nsc::kMaxDevices] = {};

}  // namespace

// imgs (B, n_elev, n_azim) float32; bounds (n_bins + 1,) int32, bin b
// holding frequencies [bounds[b], bounds[b+1]); twiddle (n_azim,) float2
// (cos, sin)(2*pi*m/n_azim); out (B, n_target * n_bins) float32. All
// contiguous on one device. max_in and max_t: the most input rows and pooled
// rows one CTA of the cluster holds (spectral_kernel.cta_rows). Returns
// cudaGetLastError().
extern "C" int nsc_spectral_encode(const void* imgs, const void* bounds,
                                   const void* twiddle, void* out, int batch,
                                   int n_elev, int n_azim, int n_target,
                                   int n_bins, int n_freqs, int max_in,
                                   int max_t, float eps, int interpolate,
                                   void* stream) {
  if (n_azim > 32 * kMaxChunks) return (int)cudaErrorInvalidValue;
  const size_t smem =
      smem_bytes(n_elev, n_azim, n_bins, n_freqs, max_in, max_t);
  int dev = 0;
  cudaError_t err = nsc::current_device(&dev);
  if (err != cudaSuccess) return (int)err;
  if ((int)smem > 48 * 1024 && (int)smem > g_smem_allowed[dev]) {
    err = cudaFuncSetAttribute(spectral_encode_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    g_smem_allowed[dev] = (int)smem;
  }
  spectral_encode_kernel<<<batch * kCluster, kThreads, smem,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(imgs), static_cast<const int*>(bounds),
      static_cast<const float2*>(twiddle), static_cast<float*>(out), n_elev,
      n_azim, n_target, n_bins, n_freqs, max_in, max_t, eps, interpolate);
  return (int)cudaGetLastError();
}

// The kernel's function, for the census of captured serving graphs
// (nsc_graph_census in project.cu).
extern "C" const void* nsc_spectral_kernel_handle() {
  return reinterpret_cast<const void*>(spectral_encode_kernel);
}
