// Spectral encoder: range images -> normalised spectral histograms.
//
// Replaces the TPU kernel neural_spectral_codec_tpu/ops/pallas_spectral.py
// (_kernel with _interpolate_block). Per scan, in order:
//   1. circular linear interpolation of empty (<= 0 or NaN) pixels per row,
//      from the nearest valid pixel left and right, weighted by distance
//      (rows with no valid pixel stay as they are);
//   2. empty-row fill: an empty row takes the nearest originally non-empty
//      row above it, else the nearest below;
//   3. adaptive average pooling of the rows (64 -> 16);
//   4. unnormalised real-DFT magnitudes against the cos/sin tables of
//      ops/spectral.dft_bases (181 frequencies at 360 columns), fp32 FMA;
//   5. exponential-alpha binning through an int32 bin index per frequency,
//      computed by the wrapper from alpha (alpha stays a runtime input);
//   6. sum-to-1 over the scan's whole histogram, or a uniform 1/(T*n_bins)
//      when the total is <= epsilon.
// Steps 1-2 run only when `interpolate` is set (config.interpolate_empty).
//
// What bounds it on the H100: the DFT, 16 x 181 x 360 x 2 = 2.1 M FMA per
// scan on the one SM that holds the scan, plus its reads of the 521 KB of
// tables (from L2 after the first CTA). At B = 8 only 8 of 132 SMs work;
// spreading a scan over several CTAs is later work.
//
// Design: one CTA of 512 threads per scan with the image (92,160 B at
// 64 x 360), the pooled rows, the magnitudes and the histogram in dynamic
// shared memory (about 131 KB, above the 48 KB default, hence the
// cudaFuncSetAttribute before the launch). Interpolation: one warp per
// row; a warp-wide max scan over column chunks gives the nearest valid
// column to the left (carried in from the row's last valid column, for the
// wrap) and a min scan from the right gives the nearest to the right. The
// blend (v_l * d_r + v_r * d_l) / (d_l + d_r) is rounded step by step as
// the JAX reference computes it.
#include <climits>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;
constexpr int kMaxChunks = 12;      // n_azim <= 32 * kMaxChunks = 384
constexpr int kRowsPerJob = 8;      // DFT rows per thread
constexpr unsigned kFull = 0xffffffffu;

// Interpolates one row in place (whole warp). Valid pixels are never
// written and empty pixels never read, so the row needs no second buffer.
__device__ void interpolate_row(float* row, int n_azim, int lane,
                                int* nonempty) {
  const int n_chunks = (n_azim + 31) / 32;
  int first = INT_MAX, last = -1;
  for (int c = 0; c < n_chunks; ++c) {
    const int idx = c * 32 + lane;
    if (idx < n_azim && row[idx] > 0.0f) {
      first = min(first, idx);
      last = max(last, idx);
    }
  }
  for (int off = 16; off > 0; off >>= 1) {
    first = min(first, __shfl_xor_sync(kFull, first, off));
    last = max(last, __shfl_xor_sync(kFull, last, off));
  }
  if (lane == 0) *nonempty = last >= 0;
  if (last < 0) return;

  // nearest valid column at or left of each column; virtual index < 0
  // means "wrapped to the previous turn" (column + n_azim)
  int left[kMaxChunks];
  int carry = last - n_azim;
#pragma unroll
  for (int c = 0; c < kMaxChunks; ++c) {
    if (c < n_chunks) {
      const int idx = c * 32 + lane;
      int x = (idx < n_azim && row[idx] > 0.0f) ? idx : INT_MIN;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int y = __shfl_up_sync(kFull, x, off);
        if (lane >= off) x = max(x, y);
      }
      x = max(x, carry);
      left[c] = x;
      carry = __shfl_sync(kFull, x, 31);
    }
  }
  // nearest valid column at or right of each column; >= n_azim wraps
  carry = first + n_azim;
#pragma unroll
  for (int c = kMaxChunks - 1; c >= 0; --c) {
    if (c < n_chunks) {
      const int idx = c * 32 + lane;
      const bool valid = idx < n_azim && row[idx] > 0.0f;
      int x = valid ? idx : INT_MAX;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int y = __shfl_down_sync(kFull, x, off);
        if (lane + off < 32) x = min(x, y);
      }
      x = min(x, carry);
      carry = __shfl_sync(kFull, x, 0);
      if (idx < n_azim && !valid) {
        const int dl = idx - left[c];
        const int dr = x - idx;
        const float vl = row[left[c] < 0 ? left[c] + n_azim : left[c]];
        const float vr = row[x >= n_azim ? x - n_azim : x];
        row[idx] = __fdiv_rn(
            __fadd_rn(__fmul_rn(vl, (float)dr), __fmul_rn(vr, (float)dl)),
            (float)(dl + dr));
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads)
spectral_encode_kernel(const float* __restrict__ imgs,
                       const int* __restrict__ assign,
                       const float* __restrict__ cos_b,
                       const float* __restrict__ sin_b,
                       float* __restrict__ out, int n_elev, int n_azim,
                       int n_target, int n_bins, int n_freqs, float eps,
                       int interpolate) {
  extern __shared__ float sm[];
  float* img = sm;                                   // n_elev * n_azim
  float* pooled = img + n_elev * n_azim;             // n_target * n_azim
  float* mags = pooled + n_target * n_azim;          // n_target * n_freqs
  float* hist = mags + n_target * n_freqs;           // n_target * n_bins
  int* bin_of = reinterpret_cast<int*>(hist + n_target * n_bins);  // n_freqs
  int* nonempty = bin_of + n_freqs;                  // n_elev
  float* red = reinterpret_cast<float*>(nonempty + n_elev);        // 33

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  constexpr int kWarps = kThreads / 32;
  const int n_pix = n_elev * n_azim;
  const float* src = imgs + (long long)blockIdx.x * n_pix;

  for (int i = tid; i < n_pix; i += kThreads) img[i] = src[i];
  for (int k = tid; k < n_freqs; k += kThreads) bin_of[k] = assign[k];
  __syncthreads();

  if (interpolate) {
    for (int e = warp; e < n_elev; e += kWarps)
      interpolate_row(img + e * n_azim, n_azim, lane, nonempty + e);
    __syncthreads();
    // empty rows copy from originally non-empty rows, which are never
    // written here, so the copy can run in place
    for (int e = warp; e < n_elev; e += kWarps) {
      if (nonempty[e]) continue;
      int from = -1;
      for (int u = e - 1; u >= 0 && from < 0; --u)
        if (nonempty[u]) from = u;
      for (int u = e + 1; u < n_elev && from < 0; ++u)
        if (nonempty[u]) from = u;
      if (from < 0) continue;
      for (int a = lane; a < n_azim; a += 32)
        img[e * n_azim + a] = img[from * n_azim + a];
    }
    __syncthreads();
  }

  // adaptive average pooling: output row t averages input rows
  // [floor(t*E/T), ceil((t+1)*E/T))
  for (int i = tid; i < n_target * n_azim; i += kThreads) {
    const int t = i / n_azim;
    const int a = i - t * n_azim;
    const int e0 = (t * n_elev) / n_target;
    const int e1 = ((t + 1) * n_elev + n_target - 1) / n_target;
    const float w = 1.0f / (float)(e1 - e0);
    float acc = 0.0f;
    for (int e = e0; e < e1; ++e) acc = fmaf(w, img[e * n_azim + a], acc);
    pooled[i] = acc;
  }
  __syncthreads();

  // |rfft| per pooled row: thread = (frequency, group of 8 rows)
  const int n_groups = (n_target + kRowsPerJob - 1) / kRowsPerJob;
  for (int job = tid; job < n_freqs * n_groups; job += kThreads) {
    const int k = job % n_freqs;
    const int t0 = (job / n_freqs) * kRowsPerJob;
    float re[kRowsPerJob], im[kRowsPerJob];
#pragma unroll
    for (int j = 0; j < kRowsPerJob; ++j) re[j] = im[j] = 0.0f;
    for (int a = 0; a < n_azim; ++a) {
      const float c = __ldg(cos_b + a * n_freqs + k);
      const float s = __ldg(sin_b + a * n_freqs + k);
#pragma unroll
      for (int j = 0; j < kRowsPerJob; ++j) {
        if (t0 + j < n_target) {
          const float p = pooled[(t0 + j) * n_azim + a];
          re[j] = fmaf(p, c, re[j]);
          im[j] = fmaf(p, s, im[j]);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < kRowsPerJob; ++j)
      if (t0 + j < n_target)
        mags[(t0 + j) * n_freqs + k] = sqrtf(re[j] * re[j] + im[j] * im[j]);
  }
  __syncthreads();

  // binning, in frequency order, and this thread's share of the total
  float part = 0.0f;
  for (int i = tid; i < n_target * n_bins; i += kThreads) {
    const int t = i / n_bins;
    const int bin = i - t * n_bins;
    float acc = 0.0f;
    for (int k = 0; k < n_freqs; ++k)
      if (bin_of[k] == bin) acc += mags[t * n_freqs + k];
    hist[i] = acc;
    part += acc;
  }
  for (int off = 16; off > 0; off >>= 1)
    part += __shfl_down_sync(kFull, part, off);
  if (lane == 0) red[warp] = part;
  __syncthreads();
  if (warp == 0) {
    float v = lane < kWarps ? red[lane] : 0.0f;
    for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(kFull, v, off);
    if (lane == 0) red[32] = v;
  }
  __syncthreads();
  const float total = red[32];
  const int n_out = n_target * n_bins;
  float* dst = out + (long long)blockIdx.x * n_out;
  for (int i = tid; i < n_out; i += kThreads)
    dst[i] = total > eps ? hist[i] / (total + eps) : 1.0f / (float)n_out;
}

size_t smem_bytes(int n_elev, int n_azim, int n_target, int n_bins,
                  int n_freqs) {
  return sizeof(float) * ((size_t)n_elev * n_azim + (size_t)n_target * n_azim +
                          (size_t)n_target * n_freqs + (size_t)n_target * n_bins +
                          n_freqs + n_elev + 33);
}

}  // namespace

// imgs (B, n_elev, n_azim) float32; assign (n_freqs,) int32 bin per
// frequency; cos_b, sin_b (n_azim, n_freqs) float32; out (B, n_target *
// n_bins) float32. All contiguous on one device. Returns cudaGetLastError().
extern "C" int nsc_spectral_encode(const void* imgs, const void* assign,
                                   const void* cos_b, const void* sin_b,
                                   void* out, int batch, int n_elev, int n_azim,
                                   int n_target, int n_bins, int n_freqs,
                                   float eps, int interpolate, void* stream) {
  if (n_azim > 32 * kMaxChunks) return (int)cudaErrorInvalidValue;
  const size_t smem =
      smem_bytes(n_elev, n_azim, n_target, n_bins, n_freqs);
  cudaError_t err = cudaFuncSetAttribute(
      spectral_encode_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  spectral_encode_kernel<<<batch, kThreads, smem,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(imgs), static_cast<const int*>(assign),
      static_cast<const float*>(cos_b), static_cast<const float*>(sin_b),
      static_cast<float*>(out), n_elev, n_azim, n_target, n_bins, n_freqs, eps,
      interpolate);
  return (int)cudaGetLastError();
}
