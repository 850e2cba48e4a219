// Ring-structured projection: ring-major points -> range image.
//
// Replaces the TPU kernel neural_spectral_codec_tpu/ops/pallas_ring.py
// (_ring_fold_kernel; pallas_call at :248), fused with what surrounds it on
// the ring path: ops/ring_path.py _ring_keys (range, azimuth bin and gates
// from raw xyz), _fold_min (min over folds) and the static row placement of
// project_rings_batch. The TPU kernel's jump-fill, run-start, run-min and
// compaction/expansion butterflies work around slow scatter; the function
// they compute is
//     image[b, row_of_ring[r], az_bin] = min range over the KEPT valid
//                                        points of ring r in that bin,
// rows without a ring 0. Walk a ring's valid points in order. A wrap event
// is a valid point whose azimuth bin is strictly less than the previous
// valid point's bin; the first valid point is never one. A point is kept
// while at most n_folds - 1 events have occurred up to and including it.
//
// What bounds it on the H100, at B = 8 full-density HDL-64E scans (64 rings
// x 2088 points x 16 B): it reads 17,104,896 B of points and writes
// 737,280 B of image, 17.84 MB in all, 5.33 us at 3.35 TB/s (0.67 us at
// B = 1). It is memory-bound; the per-point math (a square root, the angle)
// must hide under the loads.
//
// Design: one CTA per (scan, ring), B*R CTAs (512 at B = 8, R = 64), of
// 256 threads; of 1024 when every ring has an SM of its own (B = 1), so
// that each thread takes 2-3 points of its ring instead of 8-9.
//   1. Coalesced pass over the ring's points (16-byte float4 loads when the
//      points have 4 channels): azimuth bin (or -1) and range of each point
//      into shared memory. The angle is float64 atan2 rounded once, as the
//      plain version computes it (common.cuh); the mod 2*pi is an exact
//      compare-and-subtract instead of fmodf. (An atan2f path with a
//      float64 fallback near bin edges kept the bits but was slower on the
//      H100 than float64 atan2 throughout: PERF.md, kernel findings.)
//   2. Each thread owns a contiguous chunk of the ring and summarises it:
//      first valid bin, last valid bin, wrap events inside. Summaries
//      combine associatively (the events of L.R are L.ev + R.ev, plus one
//      when L.last and R.first are valid and R.first < L.last), so ONE
//      exclusive scan, warp shuffles and then a warp scan of the warps'
//      totals, gives every chunk the bin of the valid point before it and
//      the events before it.
//   3. Each thread walks its chunk; kept points take an atomicMin on the
//      uint32 bits of their range in a 360-wide row in shared memory
//      initialised to +inf (valid ranges are >= min_range >= 0, so bit
//      order is value order).
//   4. The row goes to image[b, row_of_ring[r]] with +inf -> 0. The CTA of
//      ring r also zeroes the image rows between ring r-1's row and its
//      own (the last ring: and the rows after its own), so the wrapper
//      allocates the image without a memset.
// The wrapper caches row_of_ring on the device; cudaFuncSetAttribute runs
// only when a launch needs more dynamic shared memory than any before it on
// the same device.
//
// ptxas (nvcc -Xptxas -v with _build.NVCC_FLAGS, sm_90a, CUDA 12.8, on an
// H100): 39 registers (256 threads) and 36 (1024 threads), 0 bytes of
// stack, 0 spill stores or loads, one barrier, 96 / 384 B of static shared
// memory; dynamic shared memory 18,144 B per CTA at 2088 points per ring and
// A 360. Device time on an H100 80GB HBM3 at 700 W: PERF.md, kernel table.
#include <cstdint>

#include "common.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;

// A run of points: its first and last valid bin (-1: none) and the wrap
// events between its valid points.
struct Summary {
  int first, last, ev;
};

__device__ __forceinline__ Summary combine(const Summary& l, const Summary& r) {
  return {l.first >= 0 ? l.first : r.first, r.last >= 0 ? r.last : l.last,
          l.ev + r.ev + (l.last >= 0 && r.first >= 0 && r.first < l.last)};
}

__device__ __forceinline__ Summary shfl_up(const Summary& s, int off) {
  return {__shfl_up_sync(kFull, s.first, off),
          __shfl_up_sync(kFull, s.last, off),
          __shfl_up_sync(kFull, s.ev, off)};
}

// Exclusive scan of one Summary per lane across the warp.
__device__ __forceinline__ Summary warp_exclusive(Summary s, int lane) {
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const Summary left = shfl_up(s, off);
    if (lane >= off) s = combine(left, s);
  }
  Summary pre = shfl_up(s, 1);
  if (lane == 0) pre = {-1, -1, 0};
  return pre;
}

template <int kThreads>
__global__ void __launch_bounds__(kThreads)
ring_fold_kernel(const float* __restrict__ pts, const int* __restrict__ row_of_ring,
                 float* __restrict__ img, int n_rings, int per_ring, int n_chan,
                 int vec4, int n_folds, nsc::Geometry g) {
  constexpr int kWarps = kThreads / 32;
  extern __shared__ unsigned char smem[];
  int* key = reinterpret_cast<int*>(smem);                  // per_ring
  float* val = reinterpret_cast<float*>(key + per_ring);    // per_ring
  unsigned* row = reinterpret_cast<unsigned*>(val + per_ring);  // n_azim
  __shared__ Summary warp_pre[kWarps];

  const int ring = blockIdx.x;            // b * n_rings + r
  const int b = ring / n_rings;
  const int r = ring - b * n_rings;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const float* p = pts + (long long)ring * per_ring * n_chan;

  for (int i = tid; i < per_ring; i += kThreads) {
    float x, y, z;
    if (vec4) {
      const float4 q = __ldg(reinterpret_cast<const float4*>(p) + i);
      x = q.x, y = q.y, z = q.z;
    } else {
      const float* q = p + (long long)i * n_chan;
      x = __ldg(q), y = __ldg(q + 1), z = __ldg(q + 2);
    }
    float rng = 0.0f;
    int ab = -1, eb = 0;
    const bool ok = nsc::project_point(x, y, z, g, false, &rng, &ab, &eb);
    key[i] = ok ? ab : -1;
    val[i] = rng;  // read only where key >= 0
  }
  for (int a = tid; a < g.n_azim; a += kThreads) row[a] = nsc::kInfBits;

  // image rows without a ring: those between the previous ring's row and
  // this ring's, and after the last ring's
  float* scan_img = img + (long long)b * g.n_elev * g.n_azim;
  const int my_row = row_of_ring[r];
  const int gap_lo = (r > 0 ? row_of_ring[r - 1] : -1) + 1;
  for (int i = tid + gap_lo * g.n_azim; i < my_row * g.n_azim; i += kThreads)
    scan_img[i] = 0.0f;
  if (r == n_rings - 1)
    for (int i = tid + (my_row + 1) * g.n_azim; i < g.n_elev * g.n_azim;
         i += kThreads)
      scan_img[i] = 0.0f;
  __syncthreads();

  const int per = (per_ring + kThreads - 1) / kThreads;
  const int lo = min(tid * per, per_ring);
  const int hi = min(lo + per, per_ring);

  Summary s{-1, -1, 0};
  for (int i = lo; i < hi; ++i) {
    const int k = key[i];
    if (k >= 0) {
      if (s.first < 0) s.first = k;
      s.ev += (s.last >= 0 && k < s.last);
      s.last = k;
    }
  }
  // exclusive scan: inside each warp, then across the warps' totals
  Summary pre = warp_exclusive(s, lane);
  if (lane == 31) warp_pre[warp] = combine(pre, s);
  __syncthreads();
  if (warp == 0) {
    const Summary total = lane < kWarps ? warp_pre[lane] : Summary{-1, -1, 0};
    const Summary before = warp_exclusive(total, lane);
    if (lane < kWarps) warp_pre[lane] = before;
  }
  __syncthreads();
  pre = combine(warp_pre[warp], pre);

  int folds = pre.ev, prev = pre.last;
  for (int i = lo; i < hi; ++i) {
    const int k = key[i];
    if (k >= 0) {
      folds += (prev >= 0 && k < prev);
      prev = k;
      if (folds > n_folds - 1) break;   // folds never decrease
      atomicMin(row + k, __float_as_uint(val[i]));
    }
  }
  __syncthreads();

  float* out = scan_img + (long long)my_row * g.n_azim;
  for (int a = tid; a < g.n_azim; a += kThreads) {
    const unsigned bits = row[a];
    out[a] = bits == nsc::kInfBits ? 0.0f : __uint_as_float(bits);
  }
}

// kThreads 1024 when every ring gets an SM of its own (B = 1), so that a
// ring's points are spread over more threads; 256 when the rings fill the
// card several times over (36 registers x 1024 threads leave room for one
// such CTA per SM). Both timed in turns on an H100 80GB HBM3 (PERF.md):
// at B = 1 1024 threads 6.2 us against 9.0 us, at B = 8 256 threads 14.1 us
// against 22.8 us.
constexpr int kFewThreads = 256;
constexpr int kManyThreads = 1024;
// per device: its SMs (0: not yet read) and, per thread count, the dynamic
// shared memory allowed so far (0: the default 48 KB)
int g_sms[nsc::kMaxDevices] = {};
size_t g_smem_allowed[nsc::kMaxDevices][2] = {};

template <int kThreads>
cudaError_t launch(int dev, int slot, const float* pts, const int* rows,
                   float* img, int grid, int n_rings, int per_ring, int n_chan,
                   int vec4, int n_folds, const nsc::Geometry& g, size_t smem,
                   cudaStream_t stream) {
  if (smem > 48 * 1024 && smem > g_smem_allowed[dev][slot]) {
    cudaError_t err = cudaFuncSetAttribute(
        ring_fold_kernel<kThreads>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
    g_smem_allowed[dev][slot] = smem;
  }
  ring_fold_kernel<kThreads><<<grid, kThreads, smem, stream>>>(
      pts, rows, img, n_rings, per_ring, n_chan, vec4, n_folds, g);
  return cudaGetLastError();
}

}  // namespace

// points (B, R, P, n_chan) float32 contiguous; row_of_ring (R,) int32,
// strictly increasing, < n_elev; img (B, n_elev, n_azim) float32, every
// pixel written here. Returns cudaGetLastError() after launching.
extern "C" int nsc_ring_fold(const void* points, const void* row_of_ring,
                             void* img, int batch, int n_rings, int per_ring,
                             int n_chan, int n_folds, int n_elev, int n_azim,
                             float min_range, float max_range, float elev_min,
                             float elev_max, float elev_span, int drop,
                             void* stream) {
  const nsc::Geometry g{n_elev, n_azim, min_range, max_range,
                        elev_min, elev_max, elev_span, drop};
  const size_t smem = (size_t)per_ring * (sizeof(int) + sizeof(float)) +
                      (size_t)n_azim * sizeof(unsigned);
  int dev = 0;
  cudaError_t err = nsc::current_device(&dev);
  if (err == cudaSuccess && g_sms[dev] == 0)
    err = cudaDeviceGetAttribute(&g_sms[dev], cudaDevAttrMultiProcessorCount,
                                 dev);
  if (err != cudaSuccess) return (int)err;
  const int vec4 =
      n_chan == 4 && reinterpret_cast<std::uintptr_t>(points) % 16 == 0;
  const int grid = batch * n_rings;
  const auto* pts = static_cast<const float*>(points);
  const auto* rows = static_cast<const int*>(row_of_ring);
  auto* out = static_cast<float*>(img);
  const auto s = static_cast<cudaStream_t>(stream);
  return (int)(grid <= g_sms[dev]
                   ? launch<kManyThreads>(dev, 1, pts, rows, out, grid,
                                          n_rings, per_ring, n_chan, vec4,
                                          n_folds, g, smem, s)
                   : launch<kFewThreads>(dev, 0, pts, rows, out, grid,
                                         n_rings, per_ring, n_chan, vec4,
                                         n_folds, g, smem, s));
}

// The kernel's functions (0: 256 threads, 1: 1024), for the census of
// captured serving graphs (nsc_graph_census in project.cu).
extern "C" const void* nsc_ring_fold_kernel_handle(int slot) {
  return slot ? reinterpret_cast<const void*>(ring_fold_kernel<kManyThreads>)
              : reinterpret_cast<const void*>(ring_fold_kernel<kFewThreads>);
}
