// Ring-structured projection: ring-major points -> range image.
//
// Replaces the TPU kernel neural_spectral_codec_tpu/ops/pallas_ring.py
// (_ring_fold_kernel), fused with what surrounds it on the ring path:
// ops/ring_path.py _ring_keys (range, azimuth bin and gates from raw xyz),
// _fold_min (min over folds) and the static row placement of
// project_rings_batch. The TPU kernel's jump-fill, run-start, run-min and
// compaction/expansion butterflies work around slow scatter; the function
// they compute is
//     image[b, row_of_ring[r], az_bin] = min range over the KEPT valid
//                                        points of ring r in that bin.
// Walk a ring's valid points in order. A wrap event is a valid point whose
// azimuth bin is strictly less than the previous valid point's bin; the
// first valid point is never one. A point is kept while at most
// n_folds - 1 events have occurred up to and including it.
//
// What bounds it on the H100: reading the points (16 B each; 2.1 MB per
// full-density scan) and the per-point atan2/sqrt work (angles in float64,
// see common.cuh).
//
// Design: one CTA per (scan, ring), B*R CTAs (512 at B = 8, R = 64).
//   1. Coalesced pass over the ring's points: azimuth bin (or -1) and range
//      of each point into shared memory.
//   2. Each thread owns a contiguous chunk of the ring. A block-wide scan
//      of "last valid bin of the chunk" gives every chunk the bin of the
//      valid point before it; a block-wide sum of the chunks' event counts
//      gives every chunk the events before it.
//   3. Each thread walks its chunk again; kept points take an atomicMin on
//      the uint32 bits of their range in a 360-wide row in shared memory
//      initialised to +inf (valid ranges are >= min_range >= 0, so bit
//      order is value order).
//   4. The row goes to image[b, row_of_ring[r]] with +inf -> 0. Rows with
//      no ring are zeroed by the wrapper, which allocates with zeros.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
ring_fold_kernel(const float* __restrict__ pts, const int* __restrict__ row_of_ring,
                 float* __restrict__ img, int n_rings, int per_ring, int n_chan,
                 int n_folds, nsc::Geometry g) {
  extern __shared__ unsigned char smem[];
  int* key = reinterpret_cast<int*>(smem);                  // per_ring
  float* val = reinterpret_cast<float*>(key + per_ring);    // per_ring
  unsigned* row = reinterpret_cast<unsigned*>(val + per_ring);  // n_azim
  int* last_bin = reinterpret_cast<int*>(row + g.n_azim);   // kThreads
  int* events = last_bin + kThreads;                        // kThreads

  const int ring = blockIdx.x;            // b * n_rings + r
  const int b = ring / n_rings;
  const int r = ring - b * n_rings;
  const int tid = threadIdx.x;
  const float* p = pts + (long long)ring * per_ring * n_chan;

  for (int i = tid; i < per_ring; i += kThreads) {
    const float* q = p + (long long)i * n_chan;
    float rng = 0.0f;
    int ab = -1, eb = 0;
    const bool ok = nsc::project_point(q[0], q[1], q[2], g, false, &rng, &ab, &eb);
    key[i] = ok ? ab : -1;
    val[i] = rng;  // read only where key >= 0
  }
  for (int a = tid; a < g.n_azim; a += kThreads) row[a] = nsc::kInfBits;
  __syncthreads();

  const int per = (per_ring + kThreads - 1) / kThreads;
  const int lo = min(tid * per, per_ring);
  const int hi = min(lo + per, per_ring);

  // last valid bin of each chunk, then an inclusive scan with
  // combine(left, right) = right if right is valid else left
  int last = -1;
  for (int i = lo; i < hi; ++i) last = key[i] >= 0 ? key[i] : last;
  last_bin[tid] = last;
  __syncthreads();
  for (int off = 1; off < kThreads; off <<= 1) {
    const int mine = last_bin[tid];
    const int left = tid >= off ? last_bin[tid - off] : -1;
    __syncthreads();
    if (mine < 0) last_bin[tid] = left;
    __syncthreads();
  }
  const int prev_in = tid > 0 ? last_bin[tid - 1] : -1;

  // wrap events inside each chunk, then an inclusive prefix sum
  int prev = prev_in, n_ev = 0;
  for (int i = lo; i < hi; ++i) {
    const int k = key[i];
    if (k >= 0) {
      n_ev += (prev >= 0 && k < prev);
      prev = k;
    }
  }
  events[tid] = n_ev;
  __syncthreads();
  for (int off = 1; off < kThreads; off <<= 1) {
    const int add = tid >= off ? events[tid - off] : 0;
    __syncthreads();
    events[tid] += add;
    __syncthreads();
  }
  int folds = tid > 0 ? events[tid - 1] : 0;

  prev = prev_in;
  for (int i = lo; i < hi; ++i) {
    const int k = key[i];
    if (k >= 0) {
      folds += (prev >= 0 && k < prev);
      prev = k;
      if (folds <= n_folds - 1) atomicMin(row + k, __float_as_uint(val[i]));
    }
  }
  __syncthreads();

  float* out = img + ((long long)b * g.n_elev + row_of_ring[r]) * g.n_azim;
  for (int a = tid; a < g.n_azim; a += kThreads) {
    const unsigned bits = row[a];
    out[a] = bits == nsc::kInfBits ? 0.0f : __uint_as_float(bits);
  }
}

}  // namespace

// points (B, R, P, n_chan) float32 contiguous; row_of_ring (R,) int32,
// strictly increasing, < n_elev; img (B, n_elev, n_azim) float32, zeroed by
// the caller. Returns cudaGetLastError() after launching.
extern "C" int nsc_ring_fold(const void* points, const void* row_of_ring,
                             void* img, int batch, int n_rings, int per_ring,
                             int n_chan, int n_folds, int n_elev, int n_azim,
                             float min_range, float max_range, float elev_min,
                             float elev_max, float elev_span, int drop,
                             void* stream) {
  const nsc::Geometry g{n_elev, n_azim, min_range, max_range,
                        elev_min, elev_max, elev_span, drop};
  const size_t smem = (size_t)per_ring * (sizeof(int) + sizeof(float)) +
                      (size_t)n_azim * sizeof(unsigned) +
                      2 * kThreads * sizeof(int);
  cudaError_t err = cudaFuncSetAttribute(
      ring_fold_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  ring_fold_kernel<<<batch * n_rings, kThreads, smem,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(points), static_cast<const int*>(row_of_ring),
      static_cast<float*>(img), n_rings, per_ring, n_chan, n_folds, g);
  return (int)cudaGetLastError();
}
