// General projection: arbitrary-order points -> range image, per-pixel min.
//
// Replaces the TPU kernels neural_spectral_codec_tpu/ops/pallas_compact.py
// (_compact_kernel) and ops/pallas_densify.py (_kernel), together with the
// packed-key XLA sort before them (ops/range_image.py:145-249,
// _project_points_batch_compact). On the TPU, scatter is slow, so the min
// per pixel was a sort, a run-suffix-min, a compaction butterfly and an
// expansion butterfly. What they compute together is
//     image[b, elev_bin, az_bin] = min range over the valid points of scan b
//                                  in that pixel, 0 for an empty pixel
// (np.minimum.at semantics, range_image.project_points).
//
// What bounds it on the H100: reading the points (16 B each; 2.1 MB per
// full-density HDL-64E scan) and the per-point atan2/sqrt work (the two
// angles in float64, see common.cuh; the H100 has half-rate FP64). The image
// (92 KB per scan) stays in L2.
//
// Design: a grid over points (blockIdx.y = scan) so that every SM takes
// part even at B = 8; one CTA per scan with the image in shared memory
// would leave 124 of 132 SMs idle at that batch. Each valid point takes an
// atomicMin on the uint32 bits of its range in a global image initialised
// to +inf by the wrapper (valid ranges are >= min_range >= 0, so the bit
// order of non-negative floats is their value order). A second, pointwise
// pass turns +inf into 0.
#include "common.cuh"

namespace {

__global__ void __launch_bounds__(256)
project_points_kernel(const float* __restrict__ pts, unsigned* __restrict__ img,
                      long long n_points, int n_chan, nsc::Geometry g) {
  const int b = blockIdx.y;
  const float* p = pts + (long long)b * n_points * n_chan;
  unsigned* im = img + (long long)b * g.n_elev * g.n_azim;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < n_points; i += (long long)gridDim.x * blockDim.x) {
    const float* q = p + i * n_chan;
    float rng = 0.0f;
    int ab = 0, eb = 0;
    if (nsc::project_point(q[0], q[1], q[2], g, true, &rng, &ab, &eb)) {
      atomicMin(im + eb * g.n_azim + ab, __float_as_uint(rng));
    }
  }
}

__global__ void inf_to_zero_kernel(unsigned* __restrict__ img, long long n) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    if (img[i] == nsc::kInfBits) img[i] = 0u;
  }
}

}  // namespace

// points (B, N, n_chan) float32, contiguous; img (B, n_elev, n_azim) float32,
// filled with +inf by the caller. Returns cudaGetLastError() after launching.
extern "C" int nsc_project_points(const void* points, void* img, int batch,
                                  long long n_points, int n_chan, int n_elev,
                                  int n_azim, float min_range, float max_range,
                                  float elev_min, float elev_max,
                                  float elev_span, int drop, void* stream) {
  const nsc::Geometry g{n_elev, n_azim, min_range, max_range,
                        elev_min, elev_max, elev_span, drop};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int threads = 256;
  long long want = (n_points + threads - 1) / threads;
  const int blocks_x = (int)(want < 1 ? 1 : (want > 4096 ? 4096 : want));
  if (n_points > 0) {
    project_points_kernel<<<dim3(blocks_x, batch), threads, 0, s>>>(
        static_cast<const float*>(points), static_cast<unsigned*>(img),
        n_points, n_chan, g);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  const long long n_pix = (long long)batch * n_elev * n_azim;
  long long fb = (n_pix + threads - 1) / threads;
  inf_to_zero_kernel<<<(int)(fb > 1024 ? 1024 : fb), threads, 0, s>>>(
      static_cast<unsigned*>(img), n_pix);
  return (int)cudaGetLastError();
}

extern "C" const char* nsc_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
