// Roll + compare + select floors: the unit the ring probe's phase costs are
// compared against, and the primitive rate of a circular-shift chain.
//
// Replaces two TPU probes:
//   * experiments/ring_stage_probe.py _floor_kernel (nsc_roll_floor):
//     n_stages steps of a_s = roll(a, s); take = a_s < a; a = take ? a_s : a,
//     over one carried array, or two (b follows a's choice); out = a + b;
//   * experiments/profile_hotpath.py _roll_kernel (nsc_roll_min_chain):
//     y = x + 1, then n_stages steps of r = roll(y, s); y = r < y ? r : y.
// roll follows np.roll: roll(a, s)[i] = a[(i - s) mod W]. The shift of each
// stage is computed on the host, reduced mod W, and passed by value (the
// TPU probe's doubling shift overflows an int32 after 31 stages).
//
// Design: one CTA per row. The row lives in shared memory with ping-pong
// buffers; each stage reads src[(i - s) mod W] and src[i], writes dst[i],
// then __syncthreads(). What bounds it on the H100: two shared-memory loads,
// a compare, a select and a store per element and stage, and one barrier
// per stage; the row is read from and written to device memory once.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxStages = 128;   // MAX_STAGES in ops/probe_kernels.py

struct Shifts {
  int s[kMaxStages];
};

template <int kArrays>
__global__ void __launch_bounds__(kThreads)
roll_floor_kernel(const float* __restrict__ x, const float* __restrict__ y,
                  float* __restrict__ out, int width, int n_stages, Shifts shifts) {
  extern __shared__ float buf[];
  float* a = buf;                 // width each: a, a', b, b'
  float* a_next = a + width;
  float* b = a_next + width;
  float* b_next = b + width;
  const long long base = (long long)blockIdx.x * width;
  const int tid = threadIdx.x;
  for (int i = tid; i < width; i += kThreads) {
    a[i] = x[base + i];
    b[i] = y[base + i];
  }
  __syncthreads();
  for (int st = 0; st < n_stages; ++st) {
    const int s = shifts.s[st];
    for (int i = tid; i < width; i += kThreads) {
      int j = i - s;
      if (j < 0) j += width;
      const float shifted = a[j], mine = a[i];
      const bool take = shifted < mine;
      a_next[i] = take ? shifted : mine;
      if (kArrays == 2) b_next[i] = take ? b[j] : b[i];
    }
    __syncthreads();
    float* t = a; a = a_next; a_next = t;
    if (kArrays == 2) { t = b; b = b_next; b_next = t; }
  }
  for (int i = tid; i < width; i += kThreads) out[base + i] = a[i] + b[i];
}

__global__ void __launch_bounds__(kThreads)
roll_min_chain_kernel(const float* __restrict__ x, float* __restrict__ out,
                      int width, int n_stages, Shifts shifts) {
  extern __shared__ float buf[];
  float* y = buf;
  float* y_next = y + width;
  const long long base = (long long)blockIdx.x * width;
  const int tid = threadIdx.x;
  for (int i = tid; i < width; i += kThreads) y[i] = x[base + i] + 1.0f;
  __syncthreads();
  for (int st = 0; st < n_stages; ++st) {
    const int s = shifts.s[st];
    for (int i = tid; i < width; i += kThreads) {
      int j = i - s;
      if (j < 0) j += width;
      const float r = y[j], mine = y[i];
      y_next[i] = r < mine ? r : mine;
    }
    __syncthreads();
    float* t = y; y = y_next; y_next = t;
  }
  for (int i = tid; i < width; i += kThreads) out[base + i] = y[i];
}

// Copies the host schedule, each shift reduced into [0, width).
bool load_shifts(const int* host, int n_stages, int width, Shifts* shifts) {
  if (n_stages < 0 || n_stages > kMaxStages || width < 1) return false;
  for (int st = 0; st < n_stages; ++st) {
    if (host[st] < 0 || host[st] >= width) return false;
    shifts->s[st] = host[st];
  }
  return true;
}

template <typename Kernel>
cudaError_t set_smem(Kernel kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

}  // namespace

// x, y, out (n_rows, width) float32 contiguous; shifts: n_stages host ints in
// [0, width). Returns cudaGetLastError() after launching.
extern "C" int nsc_roll_floor(const void* x, const void* y, void* out, int n_rows,
                              int width, int n_stages, int n_arrays,
                              const int* shifts, void* stream) {
  Shifts sh;
  if (!load_shifts(shifts, n_stages, width, &sh) || (n_arrays != 1 && n_arrays != 2))
    return (int)cudaErrorInvalidValue;
  const size_t smem = 4 * (size_t)width * sizeof(float);
  auto kernel = n_arrays == 2 ? roll_floor_kernel<2> : roll_floor_kernel<1>;
  cudaError_t err = set_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<n_rows, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(y),
      static_cast<float*>(out), width, n_stages, sh);
  return (int)cudaGetLastError();
}

// x, out (n_rows, width) float32 contiguous; shifts as above.
extern "C" int nsc_roll_min_chain(const void* x, void* out, int n_rows, int width,
                                  int n_stages, const int* shifts, void* stream) {
  Shifts sh;
  if (!load_shifts(shifts, n_stages, width, &sh)) return (int)cudaErrorInvalidValue;
  const size_t smem = 2 * (size_t)width * sizeof(float);
  cudaError_t err = set_smem(roll_min_chain_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  roll_min_chain_kernel<<<n_rows, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(out), width, n_stages, sh);
  return (int)cudaGetLastError();
}
