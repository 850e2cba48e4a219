// Roll-chain probes as one windowed pass per row: the floor unit the ring
// probe's phase costs are compared against, and the roll + min chain of the
// stage profile.
//
// Replaces two TPU probes:
//   * experiments/ring_stage_probe.py:200 (_floor_kernel :176), nsc_roll_floor:
//     n_stages steps of a_s = roll(a, s_k); take = a_s < a; a = take ? a_s : a,
//     over one carried array, or two (b follows a's choice); out = a + b;
//   * experiments/profile_hotpath.py:254 (_roll_kernel :244),
//     nsc_roll_min_chain: y = x + 1, then n_stages steps of r = roll(y, s_k);
//     y = r < y ? r : y.
// roll follows np.roll: roll(a, s)[i] = a[(i - s) mod W]. The shifts are
// computed on the host and reduced mod W (the TPU probe's doubling shift
// overflows an int32 after 31 stages).
//
// What a chain computes. Its stages reach every subset sum of their offsets,
// and for both schedules that set is the range [0, L - 1], L = min(sum + 1, W)
// (ops/probe_kernels.roll_window checks that on the host; saturates() below
// compares L with W). With L == W, which every entry point's schedule
// reaches:
//   * P3 is the min of y over the whole row (x + 1 is never -0 in
//     round-to-nearest, so the min has one bit pattern);
//   * P2 is the element j at or after i, circularly, with the least a (IEEE <,
//     so -0 == +0), the first one among equals (a stage keeps "mine" on a
//     tie, and with doubling offsets each residue's first code is its
//     offset); out = a[j] + b[j], or a[j] + y[i] with one array, a[j] with
//     its own bits.
//
// Bound (bytes; each input read once, the output written once, 3.35 TB/s):
// 2 x 4 B per element for P3, 2.58 us at 512 x 2112; 3 x 4 B for P2, 3.99 us
// at 512 x 2176.
//
// Design: one CTA of 256 threads per row; 512 rows are 512 CTAs, resident at
// once on the 132 SMs (17-35 KB of shared memory each at the probe shapes).
// The row is read once into shared memory, with 16-byte loads where W % 4 == 0
// and every pointer is 16-byte aligned, scalar ones otherwise, each thread's
// loads (both arrays of P2) issued before any is used. On a saturated window
// (L == W) no stage is walked: P3 reduces the row min (warp shuffles, one
// value per warp) and writes it to every element; P2 reduces the min m, then
// each warp walks its span of the row backwards with ballots of a == m,
// carrying "the next index that holds m", which wraps to the row's first
// such index, and gathers a[j], b[j] from shared memory. The result leaves
// with 16-byte stores where allowed: one read and one write per element in
// device memory, in place of n_stages shared-memory passes that each end in
// a barrier (64 for the probe's P3, 12 for its P2).
//
// The stage chain (roll_chain) runs in shared memory inside the same kernel,
// fed by the shift array that the entry points carry, on two kinds of row:
//   * a row for which __syncthreads_or(isnan(x)) holds. A NaN never replaces
//     anything, and it blocks every value that would reach position i
//     through it, so on such a row the chain is no window minimum
//     (tests/test_torch_roll_window.py, test_nan_rows_are_not_windows);
//   * every row of a window shorter than the row (L < W). No entry point
//     runs one, and a one-pass van Herk / Gil-Werman window ran slower than
//     the chain at 4 stages on an H100 80GB HBM3 at 700 W (PERF.md).
#include <climits>
#include <cmath>
#include <cstdint>
#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxStages = 128;   // MAX_STAGES in ops/probe_kernels.py
constexpr int kUnroll = 4;        // loads in flight per thread and array

struct Shifts {
  int s[kMaxStages];
};

template <class F>
__device__ __forceinline__ void each(float& v, F f) { v = f(v); }

template <class F>
__device__ __forceinline__ void each(float4& v, F f) {
  v.x = f(v.x);
  v.y = f(v.y);
  v.z = f(v.z);
  v.w = f(v.w);
}

// Reads `width` floats of a row of src (and of src2 with kTwo) into shared
// memory, adding 1 with kPlusOne. Each thread issues kUnroll loads per array
// before it uses any (16-byte ones when kVec), so that a row costs one
// round trip to device memory, not one per load. Returns whether this thread
// saw a NaN in src; *lo gets the least value it saw there.
template <bool kVec, bool kTwo, bool kPlusOne>
__device__ bool load_rows(const float* __restrict__ src, float* dst,
                          const float* __restrict__ src2, float* dst2,
                          int width, float* lo) {
  using T = typename std::conditional<kVec, float4, float>::type;
  const T* s = reinterpret_cast<const T*>(src);
  const T* s2 = reinterpret_cast<const T*>(src2);
  T* d = reinterpret_cast<T*>(dst);
  T* d2 = reinterpret_cast<T*>(dst2);
  const int n = kVec ? width / 4 : width;
  bool nan = false;
  float m = INFINITY;
  auto take = [&](float v) {
    if (kPlusOne) v = __fadd_rn(v, 1.0f);
    nan |= isnan(v);
    m = fminf(m, v);
    return v;
  };
  for (int k0 = threadIdx.x; k0 < n; k0 += kUnroll * kThreads) {
    T v[kUnroll], w[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int k = k0 + u * kThreads;
      if (k < n) {
        v[u] = s[k];
        if (kTwo) w[u] = s2[k];
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int k = k0 + u * kThreads;
      if (k < n) {
        each(v[u], take);
        d[k] = v[u];
        if (kTwo) d2[k] = w[u];
      }
    }
  }
  *lo = m;
  return nan;
}

// dst[i] = value(i) for i < width (16-byte stores when kVec).
template <bool kVec, class Value>
__device__ void store_row(float* __restrict__ dst, int width, Value value) {
  if (kVec) {
    float4* d4 = reinterpret_cast<float4*>(dst);
    for (int k = threadIdx.x; k < width / 4; k += kThreads) {
      const int i = 4 * k;
      d4[k] = make_float4(value(i), value(i + 1), value(i + 2), value(i + 3));
    }
  } else {
    for (int i = threadIdx.x; i < width; i += kThreads) dst[i] = value(i);
  }
}

// The least of every thread's v (no NaN among them).
__device__ float block_min(float v) {
  __shared__ float part[kWarps];
  for (int o = 16; o > 0; o >>= 1) v = fminf(v, __shfl_xor_sync(~0u, v, o));
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = v;
  __syncthreads();
  v = part[0];
  for (int w = 1; w < kWarps; ++w) v = fminf(v, part[w]);
  return v;
}

// The stage chain itself, for rows that hold a NaN: a (and b with two arrays)
// hold the row, a_next and b_next are scratch. Returns the buffer that holds a
// at the end; *b_out gets b's.
template <int kArrays>
__device__ float* roll_chain(float* a, float* a_next, float* b, float* b_next,
                             int width, int n_stages, const Shifts& shifts,
                             float** b_out) {
  for (int st = 0; st < n_stages; ++st) {
    const int s = shifts.s[st];
    for (int i = threadIdx.x; i < width; i += kThreads) {
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
  *b_out = b;
  return a;
}

// P2 with L == width: o[i] = a[j] + b[j] (b[i] with one array), j the first
// index at or after i, circularly, with a[j] == m, the row's min. Each warp
// takes a span of whole 32-element groups and walks it backwards with
// ballots, carrying the next index that holds m; into the last group of a
// span comes the first such index of the spans after it, or of the row.
template <int kArrays>
__device__ void first_min_saturated(const float* a, const float* b, float m,
                                    int width, float* o) {
  __shared__ int first[kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int groups = (width + 31) / 32;
  const int per = (groups + kWarps - 1) / kWarps;
  const int g0 = min(warp * per, groups), g1 = min(g0 + per, groups);
  int f = INT_MAX;   // warp-uniform: the loop's ballots stay converged
  for (int g = g0; g < g1 && f == INT_MAX; ++g) {
    const int i = 32 * g + lane;
    const unsigned mask = __ballot_sync(~0u, i < width && a[i] == m);
    if (mask) f = 32 * g + __ffs(mask) - 1;
  }
  if (lane == 0) first[warp] = f;
  __syncthreads();
  int carry = INT_MAX, wrap = INT_MAX;
  for (int w = 0; w < kWarps; ++w) {
    wrap = min(wrap, first[w]);
    if (w > warp) carry = min(carry, first[w]);
  }
  if (carry == INT_MAX) carry = wrap;
  for (int g = g1 - 1; g >= g0; --g) {
    const int i = 32 * g + lane;
    const unsigned mask = __ballot_sync(~0u, i < width && a[i] == m);
    const unsigned here = mask & (~0u << lane);
    const int j = here ? 32 * g + __ffs(here) - 1 : carry;
    if (i < width) o[i] = __fadd_rn(a[j], kArrays == 2 ? b[j] : b[i]);
    if (mask) carry = 32 * g + __ffs(mask) - 1;
  }
}

template <int kArrays, bool kVec>
__global__ void __launch_bounds__(kThreads)
roll_floor_kernel(const float* __restrict__ x, const float* __restrict__ y,
                  float* __restrict__ out, int width, bool saturated,
                  int n_stages, Shifts shifts) {
  extern __shared__ __align__(16) float smem[];
  float* a = smem;   // width each: a, b, then the chain's second buffers
  float* b = a + width;
  float* s2 = b + width;
  const long long base = (long long)blockIdx.x * width;
  float lo;
  const bool nan = load_rows<kVec, true, false>(x + base, a, y + base, b,
                                                width, &lo);
  if (__syncthreads_or(nan) || !saturated) {
    float* b_end;
    const float* a_end = roll_chain<kArrays>(a, s2, b, s2 + width, width,
                                             n_stages, shifts, &b_end);
    store_row<kVec>(out + base, width,
                    [&](int i) { return __fadd_rn(a_end[i], b_end[i]); });
    return;
  }
  first_min_saturated<kArrays>(a, b, block_min(lo), width, s2);
  __syncthreads();
  store_row<kVec>(out + base, width, [&](int i) { return s2[i]; });
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
roll_min_chain_kernel(const float* __restrict__ x, float* __restrict__ out,
                      int width, bool saturated, int n_stages, Shifts shifts) {
  extern __shared__ __align__(16) float smem[];
  float* y = smem;   // width each: y, then the chain's second buffer
  float* s1 = y + width;
  const long long base = (long long)blockIdx.x * width;
  float lo;
  const bool nan = load_rows<kVec, false, true>(x + base, y, nullptr,
                                                nullptr, width, &lo);
  if (__syncthreads_or(nan) || !saturated) {
    float* unused;
    const float* y_end = roll_chain<1>(y, s1, nullptr, nullptr, width,
                                       n_stages, shifts, &unused);
    store_row<kVec>(out + base, width, [&](int i) { return y_end[i]; });
    return;
  }
  const float m = block_min(lo);
  store_row<kVec>(out + base, width, [&](int) { return m; });
}

// Copies the host schedule, each shift in [0, width).
bool load_shifts(const int* host, int n_stages, int width, Shifts* shifts) {
  if (n_stages < 0 || n_stages > kMaxStages || width < 1) return false;
  for (int st = 0; st < n_stages; ++st) {
    if (host[st] < 0 || host[st] >= width) return false;
    shifts->s[st] = host[st];
  }
  return true;
}

// Whether the chain covers the row: L = min(1 + the offsets' sum, width) ==
// width, for a schedule whose offsets form one range (the host's roll_window
// checks that). P2's offsets look forward, (width - shift) mod width; P3's
// are its shifts.
bool saturates(const Shifts& shifts, int n_stages, int width, bool forward) {
  long long sum = 0;
  for (int st = 0; st < n_stages; ++st)
    sum += forward ? (width - shifts.s[st]) % width : shifts.s[st];
  return sum + 1 >= width;
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// Dynamic shared memory: `words` floats per column (P2 its two rows and the
// chain's second buffers, P3 its row and the chain's second buffer). Past
// what one CTA may hold beside the kernel's static shared memory (on an
// H100, 232,448 B in all: rows of about 14,500 columns for P2, 29,000 for
// P3) the attribute fails, and the entry point returns that error with the
// runtime's last error cleared, so that later launches do not report it.
template <typename Kernel>
cudaError_t set_smem(Kernel kernel, int width, int words) {
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      words * width * (int)sizeof(float));
  if (err != cudaSuccess) cudaGetLastError();
  return err;
}

}  // namespace

// x, y, out (n_rows, width) float32 contiguous; shifts: n_stages host ints in
// [0, width). Returns cudaGetLastError() after launching.
extern "C" int nsc_roll_floor(const void* x, const void* y, void* out, int n_rows,
                              int width, int n_stages, int n_arrays,
                              const int* shifts, void* stream) {
  Shifts sh;
  if (!load_shifts(shifts, n_stages, width, &sh) || n_rows < 0 ||
      (n_arrays != 1 && n_arrays != 2))
    return (int)cudaErrorInvalidValue;
  if (n_rows == 0) return (int)cudaSuccess;
  const bool vec = width % 4 == 0 && aligned16(x) && aligned16(y) && aligned16(out);
  auto kernel = n_arrays == 2
      ? (vec ? roll_floor_kernel<2, true> : roll_floor_kernel<2, false>)
      : (vec ? roll_floor_kernel<1, true> : roll_floor_kernel<1, false>);
  cudaError_t err = set_smem(kernel, width, 4);
  if (err != cudaSuccess) return (int)err;
  kernel<<<n_rows, kThreads, 4 * width * sizeof(float),
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(y),
      static_cast<float*>(out), width, saturates(sh, n_stages, width, true),
      n_stages, sh);
  return (int)cudaGetLastError();
}

// x, out (n_rows, width) float32 contiguous; shifts as above.
extern "C" int nsc_roll_min_chain(const void* x, void* out, int n_rows, int width,
                                  int n_stages, const int* shifts, void* stream) {
  Shifts sh;
  if (!load_shifts(shifts, n_stages, width, &sh) || n_rows < 0)
    return (int)cudaErrorInvalidValue;
  if (n_rows == 0) return (int)cudaSuccess;
  const bool vec = width % 4 == 0 && aligned16(x) && aligned16(out);
  auto kernel = vec ? roll_min_chain_kernel<true> : roll_min_chain_kernel<false>;
  cudaError_t err = set_smem(kernel, width, 2);
  if (err != cudaSuccess) return (int)err;
  kernel<<<n_rows, kThreads, 2 * width * sizeof(float),
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(out), width,
      saturates(sh, n_stages, width, false), n_stages, sh);
  return (int)cudaGetLastError();
}
