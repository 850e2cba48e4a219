// Phase probe of the ring fold: precomputed keys -> folded rows, with each
// phase able to be switched off.
//
// Replaces the TPU probe experiments/ring_stage_probe.py (_variant_kernel,
// a copy of ops/pallas_ring.py _ring_fold_kernel whose six stage classes
// switch off one at a time). Here the phases are those of this port's own
// ring kernel (ring_fold.cu), so that "full time minus the time without a
// phase" is that phase's cost inside the Hopper kernel:
//   scan     each thread's chunk learns the bin of the valid point before
//            it: the chunk's last valid bin, then a block-wide scan
//            (replaces the TPU's jump-fill);
//   fold     wrap events per chunk, then a block-wide prefix sum (replaces
//            the TPU's fold index and rank prefix);
//   scatter  shared-memory atomicMin on the range's uint32 bits into slot
//            fold * n_azim + bin (replaces run-min, compaction, expansion);
//   write    the folded row to global memory with +inf -> 0.
// A phase that is off gets a trivial stand-in so the others run the same
// instructions: scan -> every chunk starts after bin -1; fold -> every chunk
// starts at fold 0; scatter -> a plain store; write -> an integer clamp of
// +inf to the largest finite float instead of the select. The phase set is
// a template parameter, so the compiler drops what is off.
//
// Input and output are those of ring_fold_pallas: key (N, P) float32 azimuth
// bins, -1 (or anything outside [0, n_azim)) = invalid or padding; val (N, P)
// float32 ranges, >= 0 or +inf; out (N, wpad) float32, slot f * n_azim + bin
// = min range of the kept valid points of fold f in that bin, 0 = empty,
// slots from n_folds * n_azim on 0. The fold rule is ring_fold.cu's.
//
// What bounds it on the H100: reading 8 B per point (17.4 KB per 2176-wide
// row) and the shared-memory walk; one CTA per row, 512 rows at B = 8.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

template <bool kScan, bool kFold, bool kScatter, bool kWrite>
__global__ void __launch_bounds__(kThreads)
ring_probe_kernel(const float* __restrict__ key_in, const float* __restrict__ val_in,
                  float* __restrict__ out, int width, int n_azim, int n_folds,
                  int wpad) {
  extern __shared__ unsigned char smem[];
  int* key = reinterpret_cast<int*>(smem);                  // width
  float* val = reinterpret_cast<float*>(key + width);       // width
  unsigned* row = reinterpret_cast<unsigned*>(val + width); // wpad
  int* last_bin = reinterpret_cast<int*>(row + wpad);       // kThreads
  int* events = last_bin + kThreads;                        // kThreads

  const long long base = (long long)blockIdx.x * width;
  const int tid = threadIdx.x;
  for (int i = tid; i < width; i += kThreads) {
    const float k = key_in[base + i];
    key[i] = (k >= 0.0f && k < (float)n_azim) ? (int)k : -1;
    val[i] = val_in[base + i];
  }
  for (int a = tid; a < wpad; a += kThreads) row[a] = nsc::kInfBits;
  __syncthreads();

  const int per = (width + kThreads - 1) / kThreads;
  const int lo = min(tid * per, width);
  const int hi = min(lo + per, width);

  int prev_in = -1;
  if (kScan) {
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
    prev_in = tid > 0 ? last_bin[tid - 1] : -1;
  }

  int folds = 0;
  if (kFold) {
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
    folds = tid > 0 ? events[tid - 1] : 0;
  }

  int prev = prev_in;
  for (int i = lo; i < hi; ++i) {
    const int k = key[i];
    if (k >= 0) {
      folds += (prev >= 0 && k < prev);
      prev = k;
      if (folds <= n_folds - 1) {
        const int slot = folds * n_azim + k;
        if (kScatter) {
          atomicMin(row + slot, __float_as_uint(val[i]));
        } else {
          row[slot] = __float_as_uint(val[i]);
        }
      }
    }
  }
  __syncthreads();

  float* o = out + (long long)blockIdx.x * wpad;
  for (int a = tid; a < wpad; a += kThreads) {
    const unsigned bits = row[a];
    if (kWrite) {
      o[a] = bits == nsc::kInfBits ? 0.0f : __uint_as_float(bits);
    } else {
      o[a] = __uint_as_float(min(bits, 0x7f7fffffu));
    }
  }
}

using ProbeFn = void (*)(const float*, const float*, float*, int, int, int, int);

// skip mask bit 0 = scan, 1 = fold, 2 = scatter, 3 = write (PHASES order in
// ops/probe_kernels.py)
template <int kSkip>
ProbeFn variant() {
  return ring_probe_kernel<!(kSkip & 1), !(kSkip & 2), !(kSkip & 4), !(kSkip & 8)>;
}

}  // namespace

// key, val (n_rows, width) float32 contiguous; out (n_rows, wpad) float32.
// skip_mask selects the phases to switch off (bits as above). Returns
// cudaGetLastError() after launching.
extern "C" int nsc_ring_probe(const void* key, const void* val, void* out,
                              int n_rows, int width, int n_azim, int n_folds,
                              int wpad, int skip_mask, void* stream) {
  static const ProbeFn table[16] = {
      variant<0>(),  variant<1>(),  variant<2>(),  variant<3>(),
      variant<4>(),  variant<5>(),  variant<6>(),  variant<7>(),
      variant<8>(),  variant<9>(),  variant<10>(), variant<11>(),
      variant<12>(), variant<13>(), variant<14>(), variant<15>()};
  if (skip_mask < 0 || skip_mask > 15 || n_folds * n_azim > wpad)
    return (int)cudaErrorInvalidValue;
  const ProbeFn fn = table[skip_mask];
  const size_t smem = (size_t)width * (sizeof(int) + sizeof(float)) +
                      (size_t)wpad * sizeof(unsigned) + 2 * kThreads * sizeof(int);
  cudaError_t err =
      cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  fn<<<n_rows, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(key), static_cast<const float*>(val),
      static_cast<float*>(out), width, n_azim, n_folds, wpad);
  return (int)cudaGetLastError();
}
