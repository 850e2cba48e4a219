// Phase probe of the ring fold: precomputed keys -> folded rows, with each
// phase able to be switched off.
//
// Replaces the TPU probe experiments/ring_stage_probe.py (_variant_kernel :41,
// pallas_call at :163), a copy of ops/pallas_ring.py _ring_fold_kernel whose
// six stage classes switch off one at a time. Here the phases are those of
// this port's own ring kernel (ring_fold.cu), so that
// "full time minus the time without a phase" is that phase's cost inside the
// Hopper kernel. Each thread owns a contiguous chunk of the row and
// summarises it as {first, last, ev}: its first and last valid bin and the
// wrap events inside it. Summaries combine associatively, and ONE exclusive
// scan (warp shuffles, then a warp scan of the warps' totals) gives every
// chunk the bin of the valid point before it and the events before it:
//   scan     the first/last half of the summary (replaces the TPU's
//            jump-fill); stand-in: every chunk starts after bin -1;
//   fold     the ev half (replaces the TPU's fold index and rank prefix);
//            stand-in: every chunk starts at fold 0;
//   scatter  shared-memory atomicMin on the range's uint32 bits into slot
//            fold * n_azim + bin (replaces run-min, compaction, expansion);
//            stand-in: a plain store;
//   write    +inf -> 0 on the way out; stand-in: an integer clamp of +inf to
//            the largest finite float.
// The phase set is a template parameter, so the compiler drops what is off;
// with scan and fold both off there is no scan and no barrier for it.
//
// Input and output are those of ring_fold_pallas: key (N, P) float32 azimuth
// bins, -1 (or anything outside [0, n_azim)) = invalid or padding; val (N, P)
// float32 ranges, >= 0 or +inf; out (N, wpad) float32, slot f * n_azim + bin
// = min range of the kept valid points of fold f in that bin, 0 = empty,
// slots from n_folds * n_azim on 0. A valid point is kept while at most
// n_folds - 1 wrap events (a valid bin strictly below the valid bin before
// it) have occurred up to and including it: ring_fold.cu's rule.
//
// What bounds it on the H100: bytes. It reads 8 B per point and writes 4 B
// per slot: at 512 x 2176 (B = 8, n_folds 2, wpad 768) 8,912,896 + 1,572,864
// B, 3.13 us at 3.35 TB/s. The per-point work (two walks over a chunk of 9
// points, a scatter into shared memory) must hide under the loads.
//
// Design: one CTA per row; the 512 rows of a B = 8 call are all resident at
// once (4 an SM), so each row's chain of loads, walks, scan and barriers
// overlaps every other row's.
//   1. Each thread owns a contiguous chunk of whole quads of the row (at most
//      kPer points) and loads its keys and ranges straight into registers:
//      16-byte loads, all in flight before any is used, where the width is a
//      multiple of 4 and both pointers are 16-byte aligned, scalar loads
//      otherwise. Keys become bins there, once. The CTA sets the wpad-wide
//      output row in shared memory to +inf (ranges >= 0, so bit order is
//      value order).
//   2. Each thread summarises its chunk; one exclusive scan of the summaries
//      follows (two barriers).
//   3. From its start state each thread walks its bins; kept points take an
//      atomicMin on the range's bits in their slot of the row.
//   4. The row leaves with 16-byte stores, +inf -> 0.
// 256 threads a CTA when the rows outnumber the SMs (B = 8: 12 points a
// thread, 182 threads busy), 512 when each row has an SM to itself (B = 1:
// 8 points a thread).
//
// Measured and not kept (NVIDIA H100 80GB HBM3 at 700 W, in turns; PERF.md,
// P1 findings): a persistent grid of 2 CTAs an SM walking rows through two
// stages of shared memory, the next row's key and val in flight by TMA bulk
// copies (cp.async.bulk, mbarrier) while the CTA works on this one, ran 9.1
// us at B = 8 against 7.0 for the same code with one row a CTA: a row's time
// is its latency chain, and a CTA that takes two rows runs two chains one
// after the other, while the bulk copy hides only the second row's load.
// TMA for one row a CTA lost to 16-byte loads at B = 8 and won by 3% at
// B = 1. Staging the row in shared memory and reading each chunk back ran
// 5.45 us against 4.86 for loads straight into registers at B = 8.
//
// Shared memory: the warps' summaries and the output row, 192 + 4 * wpad
// bytes. The entry point refuses rows wider than kPer * kManyThreads (6,144
// points).
//
// Numbers (device time hot and with a cold L2, the share of the bound, the
// times against the earlier two-scan design in turns, ptxas -v): PERF.md,
// kernel table and findings. A numpy model of the chunking and the scan:
// tests/test_torch_ring_probe_design.py.
#include <cstdint>

#include "common.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kFewThreads = 256;
constexpr int kManyThreads = 512;
constexpr int kPer = 12;             // most points a thread's chunk holds

// A run of points: its first and last valid bin (-1: none) and the wrap
// events between its valid points.
struct Summary {
  int first, last, ev;
};

// shared memory before the output row: one Summary per warp, 16-aligned
constexpr int kHeadBytes = (kManyThreads / 32 * (int)sizeof(Summary) + 15) / 16 * 16;

// The halves of a Summary that a phase switched off stay constant (-1, -1
// or 0): they are neither combined nor shuffled.
template <bool kScan, bool kFold>
__device__ __forceinline__ Summary combine(const Summary& l, const Summary& r) {
  // r.first >= 0 && r.first < l.last implies l.last >= 0
  return {kScan ? (l.first >= 0 ? l.first : r.first) : -1,
          kScan ? (r.last >= 0 ? r.last : l.last) : -1,
          kFold ? l.ev + r.ev + (r.first >= 0 && r.first < l.last) : 0};
}

template <bool kScan, bool kFold>
__device__ __forceinline__ Summary shfl_up(const Summary& s, int off) {
  return {kScan ? __shfl_up_sync(kFull, s.first, off) : -1,
          kScan ? __shfl_up_sync(kFull, s.last, off) : -1,
          kFold ? __shfl_up_sync(kFull, s.ev, off) : 0};
}

// Exclusive scan of one Summary per lane across the warp.
template <bool kScan, bool kFold>
__device__ __forceinline__ Summary warp_exclusive(Summary s, int lane) {
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const Summary left = shfl_up<kScan, kFold>(s, off);
    if (lane >= off) s = combine<kScan, kFold>(left, s);
  }
  Summary pre = shfl_up<kScan, kFold>(s, 1);
  if (lane == 0) pre = {-1, -1, 0};
  return pre;
}

__device__ __forceinline__ int bin_of(float k, int n_azim) {
  return (k >= 0.0f && k < (float)n_azim) ? (int)k : -1;
}

template <int kThreads, bool kScan, bool kFold, bool kScatter, bool kWrite>
__global__ void __launch_bounds__(kThreads)
ring_probe_kernel(const float* __restrict__ key_in, const float* __restrict__ val_in,
                  float* __restrict__ out, int width, int n_azim, int n_folds,
                  int wpad, int vec_in, int vec_out) {
  constexpr int kWarps = kThreads / 32;
  constexpr int kQuads = kPer / 4;
  extern __shared__ __align__(16) unsigned char smem[];
  Summary* warp_pre = reinterpret_cast<Summary*>(smem);           // kWarps
  unsigned* row = reinterpret_cast<unsigned*>(smem + kHeadBytes);  // wpad

  const long long r = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  // this thread's chunk: whole quads [lo, lo + n), n <= kPer (the entry
  // point sees to it), straight into registers
  const int per = 4 * ((((width + 3) / 4) + kThreads - 1) / kThreads);
  const int lo = min(tid * per, width);
  const int n = min(lo + per, width) - lo;
  const float* kr = key_in + r * width + lo;
  const float* vr = val_in + r * width + lo;
  int bins[kPer];
  unsigned vb[kPer];
  if (vec_in) {
    float4 kq[kQuads], vq[kQuads];
#pragma unroll
    for (int q = 0; q < kQuads; ++q) {
      if (4 * q < n) {
        kq[q] = __ldg(reinterpret_cast<const float4*>(kr) + q);
        vq[q] = __ldg(reinterpret_cast<const float4*>(vr) + q);
      }
    }
#pragma unroll
    for (int q = 0; q < kQuads; ++q) {
      if (4 * q >= n) break;
      bins[4 * q] = bin_of(kq[q].x, n_azim);
      bins[4 * q + 1] = bin_of(kq[q].y, n_azim);
      bins[4 * q + 2] = bin_of(kq[q].z, n_azim);
      bins[4 * q + 3] = bin_of(kq[q].w, n_azim);
      vb[4 * q] = __float_as_uint(vq[q].x);
      vb[4 * q + 1] = __float_as_uint(vq[q].y);
      vb[4 * q + 2] = __float_as_uint(vq[q].z);
      vb[4 * q + 3] = __float_as_uint(vq[q].w);
    }
  } else {
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      if (u < n) {
        bins[u] = bin_of(__ldg(kr + u), n_azim);
        vb[u] = __float_as_uint(__ldg(vr + u));
      }
    }
  }
  for (int a = tid; a < wpad; a += kThreads) row[a] = nsc::kInfBits;

  Summary pre{-1, -1, 0};
  if (kScan || kFold) {
    Summary sum{-1, -1, 0};
    int last = -1;
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      if (u >= n) break;
      const int k = bins[u];
      if (k >= 0) {
        if (kScan && sum.first < 0) sum.first = k;
        if (kFold) sum.ev += (k < last);   // last < 0 before the first
        last = k;
      }
    }
    if (kScan) sum.last = last;
    pre = warp_exclusive<kScan, kFold>(sum, lane);
    if (lane == 31) warp_pre[warp] = combine<kScan, kFold>(pre, sum);
    __syncthreads();
    if (warp == 0) {
      const Summary total = lane < kWarps ? warp_pre[lane] : Summary{-1, -1, 0};
      const Summary before = warp_exclusive<kScan, kFold>(total, lane);
      if (lane < kWarps) warp_pre[lane] = before;
    }
    __syncthreads();
    pre = combine<kScan, kFold>(warp_pre[warp], pre);
  } else {
    __syncthreads();   // the row's +inf before the scatter
  }

  int folds = pre.ev, prev = pre.last;
#pragma unroll
  for (int u = 0; u < kPer; ++u) {
    if (u >= n) break;
    const int k = bins[u];
    if (k >= 0) {
      folds += (k < prev);                 // prev < 0 before the first
      prev = k;
      if (folds <= n_folds - 1) {
        if (kScatter) {
          atomicMin(row + folds * n_azim + k, vb[u]);
        } else {
          row[folds * n_azim + k] = vb[u];
        }
      }
    }
  }
  __syncthreads();

  auto value = [](unsigned bits) {
    return kWrite ? (bits == nsc::kInfBits ? 0.0f : __uint_as_float(bits))
                  : __uint_as_float(min(bits, 0x7f7fffffu));
  };
  float* o = out + r * wpad;
  if (vec_out) {
    const uint4* row4 = reinterpret_cast<const uint4*>(row);
    for (int q = tid; q < wpad / 4; q += kThreads) {
      const uint4 b = row4[q];
      reinterpret_cast<float4*>(o)[q] =
          make_float4(value(b.x), value(b.y), value(b.z), value(b.w));
    }
  } else {
    for (int a = tid; a < wpad; a += kThreads) o[a] = value(row[a]);
  }
}

using ProbeFn = void (*)(const float*, const float*, float*, int, int, int, int,
                         int, int);

// skip mask bit 0 = scan, 1 = fold, 2 = scatter, 3 = write (PHASES order in
// ops/probe_kernels.py)
template <int kThreads, int kSkip>
ProbeFn variant() {
  return ring_probe_kernel<kThreads, !(kSkip & 1), !(kSkip & 2), !(kSkip & 4),
                           !(kSkip & 8)>;
}

template <int kThreads>
ProbeFn variant_of(int skip) {
  static const ProbeFn table[16] = {
      variant<kThreads, 0>(),  variant<kThreads, 1>(),  variant<kThreads, 2>(),
      variant<kThreads, 3>(),  variant<kThreads, 4>(),  variant<kThreads, 5>(),
      variant<kThreads, 6>(),  variant<kThreads, 7>(),  variant<kThreads, 8>(),
      variant<kThreads, 9>(),  variant<kThreads, 10>(), variant<kThreads, 11>(),
      variant<kThreads, 12>(), variant<kThreads, 13>(), variant<kThreads, 14>(),
      variant<kThreads, 15>()};
  return table[skip];
}

int g_sms[nsc::kMaxDevices] = {};   // SMs of each device, read once

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace

// key, val (n_rows, width) float32 contiguous; out (n_rows, wpad) float32,
// wpad a multiple of 4 and >= n_folds * n_azim. skip_mask selects the phases
// to switch off (bits as above). Rows wider than kPer * kManyThreads, or an
// output row past the device's shared memory, are refused
// (cudaErrorInvalidValue, nothing launched). Returns cudaGetLastError()
// after launching.
extern "C" int nsc_ring_probe(const void* key, const void* val, void* out,
                              int n_rows, int width, int n_azim, int n_folds,
                              int wpad, int skip_mask, void* stream) {
  if (skip_mask < 0 || skip_mask > 15 || n_rows < 0 || width < 0 ||
      width > kPer * kManyThreads || n_azim < 1 || n_folds < 1 ||
      wpad % 4 != 0 || (long long)n_folds * n_azim > wpad)
    return (int)cudaErrorInvalidValue;
  int dev = 0;
  cudaError_t dev_err = nsc::current_device(&dev);
  if (dev_err == cudaSuccess && g_sms[dev] == 0)
    dev_err = cudaDeviceGetAttribute(&g_sms[dev],
                                     cudaDevAttrMultiProcessorCount, dev);
  if (dev_err != cudaSuccess) return (int)dev_err;
  if (n_rows == 0) return (int)cudaSuccess;

  const int vec_in = width % 4 == 0 && aligned16(key) && aligned16(val);
  const bool many = n_rows <= g_sms[dev] || width > kPer * kFewThreads;
  const ProbeFn fn = many ? variant_of<kManyThreads>(skip_mask)
                          : variant_of<kFewThreads>(skip_mask);
  // an output row past 48 KB (wpad > 12,240) needs the opt-in; past what a
  // CTA may hold the attribute fails, and that error is returned with the
  // runtime's last error cleared
  const size_t smem = kHeadBytes + 4 * (size_t)wpad;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) {
      cudaGetLastError();
      return (int)err;
    }
  }
  fn<<<n_rows, many ? kManyThreads : kFewThreads, smem,
       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(key), static_cast<const float*>(val),
      static_cast<float*>(out), width, n_azim, n_folds, wpad, vec_in,
      aligned16(out));
  return (int)cudaGetLastError();
}
