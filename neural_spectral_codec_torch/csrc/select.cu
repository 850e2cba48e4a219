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
// TB/s. A radix select reads its row once a digit pass and once more for
// the walk; a row of 400 KB does not stay in L2 between them while ~500
// rows are in flight, so the design holds each row in shared memory.
//
// Design (a radix select over the key's digits of 11, 11 and 10 bits, most
// significant first, and a walk). Each pass builds a histogram of one
// digit among the entries whose higher digits match the digits chosen so
// far, and chooses the digit whose bucket holds the remaining place, which
// it then narrows to the place inside that bucket; a bucket of one entry
// ends the passes early. Then one walk in column order finds the entry of
// that place among those that match the chosen digits. Histogram updates
// are shared atomics (count_quad): a warp whose 128 digits of a step are
// all one digit (the runs of +inf outside the miner's negatives, which are
// most of its W1 row) adds them to its run, one atomic a run; a step with
// no digit (most entries after the first pass) costs one vote; any other
// step one atomic a digit.
//
// Two regimes, chosen by n alone (training/select_kernel.py select_layout
// passes the cluster width, 0 for the streaming regime):
//   * cluster (n <= kClusterMax * kSliceOne = 438,272): a thread-block
//     cluster of C = ceil(n / kSliceTwo) CTAs (or 8 when that exceeds 8)
//     owns one row, each CTA a contiguous slice of L = ceil(n / C) columns
//     (rank order = column order), which it copies into its shared memory
//     once: the 16-byte-aligned body by cp.async.bulk (1-D TMA, completion
//     on an mbarrier), the at most 3 + 3 columns before and after it by
//     plain loads, placed so that the body lands 16-byte aligned. Every
//     pass and the walk read shared memory only. After a pass each CTA
//     adds the cluster's histograms (its 4 bins from every rank, in rank
//     order, through distributed shared memory), so every rank chooses the
//     same digit. The first pass turns the slice into its keys in place,
//     and every later pass also notes for each bin a column it counted
//     there: when the pass ends on a bucket of one entry (the miner's rows
//     mostly do after the second pass), the rank that holds it writes
//     that column and no walk is needed. Otherwise each rank's count in
//     the bucket (its matches) goes to every rank, a prefix over the ranks
//     finds the rank that holds the place, and that rank alone walks its
//     slice: each thread
//     counts the matches in its run of consecutive columns, a block scan
//     places the runs, and the thread whose run holds the place walks it.
//     L <= kSliceTwo (100 KB) lets 2 CTAs share an SM, so one runs its
//     passes while the other's copy is in flight; n = 100,000 is C = 4,
//     25,000 columns (100 KB) a CTA.
//   * streaming (longer rows): one CTA of 512 threads a row reads the row
//     from global memory in every pass and in the walk (float4 loads where
//     the row is 16-byte aligned).
#include <climits>
#include <cstdint>

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kPerThread = 4;           // consecutive columns a thread a step
constexpr int kStep = kThreads * kPerThread;
constexpr int kPasses = 3;
constexpr int kBins = 2048;             // the widest digit: 11 bits
constexpr int kOwn = kBins / kThreads;  // bins a thread owns in a choice
constexpr unsigned kNoDigit = 0xffffffffu;
constexpr int kClusterMax = 8;          // a portable cluster
constexpr int kSliceTwo = 25600;        // columns a CTA, 2 CTAs an SM
constexpr int kSliceOne = 54784;        // columns a CTA, 1 CTA an SM
constexpr int kSlack = 8;               // floats around a slice: its phase
constexpr int kCopyBytes = 32768;       // bytes a bulk copy

static_assert(kBins % kThreads == 0 && kOwn == 4, "bins per thread");
static_assert(kPerThread == 4, "count_quad takes 4 digits a lane");
static_assert(kWarps <= 32, "one warp scans the warp sums");

// digit p: its lowest bit and its width (11, 11, 10 bits from the top)
__host__ __device__ constexpr int digit_shift(int p) {
  return p == 0 ? 21 : p == 1 ? 10 : 0;
}
__host__ __device__ constexpr int digit_bits(int p) { return p == 2 ? 10 : 11; }

// dynamic shared memory of a cluster CTA with slices of L columns
__host__ __device__ constexpr int slice_bytes(int slice) {
  return (int)sizeof(float) * (slice + kSlack);
}

__device__ __forceinline__ unsigned order_key(float v) {
  const unsigned u = __float_as_uint(v);
  // the sign bit set for v >= 0, every bit flipped for v < 0 (no branch)
  const unsigned key = u ^ ((unsigned)((int)u >> 31) | 0x80000000u);
  const unsigned zero = v == 0.0f ? 0x80000000u : key;   // -0 equal to +0
  return v != v ? 0xffffffffu : zero;
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

// A warp's run of steps whose 128 digits were all one digit: that digit
// and the entries counted in it, not yet added to the histogram (the same
// in every lane; lane 0 adds it).
struct Run {
  unsigned digit = kNoDigit;
  unsigned count = 0;
};

__device__ __forceinline__ void flush(unsigned* hist, Run& run) {
  if (run.count != 0 && (threadIdx.x & 31) == 0)
    atomicAdd(&hist[run.digit], run.count);
  run.count = 0;
}

// The warp's histogram updates for its lanes' 4 digits each (kNoDigit:
// none), the digits of columns e0 .. e0 + 3 of the slice. Where the warp's
// 128 digits are one digit (the miner's runs of +inf) they join the warp's
// run, which reaches the histogram when its digit changes (flush at the
// end of the pass): one atomic a run instead of one a step on the same
// bin. Otherwise one shared atomic a digit (on the miner's blocks and on
// random rows this beat aggregating the lanes of one digit by
// __match_any_sync, whose cost grows with the distinct digits, or through
// the first and last lanes' ballots). With `note`, each counted column is
// also written into seen[digit] (a bucket a warp fills 128 at a time is
// no bucket of one, so runs write none).
__device__ __forceinline__ void count_quad(unsigned* hist,
                                           unsigned short* seen, Run& run,
                                           const unsigned (&d)[4], int e0,
                                           bool note) {
  const unsigned full = 0xffffffffu;
  const unsigned d0 = __shfl_sync(full, d[0], 0);
  if (__all_sync(full, d[0] == d0 && d[1] == d0 && d[2] == d0 &&
                           d[3] == d0)) {
    if (d0 == kNoDigit) return;
    if (d0 != run.digit) {
      flush(hist, run);
      run.digit = d0;
    }
    run.count += 4 * 32;
    return;
  }
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    if (d[c] == kNoDigit) continue;
    atomicAdd(&hist[d[c]], 1u);
    if (note) seen[d[c]] = (unsigned short)(e0 + c);
  }
}

// The digit whose bucket holds `rank`, from the histogram's totals: thread
// t owns bins kOwn * t .. kOwn * t + kOwn - 1 (tot, its totals). The owner
// of the chosen bin writes chosen = {digit, entries below it, in it}.
// Every thread calls it.
__device__ __forceinline__ void choose_digit(const unsigned (&tot)[kOwn],
                                             unsigned rank, unsigned* sums,
                                             unsigned* chosen) {
  unsigned local = 0;
#pragma unroll
  for (int b = 0; b < kOwn; ++b) local += tot[b];
  unsigned total;
  unsigned below = block_scan(local, sums, &total);
  if (below <= rank && rank < below + local) {
#pragma unroll
    for (int b = 0; b < kOwn; ++b) {
      if (rank < below + tot[b]) {
        chosen[0] = kOwn * threadIdx.x + b;
        chosen[1] = below;
        chosen[2] = tot[b];
        return;
      }
      below += tot[b];
    }
  }
}

// ---------------- the cluster regime ----------------

#ifdef NSC_SELECT_STAMPS
// A diagnostic build (experiments/kernel_ab.py select_stamps): each cluster
// CTA's global timer (ns) at its start, with its slice in shared memory,
// after the first pass's histogram, after its choice, after the second
// pass's histogram, after its choice, after the passes' last cluster
// barrier, and at its end (a bucket of one's write, or the walk's end).
constexpr int kStamps = 8;
constexpr int kMaxStampedCtas = 16384;
__device__ unsigned long long g_select_stamps[kMaxStampedCtas * kStamps];
#define SELECT_STAMP(i)                                                    \
  do {                                                                     \
    if (threadIdx.x == 0 && blockIdx.x < kMaxStampedCtas) {                \
      unsigned long long t_;                                               \
      asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t_));               \
      g_select_stamps[blockIdx.x * kStamps + (i)] = t_;                    \
    }                                                                      \
  } while (0)
#else
#define SELECT_STAMP(i) \
  do {                  \
  } while (0)
#endif

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

__device__ __forceinline__ bool mbarrier_done(unsigned bar, unsigned phase) {
  unsigned done;
  asm volatile(
      "{\n .reg .pred p;\n"
      " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      " selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done) : "r"(bar), "r"(phase) : "memory");
  return done != 0;
}

__global__ void __launch_bounds__(kThreads, 2)
select_cluster_kernel(const float* __restrict__ x, int n, long long ld,
                      const int* __restrict__ k, int* __restrict__ out) {
  extern __shared__ __align__(128) float buf[];
  __shared__ __align__(16) unsigned hist[kBins];
  __shared__ unsigned short seen[kBins];    // a column of each bin's digit
  __shared__ unsigned sums[kWarps];
  __shared__ unsigned chosen[3];        // digit, entries below it, in it
  __shared__ unsigned found[kClusterMax];   // each rank's walk matches
  __shared__ __align__(8) unsigned long long bar;
  cg::cluster_group cluster = cg::this_cluster();
  const int ctas = (int)cluster.num_blocks();
  const int me = (int)cluster.block_rank();
  const int tid = threadIdx.x;
  const int row = blockIdx.x / ctas;
  const int slice = (n + ctas - 1) / ctas;
  const int lo = min(me * slice, n);
  const int len = min(lo + slice, n) - lo;
  const float* src = x + (long long)row * ld + lo;
  SELECT_STAMP(0);

  // The slice into buf: column lo + i at buf[phase + i], phase the
  // 16-byte phase of src, so the body from the first 16-byte boundary
  // lands on one too.
  const int phase = (int)(reinterpret_cast<uintptr_t>(src) / 4 % 4);
  const int head = min((4 - phase) % 4, len);
  const int body = (len - head) / 4 * 4;
  const int tail = len - head - body;
  const unsigned b = smem_addr(&bar);
  if (tid == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" :: "r"(b)
                 : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 :: "r"(b), "r"(4 * body) : "memory");
    for (int off = 0; off < 4 * body; off += kCopyBytes) {
      const int bytes = min(kCopyBytes, 4 * body - off);
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
          " [%0], [%1], %2, [%3];\n"
          :: "r"(smem_addr(buf + phase + head) + off),
             "l"(reinterpret_cast<const char*>(src + head) + off),
             "r"(bytes), "r"(b)
          : "memory");
    }
  }
  if (tid < head) buf[phase + tid] = __ldg(src + tid);
  else if (tid < head + tail)
    buf[phase + body + tid] = __ldg(src + body + tid);
  unsigned rank = (unsigned)min(max(k[row], 0), n - 1);
  unsigned prefix = 0, mask = 0;        // the digits chosen so far
  while (!mbarrier_done(b, 0)) {}
  __syncthreads();                      // the plain loads are in
  SELECT_STAMP(1);

  // Pass 0 turns the slice's values into their keys in place; the passes
  // after it and the walk read the keys. Every pass after the first also
  // writes, for each entry it counts, the entry's column into seen[digit]:
  // for a bucket of one entry that is the entry's column.
  const float4* vals = reinterpret_cast<const float4*>(buf);
  uint4* keys = reinterpret_cast<uint4*>(buf);
  const int nq = (phase + len + 3) / 4;
  int p = 0;
  for (; p < kPasses; ++p) {
    const int shift = digit_shift(p);
    const unsigned dmask = (1u << digit_bits(p)) - 1u;
    if (p > 0) cluster_wait();          // every rank has read hist
    for (int i = tid; i < kBins; i += kThreads) hist[i] = 0;
    __syncthreads();
    Run run;
    for (int q0 = 0; q0 < nq; q0 += 2 * kThreads) {
      uint4 kq[2];                      // two quads a step, loaded first
      if (p == 0) {
        float4 f[2];
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int q = q0 + u * kThreads + tid;
          f[u] = q < nq ? vals[q] : make_float4(0, 0, 0, 0);
        }
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int q = q0 + u * kThreads + tid;
          kq[u] = make_uint4(order_key(f[u].x), order_key(f[u].y),
                             order_key(f[u].z), order_key(f[u].w));
          if (q < nq) keys[q] = kq[u];
        }
      } else {
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int q = q0 + u * kThreads + tid;
          kq[u] = q < nq ? keys[q] : make_uint4(0, 0, 0, 0);
        }
      }
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int e0 = 4 * (q0 + u * kThreads + tid) - phase;
        const unsigned key[4] = {kq[u].x, kq[u].y, kq[u].z, kq[u].w};
        bool in[4];
#pragma unroll
        for (int c = 0; c < 4; ++c)
          in[c] = (unsigned)(e0 + c) < (unsigned)len &&
                  (key[c] & mask) == prefix;
        // after the first pass most warps hold no match: one vote
        if (p > 0 &&
            !__any_sync(0xffffffffu, in[0] || in[1] || in[2] || in[3]))
          continue;
        unsigned d[4];
#pragma unroll
        for (int c = 0; c < 4; ++c)
          d[c] = in[c] ? (key[c] >> shift) & dmask : kNoDigit;
        count_quad(hist, seen, run, d, e0, p > 0);
      }
    }
    flush(hist, run);
    if (p < 2) SELECT_STAMP(2 + 2 * p);
    cluster.sync();                     // every rank's histogram is whole
    // the cluster's totals of this thread's bins, ranks in order, four
    // ranks' reads in flight at once
    unsigned tot[kOwn] = {};
    for (int r0 = 0; r0 < ctas; r0 += 4) {
      uint4 h[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        h[i] = r0 + i < ctas ? *reinterpret_cast<const uint4*>(
                                   cluster.map_shared_rank(hist, r0 + i) +
                                   kOwn * tid)
                             : make_uint4(0, 0, 0, 0);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        tot[0] += h[i].x; tot[1] += h[i].y;
        tot[2] += h[i].z; tot[3] += h[i].w;
      }
    }
    cluster_arrive();                   // done with the ranks' histograms
    choose_digit(tot, rank, sums, chosen);
    __syncthreads();
    prefix |= chosen[0] << shift;
    mask |= dmask << shift;
    rank -= chosen[1];
    if (p < 2) SELECT_STAMP(3 + 2 * p);
    if (chosen[2] == 1) break;          // a bucket of one: no more digits
  }
  cluster_wait();                       // no rank reads this one's hist
  SELECT_STAMP(6);
  const unsigned digit = chosen[0];
  if (chosen[2] == 1 && p > 0) {        // a bucket of one, its column seen
    if (tid == 0 && hist[digit] == 1) out[row] = lo + seen[digit];
    SELECT_STAMP(7);
    return;
  }
  // each rank's entries in the chosen bucket (its walk's matches), to
  // every rank
  if (tid < ctas) cluster.map_shared_rank(found, tid)[me] = hist[digit];
  cluster.sync();

  // the rank whose slice holds the place, and the place inside it
  unsigned before = 0;
  for (int r = 0; r < me; ++r) before += found[r];
  if (rank < before || rank >= before + found[me]) return;
  rank -= before;
  // the entry of place `rank` among this slice's matches, in column
  // order: thread t counts the matches in its run of `per` quads, a block
  // scan places the runs, and the thread whose run holds the place walks
  // it
  const int per = (nq + kThreads - 1) / kThreads;
  const int q_lo = min(tid * per, nq), q_hi = min(q_lo + per, nq);
  unsigned cnt = 0;
  for (int q = q_lo; q < q_hi; ++q) {
    const uint4 kk = keys[q];
    const unsigned key[4] = {kk.x, kk.y, kk.z, kk.w};
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int e = 4 * q + c - phase;
      cnt += (unsigned)e < (unsigned)len && (key[c] & mask) == prefix;
    }
  }
  unsigned total;
  const unsigned at = block_scan(cnt, sums, &total);
  SELECT_STAMP(7);
  if (rank >= total) {                  // unreachable while the counts hold
    if (tid == 0) out[row] = 0;
    return;
  }
  if (rank < at || rank >= at + cnt) return;
  unsigned left = rank - at;
  for (int q = q_lo; q < q_hi; ++q) {
    const uint4 kk = keys[q];
    const unsigned key[4] = {kk.x, kk.y, kk.z, kk.w};
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int e = 4 * q + c - phase;
      if ((unsigned)e < (unsigned)len && (key[c] & mask) == prefix) {
        if (left == 0) {
          out[row] = lo + e;
          return;
        }
        --left;
      }
    }
  }
}

// ---------------- the streaming regime ----------------

__global__ void __launch_bounds__(kThreads)
select_rows_kernel(const float* __restrict__ x, int n, long long ld,
                   const int* __restrict__ k, int* __restrict__ out) {
  __shared__ unsigned hist[kBins];
  __shared__ unsigned sums[kWarps];
  __shared__ unsigned chosen[3];        // digit, entries below it, in it
  const int tid = threadIdx.x;
  const int row = blockIdx.x;
  const float* xr = x + (long long)row * ld;
  const bool vec = reinterpret_cast<uintptr_t>(xr) % 16 == 0;
  unsigned rank = (unsigned)min(max(k[row], 0), n - 1);
  unsigned prefix = 0, mask = 0;        // the digits chosen so far

  for (int p = 0; p < kPasses; ++p) {
    const int shift = digit_shift(p);
    const unsigned dmask = (1u << digit_bits(p)) - 1u;
    for (int i = tid; i < kBins; i += kThreads) hist[i] = 0;
    __syncthreads();
    Run run;
    for (int base = 0; base < n; base += kStep) {
      const int j = base + kPerThread * tid;
      float v[kPerThread];
      load_values(xr, n, j, vec, v);
      unsigned d[kPerThread];
#pragma unroll
      for (int q = 0; q < kPerThread; ++q)
        d[q] = j + q < n && (order_key(v[q]) & mask) == prefix
                   ? (order_key(v[q]) >> shift) & dmask : kNoDigit;
      count_quad(hist, nullptr, run, d, 0, false);
    }
    flush(hist, run);
    __syncthreads();
    unsigned tot[kOwn];
#pragma unroll
    for (int i = 0; i < kOwn; ++i) tot[i] = hist[kOwn * tid + i];
    choose_digit(tot, rank, sums, chosen);
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

// dynamic shared memory the cluster kernel was opted into, per device
int g_smem_allowed[nsc::kMaxDevices] = {};

}  // namespace

// For each of `rows` rows of x (float32, row stride ld >= n elements) the
// column at place k[row] (int32 on the device, clamped to 0 .. n - 1) of
// the row's stable ascending order; out (rows,) int32. ctas is the regime,
// which the caller chooses from n (training/select_kernel.py
// select_layout): 0 streams each row through one CTA of 512 threads;
// 1 .. 8 give each row a cluster of that many CTAs of 512 threads, each
// holding a slice of ceil(n / ctas) <= 54,784 columns in its shared
// memory (cudaLaunchKernelEx with a cluster dimension).
// Returns cudaGetLastError() after the launch (cudaErrorInvalidValue,
// nothing launched, for sizes out of range; a refused cluster launch is an
// error, never a fallback).
extern "C" int nsc_select_rows(const void* x, int rows, int n, long long ld,
                               const void* k, void* out, int ctas,
                               void* stream) {
  if (rows < 1 || n < 1 || ld < n || rows > INT_MAX / kClusterMax ||
      ctas < 0 || ctas > kClusterMax ||
      (ctas > 0 && (n + ctas - 1) / ctas > kSliceOne))
    return (int)cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  const auto xp = static_cast<const float*>(x);
  const auto kp = static_cast<const int*>(k);
  const auto op = static_cast<int*>(out);
  if (ctas == 0) {
    select_rows_kernel<<<rows, kThreads, 0, s>>>(xp, n, ld, kp, op);
    return (int)cudaGetLastError();
  }
  int dev = 0;
  cudaError_t err = nsc::current_device(&dev);
  if (err != cudaSuccess) return (int)err;
  if (g_smem_allowed[dev] < slice_bytes(kSliceOne)) {
    err = cudaFuncSetAttribute(select_cluster_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               slice_bytes(kSliceOne));
    if (err != cudaSuccess) return (int)err;
    // all of the SM's unified memory as shared, so 2 CTAs of kSliceTwo fit
    err = cudaFuncSetAttribute(select_cluster_kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return (int)err;
    g_smem_allowed[dev] = slice_bytes(kSliceOne);
  }
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(rows * ctas, 1, 1);
  config.blockDim = dim3(kThreads, 1, 1);
  config.dynamicSmemBytes = slice_bytes((n + ctas - 1) / ctas);
  config.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = ctas;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  config.attrs = attr;
  config.numAttrs = 1;
  err = cudaLaunchKernelEx(&config, select_cluster_kernel, xp, n, ld, kp, op);
  const cudaError_t last = cudaGetLastError();      // and clear it
  return (int)(err != cudaSuccess ? err : last);
}

#ifdef NSC_SELECT_STAMPS
// The diagnostic build's stamps of the last cluster launch: n_ctas *
// kStamps (a CTA that ended before a stamp leaves that slot as it was).
extern "C" int nsc_select_stamps(unsigned long long* out, int n_ctas) {
  if (n_ctas > kMaxStampedCtas) return (int)cudaErrorInvalidValue;
  return (int)cudaMemcpyFromSymbol(
      out, g_select_stamps, sizeof(unsigned long long) * n_ctas * kStamps);
}
#endif

// Kernel S's kernels, for the census of captured graphs (nsc_graph_census
// in project.cu): 0 the cluster regime's, 1 the streaming regime's.
extern "C" const void* nsc_select_kernel_handle(int which) {
  return which == 0 ? reinterpret_cast<const void*>(select_cluster_kernel)
                    : reinterpret_cast<const void*>(select_rows_kernel);
}
