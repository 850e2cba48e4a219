// Kernel Q: the stage-1 query's fused body. W1 (or L2) of (Q, n_bins)
// queries against every row of an (N, n_bins) database, the size and
// spatial masks, and an exact smallest-k.
//
// Not a Pallas kernel: the hand-written form of the XLA work inside the JAX
// package's one-dispatch query programs,
// neural_spectral_codec_tpu/retrieval/retriever.py _query_math (:139-159)
// and its batched form _query_batch_kernel (:106-136), which the serving
// step (models/gnn.py:274) runs too. For query vectors q (their CDFs under
// W1, raw vectors under L2, made ahead of the launch), rows r < N and
// per-query filters [x, y, z, min_d]:
//     d(q, r) = sum_b |row[r][b] - q[b]|                   (W1)
//             = sqrt(sum_b (row[r][b] - q[b])^2)           (L2)
//     d = +inf where r >= size, or where min_d > 0 and
//         |pos[r] - (x, y, z)| < min_d
//     out = the k smallest (d, r) in retriever.smallest_k's order:
//           ascending d, equal d by the lower row (so +inf slots go to the
//           lowest masked rows), every NaN made the one quiet NaN
//           0x7fc00000 and last.
// uint16 rows are codes, row = float(code) * scale with scale =
// float32(1/65535), rounded once (retriever.dequantize_rows). `size` is
// read on the device (a captured graph stages it) or passed by value.
// The plain version is retrieval/query_kernel.py query_plain; the two agree
// bit for bit, indices and distances.
//
// Summation order (query_kernel.lane_sums adds in exactly this order, with
// elementwise adds). A row is cut into 16-byte units of V elements (V = 4
// float32 values, 8 uint16 codes), zero-padded to a multiple of 32 units.
// Lane l of a warp takes the units l, l + 32, l + 64, ... in that order and
// adds each unit's V terms in element order into one float that starts at
// 0 (a padded element adds an exact +0). The 32 lane sums are then added by
// the xor butterfly: lane l's with lane l ^ 16's, those with l ^ 8's, then
// ^ 4, ^ 2, ^ 1 (each sum is commutative, so a pair's value does not depend
// on the lane that forms it). Every operation is rounded on its own
// (__fsub_rn, __fmul_rn, __fadd_rn): nvcc would otherwise contract the
// dequantisation and L2's square and add into FMAs. The spatial norm is
// __fsqrt_rn(((dx*dx) + (dy*dy)) + (dz*dz)) with d. = pos - filter, and L2
// takes __fsqrt_rn of its sum; the plain version rounds a float64 sqrt once,
// which is the correctly rounded float sqrt (nothing here is built with
// fast-math).
//
// Keys: (u(d) << 32) | r as unsigned 64-bit, u(d) = bits | 0x80000000 for a
// d with the sign bit clear and ~bits otherwise (smallest_k's signed keys
// with the sign bit flipped: the same order). A distance is a sum of
// |terms| or of squares, so d >= +0 or NaN, every key is >= 2^63, and the
// empty slot kNoKey = ~0 lies above them all.
//
// What bounds it on the H100: at Q = 1 bytes, the rows read once (100,032
// x 800 float32 rows are 320.1 MB, 95.6 us at 3.35 TB/s; as uint16 codes
// 160.1 MB, 47.8 us); at Q = 32 operations, 2 * 32 * 100,032 * 800 = 5.12 G
// subtracts and adds that cannot fuse, 153 us at 33.5 T/s.
//
// Design (simple first).
//   * Kernel 1, query_kernel: grid (ctas, query groups) of 8 warps. A CTA's
//     group of up to 32 queries sits in shared memory (as units of V),
//     so each row is read from device memory once for all of the group's
//     queries (a call of up to 32 queries reads the database once, unless
//     large-k lists leave room for fewer). A warp takes R rows at a time
//     (1 for one query, 2 for a group, which halves the query units read
//     from shared memory a row; runs of R rows strided over every warp of
//     the grid), each lane its units of them with 16-byte loads, and keeps
//     one sum a (query, row). One query (3 CTAs an SM): a segment of 7
//     units of a float32 row (4 of a uint16 one) in flight at once, then
//     the next segment for longer rows. A group (2 CTAs an SM): one unit
//     at a time, the next kAhead = 2 units' loads in flight. Codes become
//     floats as their unit is added, once for all the queries. A row's 32
//     query sums are reduced in one pass of recursive halving: at offset o
//     a lane keeps the half of its queries that its bit o selects, sends
//     the other half to lane ^ o and adds what comes back (the butterfly's
//     pairs; 31 shuffles a row, not 32 x 5), which leaves query l's sum on
//     lane l. Lane q then masks and keys the row and keeps the smallest
//     keys its warp saw in a sorted list: for k <= kRegK = 16 the 16
//     smallest in registers (an insert is one unrolled pass of
//     compare-and-swap), for k <= kMaxK = 128 the k smallest in shared
//     memory (fewer queries a CTA where they do not fit). A key enters only
//     below the list's last, which a register holds, so after the first
//     rows inserts are rare. Each warp writes its lists' first k keys to
//     scratch, (query, warp, k).
//   * Kernel 2, query_merge_kernel: one CTA a query. The lists' first keys,
//     in kMergeGroups = 128 groups of lists, give 128 group minima; the k
//     smallest of them are keys of k distinct lists, so the k-th bounds
//     the query's k-th key from above. The keys at or below the bound (a
//     few more than k on most data; each list read up to its first key
//     above it) are gathered into shared memory; when more than kMergeCap
//     are, the bound is lowered by bisection over the key, a counting pass
//     a step, until between k and kMergeCap remain. Each kept key's place
//     among them is counted and the first k are written there.
//   * The distance entry (query_kernel<..., 0>), for k > kMaxK: kernel
//     1's loop writes the masked (Q, N) distances instead of lists, and the
//     wrapper ranks them with smallest_k. Nothing writes a (Q, N, n_bins)
//     temporary.
#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;               // kernel 1: 8 warps
constexpr int kWarps = kThreads / 32;       // candidate lists a CTA a query
constexpr int kRowsOne = 1;                 // rows a warp a step: one query
constexpr int kRowsMany = 2;                // a group (a query unit read
                                            // from shared memory serves 2)
constexpr int kMaxK = 128;                  // K_MAX: the fused route's k
constexpr int kRegK = 16;                   // lists up to here in registers
constexpr int kAhead = 2;                   // a group's units loaded ahead
constexpr int kGroup = 32;                  // queries a CTA: one a lane
constexpr int kMergeThreads = 512;
constexpr int kMergeGroups = 128;           // group minima that bound k
constexpr int kMergeCap = 4096;             // keys the merge ranks
constexpr unsigned long long kNoKey = ~0ull;
constexpr unsigned kNanBits = 0x7fc00000u;  // torch's and numpy's NaN
constexpr unsigned kFull = 0xffffffffu;
constexpr int kInstances = 18;              // 3 modes x 2 group sizes x 3

// Modes: 0 W1 over float32 rows, 1 W1 over uint16 codes, 2 L2 over float32.
template <int MODE>
struct Unit {
  static constexpr int kV = MODE == 1 ? 8 : 4;   // elements a 16-byte unit
  static constexpr int kJ = MODE == 1 ? 4 : 7;   // units a lane a segment
};

__host__ __device__ constexpr int rows_of(bool wide) {
  return wide ? kRowsMany : kRowsOne;
}

int g_smem_set[nsc::kMaxDevices][kInstances];

// Unit u of row r as its 16 bytes: zeros past the rows, the row's units or
// n_bins. `vec`: one 16-byte load (rows 16-byte aligned, n_bins a multiple
// of V), else one load an element.
template <int MODE>
__device__ __forceinline__ uint4 load_unit(const void* __restrict__ rows,
                                           long long r, int n_rows,
                                           int n_bins, int u, int n_units,
                                           bool vec) {
  constexpr int V = Unit<MODE>::kV;
  if (u >= n_units || r >= n_rows) return make_uint4(0u, 0u, 0u, 0u);
  const long long at = r * n_bins + (long long)u * V;
  if (vec) {
    if constexpr (MODE == 1)
      return __ldg(reinterpret_cast<const uint4*>(
          static_cast<const unsigned short*>(rows) + at));
    else
      return __ldg(reinterpret_cast<const uint4*>(
          static_cast<const float*>(rows) + at));
  }
  unsigned w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int v = 0; v < V; ++v) {
    if (u * V + v >= n_bins) break;
    if constexpr (MODE == 1)
      w[v / 2] |= (unsigned)__ldg(static_cast<const unsigned short*>(rows) +
                                  at + v) << (16 * (v & 1));
    else
      w[v] = __float_as_uint(__ldg(static_cast<const float*>(rows) + at + v));
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// Element v of a unit as float: a float32 value, or a code times scale
// (float(code) made exactly as 2^23 + code - 2^23, then one rounded product).
template <int MODE>
__device__ __forceinline__ float element(const uint4& w, int v, float scale) {
  const int at = MODE == 1 ? v / 2 : v;
  const unsigned word = at == 0 ? w.x : at == 1 ? w.y : at == 2 ? w.z : w.w;
  if constexpr (MODE == 1) {
    const unsigned code = (v & 1) ? word >> 16 : word & 0xffffu;
    return __fmul_rn(
        __fsub_rn(__uint_as_float(0x4b000000u | code), 8388608.0f), scale);
  } else {
    return __uint_as_float(word);
  }
}

// One unit of R rows (x, as floats) into the sums of the group's queries:
// each term |x - q| (or its square) added to its (query, row) sum in the
// unit's element order, every operation rounded on its own.
// A lane past the row's units (x all 0) reads no query: its terms are
// |0 - 0| = 0.
template <int MODE, int QT, int R>
__device__ __forceinline__ void add_unit(float (&acc)[QT][R],
                                         const float (&x)[R][Unit<MODE>::kV],
                                         const float* sq, int q_stride, int u,
                                         int n_units, int qg) {
  constexpr int V = Unit<MODE>::kV;
  const bool live = u < n_units;
#pragma unroll
  for (int q = 0; q < QT; ++q) {
    if (q >= qg) break;
    const float4* s = reinterpret_cast<const float4*>(sq + q * q_stride + u * V);
    float qv[V];
#pragma unroll
    for (int h = 0; h < V / 4; ++h) {
      const float4 t = live ? s[h] : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      qv[4 * h] = t.x;
      qv[4 * h + 1] = t.y;
      qv[4 * h + 2] = t.z;
      qv[4 * h + 3] = t.w;
    }
#pragma unroll
    for (int v = 0; v < V; ++v)
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const float t = __fsub_rn(x[i][v], qv[v]);
        acc[q][i] = MODE == 2 ? __fadd_rn(acc[q][i], __fmul_rn(t, t))
                              : __fadd_rn(acc[q][i], fabsf(t));
      }
  }
}

// The lane sums of N queries (v[0..N)) reduced over the warp by the xor
// butterfly's pairs at offsets O, O / 2, ..., 1. While N > 1 each step
// halves the queries a lane holds (recursive halving); afterwards v[0] of
// lane l holds query (l & (N0 - 1)) for the first N0 = N queries when N0 =
// 32, and every lane holds the one query's sum when N0 = 1.
template <int N, int O>
__device__ __forceinline__ void halve(float* v, int lane) {
  if constexpr (O > 0) {
    if constexpr (N > 1) {
      const bool upper = (lane & O) != 0;
#pragma unroll
      for (int t = 0; t < N / 2; ++t) {
        const float send = upper ? v[t] : v[t + N / 2];
        const float keep = upper ? v[t + N / 2] : v[t];
        v[t] = __fadd_rn(keep, __shfl_xor_sync(kFull, send, O));
      }
      halve<N / 2, O / 2>(v, lane);
    } else {
      v[0] = __fadd_rn(v[0], __shfl_xor_sync(kFull, v[0], O));
      halve<1, O / 2>(v, lane);
    }
  }
}

__device__ __forceinline__ unsigned long long make_key(float d, long long r) {
  const unsigned b = __float_as_uint(d);
  const unsigned u = (b & 0x80000000u) ? ~b : (b | 0x80000000u);
  return ((unsigned long long)u << 32) | (unsigned long long)(unsigned)r;
}

__device__ __forceinline__ float key_distance(unsigned long long key) {
  const unsigned u = (unsigned)(key >> 32);
  return __uint_as_float((u & 0x80000000u) ? (u ^ 0x80000000u) : ~u);
}

// Kernel 1. QT = 1 (one query, every lane holds its sums, lane 0 keeps
// them) or 32 (up to 32 queries, lane q keeps query q). LIST: 0 the
// distance entry (the masked distances to dist_out (Q, N), no lists);
// kRegK a list of the kRegK smallest keys in registers (k <= kRegK: its
// first k are the k smallest); kMaxK a list of the k smallest in shared
// memory, after the queries: slot i of warp w's list of query q at
// (w * k + i) * group + q. A row stays as loaded (16 bytes a unit) until
// its unit is added, when each element becomes a float once for all the
// queries.
template <int MODE, int QT, int LIST>
__global__ void __launch_bounds__(kThreads, QT > 1 ? 2 : 3)
    query_kernel(const void* __restrict__ rows, const float* __restrict__ pos,
                 const long long* __restrict__ size_ptr, long long size_val,
                 const float* __restrict__ qcdf,
                 const float* __restrict__ filters, int n_rows, int n_bins,
                 int n_queries, int group, int k, float scale, int vec,
                 unsigned long long* __restrict__ cand,
                 float* __restrict__ dist_out) {
  constexpr int V = Unit<MODE>::kV;
  constexpr int J = Unit<MODE>::kJ;
  constexpr int R = rows_of(QT > 1);
  constexpr bool DIST = LIST == 0;
  extern __shared__ float4 smem4[];
  float* sq = reinterpret_cast<float*>(smem4);
  const int n_units = (n_bins + V - 1) / V;
  const int q_stride = n_units * V;       // floats a query, zero-padded
  const int q0 = blockIdx.y * group;
  const int qg = min(group, n_queries - q0);
  for (int i = threadIdx.x; i < group * q_stride; i += kThreads) {
    const int q = i / q_stride, e = i - q * q_stride;
    sq[i] = q < qg && e < n_bins ? qcdf[(long long)(q0 + q) * n_bins + e]
                                 : 0.0f;
  }
  const int lane = threadIdx.x & 31;
  const int my_q = QT == 1 ? 0 : lane;
  const bool keeper = QT == 1 ? lane == 0 : lane < qg;
  float fx = 0.0f, fy = 0.0f, fz = 0.0f, fmin = 0.0f;
  if (keeper) {
    const float* f = filters + (long long)(q0 + my_q) * 4;
    fx = f[0];
    fy = f[1];
    fz = f[2];
    fmin = f[3];
  }
  const long long size = size_ptr != nullptr ? *size_ptr : size_val;
  unsigned long long* list = reinterpret_cast<unsigned long long*>(
      sq + group * q_stride) + (threadIdx.x >> 5) * k * group + my_q;
  unsigned long long regs[LIST == kRegK ? kRegK : 1];
  unsigned long long last = kNoKey;   // the list's last key
  if constexpr (LIST == kMaxK) {
    if (keeper)
      for (int i = 0; i < k; ++i) list[i * group] = kNoKey;
  }
  if constexpr (LIST == kRegK) {
#pragma unroll
    for (int i = 0; i < kRegK; ++i) regs[i] = kNoKey;
  }
  __syncthreads();

  const long long warps = (long long)gridDim.x * kWarps;
  const long long gw = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  for (long long r0 = gw * R; r0 < n_rows; r0 += warps * R) {
    float acc[QT][R];
#pragma unroll
    for (int q = 0; q < QT; ++q)
#pragma unroll
      for (int i = 0; i < R; ++i) acc[q][i] = 0.0f;
    if constexpr (QT == 1) {
      // one query: a segment's loads all in flight at once
      for (int u0 = 0; u0 < n_units; u0 += 32 * J) {
        uint4 raw[R][J];
#pragma unroll
        for (int j = 0; j < J; ++j)
#pragma unroll
          for (int i = 0; i < R; ++i)
            raw[i][j] = load_unit<MODE>(rows, r0 + i, n_rows, n_bins,
                                            u0 + 32 * j + lane, n_units, vec);
#pragma unroll
        for (int j = 0; j < J; ++j) {
          if (u0 + 32 * j >= n_units) break;   // the warp is past the row
          float x[R][V];
#pragma unroll
          for (int i = 0; i < R; ++i)
#pragma unroll
            for (int v = 0; v < V; ++v)
              x[i][v] = element<MODE>(raw[i][j], v, scale);
          add_unit<MODE, QT, R>(acc, x, sq, q_stride, u0 + 32 * j + lane,
                                n_units, qg);
        }
      }
    } else {
      // a group: one unit at a time (fewer registers, so two CTAs an SM),
      // the next kAhead units' loads in flight
      uint4 ring[kAhead + 1][R];
#pragma unroll
      for (int a = 0; a <= kAhead; ++a)
#pragma unroll
        for (int i = 0; i < R; ++i)
          ring[a][i] = load_unit<MODE>(rows, r0 + i, n_rows, n_bins,
                                           32 * a + lane, n_units, vec);
      for (int u0 = 0; u0 < n_units; u0 += 32) {
        float x[R][V];
#pragma unroll
        for (int i = 0; i < R; ++i)
#pragma unroll
          for (int v = 0; v < V; ++v) x[i][v] = element<MODE>(ring[0][i], v,
                                                              scale);
#pragma unroll
        for (int a = 0; a < kAhead; ++a)
#pragma unroll
          for (int i = 0; i < R; ++i) ring[a][i] = ring[a + 1][i];
#pragma unroll
        for (int i = 0; i < R; ++i)
          ring[kAhead][i] = load_unit<MODE>(
              rows, r0 + i, n_rows, n_bins, u0 + 32 * (kAhead + 1) + lane,
              n_units, vec);
        add_unit<MODE, QT, R>(acc, x, sq, q_stride, u0 + lane, n_units, qg);
      }
    }
    float d[R];
#pragma unroll
    for (int i = 0; i < R; ++i) {
      float v[QT];
#pragma unroll
      for (int q = 0; q < QT; ++q) v[q] = acc[q][i];
      halve<QT, 16>(v, lane);
      d[i] = v[0];
    }
    if (!keeper) continue;
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const long long r = r0 + i;
      if (r >= n_rows) break;
      float dd = MODE == 2 ? __fsqrt_rn(d[i]) : d[i];
      if (r >= size) {
        dd = __uint_as_float(nsc::kInfBits);
      } else if (fmin > 0.0f) {
        const float dx = __fsub_rn(pos[3 * r], fx);
        const float dy = __fsub_rn(pos[3 * r + 1], fy);
        const float dz = __fsub_rn(pos[3 * r + 2], fz);
        const float s = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx),
                                            __fmul_rn(dy, dy)),
                                  __fmul_rn(dz, dz));
        if (__fsqrt_rn(s) < fmin) dd = __uint_as_float(nsc::kInfBits);
      }
      if (dd != dd) dd = __uint_as_float(kNanBits);
      if constexpr (DIST) {
        dist_out[(long long)(q0 + my_q) * n_rows + r] = dd;
      } else {
        unsigned long long key = make_key(dd, r);
        if (key < last) {
          if constexpr (LIST == kRegK) {
            // one pass of a bubble: each slot keeps the smaller key
#pragma unroll
            for (int j = 0; j < kRegK; ++j) {
              const unsigned long long lo = min(key, regs[j]);
              key = max(key, regs[j]);
              regs[j] = lo;
            }
            last = regs[kRegK - 1];
          } else {
            int j = k - 1;
            while (j > 0 && list[(j - 1) * group] > key) {
              list[j * group] = list[(j - 1) * group];
              --j;
            }
            list[j * group] = key;
            last = list[(k - 1) * group];
          }
        }
      }
    }
  }
  if constexpr (!DIST) {
    if (keeper) {
      unsigned long long* out =
          cand + ((long long)(q0 + my_q) * warps + gw) * k;
      if constexpr (LIST == kRegK) {
#pragma unroll
        for (int i = 0; i < kRegK; ++i)
          if (i < k) out[i] = regs[i];
      } else {
        for (int i = 0; i < k; ++i) out[i] = list[i * group];
      }
    }
  }
}

// The keys of the sorted lists c (lists, k) at or below `bound`, counted
// over the CTA (every thread gets the count); a list is read up to its
// first key above the bound.
__device__ int count_at_most(const unsigned long long* __restrict__ c,
                             int lists, int k, unsigned long long bound,
                             int* red) {
  int n = 0;
  for (int l = threadIdx.x; l < lists; l += kMergeThreads)
    for (int i = 0; i < k && c[(long long)l * k + i] <= bound; ++i) ++n;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) n += __shfl_xor_sync(kFull, n, o);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = n;
  __syncthreads();
  int sum = 0;
#pragma unroll
  for (int w = 0; w < kMergeThreads / 32; ++w) sum += red[w];
  __syncthreads();
  return sum;
}

// The keys of the sorted lists c (lists, k) at or below `bound` into buf
// (the first kMergeCap of them, in no order); returns how many there are
// (every thread).
__device__ int gather_at_most(const unsigned long long* __restrict__ c,
                              int lists, int k, unsigned long long bound,
                              unsigned long long* buf, int* n_kept) {
  if (threadIdx.x == 0) *n_kept = 0;
  __syncthreads();
  for (int l = threadIdx.x; l < lists; l += kMergeThreads) {
    for (int i = 0; i < k; ++i) {
      const unsigned long long key = c[(long long)l * k + i];
      if (key > bound) break;
      const int at = atomicAdd(n_kept, 1);
      if (at < kMergeCap) buf[at] = key;
    }
  }
  __syncthreads();
  const int n = *n_kept;
  __syncthreads();
  return n;
}

// Kernel 2: query blockIdx.x's k smallest keys among its `lists` sorted
// lists of k keys (cand (Q, lists, k)) into idx (Q, k) and dist (Q, k).
__global__ void __launch_bounds__(kMergeThreads)
    query_merge_kernel(const unsigned long long* __restrict__ cand, int lists,
                       int k, long long* __restrict__ idx,
                       float* __restrict__ dist) {
  __shared__ unsigned long long buf[kMergeCap];
  __shared__ unsigned long long heads[kMergeThreads];
  __shared__ unsigned long long bound_at;
  __shared__ int red[kMergeThreads / 32];
  __shared__ int n_kept;
  const int t = threadIdx.x;
  const unsigned long long* c = cand + (long long)blockIdx.x * lists * k;
  // group g < kMergeGroups: the lists l = g (mod kMergeGroups)
  unsigned long long m = kNoKey;
  for (int l = t; l < lists; l += kMergeThreads)
    m = min(m, c[(long long)l * k]);
  heads[t] = m;
  if (t == 0) bound_at = kNoKey;
  __syncthreads();
  if (t < kMergeGroups) {
#pragma unroll
    for (int s = kMergeGroups; s < kMergeThreads; s += kMergeGroups)
      m = min(m, heads[t + s]);
  }
  __syncthreads();
  if (t < kMergeGroups) heads[t] = m;
  __syncthreads();
  if (t < kMergeGroups) {
    // the group minimum whose place (equal ones by group) is k - 1
    int place = 0;
    for (int g = 0; g < kMergeGroups; ++g) {
      const unsigned long long h = heads[g];
      place += h < m || (h == m && g < t);
    }
    if (place == k - 1) bound_at = m;
  }
  __syncthreads();
  unsigned long long bound = bound_at;
  int kept = gather_at_most(c, lists, k, bound, buf, &n_kept);
  if (kept > kMergeCap) {
    // count(<= lo) < k and count(<= hi) > kMergeCap; the keys are distinct
    // below kNoKey, so some key value between them keeps k .. kMergeCap
    unsigned long long lo = 0, hi = bound;
    for (;;) {
      const unsigned long long mid = lo + (hi - lo) / 2;
      const int n = count_at_most(c, lists, k, mid, red);
      if (n < k) {
        lo = mid;
      } else if (n > kMergeCap) {
        hi = mid;
      } else {
        bound = mid;
        break;
      }
    }
    kept = gather_at_most(c, lists, k, bound, buf, &n_kept);
  }
  // a kept key's place among the kept ones; the first k are written there
  for (int i = t; i < kept; i += kMergeThreads) {
    const unsigned long long key = buf[i];
    int place = 0;
    for (int j = 0; j < kept; ++j) place += buf[j] < key;
    if (place < k) {
      idx[(long long)blockIdx.x * k + place] =
          (long long)(key & 0xffffffffull);
      dist[(long long)blockIdx.x * k + place] = key_distance(key);
    }
  }
}

using KernelFn = void (*)(const void*, const float*, const long long*,
                          long long, const float*, const float*, int, int,
                          int, int, int, float, int, unsigned long long*,
                          float*);

// Instance (mode * 2 + (group size 32)) * 3 + route, route 0 the
// distance entry, 1 the lists in registers, 2 in local memory.
KernelFn instance(int which) {
  static const KernelFn table[kInstances] = {
      query_kernel<0, 1, 0>,  query_kernel<0, 1, kRegK>,
      query_kernel<0, 1, kMaxK>,  query_kernel<0, 32, 0>,
      query_kernel<0, 32, kRegK>, query_kernel<0, 32, kMaxK>,
      query_kernel<1, 1, 0>,  query_kernel<1, 1, kRegK>,
      query_kernel<1, 1, kMaxK>,  query_kernel<1, 32, 0>,
      query_kernel<1, 32, kRegK>, query_kernel<1, 32, kMaxK>,
      query_kernel<2, 1, 0>,  query_kernel<2, 1, kRegK>,
      query_kernel<2, 1, kMaxK>,  query_kernel<2, 32, 0>,
      query_kernel<2, 32, kRegK>, query_kernel<2, 32, kMaxK>};
  return table[which];
}

int route_of(int k) { return k == 0 ? 0 : (k <= kRegK ? 1 : 2); }

int mode_of(int storage, int metric) {
  return storage == 1 ? 1 : (metric == 1 ? 2 : 0);
}

int unit_elems(int mode) { return mode == 1 ? 8 : 4; }

// Shared bytes a query of a CTA: its units (the last zero-padded) and, on
// the route whose lists sit in shared memory (k > kRegK), its 8 warps'
// lists.
long long query_bytes(int mode, int n_bins, int k) {
  const int v = unit_elems(mode);
  const long long units = (n_bins + v - 1) / v;
  return units * v * 4LL +
         (k > kRegK ? (long long)kWarps * k * 8 : 0);
}

bool valid_shape(int storage, int metric, int n_rows, int n_bins,
                 int n_queries) {
  return storage >= 0 && storage <= 1 && metric >= 0 && metric <= 1 &&
         !(storage == 1 && metric == 1) && n_rows >= 1 && n_bins >= 1 &&
         n_queries >= 1 && (long long)n_rows * n_bins < LLONG_MAX / 4;
}

// Launches kernel 1 (after the instance's shared-memory limit is raised to
// `smem`), returning its error.
cudaError_t launch_main(int which, int ctas, int groups, int smem,
                        cudaStream_t s, void** args) {
  int dev = 0;
  cudaError_t err = nsc::current_device(&dev);
  if (err != cudaSuccess) return err;
  const void* fn = reinterpret_cast<const void*>(instance(which));
  if (smem > 48 * 1024 && g_smem_set[dev][which] < smem) {
    err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return err;
    g_smem_set[dev][which] = smem;
  }
  err = cudaLaunchKernel(fn, dim3(ctas, groups, 1), dim3(kThreads, 1, 1),
                         args, (size_t)smem, s);
  const cudaError_t last = cudaGetLastError();
  return err != cudaSuccess ? err : last;
}

}  // namespace

// The launch layout of a call: out[0] CTAs a query group (at most the CTAs
// that fit the card at once, and no more than the rows' pairs need), out[1]
// the queries a CTA holds (1 for one query; else up to 32, as many as fit
// its shared memory), out[2] its dynamic shared memory in bytes. storage: 0
// float32, 1 uint16; metric: 0 W1, 1 L2; k: the fused route's (0: the
// distance entry).
extern "C" int nsc_query_layout(int storage, int metric, int n_rows,
                                int n_bins, int n_queries, int k, int* out) {
  if (!valid_shape(storage, metric, n_rows, n_bins, n_queries))
    return (int)cudaErrorInvalidValue;
  int dev = 0;
  cudaError_t err = nsc::current_device(&dev);
  if (err != cudaSuccess) return (int)err;
  int sms = 0, optin = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
  if (err != cudaSuccess) return (int)err;
  const int mode = mode_of(storage, metric);
  if (k < 0 || k > kMaxK) return (int)cudaErrorInvalidValue;
  const long long per_query = query_bytes(mode, n_bins, k);
  const int wide = n_queries > 1;
  long long group = 1;
  if (wide) {
    group = optin / per_query;
    if (group > kGroup) group = kGroup;
    if (group > n_queries) group = n_queries;
  }
  if (group < 1 || group * per_query > optin)
    return (int)cudaErrorInvalidValue;
  const int smem = (int)(group * per_query);
  const int which = (mode * 2 + wide) * 3 + route_of(k);
  const void* fn = reinterpret_cast<const void*>(instance(which));
  if (smem > 48 * 1024 && g_smem_set[dev][which] < smem) {
    err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return (int)err;
    g_smem_set[dev][which] = smem;
  }
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, kThreads,
                                                      (size_t)smem);
  if (err != cudaSuccess) return (int)err;
  const long long step = (long long)rows_of(wide) * kWarps;
  const long long need = ((long long)n_rows + step - 1) / step;
  const long long fit = (long long)sms * (per_sm > 0 ? per_sm : 1);
  out[0] = (int)(need < fit ? need : fit);
  out[1] = (int)group;
  out[2] = smem;
  return (int)cudaSuccess;
}

// The fused route, k <= kMaxK: kernel 1 on a (ctas, ceil(Q / group)) grid,
// then kernel 2 on Q CTAs. rows (N, n_bins) float32 or uint16, pos (N, 3)
// float32, the effective size at size_ptr (a device int64) or, when it is
// null, size_val; qcdf (Q, n_bins) and filters (Q, 4) float32; cand scratch
// of Q * ctas * 8 * k int64; idx (Q, k) int64 and dist (Q, k) float32 out.
// ctas, group and smem as nsc_query_layout gave them. Returns the first
// error (cudaErrorInvalidValue, nothing launched, for sizes out of range).
extern "C" int nsc_query_topk(const void* rows, int storage, int metric,
                              const void* pos, const void* size_ptr,
                              long long size_val, const void* qcdf,
                              const void* filters, int n_rows, int n_bins,
                              int n_queries, int k, float scale, int ctas,
                              int group, int smem, void* cand, void* idx,
                              void* dist, void* stream) {
  if (!valid_shape(storage, metric, n_rows, n_bins, n_queries) || k < 1 ||
      k > kMaxK || k > n_rows || ctas < 1 || group < 1 || group > kGroup ||
      (n_queries == 1 && group != 1) ||
      (long long)ctas * kWarps * k > INT_MAX)
    return (int)cudaErrorInvalidValue;
  const int mode = mode_of(storage, metric);
  if (smem < group * query_bytes(mode, n_bins, k))
    return (int)cudaErrorInvalidValue;
  const int wide = n_queries > 1;
  const int which = (mode * 2 + wide) * 3 + route_of(k);
  int vec = n_bins % unit_elems(mode) == 0 &&
            reinterpret_cast<uintptr_t>(rows) % 16 == 0;
  const auto s = static_cast<cudaStream_t>(stream);
  const long long* sp = static_cast<const long long*>(size_ptr);
  const float* pp = static_cast<const float*>(pos);
  const float* qp = static_cast<const float*>(qcdf);
  const float* fp = static_cast<const float*>(filters);
  auto cp = static_cast<unsigned long long*>(cand);
  float* no_dist = nullptr;
  void* args[] = {(void*)&rows, (void*)&pp,     (void*)&sp,
                  (void*)&size_val, (void*)&qp, (void*)&fp,
                  (void*)&n_rows, (void*)&n_bins, (void*)&n_queries,
                  (void*)&group, (void*)&k, (void*)&scale, (void*)&vec,
                  (void*)&cp, (void*)&no_dist};
  const int groups = (n_queries + group - 1) / group;
  cudaError_t err = launch_main(which, ctas, groups, smem, s, args);
  if (err != cudaSuccess) return (int)err;
  query_merge_kernel<<<n_queries, kMergeThreads, 0, s>>>(
      cp, ctas * kWarps, k, static_cast<long long*>(idx),
      static_cast<float*>(dist));
  return (int)cudaGetLastError();
}

// The distance entry, for any k: kernel 1 writes the masked distances to
// dist (Q, N) float32 (the same arguments as nsc_query_topk otherwise).
extern "C" int nsc_query_dist(const void* rows, int storage, int metric,
                              const void* pos, const void* size_ptr,
                              long long size_val, const void* qcdf,
                              const void* filters, int n_rows, int n_bins,
                              int n_queries, float scale, int ctas, int group,
                              int smem, void* dist, void* stream) {
  if (!valid_shape(storage, metric, n_rows, n_bins, n_queries) || ctas < 1 ||
      group < 1 || group > kGroup || (n_queries == 1 && group != 1))
    return (int)cudaErrorInvalidValue;
  const int mode = mode_of(storage, metric);
  if (smem < group * query_bytes(mode, n_bins, 0))
    return (int)cudaErrorInvalidValue;
  const int wide = n_queries > 1;
  const int which = (mode * 2 + wide) * 3;
  int vec = n_bins % unit_elems(mode) == 0 &&
            reinterpret_cast<uintptr_t>(rows) % 16 == 0;
  const auto s = static_cast<cudaStream_t>(stream);
  const long long* sp = static_cast<const long long*>(size_ptr);
  const float* pp = static_cast<const float*>(pos);
  const float* qp = static_cast<const float*>(qcdf);
  const float* fp = static_cast<const float*>(filters);
  unsigned long long* no_cand = nullptr;
  auto dp = static_cast<float*>(dist);
  int k = 0;
  void* args[] = {(void*)&rows, (void*)&pp,     (void*)&sp,
                  (void*)&size_val, (void*)&qp, (void*)&fp,
                  (void*)&n_rows, (void*)&n_bins, (void*)&n_queries,
                  (void*)&group, (void*)&k, (void*)&scale, (void*)&vec,
                  (void*)&no_cand, (void*)&dp};
  const int groups = (n_queries + group - 1) / group;
  return (int)launch_main(which, ctas, groups, smem, s, args);
}
