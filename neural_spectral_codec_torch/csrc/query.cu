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
// fast-math). The order fixes which lane sum a term goes to; which warp
// or thread forms that sum, and how many (query, row) sums it holds, is
// free, so both regimes below give a query the same bits.
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
// subtracts and adds that cannot fuse, 153 us at 33.5 T/s. On the H100 the
// FP32 rate is the issue rate (4 warp-instructions a clock an SM), so the
// group regime nears its bound only where almost every instruction it
// issues is an FADD or FSUB and shared memory stays well below that pipe.
//
// Design.
//   * One query (query_kernel): grid (ctas, 1) of 8 warps, 3 CTAs an SM.
//     The query's units sit in shared memory; a warp takes a row at a
//     time, runs of rows strided over every warp of the grid, each lane its
//     units with 16-byte loads, a segment of 7 units of a float32 row (4 of
//     a uint16 one) in flight at once, then the next segment for longer
//     rows; codes become floats as their unit is added. The row's lane sums
//     are reduced by the butterfly on every lane, and lane 0 keys the row
//     (masks, NaN) into its warp's list (below).
//   * A group of 2-32 queries (query_group_kernel): grid (ctas, query
//     groups) of 8 warps, one CTA an SM. The group's queries sit in shared
//     memory for the whole launch, split into 1, 2 or 4 query tiles of at
//     most kTileQ = 8 (query_tiles; a group's queries spread evenly over
//     them), and the 8 / tiles warps of each tile split the rows: a round
//     of the CTA is kTileR = 8 rows a warp of a tile, 64 / tiles rows in
//     all (16 for 17-32 queries, 64 for up to 8). A warp holds a register
//     tile of 8 queries x 8 rows, 64 sums a lane: for each of its units a
//     lane reads the 8 rows' 16-byte units, then each query's quad, and
//     adds 8 rows x 4 terms from that one read, so a shared-memory query
//     read feeds 64 FP32 instructions (W1; 96 for L2) and a row read feeds
//     8 queries. uint16 codes become floats as a warp reads them (one FMA
//     a code, code_quad), 2 instructions a code against 16 a code's terms.
//     The rounds' rows come through a ring of ns stages in shared memory
//     (3-4 where they fit, kMaxStages; a stage: `cb` column blocks of a
//     round, a block 32 units of each of its rows, one unit a lane), each
//     filled by 2-D tensor copies (TMA, a box a block, zeros past the rows
//     and n_bins) that complete the stage's full mbarrier. The warps never
//     wait for each other: a warp leaves a stage as soon as it has summed
//     it (a shared counter a stage) and the last warp out refills it with
//     the stage ns further on, so one warp's round end (halving, masks,
//     lists) overlaps the other warps' sums. Rows that are not 16-byte
//     aligned or whose width is not a multiple of V are filled by the
//     refilling warp's plain loads instead. The host sizes cb and ns so
//     that the ring fits beside the queries (group_plan): at 32 queries
//     float32 rows go in 3 stages of 4 blocks (2 a round), uint16 codes in
//     3 stages of whole rows. At a round's end a warp reduces its 64 sums
//     by recursive halving over the butterfly's pairs (halve: 62
//     shuffles), which leaves lane l the sums of query slot l / 4 over
//     rows 2 (l % 4) and 2 (l % 4) + 1 of its tile; the lane keys them.
//   * The lists. Up to k = kRegK = 16 each keeping lane has a list of its
//     16 smallest keys in registers (an insert is one unrolled pass of
//     compare-and-swap; a key enters only below the list's last, which a
//     register holds, so after the first rows inserts are rare): one list
//     a (warp, query) for one query, one a (warp, query slot, lane) in a
//     group. A group's list keeps its k keys in the top k registers, 0s
//     (below every key) under them, so its last register is its k-th key,
//     and a key at or above the least k-th key of its slot's 4 lists is
//     not inserted (those k keys are smaller). For k <= kMaxK = 128 the
//     lists sit in shared memory, one a (warp, query) for one query (fewer
//     queries a CTA where they do not fit) and one a (warp, query slot) in
//     a group, into which the slot's four lanes' keys below its last go
//     one at a time, the whole warp shifting the list (warp_insert). Each
//     list's first k keys go to scratch, (query, list, k).
//   * Kernel 2, query_merge_kernel: one CTA a query. The lists' first keys,
//     in kMergeGroups = 128 groups of lists, give 128 group minima; the k
//     smallest of them are keys of k distinct lists, so the k-th bounds
//     the query's k-th key from above. The keys at or below the bound (a
//     few more than k on most data; each list read up to its first key
//     above it) are gathered into shared memory; when more than kMergeCap
//     are, the bound is lowered by bisection over the key, a counting pass
//     a step, until between k and kMergeCap remain. Each kept key's place
//     among them is counted and the first k are written there.
//   * The distance entry (LIST = 0), for k > kMaxK: kernel 1's loop writes
//     the masked (Q, N) distances instead of lists, and the wrapper ranks
//     them with smallest_k. Nothing writes a (Q, N, n_bins) temporary.
#include <climits>
#include <cstdint>

#include <cuda.h>             // CUtensorMap (the encoder comes from the runtime)
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;               // one query: 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kGroupWarps = 8;              // a group's CTA at most
constexpr int kGroupThreads = 32 * kGroupWarps;
constexpr int kRowsOne = 1;                 // rows a warp a step: one query
constexpr int kTileQ = 8;                   // a group warp's tile: queries
constexpr int kTileR = 8;                   // x rows, 64 sums a lane
constexpr int kSlotLanes = 4;               // lanes of a query slot after
                                            // the halving (2 rows each)
constexpr int kLaneSums = kTileQ * kTileR / 32;   // a lane's after it
constexpr int kBlock = 32;                  // units a column block: a lane's
constexpr int kMaxStages = 4;               // a group's ring of row slabs
constexpr int kMinStages = 3;               // ... where they fit
constexpr int kBarriers = 16;               // full[], leave counts: 128 B
constexpr int kMaxK = 128;                  // K_MAX: the fused route's k
constexpr int kRegK = 16;                   // lists up to here in registers
constexpr int kGroup = 32;                  // queries a CTA at most
constexpr int kMergeThreads = 512;
constexpr int kMergeGroups = 128;           // group minima that bound k
constexpr int kMergeCap = 4096;             // keys the merge ranks
constexpr unsigned long long kNoKey = ~0ull;
constexpr unsigned kNanBits = 0x7fc00000u;  // torch's and numpy's NaN
constexpr unsigned kFull = 0xffffffffu;
constexpr int kInstances = 18;              // 3 modes x 2 regimes x 3

static_assert(kSlotLanes * kTileQ == 32 && kSlotLanes * kLaneSums == kTileR,
              "after the halving lane l holds slot l / 4, 2 of its rows");
static_assert(4 * kTileQ == kGroup && kGroupWarps % 4 == 0,
              "at most 4 query tiles, each with the same warps");
static_assert(2 * kMaxStages <= kBarriers && kBarriers * 8 % 128 == 0,
              "a group CTA's barriers keep the queries 128-byte aligned");

// Modes: 0 W1 over float32 rows, 1 W1 over uint16 codes, 2 L2 over float32.
template <int MODE>
struct Unit {
  static constexpr int kV = MODE == 1 ? 8 : 4;   // elements a 16-byte unit
  static constexpr int kJ = MODE == 1 ? 4 : 7;   // units a lane a segment
  static constexpr int kH = kV / 4;              // float quads a unit
};

// Query tiles of a group's CTA: 1, 2 or 4 of at most kTileQ queries; the
// warps / tiles warps of a tile split the rows.
__host__ __device__ constexpr int query_tiles(int group) {
  return group <= kTileQ ? 1 : (group <= 2 * kTileQ ? 2 : 4);
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

// Half h of a unit of codes as 4 floats, each code * scale rounded once:
// 2^23 + code and bias = -2^23 * scale are exact, so one FMA of the two
// rounds code * scale once (the value element<1> makes with two roundings
// of exact operands).
__device__ __forceinline__ float4 code_quad(const uint4& w, int h,
                                            float scale, float bias) {
  const unsigned a = h ? w.z : w.x, b = h ? w.w : w.y;
  return make_float4(
      __fmaf_rn(__uint_as_float(0x4b000000u | (a & 0xffffu)), scale, bias),
      __fmaf_rn(__uint_as_float(0x4b000000u | (a >> 16)), scale, bias),
      __fmaf_rn(__uint_as_float(0x4b000000u | (b & 0xffffu)), scale, bias),
      __fmaf_rn(__uint_as_float(0x4b000000u | (b >> 16)), scale, bias));
}

// One unit of R rows (x, as floats) into the sum of the one query: each
// term |x - q| (or its square) added to its row's sum in the unit's element
// order, every operation rounded on its own. A lane past the row's units
// (x all 0) reads no query: its terms are |0 - 0| = 0.
template <int MODE, int R>
__device__ __forceinline__ void add_unit(float (&acc)[R],
                                         const float (&x)[R][Unit<MODE>::kV],
                                         const float* sq, int u,
                                         int n_units) {
  constexpr int V = Unit<MODE>::kV;
  const bool live = u < n_units;
  const float4* s = reinterpret_cast<const float4*>(sq + u * V);
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
      acc[i] = MODE == 2 ? __fadd_rn(acc[i], __fmul_rn(t, t))
                         : __fadd_rn(acc[i], fabsf(t));
    }
}

// a + |x - y| (or + (x - y)^2) for each of a quad's 4 elements in order.
template <int MODE>
__device__ __forceinline__ float add_quad(float a, const float4& x,
                                          const float4& y) {
  const float t0 = __fsub_rn(x.x, y.x), t1 = __fsub_rn(x.y, y.y);
  const float t2 = __fsub_rn(x.z, y.z), t3 = __fsub_rn(x.w, y.w);
  if constexpr (MODE == 2) {
    a = __fadd_rn(a, __fmul_rn(t0, t0));
    a = __fadd_rn(a, __fmul_rn(t1, t1));
    a = __fadd_rn(a, __fmul_rn(t2, t2));
    return __fadd_rn(a, __fmul_rn(t3, t3));
  } else {
    a = __fadd_rn(a, fabsf(t0));
    a = __fadd_rn(a, fabsf(t1));
    a = __fadd_rn(a, fabsf(t2));
    return __fadd_rn(a, fabsf(t3));
  }
}

// The lane sums of N (query, row) pairs (v[0..N)) reduced over the warp by
// the xor butterfly's pairs at offsets O, O / 2, ..., 1. While N > 1 each
// step halves the values a lane holds (recursive halving: at offset o a
// lane keeps the half its bit o selects, sends the other half to lane ^ o
// and adds what comes back); afterwards lane l holds the pairs (l << 1) |
// t for t < N0 / 32 of the first N0 = N >= 32, and every lane holds the
// one pair's sum when N0 = 1.
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

// The masked distance of a (query, row) sum d: L2's root, +inf past size
// or nearer than fmin (> 0) to the filter's point (p: the row's
// position), every NaN the one NaN.
template <int MODE>
__device__ __forceinline__ float masked(float d, long long r, long long size,
                                        const float* p, float fx, float fy,
                                        float fz, float fmin) {
  float dd = MODE == 2 ? __fsqrt_rn(d) : d;
  if (r >= size) {
    dd = __uint_as_float(nsc::kInfBits);
  } else if (fmin > 0.0f) {
    const float dx = __fsub_rn(p[0], fx);
    const float dy = __fsub_rn(p[1], fy);
    const float dz = __fsub_rn(p[2], fz);
    const float s = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                              __fmul_rn(dz, dz));
    if (__fsqrt_rn(s) < fmin) dd = __uint_as_float(nsc::kInfBits);
  }
  if (dd != dd) dd = __uint_as_float(kNanBits);
  return dd;
}

// key into a sorted register list of kRegK keys: one pass of a bubble,
// each slot keeping the smaller key; `last` follows the list's last.
__device__ __forceinline__ void insert_regs(unsigned long long (&regs)[kRegK],
                                            unsigned long long key,
                                            unsigned long long& last) {
#pragma unroll
  for (int j = 0; j < kRegK; ++j) {
    const unsigned long long lo = min(key, regs[j]);
    key = max(key, regs[j]);
    regs[j] = lo;
  }
  last = regs[kRegK - 1];
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// Kernel 1 for one query (every lane holds its sums, lane 0 keeps them).
// LIST: 0 the distance entry (the masked distances to dist_out (1, N), no
// lists); kRegK a list of the kRegK smallest keys in registers (k <=
// kRegK: its first k are the k smallest); kMaxK a list of the k smallest
// in shared memory, after the query: slot i of warp w's list at (w * k +
// i) * group. A row stays as loaded (16 bytes a unit) until its unit is
// added, when each element becomes a float.
template <int MODE, int LIST>
__global__ void __launch_bounds__(kThreads, 3)
    query_kernel(const void* __restrict__ rows, const float* __restrict__ pos,
                 const long long* __restrict__ size_ptr, long long size_val,
                 const float* __restrict__ qcdf,
                 const float* __restrict__ filters, int n_rows, int n_bins,
                 int n_queries, int group, int k, float scale, int vec,
                 unsigned long long* __restrict__ cand,
                 float* __restrict__ dist_out) {
  constexpr int V = Unit<MODE>::kV;
  constexpr int J = Unit<MODE>::kJ;
  constexpr int R = kRowsOne;
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
  const bool keeper = lane == 0;
  float fx = 0.0f, fy = 0.0f, fz = 0.0f, fmin = 0.0f;
  if (keeper) {
    const float* f = filters + (long long)q0 * 4;
    fx = f[0];
    fy = f[1];
    fz = f[2];
    fmin = f[3];
  }
  const long long size = size_ptr != nullptr ? *size_ptr : size_val;
  unsigned long long* list = reinterpret_cast<unsigned long long*>(
      sq + group * q_stride) + (threadIdx.x >> 5) * k * group;
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
    float acc[R];
#pragma unroll
    for (int i = 0; i < R; ++i) acc[i] = 0.0f;
    // a segment's loads all in flight at once
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
        add_unit<MODE, R>(acc, x, sq, u0 + 32 * j + lane, n_units);
      }
    }
    float d[R];
#pragma unroll
    for (int i = 0; i < R; ++i) {
      float v[1] = {acc[i]};
      halve<1, 16>(v, lane);
      d[i] = v[0];
    }
    if (!keeper) continue;
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const long long r = r0 + i;
      if (r >= n_rows) break;
      const float dd =
          masked<MODE>(d[i], r, size, pos + 3 * r, fx, fy, fz, fmin);
      if constexpr (DIST) {
        dist_out[(long long)q0 * n_rows + r] = dd;
      } else {
        unsigned long long key = make_key(dd, r);
        if (key < last) {
          if constexpr (LIST == kRegK) {
            insert_regs(regs, key, last);
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
          cand + ((long long)q0 * warps + gw) * k;
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

__device__ __forceinline__ bool mbarrier_done(unsigned bar, unsigned phase) {
  unsigned done;
  asm volatile(
      "{\n .reg .pred p;\n"
      " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      " selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done) : "r"(bar), "r"(phase) : "memory");
  return done != 0;
}

// key into a sorted shared-memory list of k <= kMaxK keys (kNoKey past its
// filled part) by the whole warp: lane l holds positions l + 32 c; the
// keys below `key` keep their places, the rest move up one, the last
// drops out. A key not below the list's last changes nothing.
__device__ __forceinline__ void warp_insert(unsigned long long* list, int k,
                                            unsigned long long key,
                                            int lane) {
  constexpr int C = kMaxK / 32;
  unsigned long long e[C];
  int p = 0;                                  // the keys below key
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int at = lane + 32 * c;
    e[c] = at < k ? list[at] : kNoKey;
    p += __popc(__ballot_sync(kFull, e[c] < key));
  }
  if (p >= k) return;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const unsigned long long up = __shfl_up_sync(kFull, e[c], 1);
    const unsigned long long wrap =
        __shfl_sync(kFull, e[c > 0 ? c - 1 : 0], 31);   // lane 0, c > 0
    const int at = lane + 32 * c;
    if (at < k && at >= p) list[at] = at == p ? key : (lane ? up : wrap);
  }
  __syncwarp();
}

// A quad step of a warp's tile: the kTileR rows' quads x[], then each
// query's quad (qp, q_quads apart) with its kTileR x 4 terms. FULL: all
// kTileQ query slots hold queries (no test a query).
template <int MODE, bool FULL>
__device__ __forceinline__ void tile_step(float (&acc)[kTileQ][kTileR],
                                          const float4 (&x)[kTileR],
                                          const float4* qp, int q_quads,
                                          int qn) {
#pragma unroll
  for (int q = 0; q < kTileQ; ++q) {
    if (!FULL && q >= qn) break;
    const float4 y = qp[q * q_quads];
#pragma unroll
    for (int i = 0; i < kTileR; ++i)
      acc[q][i] = add_quad<MODE>(acc[q][i], x[i], y);
  }
}

__device__ __forceinline__ void mbarrier_wait(unsigned bar, unsigned phase) {
  while (!mbarrier_done(bar, phase)) {}
}

// One box of (box rows, kBlock units) of the rows' tensor map at element
// column `col`, row `row`, into shared memory at dst, completing on bar.
__device__ __forceinline__ void tma_box(void* dst, const CUtensorMap* map,
                                        int col, int row, unsigned bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%2, %3}], [%4];\n"
      :: "r"(smem_addr(dst)), "l"(reinterpret_cast<unsigned long long>(map)),
         "r"(col), "r"(row), "r"(bar)
      : "memory");
}

// Kernel 1 for a group of up to kGroup queries (the design above), on
// blockDim.x = 32 x warps threads (group_plan's warps). cb: column blocks
// a stage; ns: stages in the ring. Shared memory, in order: ns stages of
// the rows' 16-byte units, row r's block b unit j at (b * slab_rows + r) *
// kBlock + j (the tensor copies' own boxes); the full mbarriers and the
// stages' leave counts (kBarriers x 8 bytes); the queries, `group` x
// q_quads float quads (a uint16 query's two halves of unit u at u and
// n_units + u); for LIST = kMaxK the lists, warps x kTileQ of k keys.
template <int MODE, int LIST>
__global__ void __launch_bounds__(kGroupThreads, 1)
    query_group_kernel(const void* __restrict__ rows,
                       const float* __restrict__ pos,
                       const long long* __restrict__ size_ptr,
                       long long size_val, const float* __restrict__ qcdf,
                       const float* __restrict__ filters, int n_rows,
                       int n_bins, int n_queries, int group, int k,
                       float scale, int vec, int cb, int ns,
                       unsigned long long* __restrict__ cand,
                       float* __restrict__ dist_out,
                       const __grid_constant__ CUtensorMap rows_map) {
  constexpr int V = Unit<MODE>::kV;
  constexpr int H = Unit<MODE>::kH;
  constexpr bool DIST = LIST == 0;
  extern __shared__ __align__(128) float4 smem4[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int warps = blockDim.x >> 5;
  const int n_units = (n_bins + V - 1) / V;
  const int n_blocks = (n_units + kBlock - 1) / kBlock;
  const int q_quads = n_units * H;
  const int tiles = query_tiles(group);
  const int row_tiles = warps / tiles;
  const int slab_rows = kTileR * row_tiles;     // rows a round
  const int chunks = (n_blocks + cb - 1) / cb;  // stages a round
  const int slot_units = slab_rows * cb * kBlock;

  uint4* ring = reinterpret_cast<uint4*>(smem4);
  unsigned long long* bars =
      reinterpret_cast<unsigned long long*>(ring + ns * slot_units);
  unsigned* left = reinterpret_cast<unsigned*>(bars + kMaxStages);
  float4* sq = reinterpret_cast<float4*>(bars + kBarriers);
  unsigned long long* lists =
      reinterpret_cast<unsigned long long*>(sq + group * q_quads);
  const unsigned full0 = smem_addr(bars);

  const int q0 = blockIdx.y * group;
  const int qg = min(group, n_queries - q0);
  if (tid == 0) {
    // full[s]: the tensor copies' bytes, or the filling warp's 32 lanes
    for (int s = 0; s < kMaxStages; ++s) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
                   :: "r"(full0 + 8 * s), "r"(vec ? 1 : 32) : "memory");
      left[s] = 0;
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // the queries, zero past qg and n_bins, a quad a lane
  for (int q = warp; q < group; q += warps) {
    const float* src = qcdf + (long long)(q0 + q) * n_bins;
    for (int p = lane; p < q_quads; p += 32) {
      const int h = p >= n_units, u = p - h * n_units;
      const int e = u * V + 4 * h;
      float w[4];
#pragma unroll
      for (int c = 0; c < 4; ++c)
        w[c] = q < qg && e + c < n_bins ? src[e + c] : 0.0f;
      sq[q * q_quads + p] = make_float4(w[0], w[1], w[2], w[3]);
    }
  }
  if constexpr (LIST == kMaxK) {
    for (int i = tid; i < warps * kTileQ * k; i += blockDim.x)
      lists[i] = kNoKey;
  }
  __syncthreads();

  // rounds of this CTA: rows first + rho * step, slab_rows of them; stage
  // g is chunk g % chunks of round g / chunks, in ring slot g % ns
  const long long first = (long long)blockIdx.x * slab_rows;
  const long long step = (long long)gridDim.x * slab_rows;
  const long long rounds =
      first < n_rows ? (n_rows - first + step - 1) / step : 0;
  const long long total = rounds * chunks;

  // Fill slot s with chunk c of the round at base, by one warp: lane 0's
  // tensor copies, a block each (zeros past the rows and n_bins), which
  // complete full[s]; or, for rows not 16-byte aligned or a width not a
  // multiple of V, every lane's plain loads and its arrival.
  auto fill = [&](int s, int c, long long base) {
    const int b0 = c * cb, nb = min(cb, n_blocks - b0);
    uint4* slot = ring + s * slot_units;
    const unsigned full = full0 + 8 * s;
    if (vec) {
      if (lane != 0) return;
      asm volatile(
          "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
          :: "r"(full), "r"(nb * slab_rows * kBlock * 16) : "memory");
      for (int b = 0; b < nb; ++b)
        tma_box(slot + b * slab_rows * kBlock, &rows_map,
                (b0 + b) * kBlock * V, (int)base, full);
    } else {
      for (int r = 0; r < slab_rows; ++r)
        for (int b = 0; b < nb; ++b)
          slot[(b * slab_rows + r) * kBlock + lane] = load_unit<MODE>(
              rows, base + r, n_rows, n_bins, (b0 + b) * kBlock + lane,
              n_units, false);
      asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(full)
                   : "memory");
    }
  };
  // (c_ahead, base_ahead): the chunk and round of stage g + ns
  int c_ahead = 0;
  long long base_ahead = first;
  for (int g = 0; g < ns; ++g) {
    if (warp == 0 && g < total) fill(g, c_ahead, base_ahead);
    if (++c_ahead == chunks) {
      c_ahead = 0;
      base_ahead += step;
    }
  }

  const int qt = warp / row_tiles, rt = warp - qt * row_tiles;
  const int q_lo = qt * qg / tiles;               // the warp's queries
  const int qn = (qt + 1) * qg / tiles - q_lo;
  const int slot_q = lane / kSlotLanes;           // after the halving
  const bool keeper = slot_q < qn;
  float fx = 0.0f, fy = 0.0f, fz = 0.0f, fmin = 0.0f;
  if (keeper) {
    const float* f = filters + (long long)(q0 + q_lo + slot_q) * 4;
    fx = f[0];
    fy = f[1];
    fz = f[2];
    fmin = f[3];
  }
  const long long size = size_ptr != nullptr ? *size_ptr : size_val;
  const float bias = -8388608.0f * scale;         // code_quad's
  // A register list holds its k keys in regs[kRegK - k ..]; the slots
  // below hold 0, under every key (all keys are >= 2^63), which an insert
  // passes through, so `last` is the list's k-th key.
  unsigned long long regs[LIST == kRegK ? kRegK : 1];
  unsigned long long last = kNoKey;
  unsigned long long* my_lists = lists + warp * kTileQ * k;
  if constexpr (LIST == kRegK) {
#pragma unroll
    for (int i = 0; i < kRegK; ++i) regs[i] = i < kRegK - k ? 0ull : kNoKey;
  }

  const int row0 = rt * kTileR;                   // the warp's rows
  const float4* qbase = sq + q_lo * q_quads;
  float acc[kTileQ][kTileR];
  float rp[kLaneSums][3];                         // the lane's rows' positions
  int c = 0, s = 0;                               // chunk, slot
  unsigned lap = 0;                               // g / ns
  long long base = first;                         // the round's first row
  for (long long g = 0; g < total; ++g) {
    const int b0 = c * cb, nb = min(cb, n_blocks - b0);
    if (c == 0) {
#pragma unroll
      for (int q = 0; q < kTileQ; ++q)
#pragma unroll
        for (int i = 0; i < kTileR; ++i) acc[q][i] = 0.0f;
      // the positions of the lane's rows, read now, used at the round's end
#pragma unroll
      for (int t = 0; t < kLaneSums; ++t) {
        const long long r = base + row0 + kLaneSums * (lane % kSlotLanes) + t;
#pragma unroll
        for (int d = 0; d < 3; ++d)
          rp[t][d] = keeper && fmin > 0.0f && r < n_rows ? pos[3 * r + d]
                                                         : 0.0f;
      }
    }
    mbarrier_wait(full0 + 8 * s, lap & 1u);
    const uint4* slot = ring + s * slot_units;
#pragma unroll 1
    for (int b = 0; b < nb; ++b) {
      const int u = (b0 + b) * kBlock + lane;
      if (u >= n_units) continue;                 // past the row: adds +0
      const uint4* xr = slot + (b * slab_rows + row0) * kBlock + lane;
      uint4 w[kTileR];
#pragma unroll
      for (int i = 0; i < kTileR; ++i) w[i] = xr[i * kBlock];
#pragma unroll
      for (int h = 0; h < H; ++h) {
        float4 x[kTileR];
#pragma unroll
        for (int i = 0; i < kTileR; ++i)
          x[i] = MODE == 1 ? code_quad(w[i], h, scale, bias)
                           : make_float4(__uint_as_float(w[i].x),
                                         __uint_as_float(w[i].y),
                                         __uint_as_float(w[i].z),
                                         __uint_as_float(w[i].w));
        const float4* qp = qbase + h * n_units + u;
        if (qn == kTileQ)
          tile_step<MODE, true>(acc, x, qp, q_quads, qn);
        else
          tile_step<MODE, false>(acc, x, qp, q_quads, qn);
      }
    }
    // leave slot s; the last warp out fills it with stage g + ns
    __syncwarp();
    unsigned out_before = 0;
    if (lane == 0) {
      __threadfence_block();
      out_before = atomicAdd(left + s, 1u);
    }
    out_before = __shfl_sync(kFull, out_before, 0);
    if (out_before + 1 == (lap + 1) * warps && g + ns < total)
      fill(s, c_ahead, base_ahead);
    if (++c_ahead == chunks) {
      c_ahead = 0;
      base_ahead += step;
    }
    if (c == chunks - 1) {
      // the round's sums: lane l gets slot l / 4, rows 2 (l % 4) + t
      float v[kTileQ * kTileR];
#pragma unroll
      for (int q = 0; q < kTileQ; ++q)
#pragma unroll
        for (int i = 0; i < kTileR; ++i) v[q * kTileR + i] = acc[q][i];
      halve<kTileQ * kTileR, 16>(v, lane);
      unsigned long long key[kLaneSums];
#pragma unroll
      for (int t = 0; t < kLaneSums; ++t) {
        key[t] = kNoKey;
        const long long r = base + row0 + kLaneSums * (lane % kSlotLanes) + t;
        if (!keeper || r >= n_rows) continue;
        const float dd = masked<MODE>(v[t], r, size, rp[t], fx, fy, fz, fmin);
        if constexpr (DIST)
          dist_out[(long long)(q0 + q_lo + slot_q) * n_rows + r] = dd;
        else
          key[t] = make_key(dd, r);
      }
      if constexpr (LIST == kRegK) {
        // a key at or above the k-th key of any list of its query (here:
        // of the slot's 4 lanes) is not among the query's k smallest
        unsigned long long bar_key = last;
        bar_key = min(bar_key, __shfl_xor_sync(kFull, bar_key, 1));
        bar_key = min(bar_key, __shfl_xor_sync(kFull, bar_key, 2));
#pragma unroll
        for (int t = 0; t < kLaneSums; ++t)
          if (key[t] < bar_key) insert_regs(regs, key[t], last);
      } else if constexpr (LIST == kMaxK) {
        // the keys below their slot's list's last (which only falls, so a
        // key above it stays out), one at a time by the whole warp
        const unsigned long long bar_key =
            keeper ? my_lists[slot_q * k + k - 1] : kNoKey;
#pragma unroll
        for (int t = 0; t < kLaneSums; ++t) {
          unsigned todo = __ballot_sync(kFull, key[t] < bar_key);
          while (todo) {
            const int src = __ffs(todo) - 1;
            todo &= todo - 1;
            warp_insert(my_lists + src / kSlotLanes * k, k,
                        __shfl_sync(kFull, key[t], src), lane);
          }
        }
      }
    }
    if (++s == ns) {
      s = 0;
      ++lap;
    }
    if (++c == chunks) {
      c = 0;
      base += step;
    }
  }
  if constexpr (LIST == kRegK) {
    // list (CTA, row tile, lane of the slot) of query q0 + q_lo + slot_q
    if (keeper) {
      const long long lists_q = (long long)gridDim.x * row_tiles * kSlotLanes;
      const long long id = ((long long)blockIdx.x * row_tiles + rt) *
                               kSlotLanes + lane % kSlotLanes;
      unsigned long long* out =
          cand + ((long long)(q0 + q_lo + slot_q) * lists_q + id) * k;
#pragma unroll
      for (int i = 0; i < kRegK; ++i)
        if (i >= kRegK - k) out[i - (kRegK - k)] = regs[i];
    }
  } else if constexpr (LIST == kMaxK) {
    // list (CTA, row tile) of each of the warp's queries, a position a lane
    const long long lists_q = (long long)gridDim.x * row_tiles;
    const long long id = (long long)blockIdx.x * row_tiles + rt;
    for (int q = 0; q < qn; ++q) {
      unsigned long long* out =
          cand + ((long long)(q0 + q_lo + q) * lists_q + id) * k;
      for (int i = lane; i < k; i += 32) out[i] = my_lists[q * k + i];
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

// Instance (regime * 3 + mode) * 3 + route: regime 0 one query, 1 a group;
// route 0 the distance entry, 1 the lists in registers, 2 in shared
// memory; one a kernel function, each with its own shared-memory limit
// (g_smem_set).
const void* instance(int which) {
  static const void* const table[kInstances] = {
      reinterpret_cast<const void*>(query_kernel<0, 0>),
      reinterpret_cast<const void*>(query_kernel<0, kRegK>),
      reinterpret_cast<const void*>(query_kernel<0, kMaxK>),
      reinterpret_cast<const void*>(query_kernel<1, 0>),
      reinterpret_cast<const void*>(query_kernel<1, kRegK>),
      reinterpret_cast<const void*>(query_kernel<1, kMaxK>),
      reinterpret_cast<const void*>(query_kernel<2, 0>),
      reinterpret_cast<const void*>(query_kernel<2, kRegK>),
      reinterpret_cast<const void*>(query_kernel<2, kMaxK>),
      reinterpret_cast<const void*>(query_group_kernel<0, 0>),
      reinterpret_cast<const void*>(query_group_kernel<0, kRegK>),
      reinterpret_cast<const void*>(query_group_kernel<0, kMaxK>),
      reinterpret_cast<const void*>(query_group_kernel<1, 0>),
      reinterpret_cast<const void*>(query_group_kernel<1, kRegK>),
      reinterpret_cast<const void*>(query_group_kernel<1, kMaxK>),
      reinterpret_cast<const void*>(query_group_kernel<2, 0>),
      reinterpret_cast<const void*>(query_group_kernel<2, kRegK>),
      reinterpret_cast<const void*>(query_group_kernel<2, kMaxK>)};
  return table[which];
}

int route_of(int k) { return k == 0 ? 0 : (k <= kRegK ? 1 : 2); }

int mode_of(int storage, int metric) {
  return storage == 1 ? 1 : (metric == 1 ? 2 : 0);
}

int which_of(int mode, bool wide, int k) {
  return ((wide ? 3 : 0) + mode) * 3 + route_of(k);
}

int unit_elems(int mode) { return mode == 1 ? 8 : 4; }

// Shared bytes a query of a one-query CTA: its units (the last
// zero-padded) and, on the route whose lists sit in shared memory (k >
// kRegK), its 8 warps' lists.
long long query_bytes(int mode, int n_bins, int k) {
  const int v = unit_elems(mode);
  const long long units = (n_bins + v - 1) / v;
  return units * v * 4LL +
         (k > kRegK ? (long long)kWarps * k * 8 : 0);
}

// A group CTA's plan: warps, rows a round, column blocks a stage,
// stages and shared bytes.
struct Plan {
  int warps;
  int rows;
  int cb;
  int ns;
  long long smem;
};

// The plan of `group` queries a CTA within `budget` shared bytes: the
// most warps (kGroupWarps, then half, then a quarter) for which a ring
// fits beside the queries, the barriers and the lists (k keys a warp's
// query slot; k = 0 none); the ring's stages are a round's blocks cut
// into the fewest even chunks that give kMinStages stages (at most
// kMaxStages), else the fewest that give 2. False when nothing fits.
bool group_plan(int mode, int n_bins, int k, int group, long long budget,
                Plan* p) {
  const int v = unit_elems(mode);
  const long long units = (n_bins + v - 1) / v;
  const long long blocks = (units + kBlock - 1) / kBlock;
  for (int warps = kGroupWarps; warps >= kGroupWarps / 4 &&
                                warps >= query_tiles(group);
       warps /= 2) {
    if (warps % query_tiles(group) != 0) continue;
    const long long rows = (long long)kTileR * (warps / query_tiles(group));
    const long long fixed =
        kBarriers * 8LL + group * units * v * 4LL +
        (k > kRegK ? (long long)warps * kTileQ * 8LL * k : 0);
    const long long per_block = rows * kBlock * 16;   // a block of a round
    for (int need = kMinStages; need >= 2; --need)
      for (long long chunks = 1; chunks <= blocks; ++chunks) {
        const long long cb = (blocks + chunks - 1) / chunks;
        long long ns = (budget - fixed) / (cb * per_block);
        if (ns > kMaxStages) ns = kMaxStages;
        if (ns < need) continue;
        *p = {warps, (int)rows, (int)cb, (int)ns,
              fixed + ns * cb * per_block};
        return true;
      }
  }
  return false;
}

bool valid_shape(int storage, int metric, int n_rows, int n_bins,
                 int n_queries) {
  return storage >= 0 && storage <= 1 && metric >= 0 && metric <= 1 &&
         !(storage == 1 && metric == 1) && n_rows >= 1 && n_bins >= 1 &&
         n_queries >= 1 && (long long)n_rows * n_bins < LLONG_MAX / 4;
}

// The instance's dynamic shared-memory limit raised to `smem` (on the
// current device, once), returning the error.
cudaError_t allow_smem(int dev, int which, int smem) {
  if (smem <= 48 * 1024 || g_smem_set[dev][which] >= smem)
    return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      instance(which), cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess) g_smem_set[dev][which] = smem;
  return err;
}

// Launches kernel 1 (after the instance's shared-memory limit is raised to
// `smem`), returning its error.
cudaError_t launch_main(int which, int ctas, int groups, int threads,
                        int smem, cudaStream_t s, void** args) {
  int dev = 0;
  cudaError_t err = nsc::current_device(&dev);
  if (err != cudaSuccess) return err;
  err = allow_smem(dev, which, smem);
  if (err != cudaSuccess) return err;
  err = cudaLaunchKernel(instance(which), dim3(ctas, groups, 1),
                         dim3(threads, 1, 1), args, (size_t)smem, s);
  const cudaError_t last = cudaGetLastError();
  return err != cudaSuccess ? err : last;
}

// The candidate lists a query of a call has, one a warp that holds it
// (for a group: a warp of each of the CTA's row tiles), and the threads a
// CTA (p: the group's plan); lists 0 for a group that does not fit.
long long lists_of(int mode, int n_bins, int n_queries, int k, int ctas,
                   int group, int smem, Plan* p, int* threads) {
  *threads = kThreads;
  if (n_queries == 1) return (long long)ctas * kWarps;
  if (!group_plan(mode, n_bins, k, group, smem, p)) return 0;
  *threads = 32 * p->warps;
  return (long long)ctas * (p->warps / query_tiles(group)) *
         (k > kRegK ? 1 : kSlotLanes);
}

using EncodeTiled = CUresult (*)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

// The rows as a 2-D tensor map for the group kernel's stages: n_bins
// elements x n_rows, boxes of kBlock units x box_rows rows, zeros outside
// (cuTensorMapEncodeTiled, its entry point found through the runtime).
cudaError_t rows_map(CUtensorMap* map, const void* rows, int mode,
                     int n_rows, int n_bins, int box_rows) {
  static EncodeTiled encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &fn, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess) return err;
    if (found != cudaDriverEntryPointSuccess || fn == nullptr)
      return cudaErrorInvalidValue;
    encode = reinterpret_cast<EncodeTiled>(fn);
  }
  const cuuint64_t dims[2] = {(cuuint64_t)n_bins, (cuuint64_t)n_rows};
  const cuuint64_t strides[1] = {(cuuint64_t)n_bins * (mode == 1 ? 2 : 4)};
  const cuuint32_t box[2] = {(cuuint32_t)(kBlock * unit_elems(mode)),
                             (cuuint32_t)box_rows};
  const cuuint32_t steps[2] = {1, 1};
  const CUresult r = encode(
      map,
      mode == 1 ? CU_TENSOR_MAP_DATA_TYPE_UINT16
                : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
      2, const_cast<void*>(rows), dims, strides, box, steps,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace

// The launch layout of a call: out[0] CTAs a query group (at most the CTAs
// that fit the card at once, and no more than the rows need), out[1] the
// queries a CTA holds (1 for one query; else up to 32, as many as fit its
// shared memory beside one column block a stage), out[2] its dynamic
// shared memory in bytes, out[3] the candidate lists a query has (the
// scratch of the fused route holds Q x out[3] x k keys). storage: 0
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
  const bool wide = n_queries > 1;
  long long group = 1, smem = query_bytes(mode, n_bins, k);
  long long step = (long long)kRowsOne * kWarps, threads = kThreads;
  Plan plan{};
  if (wide) {
    group = n_queries < kGroup ? n_queries : kGroup;
    while (group > 1 && !group_plan(mode, n_bins, k, (int)group, optin, &plan))
      --group;
    if (!group_plan(mode, n_bins, k, (int)group, optin, &plan))
      return (int)cudaErrorInvalidValue;
    smem = plan.smem;
    step = plan.rows;
    threads = 32 * plan.warps;
  } else if (smem > optin) {
    return (int)cudaErrorInvalidValue;
  }
  const int which = which_of(mode, wide, k);
  err = allow_smem(dev, which, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, instance(which), (int)threads, (size_t)smem);
  if (err != cudaSuccess) return (int)err;
  const long long need = ((long long)n_rows + step - 1) / step;
  const long long fit = (long long)sms * (per_sm > 0 ? per_sm : 1);
  const long long ctas = need < fit ? need : fit;
  out[0] = (int)ctas;
  out[1] = (int)group;
  out[2] = (int)smem;
  out[3] = (int)(wide ? ctas * (plan.warps / query_tiles((int)group)) *
                            (k > kRegK ? 1 : kSlotLanes)
                      : ctas * kWarps);
  return (int)cudaSuccess;
}

// The fused route, k <= kMaxK: kernel 1 on a (ctas, ceil(Q / group)) grid,
// then kernel 2 on Q CTAs. rows (N, n_bins) float32 or uint16, pos (N, 3)
// float32, the effective size at size_ptr (a device int64) or, when it is
// null, size_val; qcdf (Q, n_bins) and filters (Q, 4) float32; cand scratch
// of Q x lists x k int64 (lists: nsc_query_layout's out[3]); idx (Q, k)
// int64 and dist (Q, k) float32 out. ctas, group and smem as
// nsc_query_layout gave them. Returns the first error
// (cudaErrorInvalidValue, nothing launched, for sizes out of range).
extern "C" int nsc_query_topk(const void* rows, int storage, int metric,
                              const void* pos, const void* size_ptr,
                              long long size_val, const void* qcdf,
                              const void* filters, int n_rows, int n_bins,
                              int n_queries, int k, float scale, int ctas,
                              int group, int smem, void* cand, void* idx,
                              void* dist, void* stream) {
  if (!valid_shape(storage, metric, n_rows, n_bins, n_queries) || k < 1 ||
      k > kMaxK || k > n_rows || ctas < 1 || group < 1 || group > kGroup ||
      (n_queries == 1 && group != 1))
    return (int)cudaErrorInvalidValue;
  const int mode = mode_of(storage, metric);
  const bool wide = n_queries > 1;
  Plan plan{};
  int threads = 0;
  const long long lists = lists_of(mode, n_bins, n_queries, k, ctas, group,
                                   smem, &plan, &threads);
  if (lists < 1 || lists * k > INT_MAX ||
      (!wide && smem < group * query_bytes(mode, n_bins, k)))
    return (int)cudaErrorInvalidValue;
  const int which = which_of(mode, wide, k);
  int vec = n_bins % unit_elems(mode) == 0 &&
            reinterpret_cast<uintptr_t>(rows) % 16 == 0;
  const auto s = static_cast<cudaStream_t>(stream);
  const long long* sp = static_cast<const long long*>(size_ptr);
  const float* pp = static_cast<const float*>(pos);
  const float* qp = static_cast<const float*>(qcdf);
  const float* fp = static_cast<const float*>(filters);
  auto cp = static_cast<unsigned long long*>(cand);
  float* no_dist = nullptr;
  CUtensorMap map{};
  if (wide && vec) {
    const cudaError_t err =
        rows_map(&map, rows, mode, n_rows, n_bins, plan.rows);
    if (err != cudaSuccess) return (int)err;
  }
  void* one[] = {(void*)&rows, (void*)&pp,     (void*)&sp,
                 (void*)&size_val, (void*)&qp, (void*)&fp,
                 (void*)&n_rows, (void*)&n_bins, (void*)&n_queries,
                 (void*)&group, (void*)&k, (void*)&scale, (void*)&vec,
                 (void*)&cp, (void*)&no_dist};
  void* many[] = {(void*)&rows, (void*)&pp,     (void*)&sp,
                  (void*)&size_val, (void*)&qp, (void*)&fp,
                  (void*)&n_rows, (void*)&n_bins, (void*)&n_queries,
                  (void*)&group, (void*)&k, (void*)&scale, (void*)&vec,
                  (void*)&plan.cb, (void*)&plan.ns, (void*)&cp,
                  (void*)&no_dist, (void*)&map};
  const int groups = (n_queries + group - 1) / group;
  cudaError_t err = launch_main(which, ctas, groups, threads, smem, s,
                                wide ? many : one);
  if (err != cudaSuccess) return (int)err;
  query_merge_kernel<<<n_queries, kMergeThreads, 0, s>>>(
      cp, (int)lists, k, static_cast<long long*>(idx),
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
  const bool wide = n_queries > 1;
  Plan plan{};
  int threads = 0;
  if (lists_of(mode, n_bins, n_queries, 0, ctas, group, smem, &plan,
               &threads) < 1 ||
      (!wide && smem < group * query_bytes(mode, n_bins, 0)))
    return (int)cudaErrorInvalidValue;
  const int which = which_of(mode, wide, 0);
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
  CUtensorMap map{};
  if (wide && vec) {
    const cudaError_t err =
        rows_map(&map, rows, mode, n_rows, n_bins, plan.rows);
    if (err != cudaSuccess) return (int)err;
  }
  void* one[] = {(void*)&rows, (void*)&pp,     (void*)&sp,
                 (void*)&size_val, (void*)&qp, (void*)&fp,
                 (void*)&n_rows, (void*)&n_bins, (void*)&n_queries,
                 (void*)&group, (void*)&k, (void*)&scale, (void*)&vec,
                 (void*)&no_cand, (void*)&dp};
  void* many[] = {(void*)&rows, (void*)&pp,     (void*)&sp,
                  (void*)&size_val, (void*)&qp, (void*)&fp,
                  (void*)&n_rows, (void*)&n_bins, (void*)&n_queries,
                  (void*)&group, (void*)&k, (void*)&scale, (void*)&vec,
                  (void*)&plan.cb, (void*)&plan.ns, (void*)&no_cand,
                  (void*)&dp, (void*)&map};
  const int groups = (n_queries + group - 1) / group;
  return (int)launch_main(which, ctas, groups, threads, smem, s,
                          wide ? many : one);
}
