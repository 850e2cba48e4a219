// Kernel M: one chunk of the triplet miner's "hard" strategy.
//
// Not a Pallas kernel: the hand-written form of the XLA work inside the JAX
// package's mining program, neural_spectral_codec_tpu/training/miner.py
// _mine_chunk (:54-98): the all-pairs masks of a chunk of anchors against
// every frame of the sequence and the tiled W1 running argmin over the
// anchors' negatives. For anchors a = start .. start + count - 1 of a
// sequence of n frames (positions (n, 3), CDFs (n, B) float32):
//     d[a, j]   = sqrt((dx*dx + dy*dy) + dz*dz), (dx, dy, dz) = p[a] - p[j],
//                 each product and sum rounded on its own (no FMA)
//     gap[a, j] = |a - j|, compared with the thresholds in float32
//     pos[a, j] = d < pos_max & gap >= pos_gap & gap > 0
//     neg[a, j] = d >= neg_min & d <= neg_max & gap >= neg_gap & gap > 0
//     count_pos[a], count_neg[a] = the number of positives, negatives
//     W1[a, j]  = sum over b = 0 .. B-1, in that order, of
//                 |cdf[a, b] - cdf[j, b]| (one rounded subtract, one
//                 rounded add a bin)
//     neg_idx[a] = the negative j of least W1, the lower j on a tie
//                  (JAX's fori_loop keeps the first tile's with tmin < best,
//                  argmin the first column), 0 when a has no negative
//     valid[a]  = count_pos[a] > 0 & count_neg[a] > 0
// and, second entry (nsc_mine_draw), the positive: with one u in [0, 1) an
// anchor, r = min(floor(u * count_pos), count_pos - 1) and pos_idx[a] = the
// r-th positive of a in index order (0 when a has none), a uniform draw
// over the positive mask, the support of JAX's jax.random.categorical.
// The (count, n) masks and distances never reach device memory. start is
// read from device memory, so one captured graph serves every chunk. The
// plain version is training/mine_kernel.py mine_plain; it sums W1 in the
// same order, so the two agree bit for bit.
//
// What bounds it on the H100: operations. W1 is 2 operations a bin (a
// subtract, and an add of the absolute value, which cannot fuse into an
// FMA), so a 2,048-anchor chunk against 100,000 frames of 800 bins is
// 3.28e11 operations, 9.8 ms at 33.5 T non-FMA operations a second (the
// masks add ~12 operations a pair, 0.8%); the bytes (the CDFs, 320 MB) take
// 0.1 ms. A 100,000-frame sequence is 49 chunks: 0.48 s.
//
// Design, simple first: a CTA of 256 threads (16 x 16) owns kBA = 64
// anchors and walks its split of the frames in tiles of kBJ = 64 rows; each
// thread holds 4 anchors x 4 rows of W1 sums in registers and reads both
// from shared memory, where the CTA stages kK = 32 bins of the anchors' and
// the tile's CDFs at a time (bin-major, so a thread's 4 anchors or 4 rows
// are one float4). Bins past B count as 0 in both (adding +0 to a sum of
// absolute values leaves its bits). After a tile's last bin the thread
// forms its 16 pairs' masks and keeps, per anchor, the counts and the
// (W1, j) of its least negative, its rows visited in increasing j (a
// strict < keeps the first). The frames are cut into `splits` contiguous
// parts (grid.x), so that enough CTAs fill the card; the 16 threads of an
// anchor merge by (W1, j) (lower j on equal W1) in shared memory, each
// split writes one partial (W1, j, counts) an anchor, and the last CTA of
// the anchor tile to finish (a ticket, after a fence) merges the splits the
// same way: the answer does not depend on the split. The draw: one warp an
// anchor, 32 frames a step, a ballot of the positive mask and its
// population count until the r-th positive is reached. Later work: keep
// the anchors' CDFs resident, double-buffer the tiles (cp.async or TMA).
#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBA = 64;                 // anchors a CTA
constexpr int kBJ = 64;                 // frames a tile
constexpr int kK = 32;                  // bins staged at a time
constexpr int kPer = 4;                 // anchors (and frames) a thread
constexpr int kPad = 4;                 // shared row padding (floats)
constexpr int kLanes = kBA / kPer;      // 16 threads across the anchors
constexpr int kNone = INT_MAX;          // no negative yet
constexpr int kDrawWarps = kThreads / 32;

struct Params {
  float pos_max, pos_gap, neg_min, neg_max, neg_gap;
};

struct Partial {
  float w;
  int j;
  int count_pos;
  int count_neg;
};

// (w, j) before (bw, bj): the lesser W1, the lower index on a tie.
__device__ __forceinline__ bool before(float w, int j, float bw, int bj) {
  return w < bw || (w == bw && j < bj);
}

// The masks of anchor a (position pa) and frame j (position pj).
__device__ __forceinline__ void masks(float3 pa, float3 pj, int a, int j,
                                      const Params& p, bool* pos, bool* neg) {
  const float dx = __fsub_rn(pa.x, pj.x);
  const float dy = __fsub_rn(pa.y, pj.y);
  const float dz = __fsub_rn(pa.z, pj.z);
  const float d = __fsqrt_rn(__fadd_rn(
      __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz)));
  const int gap = a > j ? a - j : j - a;
  const float fg = (float)gap;
  *pos = d < p.pos_max && fg >= p.pos_gap && gap > 0;
  *neg = d >= p.neg_min && d <= p.neg_max && fg >= p.neg_gap && gap > 0;
}

__device__ __forceinline__ float3 position(const float* pts, int i) {
  return make_float3(pts[3 * i], pts[3 * i + 1], pts[3 * i + 2]);
}

__global__ void __launch_bounds__(kThreads)
mine_hard_kernel(const float* __restrict__ pts, const float* __restrict__ cdf,
                 const int* __restrict__ start_at, int n, int count, int bins,
                 Params prm, int splits, Partial* __restrict__ partial,
                 int* __restrict__ tickets, int* __restrict__ neg_idx,
                 int* __restrict__ count_pos, int* __restrict__ count_neg,
                 uint8_t* __restrict__ valid) {
  __shared__ __align__(16) float as[kK][kBA + kPad];
  __shared__ __align__(16) float cs[kK][kBJ + kPad];
  __shared__ Partial merge[kLanes][kBA];
  __shared__ int last;

  const int start = *start_at;
  const int tile = blockIdx.y;
  const int split = blockIdx.x;
  const int tx = threadIdx.x % kLanes;          // anchors tx*4 .. tx*4+3
  const int ty = threadIdx.x / kLanes;          // rows ty*4 .. ty*4+3
  const int a0 = tile * kBA;                    // first anchor (chunk index)

  float3 pa[kPer];
  int ag[kPer];
  float best_w[kPer];
  int best_j[kPer], cpos[kPer], cneg[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int a = a0 + tx * kPer + i;
    ag[i] = start + (a < count ? a : 0);
    pa[i] = position(pts, ag[i]);
    best_w[i] = __int_as_float(0x7f800000);     // +inf
    best_j[i] = kNone;
    cpos[i] = cneg[i] = 0;
  }

  const int n_tiles = (n + kBJ - 1) / kBJ;
  const int t_begin = (int)((long long)n_tiles * split / splits);
  const int t_end = (int)((long long)n_tiles * (split + 1) / splits);
  for (int t = t_begin; t < t_end; ++t) {
    const int j0 = t * kBJ;
    float acc[kPer][kPer];
#pragma unroll
    for (int i = 0; i < kPer; ++i)
#pragma unroll
      for (int j = 0; j < kPer; ++j) acc[i][j] = 0.0f;
    for (int b0 = 0; b0 < bins; b0 += kK) {
      __syncthreads();
      for (int e = threadIdx.x; e < kBA * kK; e += kThreads) {
        const int r = e / kK, b = e % kK;
        const int a = a0 + r, j = j0 + r;
        const bool in_bins = b0 + b < bins;
        as[b][r] = in_bins && a < count
                       ? cdf[(long long)(start + a) * bins + b0 + b] : 0.0f;
        cs[b][r] = in_bins && j < n
                       ? cdf[(long long)j * bins + b0 + b] : 0.0f;
      }
      __syncthreads();
#pragma unroll 8
      for (int b = 0; b < kK; ++b) {
        const float4 av = *reinterpret_cast<const float4*>(&as[b][tx * kPer]);
        const float4 cv = *reinterpret_cast<const float4*>(&cs[b][ty * kPer]);
        const float x[kPer] = {av.x, av.y, av.z, av.w};
        const float y[kPer] = {cv.x, cv.y, cv.z, cv.w};
#pragma unroll
        for (int i = 0; i < kPer; ++i)
#pragma unroll
          for (int j = 0; j < kPer; ++j)
            acc[i][j] = __fadd_rn(acc[i][j], fabsf(__fsub_rn(x[i], y[j])));
      }
    }
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int jg = j0 + ty * kPer + j;
      if (jg >= n) break;
      const float3 pj = position(pts, jg);
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        bool pos, neg;
        masks(pa[i], pj, ag[i], jg, prm, &pos, &neg);
        cpos[i] += pos;
        cneg[i] += neg;
        if (neg && acc[i][j] < best_w[i]) {
          best_w[i] = acc[i][j];
          best_j[i] = jg;
        }
      }
    }
  }

  // the 16 row-threads of each anchor, then this split's partial
#pragma unroll
  for (int i = 0; i < kPer; ++i)
    merge[ty][tx * kPer + i] = {best_w[i], best_j[i], cpos[i], cneg[i]};
  __syncthreads();
  if (threadIdx.x < kBA && a0 + (int)threadIdx.x < count) {
    Partial m = merge[0][threadIdx.x];
    for (int r = 1; r < kLanes; ++r) {
      const Partial q = merge[r][threadIdx.x];
      if (before(q.w, q.j, m.w, m.j)) { m.w = q.w; m.j = q.j; }
      m.count_pos += q.count_pos;
      m.count_neg += q.count_neg;
    }
    partial[(long long)split * count + a0 + threadIdx.x] = m;
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(&tickets[tile], 1) == splits - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  const int a = a0 + threadIdx.x;
  if (threadIdx.x < kBA && a < count) {
    float w = __int_as_float(0x7f800000);
    int j = kNone, np = 0, nn = 0;
    for (int s = 0; s < splits; ++s) {
      const Partial* q = partial + (long long)s * count + a;
      const float qw = __ldcg(&q->w);
      const int qj = __ldcg(&q->j);
      if (before(qw, qj, w, j)) { w = qw; j = qj; }
      np += __ldcg(&q->count_pos);
      nn += __ldcg(&q->count_neg);
    }
    neg_idx[a] = j == kNone ? 0 : j;
    count_pos[a] = np;
    count_neg[a] = nn;
    valid[a] = np > 0 && nn > 0;
  }
  if (threadIdx.x == 0) tickets[tile] = 0;
}

__global__ void __launch_bounds__(kThreads)
mine_draw_kernel(const float* __restrict__ pts,
                 const int* __restrict__ start_at, int n, int count,
                 Params prm, const float* __restrict__ u,
                 const int* __restrict__ count_pos,
                 int* __restrict__ pos_idx) {
  const int a = blockIdx.x * kDrawWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (a >= count) return;
  const int ag = *start_at + a;
  const int cnt = count_pos[a];
  if (cnt == 0) {
    if (lane == 0) pos_idx[a] = 0;
    return;
  }
  const int r = min((int)floorf(__fmul_rn(u[a], (float)cnt)), cnt - 1);
  const float3 pa = position(pts, ag);
  int seen = 0;
  for (int j0 = 0; j0 < n; j0 += 32) {
    const int j = j0 + lane;
    bool pos = false, neg;
    if (j < n) masks(pa, position(pts, j), ag, j, prm, &pos, &neg);
    const unsigned m = __ballot_sync(0xffffffffu, pos);
    const int c = __popc(m);
    if (seen + c > r) {
      if (pos && __popc(m & ((1u << lane) - 1u)) == r - seen) pos_idx[a] = j;
      return;
    }
    seen += c;
  }
  if (lane == 0) pos_idx[a] = 0;   // unreachable while cnt is the count
}

}  // namespace

// One chunk's counts and hard negatives. pts (n, 3) and cdf (n, bins)
// float32, start (1,) int32 on the device (start + count <= n); partial
// (splits * count) 16-byte entries and tickets (ceil(count / 64),) int32 at
// 0 (left at 0) as scratch; neg_idx, count_pos, count_neg (count,) int32 and
// valid (count,) uint8 out. Returns cudaGetLastError() after the launch
// (cudaErrorInvalidValue, nothing launched, for sizes out of range).
extern "C" int nsc_mine_hard(const void* pts, const void* cdf,
                             const void* start, int n, int count, int bins,
                             float pos_max, float pos_gap, float neg_min,
                             float neg_max, float neg_gap, int splits,
                             void* partial, void* tickets, void* neg_idx,
                             void* count_pos, void* count_neg, void* valid,
                             void* stream) {
  if (n < 1 || count < 1 || count > n || bins < 1 || splits < 1)
    return (int)cudaErrorInvalidValue;
  const Params prm = {pos_max, pos_gap, neg_min, neg_max, neg_gap};
  const dim3 grid(splits, (count + kBA - 1) / kBA);
  mine_hard_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(pts), static_cast<const float*>(cdf),
      static_cast<const int*>(start), n, count, bins, prm, splits,
      static_cast<Partial*>(partial), static_cast<int*>(tickets),
      static_cast<int*>(neg_idx), static_cast<int*>(count_pos),
      static_cast<int*>(count_neg), static_cast<uint8_t*>(valid));
  return (int)cudaGetLastError();
}

// One chunk's positives: u (count,) float32 in [0, 1) and count_pos
// (count,) int32 (nsc_mine_hard's) in, pos_idx (count,) int32 out.
extern "C" int nsc_mine_draw(const void* pts, const void* start, int n,
                             int count, float pos_max, float pos_gap,
                             float neg_min, float neg_max, float neg_gap,
                             const void* u, const void* count_pos,
                             void* pos_idx, void* stream) {
  if (n < 1 || count < 1 || count > n) return (int)cudaErrorInvalidValue;
  const Params prm = {pos_max, pos_gap, neg_min, neg_max, neg_gap};
  mine_draw_kernel<<<(count + kDrawWarps - 1) / kDrawWarps, kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(pts), static_cast<const int*>(start), n,
      count, prm, static_cast<const float*>(u),
      static_cast<const int*>(count_pos), static_cast<int*>(pos_idx));
  return (int)cudaGetLastError();
}

// The two kernels (0 the counts and hard negatives, 1 the draw), for the
// census of captured graphs (nsc_graph_census in project.cu).
extern "C" const void* nsc_mine_kernel_handle(int which) {
  return which == 0 ? reinterpret_cast<const void*>(mine_hard_kernel)
                    : reinterpret_cast<const void*>(mine_draw_kernel);
}
