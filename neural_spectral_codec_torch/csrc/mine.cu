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
// 0.1 ms. A 100,000-frame sequence is 49 chunks: 0.48 s. At that bound the
// FP32 pipes issue every cycle, so every other instruction takes a slot
// from them: the design keeps the others few.
//
// Design. A CTA of 256 threads (16 x 16) owns kBA = 128 anchors and walks
// its split of the frames in tiles of kBJ = 128 rows; each thread holds
// 8 anchors x 8 frames of W1 sums in registers (anchors tx + 16 i, frames
// ty + 16 j). The CTA's CDF rows (its anchors' and the tile's) come in
// slabs of kK = 32 bins through a ring of kStages = 2 shared-memory stages
// filled by cp.async (16-byte copies of 4 bins; 4-byte copies when the rows
// are not 16-byte aligned), one slab ahead, one barrier a slab; the copies
// run on across tile boundaries, so the masks after a tile's last slab
// overlap the next tile's loads. Rows stay row-major (bins contiguous,
// padded to kRow = 36 floats): a thread reads 4 bins of one anchor or
// frame as a float4, 8 + 8 such reads for 256 W1 additions; the 8 anchors
// a quarter-warp reads are 8 consecutive rows, 144 bytes apart, which fall
// in 8 distinct 16-byte bank groups, and its frame read is one row (a
// broadcast). Bins past B, anchors past count and frames past n are
// zero-filled by the copies (adding +0 to a sum of absolute values leaves
// its bits) and never reported. The anchors' CDFs are staged again for
// every tile, through the same ring: 128 anchors x 800 bins (400 KB) do not
// fit beside the ring, and 64 resident anchors (200 KB) would leave one CTA
// an SM with 64 x 256 tiles, which reads as many bytes a pair from L2 as
// 128 x 128 tiles that restage both (1/64 of a row a pair a bin) and would
// wait on every barrier with the whole SM. A thread's per-anchor state
// (least W1 and its j, the two counts) lives in shared memory and is
// touched only after each tile: the registers hold the 64 sums and the
// operands (kCtasPerSm = 2 CTAs an SM, at most 128 registers a thread; 32
// bins and 2 stages, against 16 and 3, halve the barriers and spill
// nothing: 14.2 against 15.4 ms a 2,048 x 100,000 x 800 chunk on an H100).
// After a tile's last slab the thread forms its 64 pairs' masks and keeps,
// per anchor, the counts and the (W1, j) of its least negative, its frames
// visited in increasing j (a strict < keeps the first). The frames are cut
// into `splits` contiguous parts (grid.x; training/mine_kernel.py
// row_splits: as many as fill kCtasPerSm CTAs an SM in one wave); the 16
// threads of an anchor merge by (W1, j) (lower j on equal W1) in shared
// memory, each split writes one partial (W1, j, counts) an anchor, and the
// last CTA of the anchor tile to finish (a ticket, after a fence) merges the
// splits the same way: the answer does not depend on the split.
//
// The draw: one CTA of kDrawWarps warps an anchor. Every warp reads the
// anchor's per-split counts of the drawn mask (the partials the entry
// before it wrote), 32 at a time with a warp prefix sum, and finds the
// split that holds the r-th member and the rank rr within it. The CTA then
// tests the box of each of that split's 128-frame tiles (one a thread;
// the sequence's tile boxes, training/mine_kernel.py tile_boxes, made once
// a sequence) against the anchor, with the counts entry's box bounds
// (box_sums), and lists in index order the tiles that can hold a member of the drawn
// mask. It walks that list in rounds: in each, warp w counts the members
// of the round's w-th listed tile (4 frames a lane, loaded together; no
// load waits on another), the CTA forms one prefix over the warps' counts
// in shared memory, and the round in which the running count passes rr is
// the last: the warp that holds the member finds it by ballots and
// population counts. The gate changes which tiles are read, never the
// answer: a skipped tile holds no member. At 2,048 x 100,000, by the
// design's model (training/mine_kernel.py draw_rounds), it keeps 1.2 of
// the ~25 tiles before a positive and 3.7 before a negative, so 1.4 and
// 2.6 rounds an anchor (at most 3 and 6) where a warp took ~25 (at most
// 49) dependent steps; the CTA's first loads (the counts, the first
// 32 splits' counts, the anchor's position) go out together. 2 warps a
// CTA beat 1, 4 and 8 on an H100 (experiments/kernel_ab.py, in turns): a
// CTA has little to do, and small CTAs put every anchor of a chunk on the
// card at once. The mask is the counts entry's (Bounds: the rounded sum
// of squares and the integer gap against mask_bounds' exact bounds), with
// no square root and no int-to-float.
//
// Three more entries serve the miner's other strategies (JAX's
// _mine_chunk with "semi-hard" and "random", :99-111):
//   nsc_mine_rows   (semi-hard) the first entry's walk with the least-W1
//                   search replaced by a write of the (count, n) W1 block,
//                   W1[a, j] where j is a negative of a and +inf elsewhere,
//                   with the counts, valid and the same per-split partial
//                   counts. Its sums are the first entry's, bit for bit. The
//                   stores are 16 rows x 8 bytes a warp; the L2 joins them
//                   into whole sectors (the block is 0.82 GB at 2,048 x
//                   100,000, 0.25 ms of writes beside ~14 ms of sums).
//   nsc_mine_counts (random) the masks alone: counts, valid and partials,
//                   no CDF read; 128 anchors x 128-frame tiles a CTA of 256
//                   threads as above, each tile's positions staged in shared
//                   memory, the splits merged by the last CTA the same way.
//                   No square root and no int-to-float: the thresholds come
//                   as exact bounds on the rounded sum of squares and on
//                   the integer gap (Bounds), and a tile whose box, against
//                   the anchors' box, bounds every pair's sum of squares
//                   away from both masks is skipped (skip_block). Bound: 12
//                   operations a pair, 2,048 x 100,000 in 0.073 ms at 33.5 T
//                   a second; over the pairs of the tiles the gate keeps
//                   (training/mine_kernel.py gate_pairs), less.
//   nsc_mine_draw_mask  the draw over either mask (which = 0 positives, 1
//                   negatives): r = min(floor(u * count), count - 1) of that
//                   mask's count, the r-th member in index order, 0 when
//                   the count is 0; the rounds of the draw above on the
//                   partials of whichever entry ran before it. With which
//                   = 0 it gives nsc_mine_draw's answer. Bound: 12
//                   operations a frame of the kept tiles up to the member
//                   and 18 a box test, or the bytes of the distinct frames
//                   and boxes read (chip_smoke.py _draw_bounds), a few
//                   tenths of a us at 2,048 x 100,000; what holds a draw is
//                   the latency of its dependent loads (counts, boxes, a
//                   round's positions), which the gate and the rounds make
//                   few.
// The semi-hard negative itself is kernel S (select.cu) on the W1 block at
// rank count_neg / 2.
#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBA = 128;                // anchors a CTA
constexpr int kBJ = 128;                // frames a tile
constexpr int kPer = 8;                 // anchors (and frames) a thread
constexpr int kLanes = 16;              // threads across anchors, frames
constexpr int kK = 32;                  // bins a stage
constexpr int kStages = 2;              // stages in the ring
constexpr int kRow = 36;                // floats a staged row (kK + 4 padding)
constexpr int kCtasPerSm = 2;
constexpr int kNone = INT_MAX;          // no negative yet
constexpr int kDrawWarps = 2;           // warps of a draw CTA (one anchor)
constexpr int kDrawUnroll = 4;          // frames a lane a draw round
constexpr int kDrawTile = 32 * kDrawUnroll;   // frames a warp a round
constexpr int kDrawGate = 32 * kDrawWarps;    // tiles a gate pass
static_assert(kDrawTile == 128, "a draw warp's frames are one frame tile");
constexpr int kStageFloats = (kBA + kBJ) * kRow;

static_assert(kLanes * kPer == kBA && kLanes * kPer == kBJ, "tile shape");
static_assert(kLanes * kLanes == kThreads, "16 x 16 threads");
static_assert(kRow >= kK && kRow % 4 == 0 && kK % 4 == 0, "row layout");
// a thread's 16-byte copies: 4 bins of rows tid / kQuads + h * kCopyRows
// (h < kCopies) of the anchors and of the tile
constexpr int kQuads = kK / 4;
constexpr int kCopyRows = kThreads / kQuads;
constexpr int kCopies = kBA / kCopyRows;
static_assert(kCopies * kCopyRows == kBA && kBA == kBJ, "copy layout");

struct Params {
  float pos_max, pos_gap, neg_min, neg_max, neg_gap;
};

struct Partial {
  float w;
  int j;
  int count_pos;
  int count_neg;
};

// the ring, the threads' per-anchor state, the anchors' positions, the
// frame positions of kStages tiles
constexpr size_t kSmemBytes = sizeof(float) * kStages * kStageFloats +
                              sizeof(Partial) * kPer * kThreads +
                              sizeof(float4) * kBA +
                              sizeof(float) * kStages * 3 * kBJ;

// (w, j) before (bw, bj): the lesser W1, the lower index on a tie.
__device__ __forceinline__ bool before(float w, int j, float bw, int bj) {
  return w < bw || (w == bw && j < bj);
}

// The masks of anchor a (position pa) and frame j (position pj), as the
// W1 walk tests them; the counts entry and the draws test the same masks
// on Bounds (below), with no square root.
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

// The first frame tile of split s of `splits` over n_tiles tiles: split s
// takes the tiles split_tile(s) .. split_tile(s + 1) - 1
// (training/mine_kernel.py split_frames).
__device__ __forceinline__ int split_tile(int n_tiles, int s, int splits) {
  return (int)((long long)n_tiles * s / splits);
}

// cp.async of kBytes (16 or 4) into shared memory; 0 source bytes fill
// the destination with zeros (src is then not read).
template <int kBytes>
__device__ __forceinline__ void copy_async(float* dst, const float* src,
                                           bool full) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  if (kBytes == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(d), "l"(src), "r"(full ? 16 : 0) : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                 :: "r"(d), "l"(src), "r"(full ? 4 : 0) : "memory");
  }
}

__device__ __forceinline__ void commit_copies() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// every copy group but the newest kStages - 2 has landed (this thread's)
__device__ __forceinline__ void wait_copies() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(kStages - 2) : "memory");
}

// The 16 frame-threads of each of the CTA's anchors merged (state: their
// per-anchor Partials, kPer x kThreads), this split's partial written, and
// the last CTA of the anchor tile to finish (a ticket, after a fence)
// merging the splits in split order: the counts, valid and, with kHard,
// the least-W1 negative.
template <bool kHard>
__device__ __forceinline__ void merge_splits(
    const Partial* state, int tid, int a0, int count, int split, int splits,
    int tile, Partial* __restrict__ partial, int* __restrict__ tickets,
    int* __restrict__ neg_idx, int* __restrict__ count_pos,
    int* __restrict__ count_neg, uint8_t* __restrict__ valid) {
  __shared__ int last;
  __syncthreads();
  if (tid < kBA && a0 + tid < count) {
    const int i = tid / kLanes, x = tid % kLanes;
    Partial m = state[i * kThreads + x];
    for (int y = 1; y < kLanes; ++y) {
      const Partial q = state[i * kThreads + y * kLanes + x];
      if (before(q.w, q.j, m.w, m.j)) { m.w = q.w; m.j = q.j; }
      m.count_pos += q.count_pos;
      m.count_neg += q.count_neg;
    }
    partial[(long long)split * count + a0 + tid] = m;
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) last = atomicAdd(&tickets[tile], 1) == splits - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  const int a = a0 + tid;
  if (tid < kBA && a < count) {
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
    if (kHard) neg_idx[a] = j == kNone ? 0 : j;
    count_pos[a] = np;
    count_neg[a] = nn;
    valid[a] = np > 0 && nn > 0;
  }
  if (tid == 0) tickets[tile] = 0;
}

// The W1 walk of one (split, anchor tile) CTA: with kRows false the first
// entry (least-W1 negatives), with kRows true the W1-row entry (w1, the
// (count, n) block, written instead).
template <bool kRows>
__device__ __forceinline__ void w1_walk(
    const float* __restrict__ pts, const float* __restrict__ cdf,
    const int* __restrict__ start_at, int n, int count, int bins,
    const Params& prm, int splits, int vec, Partial* __restrict__ partial,
    int* __restrict__ tickets, int* __restrict__ neg_idx,
    int* __restrict__ count_pos, int* __restrict__ count_neg,
    uint8_t* __restrict__ valid, float* __restrict__ w1) {
  extern __shared__ __align__(16) float smem[];
  float* ring = smem;
  Partial* state = reinterpret_cast<Partial*>(ring + kStages * kStageFloats);
  float4* apos = reinterpret_cast<float4*>(state + kPer * kThreads);
  float* fpos = reinterpret_cast<float*>(apos + kBA);

  const int start = *start_at;
  const int tile = blockIdx.y;
  const int split = blockIdx.x;
  const int tid = threadIdx.x;
  const int tx = tid % kLanes;          // anchors tx + 16 i
  const int ty = tid / kLanes;          // frames ty + 16 j of each tile
  const int a0 = tile * kBA;            // first anchor (chunk index)

  if (tid < kBA) {
    // an anchor past count stands in as the chunk's first (never reported)
    const int ag = start + (a0 + tid < count ? a0 + tid : 0);
    const float3 p = position(pts, ag);
    apos[tid] = make_float4(p.x, p.y, p.z, __int_as_float(ag));
  }
#pragma unroll
  for (int i = 0; i < kPer; ++i)
    state[i * kThreads + tid] = {__int_as_float(0x7f800000), kNone, 0, 0};

  const int n_tiles = (n + kBJ - 1) / kBJ;
  const int t_begin = split_tile(n_tiles, split, splits);
  const int t_end = split_tile(n_tiles, split + 1, splits);
  const int slabs = (bins + kK - 1) / kK;
  const int total = (t_end - t_begin) * slabs;

  // The copies: 16-byte ones take 4 bins of the rows tid / kQuads + h *
  // kCopyRows of the anchors and of the tile, so a thread's source rows
  // are fixed for the CTA (anchors) and for a tile (frames); 4-byte ones
  // take bin tid % kK of every (kThreads / kK)-th row. A tile's frame
  // positions (3 x 128 floats) come with its first slab, into one of
  // kStages buffers (tile index mod kStages: the epilogue of tile t reads
  // its buffer before tile t + kStages is staged).
  const int quad = 4 * (tid % kQuads), row4 = tid / kQuads;
  int arow[kCopies], frow[kCopies];     // source rows, -1: none (zeros)
#pragma unroll
  for (int h = 0; h < kCopies; ++h) {
    const int a = a0 + row4 + kCopyRows * h;
    arow[h] = a < count ? start + a : -1;
    frow[h] = -1;
  }
  auto src = [&](int row, int b) {
    return cdf + (long long)(row < 0 ? 0 : row) * bins + b;
  };
  int stage_t = t_begin, stage_b = 0, stage_slot = 0;
  auto stage_next = [&]() {        // the next slab of the walk, then advance
    float* slot = ring + stage_slot * kStageFloats;
    const int j0 = stage_t * kBJ, b0 = stage_b * kK;
    if (stage_b == 0) {
      float* fp = fpos + (stage_t % kStages) * (3 * kBJ);
      for (int e = tid; e < 3 * kBJ; e += kThreads) {
        const bool ok = 3LL * j0 + e < 3LL * n;
        copy_async<4>(fp + e, ok ? pts + 3LL * j0 + e : pts, ok);
      }
#pragma unroll
      for (int h = 0; h < kCopies; ++h) {
        const int j = j0 + row4 + kCopyRows * h;
        frow[h] = j < n ? j : -1;
      }
    }
    if (vec) {
      const bool in = b0 + quad < bins;
#pragma unroll
      for (int h = 0; h < kCopies; ++h) {
        const int r = row4 + kCopyRows * h;
        copy_async<16>(slot + r * kRow + quad, src(arow[h], b0 + quad),
                       in && arow[h] >= 0);
        copy_async<16>(slot + (kBA + r) * kRow + quad,
                       src(frow[h], b0 + quad), in && frow[h] >= 0);
      }
    } else {
      const int k = tid % kK;
      const bool in = b0 + k < bins;
#pragma unroll 4
      for (int r = tid / kK; r < kBA + kBJ; r += kThreads / kK) {
        const bool anchor = r < kBA;
        const int row = anchor ? start + a0 + r : j0 + r - kBA;
        const bool ok = in && (anchor ? a0 + r < count : row < n);
        copy_async<4>(slot + r * kRow + k,
                      ok ? cdf + (long long)row * bins + b0 + k : cdf, ok);
      }
    }
    if (++stage_b == slabs) { stage_b = 0; ++stage_t; }
    if (++stage_slot == kStages) stage_slot = 0;
  };
#pragma unroll
  for (int g = 0; g < kStages - 1; ++g) {
    if (g < total) stage_next();
    commit_copies();
  }

  float acc[kPer][kPer] = {};
  int cur_t = t_begin, cur_b = 0, cur_slot = 0;
  for (int g = 0; g < total; ++g) {
    wait_copies();
    __syncthreads();              // slab g is in; slab g - 1 is consumed
    if (g + kStages - 1 < total) stage_next();
    commit_copies();
    if (cur_b == 0) {
#pragma unroll
      for (int i = 0; i < kPer; ++i)
#pragma unroll
        for (int j = 0; j < kPer; ++j) acc[i][j] = 0.0f;
    }
    const float* as = ring + cur_slot * kStageFloats + tx * kRow;
    const float* fs = ring + cur_slot * kStageFloats + (kBA + ty) * kRow;
#pragma unroll 1
    for (int kb = 0; kb < kK; kb += 4) {
      float4 a[kPer];
#pragma unroll
      for (int i = 0; i < kPer; ++i)
        a[i] = *reinterpret_cast<const float4*>(as + kLanes * i * kRow + kb);
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        const float4 c = *reinterpret_cast<const float4*>(
            fs + kLanes * j * kRow + kb);
#pragma unroll
        for (int i = 0; i < kPer; ++i) {
          float s = acc[i][j];
          s = __fadd_rn(s, fabsf(__fsub_rn(a[i].x, c.x)));
          s = __fadd_rn(s, fabsf(__fsub_rn(a[i].y, c.y)));
          s = __fadd_rn(s, fabsf(__fsub_rn(a[i].z, c.z)));
          s = __fadd_rn(s, fabsf(__fsub_rn(a[i].w, c.w)));
          acc[i][j] = s;
        }
      }
    }
    if (cur_b == slabs - 1) {     // the tile's last bins: masks and minima
      const int j0 = cur_t * kBJ;
      const float* fp = fpos + (cur_t % kStages) * (3 * kBJ);
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        const float4 pa4 = apos[tx + kLanes * i];
        const float3 pa = make_float3(pa4.x, pa4.y, pa4.z);
        const int ag = __float_as_int(pa4.w);
        Partial st = state[i * kThreads + tid];
#pragma unroll
        for (int j = 0; j < kPer; ++j) {
          const int jl = ty + kLanes * j, jg = j0 + jl;
          if (jg < n) {
            bool pos, neg;
            masks(pa, make_float3(fp[3 * jl], fp[3 * jl + 1], fp[3 * jl + 2]),
                  ag, jg, prm, &pos, &neg);
            st.count_pos += pos;
            st.count_neg += neg;
            if (kRows) {
              if (a0 + tx + kLanes * i < count)
                w1[(long long)(a0 + tx + kLanes * i) * n + jg] =
                    neg ? acc[i][j] : __int_as_float(0x7f800000);
            } else if (neg && acc[i][j] < st.w) {
              st.w = acc[i][j];
              st.j = jg;
            }
          }
        }
        state[i * kThreads + tid] = st;
      }
    }
    if (++cur_b == slabs) { cur_b = 0; ++cur_t; }
    if (++cur_slot == kStages) cur_slot = 0;
  }

  merge_splits<!kRows>(state, tid, a0, count, split, splits, tile, partial,
                       tickets, neg_idx, count_pos, count_neg, valid);
}

__global__ void __launch_bounds__(kThreads, kCtasPerSm)
mine_hard_kernel(const float* __restrict__ pts, const float* __restrict__ cdf,
                 const int* __restrict__ start_at, int n, int count, int bins,
                 Params prm, int splits, int vec,
                 Partial* __restrict__ partial, int* __restrict__ tickets,
                 int* __restrict__ neg_idx, int* __restrict__ count_pos,
                 int* __restrict__ count_neg, uint8_t* __restrict__ valid) {
  w1_walk<false>(pts, cdf, start_at, n, count, bins, prm, splits, vec,
                 partial, tickets, neg_idx, count_pos, count_neg, valid,
                 nullptr);
}

__global__ void __launch_bounds__(kThreads, kCtasPerSm)
mine_rows_kernel(const float* __restrict__ pts, const float* __restrict__ cdf,
                 const int* __restrict__ start_at, int n, int count, int bins,
                 Params prm, int splits, int vec,
                 Partial* __restrict__ partial, int* __restrict__ tickets,
                 float* __restrict__ w1, int* __restrict__ count_pos,
                 int* __restrict__ count_neg, uint8_t* __restrict__ valid) {
  w1_walk<true>(pts, cdf, start_at, n, count, bins, prm, splits, vec,
                partial, tickets, nullptr, count_pos, count_neg, valid, w1);
}

// The counts entry's and the draws' thresholds (training/mine_kernel.py
// mask_bounds): for a pair's rounded sum of squares s = (dx*dx + dy*dy) +
// dz*dz (+0 to +inf, or NaN) and its gap g,
//     pos = s < pos_s && g >= pos_gap
//     neg = s >= neg_lo_s && s <= neg_hi_s && g >= neg_gap
// give masks()'s masks: sqrt_rn is correctly rounded and monotone, so
// sqrt_rn(s) < t <=> s < (the least s' with sqrt_rn(s') >= t), and so on;
// (float)g >= g_t <=> g >= (the least int32 whose float is >= g_t); both
// gap bounds are at least 1 (the test g > 0). A NaN s, or a NaN bound,
// fails every comparison, as a NaN distance or threshold does.
struct Bounds {
  float pos_s, neg_lo_s, neg_hi_s;
  int pos_gap, neg_gap;
};

__device__ __forceinline__ float sum_sq(float dx, float dy, float dz) {
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                   __fmul_rn(dz, dz));
}

// min and max that keep a NaN (of either argument)
__device__ __forceinline__ float nan_min(float a, float b) {
  return b < a || b != b ? b : a;
}
__device__ __forceinline__ float nan_max(float a, float b) {
  return b > a || b != b ? b : a;
}

// The box (min x, y, z, max x, y, z) of the positions that the first
// kBoxWarps warps' threads hold with `in` set (a NaN coordinate makes its
// min and max NaN), into box[6] for every thread; part (kBoxWarps * 6
// floats) is scratch. Every thread calls it; it ends in a barrier.
constexpr int kBoxWarps = kBA / 32;     // the threads that hold a position
static_assert(kBA == kBJ, "one box shape for anchors and frames");
__device__ __forceinline__ void box_of(float3 p, bool in, float* part,
                                       float* box) {
  const unsigned full = 0xffffffffu;
  const float inf = __int_as_float(0x7f800000);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (warp < kBoxWarps) {
    float v[6] = {in ? p.x : inf, in ? p.y : inf, in ? p.z : inf,
                  in ? p.x : -inf, in ? p.y : -inf, in ? p.z : -inf};
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        v[c] = nan_min(v[c], __shfl_xor_sync(full, v[c], o));
        v[c + 3] = nan_max(v[c + 3], __shfl_xor_sync(full, v[c + 3], o));
      }
    }
    if (lane < 6) {
      float w = v[0];
#pragma unroll
      for (int c = 1; c < 6; ++c) w = lane == c ? v[c] : w;
      part[warp * 6 + lane] = w;
    }
  }
  __syncthreads();
#pragma unroll
  for (int c = 0; c < 6; ++c) box[c] = part[c];
#pragma unroll
  for (int w = 1; w < kBoxWarps; ++w) {
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      box[c] = nan_min(box[c], part[w * 6 + c]);
      box[c + 3] = nan_max(box[c + 3], part[w * 6 + c + 3]);
    }
  }
}

// The least |d| of the rounded differences d of a value in [amin, amax]
// and one in [fmin, fmax], from dlo = amin - fmax and dhi = amax - fmin
// (rounded; rounding is monotone, so every d lies in [dlo, dhi]); NaN
// where dlo or dhi is NaN.
__device__ __forceinline__ float least_abs(float dlo, float dhi) {
  if (dlo > 0.0f) return dlo;
  if (dhi < 0.0f) return -dhi;
  return dlo == dlo && dhi == dhi ? 0.0f : __int_as_float(0x7fc00000);
}

// Bounds s_lo, s_hi on every pair's s of a point in the box [a_lo, a_hi]
// and one in box f (min x, y, z, max x, y, z), in the pair test's rounded
// operations and order (training/mine_kernel.py tile_gate); s_lo is NaN
// where a coordinate is.
__device__ __forceinline__ void box_sums(const float* a_lo,
                                         const float* a_hi, const float* f,
                                         float& s_lo, float& s_hi) {
  float lo[3], hi[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float dlo = __fsub_rn(a_lo[c], f[c + 3]);
    const float dhi = __fsub_rn(a_hi[c], f[c]);
    lo[c] = least_abs(dlo, dhi);
    hi[c] = fmaxf(fabsf(dlo), fabsf(dhi));
  }
  s_lo = sum_sq(lo[0], lo[1], lo[2]);
  s_hi = sum_sq(hi[0], hi[1], hi[2]);
}

// Whether no pair of an anchor in box a and a frame in box f can be a
// positive or a negative (box_sums). A NaN lower bound makes it false.
__device__ __forceinline__ bool skip_block(const float* a, const float* f,
                                           const Bounds& b) {
  float s_lo, s_hi;
  box_sums(a, a + 3, f, s_lo, s_hi);
  return s_lo >= b.pos_s && (s_hi < b.neg_lo_s || s_lo > b.neg_hi_s);
}

// One tile's pairs for a thread: its 8 anchors (tx + 16 i) against its 8
// frames (ty + 16 j) of the tile's positions in shared memory, counted
// into cp and cn; with kGaps the gap tests too, without them only the
// sums of squares (a tile whose every pair passes both gap tests).
template <bool kGaps>
__device__ __forceinline__ void count_tile(const float4* apos,
                                           const float* fpos, int j0, int tx,
                                           int ty, const Bounds& bnd,
                                           int (&cp)[kPer], int (&cn)[kPer]) {
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const float4 pa = apos[tx + kLanes * i];
    const int ag = __float_as_int(pa.w);
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int jl = ty + kLanes * j;
      const float s = sum_sq(__fsub_rn(pa.x, fpos[3 * jl]),
                             __fsub_rn(pa.y, fpos[3 * jl + 1]),
                             __fsub_rn(pa.z, fpos[3 * jl + 2]));
      const bool pos = s < bnd.pos_s;
      const bool neg = s >= bnd.neg_lo_s && s <= bnd.neg_hi_s;
      if (kGaps) {
        const int gap = abs(ag - (j0 + jl));
        cp[i] += pos && gap >= bnd.pos_gap;
        cn[i] += neg && gap >= bnd.neg_gap;
      } else {
        cp[i] += pos;
        cn[i] += neg;
      }
    }
  }
}

// The masks alone: a CTA of 256 threads (16 x 16) owns kBA anchors and
// walks its split's frame tiles of kBJ rows. Each tile's positions are
// loaded (one frame a thread of the first kBJ, the next tile's loads
// issued before this tile's tests) into shared memory, frames past n as
// NaN (which fail every test); the box of the tile's frames against the
// box of the CTA's anchors decides whether any pair can count
// (skip_block); if one can, a thread tests 8 anchors x 8 frames
// (anchors tx + 16 i, frames ty + 16 j) against the Bounds in registers,
// without the gap tests where the tile lies beyond both gap bounds of
// every anchor (count_tile<false>: most kept tiles, on other laps).
// The threads of an anchor and the splits merge as the first entry's do.
__global__ void __launch_bounds__(kThreads)
mine_counts_kernel(const float* __restrict__ pts,
                   const int* __restrict__ start_at, int n, int count,
                   Bounds bnd, int splits, Partial* __restrict__ partial,
                   int* __restrict__ tickets, int* __restrict__ count_pos,
                   int* __restrict__ count_neg, uint8_t* __restrict__ valid) {
  __shared__ Partial state[kPer * kThreads];
  __shared__ float4 apos[kBA];
  __shared__ float fpos[3 * kBJ];
  __shared__ float part[kBoxWarps * 6];
  const int start = *start_at;
  const int tile = blockIdx.y, split = blockIdx.x, tid = threadIdx.x;
  const int tx = tid % kLanes, ty = tid / kLanes, a0 = tile * kBA;
  const float nan = __int_as_float(0x7fc00000);
  float abox[6], fbox[6];
  {
    const bool in = tid < kBA && a0 + tid < count;
    float3 p = make_float3(0.0f, 0.0f, 0.0f);
    if (tid < kBA) {
      const int ag = start + (in ? a0 + tid : 0);
      p = position(pts, ag);
      apos[tid] = make_float4(p.x, p.y, p.z, __int_as_float(ag));
    }
    box_of(p, in, part, abox);   // its barrier also publishes apos
  }
  int cp[kPer] = {}, cn[kPer] = {};
  const int a_first = start + a0, a_last = start + min(a0 + kBA, count) - 1;
  const int n_tiles = (n + kBJ - 1) / kBJ;
  const int t_end = split_tile(n_tiles, split + 1, splits);
  int t = split_tile(n_tiles, split, splits);
  auto load = [&](int tt) {     // frame tt * kBJ + tid, NaN past n
    const int jg = tt * kBJ + tid;
    return tid < kBJ && tt < t_end && jg < n ? position(pts, jg)
                                             : make_float3(nan, nan, nan);
  };
  float3 next = load(t);
  for (; t < t_end; ++t) {
    const int j0 = t * kBJ;
    const float3 pj = next;
    next = load(t + 1);
    __syncthreads();              // the last tile's positions and box read
    if (tid < kBJ) {
      fpos[3 * tid] = pj.x;
      fpos[3 * tid + 1] = pj.y;
      fpos[3 * tid + 2] = pj.z;
    }
    box_of(pj, tid < kBJ && j0 + tid < n, part, fbox);
    if (skip_block(abox, fbox, bnd)) continue;   // the same in every thread
    // the least gap between the group's anchors (consecutive frames) and
    // the tile's frames: where it reaches both gap bounds, every pair
    // passes both gap tests (the stand-ins past count go unreported)
    const int j_last = min(j0 + kBJ, n) - 1;
    const int gap_min = j0 > a_last ? j0 - a_last
                        : a_first > j_last ? a_first - j_last : 0;
    if (gap_min >= max(bnd.pos_gap, bnd.neg_gap))
      count_tile<false>(apos, fpos, j0, tx, ty, bnd, cp, cn);
    else
      count_tile<true>(apos, fpos, j0, tx, ty, bnd, cp, cn);
  }
#pragma unroll
  for (int i = 0; i < kPer; ++i)
    state[i * kThreads + tid] = {__int_as_float(0x7f800000), kNone, cp[i],
                                 cn[i]};
  merge_splits<false>(state, tid, a0, count, split, splits, tile, partial,
                      tickets, nullptr, count_pos, count_neg, valid);
}

// Whether frame j (position pj) is a member of anchor ag's (position pa)
// positive mask (neg false) or negative mask (neg true): the counts
// entry's test on the rounded sum of squares and the integer gap.
__device__ __forceinline__ bool member(float3 pa, float3 pj, int ag, int j,
                                       const Bounds& b, bool neg) {
  const float s = sum_sq(__fsub_rn(pa.x, pj.x), __fsub_rn(pa.y, pj.y),
                         __fsub_rn(pa.z, pj.z));
  const int gap = abs(ag - j);
  return neg ? s >= b.neg_lo_s && s <= b.neg_hi_s && gap >= b.neg_gap
             : s < b.pos_s && gap >= b.pos_gap;
}

// Whether no frame of a tile whose box is f (min x, y, z, max x, y, z; NaN
// where the tile holds a NaN) can be a member of the anchor's (position
// pa) positive mask (neg false) or negative mask (neg true): box_sums with
// the anchor for the anchors' box. A NaN lower bound makes it false.
__device__ __forceinline__ bool skip_tile(float3 pa, const float* f,
                                          const Bounds& b, bool neg) {
  const float a[3] = {pa.x, pa.y, pa.z};
  float s_lo, s_hi;
  box_sums(a, a, f, s_lo, s_hi);
  if (!neg) return s_lo >= b.pos_s;
  return s_hi < b.neg_lo_s || s_lo > b.neg_hi_s;
}

// One CTA an anchor (blockIdx.x): the r-th member in index order of its
// positive mask (neg false) or negative mask (neg true), r = min(floor(u *
// count), count - 1), found from the splits' counts of that mask in
// `partial`, then among that split's tiles whose box (`boxes`, the
// tile_boxes of the sequence) can hold a member, in rounds of kDrawWarps
// tiles (one a warp); 0 when the count is 0. Every exit is taken by the
// whole CTA.
__device__ __forceinline__ void draw_member(
    const float* __restrict__ pts, const float* __restrict__ boxes,
    const int* __restrict__ start_at, int n, int count, const Bounds& bnd,
    const float* __restrict__ u, const int* __restrict__ counts, int splits,
    const Partial* __restrict__ partial, int* __restrict__ idx, bool neg) {
  __shared__ int warp_count[2][kDrawWarps];   // a round's, double-buffered
  __shared__ int warp_kept[kDrawWarps];
  __shared__ int kept[kDrawGate];             // a pass's kept tiles
  const unsigned full = 0xffffffffu;
  const int a = blockIdx.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  // the mask's count of the anchor in split s (0 past the splits)
  auto split_count = [&](int s) {
    const Partial* q = partial + (long long)s * count + a;
    return s < splits ? (neg ? q->count_neg : q->count_pos) : 0;
  };
  // loaded together: the first 32 splits' counts beside the anchor's
  const int first = split_count(lane);
  const int cnt = counts[a];
  const float ua = u[a];
  const int ag = *start_at + a;
  const float3 pa = position(pts, ag);
  if (cnt == 0) {
    if (threadIdx.x == 0) idx[a] = 0;
    return;
  }
  const int r = min((int)floorf(__fmul_rn(ua, (float)cnt)), cnt - 1);
  // the split that holds the r-th member, and the members before it (each
  // warp finds the same)
  int split = -1, seen = 0;
  for (int s0 = 0; s0 < splits; s0 += 32) {
    const int c = s0 == 0 ? first : split_count(s0 + lane);
    int incl = c;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int v = __shfl_up_sync(full, incl, o);
      if (lane >= o) incl += v;
    }
    const unsigned past = __ballot_sync(full, seen + incl > r);
    if (past) {
      const int l = __ffs(past) - 1;
      split = s0 + l;
      seen += __shfl_sync(full, incl - c, l);
      break;
    }
    seen += __shfl_sync(full, incl, 31);
  }
  if (split < 0) {                // unreachable while the counts hold
    if (threadIdx.x == 0) idx[a] = 0;
    return;
  }
  const int rr = r - seen;                      // its rank in the split
  const int n_tiles = (n + kBJ - 1) / kBJ;
  const int t_lo = split_tile(n_tiles, split, splits);
  const int t_hi = split_tile(n_tiles, split + 1, splits);
  const int hi = min(t_hi * kBJ, n);
  const unsigned below = (1u << lane) - 1u;     // the lanes under this one
  int before = 0;                 // the members of the earlier rounds
  int round = 0;
  // passes of kDrawGate tiles (one a thread): the tiles the gate keeps,
  // listed in index order, then walked kDrawWarps a round
  for (int g0 = t_lo; g0 < t_hi; g0 += kDrawGate) {
    const int t = g0 + threadIdx.x;
    const bool keep = t < t_hi && !skip_tile(pa, boxes + 6LL * t, bnd, neg);
    const unsigned kb = __ballot_sync(full, keep);
    if (lane == 0) warp_kept[warp] = __popc(kb);
    __syncthreads();
    int n_kept = 0, at = 0;
#pragma unroll
    for (int w = 0; w < kDrawWarps; ++w) {
      const int v = warp_kept[w];
      n_kept += v;
      at += w < warp ? v : 0;
    }
    if (keep) kept[at + __popc(kb & below)] = t;
    __syncthreads();
    for (int k0 = 0; k0 < n_kept; k0 += kDrawWarps, ++round) {
      // this warp's tile (none past the list: its frames start at hi)
      const int j0 = k0 + warp < n_kept ? kept[k0 + warp] * kBJ : hi;
      bool in[kDrawUnroll];
#pragma unroll
      for (int q = 0; q < kDrawUnroll; ++q) {
        const int j = j0 + 32 * q + lane;
        in[q] = j < hi && member(pa, position(pts, j), ag, j, bnd, neg);
      }
      unsigned m[kDrawUnroll];
      int c = 0;
#pragma unroll
      for (int q = 0; q < kDrawUnroll; ++q) {
        m[q] = __ballot_sync(full, in[q]);
        c += __popc(m[q]);
      }
      int* wc = warp_count[round & 1];
      if (lane == 0) wc[warp] = c;
      __syncthreads();            // (the other buffer's reads are done:
                                  // every warp passed the last barrier)
      int total = 0, earlier = 0; // the round's members, the lower warps'
#pragma unroll
      for (int w = 0; w < kDrawWarps; ++w) {
        const int v = wc[w];
        total += v;
        earlier += w < warp ? v : 0;
      }
      if (before + total > rr) {  // the last round, for every warp
        int f = before + earlier;
        if (f <= rr && rr < f + c) {
#pragma unroll
          for (int q = 0; q < kDrawUnroll; ++q) {
            const int cq = __popc(m[q]);
            if (f + cq > rr) {
              if (in[q] && __popc(m[q] & below) == rr - f)
                idx[a] = j0 + 32 * q + lane;
              break;
            }
            f += cq;
          }
        }
        return;
      }
      before += total;
    }
    __syncthreads();              // kept and warp_kept are read
  }
  if (threadIdx.x == 0) idx[a] = 0;   // unreachable while the counts hold
}

__global__ void __launch_bounds__(32 * kDrawWarps)
mine_draw_kernel(const float* __restrict__ pts,
                 const float* __restrict__ boxes,
                 const int* __restrict__ start_at, int n, int count,
                 Bounds bnd, const float* __restrict__ u,
                 const int* __restrict__ count_pos, int splits,
                 const Partial* __restrict__ partial,
                 int* __restrict__ pos_idx) {
  draw_member(pts, boxes, start_at, n, count, bnd, u, count_pos, splits,
              partial, pos_idx, false);
}

__global__ void __launch_bounds__(32 * kDrawWarps)
mine_draw_mask_kernel(const float* __restrict__ pts,
                      const float* __restrict__ boxes,
                      const int* __restrict__ start_at, int n, int count,
                      Bounds bnd, int which, const float* __restrict__ u,
                      const int* __restrict__ counts, int splits,
                      const Partial* __restrict__ partial,
                      int* __restrict__ idx) {
  draw_member(pts, boxes, start_at, n, count, bnd, u, counts, splits,
              partial, idx, which != 0);
}

// dynamic shared memory allowed so far, per device (0: the default 48 KB),
// of the first entry's kernel and of the W1-row entry's
int g_smem_allowed[nsc::kMaxDevices] = {};
int g_rows_smem_allowed[nsc::kMaxDevices] = {};

// Both W1 walks' launch: the checks, the shared-memory opt-in, the copy
// width and the grid. Returns cudaGetLastError() after the launch.
template <bool kRows>
int launch_w1_walk(const void* pts, const void* cdf, const void* start,
                   int n, int count, int bins, const Params& prm, int splits,
                   void* partial, void* tickets, void* out, void* count_pos,
                   void* count_neg, void* valid, void* stream) {
  if (n < 1 || count < 1 || count > n || bins < 1 || splits < 1 ||
      splits > (n + kBJ - 1) / kBJ)
    return (int)cudaErrorInvalidValue;
  int dev = 0;
  cudaError_t err = nsc::current_device(&dev);
  if (err != cudaSuccess) return (int)err;
  int* allowed = kRows ? g_rows_smem_allowed : g_smem_allowed;
  if (allowed[dev] < (int)kSmemBytes) {
    const void* fn = kRows ? reinterpret_cast<const void*>(mine_rows_kernel)
                           : reinterpret_cast<const void*>(mine_hard_kernel);
    err = cudaFuncSetAttribute(fn,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)kSmemBytes);
    if (err != cudaSuccess) return (int)err;
    allowed[dev] = (int)kSmemBytes;
  }
  // 16-byte copies need every row 16-byte aligned
  const int vec = bins % 4 == 0 &&
                  reinterpret_cast<uintptr_t>(cdf) % 16 == 0;
  const dim3 grid(splits, (count + kBA - 1) / kBA);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto p = static_cast<const float*>(pts);
  const auto c = static_cast<const float*>(cdf);
  const auto st = static_cast<const int*>(start);
  const auto part = static_cast<Partial*>(partial);
  const auto tk = static_cast<int*>(tickets);
  const auto cp = static_cast<int*>(count_pos);
  const auto cn = static_cast<int*>(count_neg);
  const auto ok = static_cast<uint8_t*>(valid);
  if (kRows)
    mine_rows_kernel<<<grid, kThreads, kSmemBytes, s>>>(
        p, c, st, n, count, bins, prm, splits, vec, part, tk,
        static_cast<float*>(out), cp, cn, ok);
  else
    mine_hard_kernel<<<grid, kThreads, kSmemBytes, s>>>(
        p, c, st, n, count, bins, prm, splits, vec, part, tk,
        static_cast<int*>(out), cp, cn, ok);
  return (int)cudaGetLastError();
}

}  // namespace

// One chunk's counts and hard negatives. pts (n, 3) and cdf (n, bins)
// float32, start (1,) int32 on the device (start + count <= n); partial
// (splits * count) 16-byte entries and tickets (ceil(count / 128),) int32
// at 0 (left at 0) as scratch; neg_idx, count_pos, count_neg (count,) int32
// and valid (count,) uint8 out. splits <= ceil(n / 128). Launches splits x
// ceil(count / 128) CTAs of 256 threads with kSmemBytes of dynamic shared
// memory. Returns cudaGetLastError() after the launch (cudaErrorInvalidValue,
// nothing launched, for sizes out of range).
extern "C" int nsc_mine_hard(const void* pts, const void* cdf,
                             const void* start, int n, int count, int bins,
                             float pos_max, float pos_gap, float neg_min,
                             float neg_max, float neg_gap, int splits,
                             void* partial, void* tickets, void* neg_idx,
                             void* count_pos, void* count_neg, void* valid,
                             void* stream) {
  const Params prm = {pos_max, pos_gap, neg_min, neg_max, neg_gap};
  return launch_w1_walk<false>(pts, cdf, start, n, count, bins, prm, splits,
                               partial, tickets, neg_idx, count_pos,
                               count_neg, valid, stream);
}

// One chunk's W1 block for "semi-hard": as nsc_mine_hard, with w1 (count,
// n) float32 out (W1 where the frame is a negative of the anchor, +inf
// elsewhere) in place of neg_idx. The partials are left as nsc_mine_hard
// leaves them, for nsc_mine_draw_mask.
extern "C" int nsc_mine_rows(const void* pts, const void* cdf,
                             const void* start, int n, int count, int bins,
                             float pos_max, float pos_gap, float neg_min,
                             float neg_max, float neg_gap, int splits,
                             void* partial, void* tickets, void* w1,
                             void* count_pos, void* count_neg, void* valid,
                             void* stream) {
  const Params prm = {pos_max, pos_gap, neg_min, neg_max, neg_gap};
  return launch_w1_walk<true>(pts, cdf, start, n, count, bins, prm, splits,
                              partial, tickets, w1, count_pos, count_neg,
                              valid, stream);
}

// One chunk's counts for "random": as nsc_mine_hard without the CDFs and
// without neg_idx, the thresholds as Bounds (training/mine_kernel.py
// mask_bounds: pos_s, neg_lo_s, neg_hi_s on the rounded sum of squares,
// pos_gap and neg_gap >= 1 on the integer gap). Launches splits x
// ceil(count / 128) CTAs of 256 threads (static shared memory only).
extern "C" int nsc_mine_counts(const void* pts, const void* start, int n,
                               int count, float pos_s, float neg_lo_s,
                               float neg_hi_s, int pos_gap, int neg_gap,
                               int splits, void* partial, void* tickets,
                               void* count_pos, void* count_neg, void* valid,
                               void* stream) {
  if (n < 1 || count < 1 || count > n || splits < 1 ||
      splits > (n + kBJ - 1) / kBJ || pos_gap < 1 || neg_gap < 1)
    return (int)cudaErrorInvalidValue;
  const Bounds bnd = {pos_s, neg_lo_s, neg_hi_s, pos_gap, neg_gap};
  mine_counts_kernel<<<dim3(splits, (count + kBA - 1) / kBA), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(pts), static_cast<const int*>(start), n,
      count, bnd, splits, static_cast<Partial*>(partial),
      static_cast<int*>(tickets), static_cast<int*>(count_pos),
      static_cast<int*>(count_neg), static_cast<uint8_t*>(valid));
  return (int)cudaGetLastError();
}

// One chunk's positives: boxes (ceil(n / 128), 6) float32 the frame tiles'
// boxes (training/mine_kernel.py tile_boxes), u (count,) float32 in [0,
// 1), count_pos (count,) int32 and partial (splits * count entries) as
// nsc_mine_hard left them, with the same splits; the thresholds as
// nsc_mine_counts takes them (mask_bounds); pos_idx (count,) int32 out.
// Launches count CTAs of 32 * kDrawWarps threads (static shared memory).
extern "C" int nsc_mine_draw(const void* pts, const void* boxes,
                             const void* start, int n, int count,
                             float pos_s, float neg_lo_s, float neg_hi_s,
                             int pos_gap, int neg_gap, const void* u,
                             const void* count_pos, int splits,
                             const void* partial, void* pos_idx,
                             void* stream) {
  if (n < 1 || count < 1 || count > n || splits < 1 ||
      splits > (n + kBJ - 1) / kBJ || pos_gap < 1 || neg_gap < 1)
    return (int)cudaErrorInvalidValue;
  const Bounds bnd = {pos_s, neg_lo_s, neg_hi_s, pos_gap, neg_gap};
  mine_draw_kernel<<<count, 32 * kDrawWarps, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(pts), static_cast<const float*>(boxes),
      static_cast<const int*>(start), n, count, bnd,
      static_cast<const float*>(u),
      static_cast<const int*>(count_pos), splits,
      static_cast<const Partial*>(partial), static_cast<int*>(pos_idx));
  return (int)cudaGetLastError();
}

// One chunk's draw over the positives (which 0) or the negatives (which 1):
// boxes as nsc_mine_draw's, u (count,) float32 in [0, 1), counts (count,)
// int32 that mask's counts, partial as any of the three entries above left
// it, with the same splits, the thresholds as mask_bounds; idx (count,)
// int32 out.
extern "C" int nsc_mine_draw_mask(const void* pts, const void* boxes,
                                  const void* start, int n, int count,
                                  float pos_s, float neg_lo_s,
                                  float neg_hi_s, int pos_gap, int neg_gap,
                                  int which, const void* u, const void* counts,
                                  int splits, const void* partial, void* idx,
                                  void* stream) {
  if (n < 1 || count < 1 || count > n || splits < 1 ||
      splits > (n + kBJ - 1) / kBJ || which < 0 || which > 1 ||
      pos_gap < 1 || neg_gap < 1)
    return (int)cudaErrorInvalidValue;
  const Bounds bnd = {pos_s, neg_lo_s, neg_hi_s, pos_gap, neg_gap};
  mine_draw_mask_kernel<<<count, 32 * kDrawWarps, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(pts), static_cast<const float*>(boxes),
      static_cast<const int*>(start), n, count, bnd, which,
      static_cast<const float*>(u),
      static_cast<const int*>(counts), splits,
      static_cast<const Partial*>(partial), static_cast<int*>(idx));
  return (int)cudaGetLastError();
}

// Kernel M's kernels, for the census of captured graphs (nsc_graph_census
// in project.cu): 0 the counts and hard negatives, 1 the draw, 2 the counts
// alone, 3 the W1 rows, 4 the draw over either mask.
extern "C" const void* nsc_mine_kernel_handle(int which) {
  switch (which) {
    case 0: return reinterpret_cast<const void*>(mine_hard_kernel);
    case 1: return reinterpret_cast<const void*>(mine_draw_kernel);
    case 2: return reinterpret_cast<const void*>(mine_counts_kernel);
    case 3: return reinterpret_cast<const void*>(mine_rows_kernel);
    default: return reinterpret_cast<const void*>(mine_draw_mask_kernel);
  }
}
