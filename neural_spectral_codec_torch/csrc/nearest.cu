// Kernel N: the nearest valid target of every source point.
//
// Not a Pallas kernel: the hand-written form of the correspondence search
// inside the JAX package's registration program,
// neural_spectral_codec_tpu/retrieval/verification.py _icp_kernel
// (correspondences, :124-131): an all-pairs (P, Q) distance matrix, masked
// targets at +inf, and a row argmin. Its function, for moved (P, 3), dst
// (Q, 3) and dst_mask (Q,):
//     d2[i, j] = dst_mask[j] ? (dx^2 + dy^2) + dz^2 : +inf
//     j_out[i] = argmin_j d2[i, j]   (first NaN, else the least, ties to the
//                                     lower index: torch.argmin, jnp.argmin)
//     d2_out[i] = d2[i, j_out[i]]
// The plain version is retrieval/nearest_kernel.py nearest_plain; this
// kernel gives its j_out and d2_out bit for bit (a NaN distance as the
// card's canonical NaN).
//
// What bounds it on the H100: operations. At P = Q = 4,096 (the verifier's
// default) it reads 114,688 B and writes 49,152 B, but computes 16.8 M
// distances of 9 operations each (3 subtractions, 3 products, 2 sums, 1
// comparison), none of which may fuse into an FMA: 151 M operations,
// 4.5 us at the fp32 rate of 33.5 T non-FMA operations a second. A
// registration runs it 31 times (30 Gauss-Newton steps and the final
// fitness), all inside one captured CUDA graph.
//
// Design: register blocking, one broadcast read per kRows distances, and
// 32-bit compares; the targets split across a CTA's warps and a cluster.
//   * A CTA of 32 warps owns kRowsPerCta = 64 source points: lane l of every
//     warp holds points l and l + 32 in registers (kRows = 2), and warp w
//     scans part w of the CTA's targets. A cluster of kCluster = 2 CTAs
//     splits the targets in two (rank r takes [r*Q/2, (r+1)*Q/2)), so
//     P = 4,096 makes 64 clusters, 128 CTAs for 132 SMs, and a thread scans
//     64 targets at Q = 4,096. 1,024 threads of more than 32 registers fill
//     half the register file, so no two CTAs share an SM, and a cluster of
//     two fits any pair of SMs of a GPC (clusters of 8 CTAs of 256 threads
//     were packed two CTAs to an SM, or, held to one, did not all fit at
//     once).
//   * The CTA stages its targets in shared memory as float4 entries
//     (pairwise.cuh search_entry: the mask folded into the point, the index
//     in w), kTile = 2,048 at a time (one tile at Q = 4,096), and cuts the
//     tile into 32 parts of whole groups. Every lane of a warp reads the
//     same entry, a broadcast: one read feeds kRows distances.
//   * Common path (the lane's points finite, no valid non-finite target in
//     the tile, so no distance is NaN): targets in groups of kGroup = 8 in
//     ascending index; the group's least distance by an fminf tree (7
//     FMNMX), and best = that least, group = g only where it is strictly
//     below best: about 8 + 1.25 operations a distance, no 64-bit work. The
//     part's result is the key (bits of best, group), which orders like
//     (distance, index) since parts and groups are in index order.
//   * Exact path, off the common one (a non-finite point, or a valid
//     non-finite target in the tile): one 64-bit key a candidate (NaN
//     first, then the distance, then the index) and its minimum.
//   * After each tile, 16 threads a row take the least of its 32 part keys;
//     on the common path one of them searches the winning group again for
//     its first target at that distance (8 distances a row a tile), which
//     gives the first minimum with ties to the lower index, or the tile's
//     first target when every distance was +inf, as argmin has it. That
//     thread keeps the row's key over the tiles, then stores it into the
//     shared memory of the rank that writes the row (rank r writes rows
//     [32r, 32r + 32)); after one cluster barrier each rank reads its own
//     shared memory only, so no second barrier keeps a CTA alive.
// One launch, no atomics, no scratch: deterministic. What limits it: the
// issue rate of the ~10 instructions a distance (8 of them fp32 that may
// not fuse) on 128 busy SMs, plus the launch, one staging round trip, the
// part merge and the cluster barrier.
#include <cstdint>

#include <cooperative_groups.h>

#include "common.cuh"
#include "pairwise.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kRows = 2;                       // source points a lane holds
constexpr int kRowsPerCta = 32 * kRows;
constexpr int kParts = 32;                     // warps, each its own part
constexpr int kThreads = 32 * kParts;
constexpr int kCluster = 2;                    // CTAs that split the targets
constexpr int kGroup = 8;                      // targets a min tree takes
constexpr int kTile = 2048;                    // entries staged at a time
constexpr int kMergers = kThreads / kRowsPerCta;   // threads a row's merge
constexpr int kPartStride = kParts + 1;        // part keys of a row, padded
static_assert(kMergers * kRowsPerCta == kThreads && 32 % kMergers == 0,
              "a row's merge is whole lanes of one warp");
static_assert(kRowsPerCta % kCluster == 0, "ranks write whole rows");
static_assert(kTile % kThreads == 0, "a thread stages whole entries");

constexpr int kOwnRows = kRowsPerCta / kCluster;   // rows a rank writes

constexpr size_t kSmemBytes =
    sizeof(float4) * kTile +
    sizeof(unsigned long long) * (kRowsPerCta * kPartStride + kRowsPerCta) +
    sizeof(int) * 32;

// Cluster barrier halves: every CTA of the cluster has started once all
// have arrived, and only then may one store into another's shared memory.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

#ifdef NSC_NEAREST_STAMPS
// A diagnostic build (experiments/kernel_ab.py): each CTA's global timer
// (ns) at its start, after the staging, after the scan, after the part
// merge, after the cluster barrier and at its end (the last tile's).
constexpr int kStamps = 6;
constexpr int kMaxStampedCtas = 4096;
__device__ unsigned long long g_nearest_stamps[kMaxStampedCtas * kStamps];
#define NEAREST_STAMP(i)                                              \
  if (threadIdx.x == 0 && blockIdx.x < kMaxStampedCtas) {             \
    unsigned long long t;                                             \
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));             \
    g_nearest_stamps[blockIdx.x * kStamps + (i)] = t;                 \
  }
#else
#define NEAREST_STAMP(i)
#endif

// Argmin order: NaN first (bits 0), then the distance (its bits + 1), then
// the index.
__device__ __forceinline__ unsigned long long argmin_key(float d2, int j) {
  return nsc::pack_key(isnan(d2) ? 0u : __float_as_uint(d2) + 1u, j);
}

__device__ __forceinline__ unsigned long long kmin(unsigned long long a,
                                                   unsigned long long b) {
  return a < b ? a : b;
}

__device__ __forceinline__ float min8(const float (&d)[kGroup]) {
  return fminf(fminf(fminf(d[0], d[1]), fminf(d[2], d[3])),
               fminf(fminf(d[4], d[5]), fminf(d[6], d[7])));
}

// The common path over entries [lo, hi) of the tile (lo a multiple of
// kGroup, the tile padded past hi to one): per row the key (bits of the
// least distance, the tile offset of the first group that holds it), or
// (+inf, lo) when every distance is +inf.
__device__ __forceinline__ void scan_groups(const float4* tile, int lo, int hi,
                                            const float (&px)[kRows],
                                            const float (&py)[kRows],
                                            const float (&pz)[kRows],
                                            unsigned long long (&key)[kRows]) {
  float best[kRows];
  int group[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    best[r] = INFINITY;
    group[r] = lo;
  }
#pragma unroll 2
  for (int g = lo; g < hi; g += kGroup) {
    float4 q[kGroup];
#pragma unroll
    for (int i = 0; i < kGroup; ++i) q[i] = tile[g + i];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      float d[kGroup];
#pragma unroll
      for (int i = 0; i < kGroup; ++i)
        d[i] = nsc::sq_dist(px[r], py[r], pz[r], q[i].x, q[i].y, q[i].z);
      const float m = min8(d);
      if (m < best[r]) {
        best[r] = m;
        group[r] = g;
      }
    }
  }
#pragma unroll
  for (int r = 0; r < kRows; ++r)
    key[r] = nsc::pack_key(__float_as_uint(best[r]), group[r]);
}

// The exact path over entries [lo, hi) of the tile: a key a candidate.
__device__ __forceinline__ void scan_keys(const float4* tile, int lo, int hi,
                                          const float (&px)[kRows],
                                          const float (&py)[kRows],
                                          const float (&pz)[kRows],
                                          unsigned long long (&key)[kRows]) {
  for (int t = lo; t < hi; ++t) {
    const float4 e = tile[t];
#pragma unroll
    for (int r = 0; r < kRows; ++r)
      key[r] = kmin(key[r], argmin_key(nsc::entry_d2(px[r], py[r], pz[r], e),
                                       nsc::entry_index(e)));
  }
}

__device__ __forceinline__ void load_point(const float* __restrict__ moved,
                                           int row, int n_src, float* x,
                                           float* y, float* z) {
  *x = *y = *z = 0.0f;                         // a row past P: unused
  if (row < n_src) {
    *x = __ldg(moved + 3 * row);
    *y = __ldg(moved + 3 * row + 1);
    *z = __ldg(moved + 3 * row + 2);
  }
}

__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads, 1)
nearest_kernel(const float* __restrict__ moved, const float* __restrict__ dst,
               const uint8_t* __restrict__ dst_mask,
               long long* __restrict__ j_out, float* __restrict__ d2_out,
               int n_src, int n_dst) {
  extern __shared__ float4 tile[];                        // kTile
  auto* part_keys = reinterpret_cast<unsigned long long*>(tile + kTile);
  // incoming[s * kOwnRows + i]: rank s's key of row rank * kOwnRows + i
  unsigned long long* incoming = part_keys + kRowsPerCta * kPartStride;
  int* lane_exact = reinterpret_cast<int*>(incoming + kRowsPerCta);
  cluster_arrive();                   // waited for before the first store
  NEAREST_STAMP(0)
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int row0 = (blockIdx.x / kCluster) * kRowsPerCta;
  const int lane = threadIdx.x & 31;
  const int part = threadIdx.x >> 5;
  const int lo = (int)((long long)rank * n_dst / kCluster);
  const int hi = (int)((long long)(rank + 1) * n_dst / kCluster);

  float px[kRows], py[kRows], pz[kRows];
  bool finite = true;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    load_point(moved, row0 + r * 32 + lane, n_src, &px[r], &py[r], &pz[r]);
    finite = finite && nsc::finite3(px[r], py[r], pz[r]);
  }
  // this thread's share of the part merge: row mrow, parts msub + 16 i
  const int mrow = threadIdx.x / kMergers;
  const int msub = threadIdx.x % kMergers;
  float mx, my, mz;
  load_point(moved, row0 + mrow, n_src, &mx, &my, &mz);
  unsigned long long row_key = ~0ull;           // the row's key (msub 0)

  for (int base = lo; base < hi; base += kTile) {
    const int n = min(kTile, hi - base);
    const int padded = (n + kGroup - 1) / kGroup * kGroup;
    // part p takes [p * span, (p + 1) * span) of the tile, whole groups
    const int span = ((n + kParts - 1) / kParts + kGroup - 1) / kGroup * kGroup;
    if (base > lo) __syncthreads();   // the last tile and its keys are used
    const bool nonfinite = nsc::stage_tile<kTile / kThreads, kThreads>(
        tile, dst, dst_mask, base, n, padded);
    // written after the staging loads are issued, so both are in flight
    if (part == 0) lane_exact[lane] = !finite;
    const bool exact_tile = __syncthreads_or(nonfinite) != 0;
    NEAREST_STAMP(1)
    const int t_lo = part * span;
    const int t_hi = min(n, t_lo + span);
    unsigned long long key[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) key[r] = ~0ull;
    if (t_lo < t_hi) {
      if (exact_tile || !finite)
        scan_keys(tile, t_lo, t_hi, px, py, pz, key);
      else
        scan_groups(tile, t_lo, t_hi, px, py, pz, key);
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r)
      part_keys[(r * 32 + lane) * kPartStride + part] = key[r];
    __syncthreads();
    NEAREST_STAMP(2)
    unsigned long long k0 = ~0ull;
#pragma unroll
    for (int p = msub; p < kParts; p += kMergers)
      k0 = kmin(k0, part_keys[mrow * kPartStride + p]);
#pragma unroll
    for (int off = kMergers / 2; off > 0; off >>= 1)
      k0 = kmin(k0, __shfl_xor_sync(nsc::kFullMask, k0, off));
    if (msub == 0) {
      if (!exact_tile && !lane_exact[mrow % 32]) {
        // the winning group's first target at the least distance
        const float best = __uint_as_float(static_cast<unsigned>(k0 >> 32));
        const int g = nsc::key_index(k0);
        int j = 0;
#pragma unroll
        for (int i = kGroup - 1; i >= 0; --i) {
          const float4 e = tile[g + i];
          if (nsc::sq_dist(mx, my, mz, e.x, e.y, e.z) == best)
            j = nsc::entry_index(e);
        }
        k0 = argmin_key(best, j);
      }
      row_key = kmin(row_key, k0);
    }
  }
  NEAREST_STAMP(3)

  // each rank stores its row keys into the rank that writes the row, so
  // that after one barrier every rank reads only its own shared memory
  cluster_wait();
  if (msub == 0)
    cluster.map_shared_rank(incoming, mrow / kOwnRows)[
        rank * kOwnRows + mrow % kOwnRows] = row_key;
  cluster.sync();
  NEAREST_STAMP(4)
  if (threadIdx.x < kOwnRows) {
    unsigned long long best = ~0ull;
#pragma unroll
    for (int s = 0; s < kCluster; ++s)
      best = kmin(best, incoming[s * kOwnRows + threadIdx.x]);
    const int row = row0 + rank * kOwnRows + threadIdx.x;
    if (row < n_src) {
      const unsigned bits = static_cast<unsigned>(best >> 32);
      j_out[row] = nsc::key_index(best);
      d2_out[row] = bits == 0u ? __int_as_float(0x7fffffff)
                               : __uint_as_float(bits - 1u);
    }
  }
  NEAREST_STAMP(5)
}

// dynamic shared memory allowed so far, per device (0: the default 48 KB)
int g_smem_allowed[nsc::kMaxDevices] = {};

}  // namespace

// moved (n_src, 3) and dst (n_dst, 3) float32, dst_mask (n_dst,) bool (one
// byte each), j_out (n_src,) int64 and d2_out (n_src,) float32, all
// contiguous on the current device; n_src, n_dst >= 1. Launches
// ceil(n_src / 64) clusters of 2 CTAs of 1,024 threads with kSmemBytes of
// dynamic shared memory. Returns cudaGetLastError() after the launch (a
// refused cluster shape is an error, never a fallback).
extern "C" int nsc_nearest(const void* moved, const void* dst,
                           const void* dst_mask, void* j_out, void* d2_out,
                           int n_src, int n_dst, void* stream) {
  if (n_src < 1 || n_dst < 1) return (int)cudaErrorInvalidValue;
  int dev = 0;
  cudaError_t err = nsc::current_device(&dev);
  if (err != cudaSuccess) return (int)err;
  if (g_smem_allowed[dev] < (int)kSmemBytes) {
    err = cudaFuncSetAttribute(nearest_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)kSmemBytes);
    if (err != cudaSuccess) return (int)err;
    g_smem_allowed[dev] = (int)kSmemBytes;
  }
  const int blocks = (n_src + kRowsPerCta - 1) / kRowsPerCta;
  nearest_kernel<<<blocks * kCluster, kThreads, kSmemBytes,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(moved), static_cast<const float*>(dst),
      static_cast<const uint8_t*>(dst_mask), static_cast<long long*>(j_out),
      static_cast<float*>(d2_out), n_src, n_dst);
  return (int)cudaGetLastError();
}

#ifdef NSC_NEAREST_STAMPS
// The diagnostic build's stamps of the last launch: n_ctas * kStamps.
extern "C" int nsc_nearest_stamps(unsigned long long* out, int n_ctas) {
  if (n_ctas > kMaxStampedCtas) return (int)cudaErrorInvalidValue;
  return (int)cudaMemcpyFromSymbol(
      out, g_nearest_stamps, sizeof(unsigned long long) * n_ctas * kStamps);
}
#endif

// The kernel's function, for the census of captured graphs
// (nsc_graph_census in project.cu).
extern "C" const void* nsc_nearest_kernel_handle() {
  return reinterpret_cast<const void*>(nearest_kernel);
}
