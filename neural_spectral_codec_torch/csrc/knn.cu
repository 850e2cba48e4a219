// Kernel K: the k nearest valid points of every point of one cloud.
//
// Not a Pallas kernel: the hand-written form of the k-NN selection inside
// the JAX package's per-cloud preparation,
// neural_spectral_codec_tpu/retrieval/verification.py _knn_cov_matrices
// (:64-73, run by the jitted _knn_covariances and _knn_normals): an
// all-pairs (P, P) distance matrix, masked columns at +inf, and
// lax.top_k(-d2, k). Its function, for pts (P, 3), mask (P,) and k <= 32:
//     d2[i, j] = mask[j] ? (dx^2 + dy^2) + dz^2 : +inf
//     idx[i, :] = the first k of row i in ascending d2, ties to the lower
//                 index (NaN after +inf)
// which is the order of lax.top_k and of a stable ascending sort. A row
// with fewer than k valid points is filled with masked indices in
// ascending order. The plain version is retrieval/knn_kernel.py knn_plain;
// this kernel gives its idx index for index.
//
// What bounds it on the H100: operations, as for kernel N (nearest.cu):
// P^2 distances of 9 operations, 151 M at P = 4,096, 4.5 us at 33.5 T
// non-FMA operations a second; the selection work depends on the data and
// is not counted in the bound. It runs once a prepared cloud (k = 20 for
// GICP covariances, 16 for normals).
//
// Design: one warp for kRows = 2 rows, which start where their answer is.
// The keys are a total order (distance, then index), so the k least do not
// depend on the order the candidates are visited in.
//   * A CTA of 16 warps owns 32 consecutive rows, one batch of the cloud
//     (warp w takes rows w and w + 16: neighbouring rows, whose merges come
//     alike, go to different warps). It stages the cloud in shared memory
//     as float4 entries (pairwise.cuh search_entry), kTile = 4,096 at a
//     time (64 KB: the whole cloud at the verifier's P), padded to a whole
//     batch of 32; the tile that holds the CTA's rows comes first, the
//     others after it in turn. P = 4,096 makes 128 CTAs.
//   * A batch is one candidate a lane; one shared read feeds the warp's two
//     rows (a warp a row read 16 B of shared memory a distance, which bound
//     the scan; four rows a warp left too few warps to hide the merges).
//     In a tile a warp visits its rows' own batch first (batch 0 in the
//     other tiles), then the batches out from it both ways in turn,
//     wrapping round. A prepared cloud is sorted by voxel key, so the near
//     batches on both sides hold the neighbours: the k-th key falls close
//     to its final value at once, and the test then skips almost every
//     other batch. (The following batches alone, wrapping round, left the
//     preceding neighbours to the end: 6.4 exact tests a row on phase 8's
//     frames, against 5.1 both ways, by experiments/kernel_ab.py's counts.)
//   * The warp keeps, per row, the 32 least keys seen so far (pairwise.cuh),
//     one a lane in ascending order. Per row and batch, one ballot of
//     !(d2 > k-th distance), a 32-bit float compare (a NaN distance, or a
//     list still short of k numbers, lets the batch through); one vote over
//     the two rows skips the batch. Only a row that a lane passes builds
//     64-bit keys and ballots key < k-th key, the exact test (it decides
//     ties by the index).
//   * A batch with at most kInsertMax exact passes inserts only those lanes
//     into the row's sorted list: the lane's rank from one ballot, one
//     __shfl_up_sync shift. More passes (the own batch, mostly) take the
//     full merge: a bitonic sort of the batch across the lanes, the least
//     of the list and the reversed batch lane by lane (bitonic), and five
//     cleaning steps (the first batch of a row is the sorted batch). Each
//     compare-exchange is one 64-bit comparison and two selects.
//   * A warp with a row whose point is not finite takes the exact distance
//     (entry_d2: +inf for a masked entry), warp-uniform.
// One launch, no atomics, no scratch: deterministic. What limits it: the
// merges, a few a row on prepared clouds, each a chain of dependent
// shuffles and 64-bit integer compares (a full merge about 20 steps) on the
// half-rate integer pipe, which the scan (about 12 instructions a
// distance: 8 fp32 that may not fuse, the compare, half the shared read,
// vote and loop) hides only in part; and the staging, every CTA reading
// the whole cloud from L2.
#include <cstdint>

#include "common.cuh"
#include "pairwise.cuh"

namespace {

constexpr int kRows = 2;                   // rows a warp
constexpr int kWarps = 16;
constexpr int kRowsPerCta = kRows * kWarps;
constexpr int kThreads = 32 * kWarps;
constexpr int kTile = 4096;                // entries staged at a time
static_assert(kRowsPerCta == 32 && kTile % 32 == 0,
              "a CTA's rows are one batch, their own, in one tile");
static_assert(kTile % kThreads == 0, "a thread stages whole entries");
constexpr int kMaxK = 32;
constexpr int kInsertMax = 8;              // insertions before a full merge
constexpr unsigned kNanBits = 0x7f800001u; // NaN orders after +inf

#ifdef NSC_KNN_COUNT
// A diagnostic build (experiments/kernel_ab.py): batches that reached the
// exact test, batches that passed it, lanes inserted, full merges.
__device__ unsigned long long g_knn_counts[4];
#define KNN_COUNT(i, v) \
  if (lane == 0) atomicAdd(&g_knn_counts[i], (unsigned long long)(v))
#else
#define KNN_COUNT(i, v)
#endif

__device__ __forceinline__ unsigned long long kmin(unsigned long long a,
                                                   unsigned long long b) {
  return a < b ? a : b;
}

// One compare-exchange step of a sorting network: this lane keeps the less
// of (key, other) when keep_less, else the greater. One 64-bit comparison
// and two selects (a min and a max apart took two comparisons and four).
__device__ __forceinline__ unsigned long long exchange(unsigned long long key,
                                                      unsigned long long other,
                                                      bool keep_less) {
  return (other < key) == keep_less ? other : key;
}

// Sort one key a lane ascending across the warp (bitonic network).
__device__ __forceinline__ unsigned long long warp_sort(unsigned long long key,
                                                        int lane) {
#pragma unroll
  for (int size = 2; size <= 32; size <<= 1) {
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      const unsigned long long other =
          __shfl_xor_sync(nsc::kFullMask, key, stride);
      const bool ascending = (lane & size) == 0;   // size 32: every lane
      const bool lower = (lane & stride) == 0;
      key = exchange(key, other, lower == ascending);
    }
  }
  return key;
}

// A bitonic sequence across the warp, sorted ascending.
__device__ __forceinline__ unsigned long long warp_clean(unsigned long long key,
                                                         int lane) {
#pragma unroll
  for (int stride = 16; stride > 0; stride >>= 1) {
    const unsigned long long other =
        __shfl_xor_sync(nsc::kFullMask, key, stride);
    key = exchange(key, other, (lane & stride) == 0);
  }
  return key;
}

// The distance that the 32-bit test compares with: the k-th key's, or NaN
// (every batch goes to the exact test) while the k-th key is NaN or empty.
__device__ __forceinline__ float test_distance(unsigned long long kth) {
  const unsigned bits = static_cast<unsigned>(kth >> 32);
  return bits <= 0x7f800000u ? __uint_as_float(bits)
                             : __int_as_float(0x7fffffff);
}

// One row's sorted list: lane i holds the i-th least key so far.
struct List {
  unsigned long long keys;
  unsigned long long kth;                  // the k-th least key so far
  float kth_d2;                            // test_distance(kth)
};

// Candidate (d2, e) of this lane into the list, for a batch that passed the
// 32-bit test on some lane.
__device__ __forceinline__ List merge(List list, float d2, float4 e, int lane,
                                      int k) {
  KNN_COUNT(0, 1);
  const unsigned long long key =
      nsc::pack_key(min(__float_as_uint(d2), kNanBits), nsc::entry_index(e));
  unsigned pass = __ballot_sync(nsc::kFullMask, key < list.kth);
  if (pass == 0u) return list;
  KNN_COUNT(1, 1);
  if (__popc(pass) > kInsertMax) {
    KNN_COUNT(3, 1);
    const unsigned long long sorted = warp_sort(key, lane);
    if (__all_sync(nsc::kFullMask, list.keys == ~0ull)) {
      list.keys = sorted;                  // the first batch: nothing to merge
    } else {
      const unsigned long long reversed =
          __shfl_sync(nsc::kFullMask, sorted, 31 - lane);
      list.keys = warp_clean(kmin(list.keys, reversed), lane);
    }
  } else {
    KNN_COUNT(2, __popc(pass));
    while (pass != 0u) {
      const int from = __ffs(pass) - 1;
      pass &= pass - 1u;
      const unsigned long long cand = __shfl_sync(nsc::kFullMask, key, from);
      const int pos = __popc(__ballot_sync(nsc::kFullMask, list.keys < cand));
      const unsigned long long up =
          __shfl_up_sync(nsc::kFullMask, list.keys, 1);
      list.keys = lane < pos ? list.keys : lane == pos ? cand : up;
    }
  }
  list.kth = __shfl_sync(nsc::kFullMask, list.keys, k - 1);
  list.kth_d2 = test_distance(list.kth);
  return list;
}

// The tile's nb batches, out from batch first both ways in turn (first,
// first + 1, first - 1, first + 2, ...), wrapping round. kFinite: the rows'
// points are finite, so an entry's plain distance is exact (pairwise.cuh).
template <bool kFinite>
__device__ __forceinline__ void scan(const float4* tile, int first, int nb,
                                     const float (&px)[kRows],
                                     const float (&py)[kRows],
                                     const float (&pz)[kRows],
                                     List (&list)[kRows], int lane, int k) {
#pragma unroll 4
  for (int i = 0; i < nb; ++i) {
    const int off = (i + 1) >> 1;
    int b = (i & 1) ? first + off : first - off;
    b += b < 0 ? nb : 0;
    b -= b >= nb ? nb : 0;
    const float4 e = tile[b * 32 + lane];
    float d2[kRows];
    bool near = false;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      d2[r] = kFinite ? nsc::sq_dist(px[r], py[r], pz[r], e.x, e.y, e.z)
                      : nsc::entry_d2(px[r], py[r], pz[r], e);
      near = near || !(d2[r] > list[r].kth_d2);
    }
    if (!__any_sync(nsc::kFullMask, near)) continue;
#pragma unroll
    for (int r = 0; r < kRows; ++r)
      if (__any_sync(nsc::kFullMask, !(d2[r] > list[r].kth_d2)))
        list[r] = merge(list[r], d2[r], e, lane, k);
  }
}

__global__ void __launch_bounds__(kThreads, 1)
knn_kernel(const float* __restrict__ pts, const uint8_t* __restrict__ mask,
           long long* __restrict__ idx, int n, int k) {
  extern __shared__ float4 tile[];
  const int lane = threadIdx.x & 31;
  const int cta_row = blockIdx.x * kRowsPerCta;
  const int row0 = cta_row + (threadIdx.x >> 5);   // rows row0 + kWarps r
  const bool active = row0 < n;            // warp-uniform
  float px[kRows], py[kRows], pz[kRows];
  List list[kRows];
  bool finite = true;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int row = row0 + r * kWarps;
    px[r] = py[r] = pz[r] = 0.0f;          // a row past P: unused
    if (row < n) {
      px[r] = __ldg(pts + 3 * row);
      py[r] = __ldg(pts + 3 * row + 1);
      pz[r] = __ldg(pts + 3 * row + 2);
    }
    finite = finite && nsc::finite3(px[r], py[r], pz[r]);
    list[r] = {~0ull, ~0ull, test_distance(~0ull)};
  }
  const int n_tiles = (n + kTile - 1) / kTile;
  const int own = cta_row / kTile;         // the tile of the CTA's rows
  for (int s = 0; s < n_tiles; ++s) {
    const int t = own + s < n_tiles ? own + s : own + s - n_tiles;
    const int base = t * kTile;
    const int m = min(kTile, n - base);
    const int nb = (m + 31) / 32;
    if (s > 0) __syncthreads();            // the last tile is consumed
    nsc::stage_tile<kTile / kThreads, kThreads>(tile, pts, mask, base, m,
                                                nb * 32);
    __syncthreads();
    if (!active) continue;
    const int first = s == 0 ? (row0 - base) / 32 : 0;   // the own batch
    if (finite)
      scan<true>(tile, first, nb, px, py, pz, list, lane, k);
    else
      scan<false>(tile, first, nb, px, py, pz, list, lane, k);
  }
#pragma unroll
  for (int r = 0; r < kRows; ++r)
    if (row0 + r * kWarps < n && lane < k)
      idx[(long long)(row0 + r * kWarps) * k + lane] =
          nsc::key_index(list[r].keys);
}

// dynamic shared memory allowed so far, per device (0: the default 48 KB)
int g_smem_allowed[nsc::kMaxDevices] = {};

}  // namespace

// pts (n, 3) float32, mask (n,) bool (one byte each), idx (n, k) int64, all
// contiguous on the current device; 1 <= k <= min(32, n). Launches
// ceil(n / 32) CTAs of 512 threads with min(n, 4,096) rounded up to 32
// float4 entries of dynamic shared memory. Returns cudaGetLastError() after
// the launch.
extern "C" int nsc_knn(const void* pts, const void* mask, void* idx, int n,
                       int k, void* stream) {
  if (n < 1 || k < 1 || k > kMaxK || k > n) return (int)cudaErrorInvalidValue;
  const int entries = ((n < kTile ? n : kTile) + 31) / 32 * 32;
  const int smem = (int)sizeof(float4) * entries;
  int dev = 0;
  cudaError_t err = nsc::current_device(&dev);
  if (err != cudaSuccess) return (int)err;
  if (smem > 48 * 1024 && smem > g_smem_allowed[dev]) {
    err = cudaFuncSetAttribute(knn_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return (int)err;
    g_smem_allowed[dev] = smem;
  }
  knn_kernel<<<(n + kRowsPerCta - 1) / kRowsPerCta, kThreads, smem,
               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(pts), static_cast<const uint8_t*>(mask),
      static_cast<long long*>(idx), n, k);
  return (int)cudaGetLastError();
}

#ifdef NSC_KNN_COUNT
// The diagnostic build's counts (g_knn_counts), read and cleared.
extern "C" int nsc_knn_counts(unsigned long long* out) {
  cudaError_t err =
      cudaMemcpyFromSymbol(out, g_knn_counts, sizeof(g_knn_counts));
  if (err != cudaSuccess) return (int)err;
  const unsigned long long zero[4] = {};
  return (int)cudaMemcpyToSymbol(g_knn_counts, zero, sizeof(zero));
}
#endif

// The kernel's function, for the census of captured graphs
// (nsc_graph_census in project.cu).
extern "C" const void* nsc_knn_kernel_handle() {
  return reinterpret_cast<const void*>(knn_kernel);
}
