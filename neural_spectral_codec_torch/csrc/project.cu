// General projection: arbitrary-order points -> range image, per-pixel min.
//
// Replaces the TPU kernels neural_spectral_codec_tpu/ops/pallas_compact.py
// (_compact_kernel) and ops/pallas_densify.py (_kernel), together with the
// packed-key XLA sort before them (ops/range_image.py:145-249,
// _project_points_batch_compact). On the TPU, scatter is slow, so the min
// per pixel was a sort, a run-suffix-min, a compaction butterfly and an
// expansion butterfly. What they compute together is
//     image[b, elev_bin, az_bin] = min range over the valid points of scan b
//                                  in that pixel, 0 for an empty pixel
// (np.minimum.at semantics, range_image.project_points).
//
// What bounds it on the H100, at B = 8 full-density HDL-64E scans (133,632
// points x 16 B): it reads 17,104,896 B of points and writes 737,280 B of
// image, 5.33 us at 3.35 TB/s (0.67 us at B = 1). In practice the per-point
// instructions bound it: two angles per point, a range and a radius square
// root, and a scattered atomic each (PERF.md, K3).
//
// Design: ONE cooperative launch per call, which writes every pixel of the
// output (allocated with torch.empty) once.
//   1. As many CTAs of 512 threads as fit the card at once. They take
//      chunks of a scan's points from a work counter (the next chunk is
//      asked for while the current one runs) and take an atomicMin on the
//      uint32 bits of each valid range in a global scratch image of the
//      scan (valid ranges are >= min_range >= 0, so the bit order of
//      non-negative floats is their value order). Points come in 16-byte
//      float4 loads when they have 4 channels.
//   2. Bins without float64 angles, bit-equal all the same. A float32
//      polynomial guesses each angle (within 2e-6 rad); the guess is then
//      walked against a table of the exact edges of the plain version's
//      bins (projection_kernel.azimuth_edges / elevation_edges: the
//      float32 angles where a bin steps, each given by the cosine and sine
//      of its rounding boundary as float32 hi + lo pairs). The side of an
//      edge is the sign of u cos m - v sin m, computed with exactly split
//      products; a bin counts only when the edges on both sides are
//      cleared by a margin that covers every rounding, so any float64
//      atan2 of the point rounds into it. Points within 2^-40 of an edge
//      (or a guess two bins off) are deferred to the float64 path of
//      common.cuh at the end of their chunk.
//   3. A grid barrier (one acquire-release arrival per CTA; the last one
//      advances a generation the others wait on), then every CTA decodes a
//      share of the scratch images into the output, +inf -> 0, and sets
//      them back to +inf. The kernel leaves the scratch at +inf and its
//      control words at 0: the wrapper allocates both once per device,
//      stream and shape (projection_kernel.scratch_for).
// Measured against it, in turns on an H100 (PERF.md, K3): a private image
// per CTA in shared memory merged over distributed shared memory or into
// the scratch, clusters of 8 and 16 CTAs, a last-CTA decode, float64
// angles and atan2f guesses with float64 checks.
#include <cstdint>
#include <vector>

#include "common.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kMaxChunk = 1024;   // points; projection_kernel.MAX_CHUNK

struct Plan {
  long long n_points;   // points per scan
  int n_chan;
  int vec4;             // 4 channels on a 16-byte aligned base: float4 loads
  int batch;
  int chunks;           // chunks per scan
  int per_chunk;        // points per chunk (the last chunk may get fewer)
  int n_quads;          // 16-byte words of one scan's image (padded)
};

struct Edges {
  const float4* az;     // (n_azim,) cos m hi, lo, sin m hi, lo per edge
  const float4* el;     // (n_el,) the same for the elevation edges
  int n_el;
  float az_scale;       // n_azim / 2 pi, for the guess
  float el_scale;       // n_elev / span, for the guess
};

// Control words, each on its own 128-byte line: arrivals at the barrier
// and the next chunk to take (both left at 0), the barrier's generation.
constexpr int kArrivals = 0, kGeneration = 32, kNextChunk = 64;

__device__ __forceinline__ float decode(unsigned bits) {
  return bits == nsc::kInfBits ? 0.0f : __uint_as_float(bits);
}

// Word q of the image (pixels 4q .. 4q+3) into the scan's output, +inf -> 0.
__device__ __forceinline__ void store_word(float* out, int q, const uint4& m,
                                           int n_pix) {
  if (n_pix % 4 == 0) {
    reinterpret_cast<float4*>(out)[q] =
        make_float4(decode(m.x), decode(m.y), decode(m.z), decode(m.w));
    return;
  }
  const unsigned v[4] = {m.x, m.y, m.z, m.w};
#pragma unroll
  for (int k = 0; k < 4; ++k)
    if (4 * q + k < n_pix) out[4 * q + k] = decode(v[k]);
}

// u cos m - v sin m for an edge (cos m, sin m) = (c.x + c.y, c.z + c.w), in
// float32 with the products split exactly (FMA): off by at most
// 2^-23 |result| + 2^-45 (|u| + |v|), so a result beyond 2^-40 (|u| + |v|)
// has the sign of sin(atan2(u, v) - m), and every float64 atan2 of (u, v)
// lies on that side of m.
__device__ __forceinline__ float edge_side(float u, float v, const float4& c) {
  const float p1 = __fmul_rn(u, c.x), p2 = __fmul_rn(v, c.z);
  const float e1 = __fmaf_rn(u, c.x, -p1), e2 = __fmaf_rn(v, c.z, -p2);
  const float small = __fadd_rn(__fsub_rn(e1, e2),
                                __fsub_rn(__fmul_rn(u, c.y), __fmul_rn(v, c.w)));
  return __fadd_rn(__fsub_rn(p1, p2), small);
}

// A guess of atan2(y, x) within 2e-6 rad: an odd minimax polynomial of
// min/max over the octant, then the octant's reflections.
__device__ __forceinline__ float atan2_guess(float y, float x) {
  const float ax = fabsf(x), ay = fabsf(y);
  const float t = __fdividef(fminf(ax, ay), fmaxf(ax, ay));
  const float t2 = t * t;
  float p = -0.01172120f;
  p = fmaf(p, t2, 0.05265332f);
  p = fmaf(p, t2, -0.11643287f);
  p = fmaf(p, t2, 0.19354346f);
  p = fmaf(p, t2, -0.33262347f);
  p = fmaf(p, t2, 0.99997726f);
  float r = p * t;
  r = ay > ax ? 1.57079637f - r : r;
  r = x < 0.0f ? 3.14159274f - r : r;
  return copysignf(r, y);
}

// The level of atan2(u, v) among the k edges of a table (the number of
// edges it lies above), from a guess, stepping at most once: confirmed
// only when the edges on both sides are cleared; -1 otherwise.
__device__ __forceinline__ int edge_walk(float u, float v, int level, int k,
                                         const float4* __restrict__ table,
                                         float margin) {
#pragma unroll 1
  for (int step = 0; step < 2; ++step) {
    const float lo = level > 0 ? edge_side(u, v, __ldg(table + level - 1))
                               : INFINITY;
    const float hi = level < k ? edge_side(u, v, __ldg(table + level))
                               : -INFINITY;
    if (lo > margin && hi < -margin) return level;
    if (lo < -margin && level > 0) --level;
    else if (hi > margin && level < k) ++level;
    else return -1;
  }
  return -1;
}

// Pixel and range bits of a point: .x = pixel, -1 for a point the gates
// drop, -2 for one whose bins are not confirmed (the float64 path decides).
__device__ __forceinline__ int2 point_pixel(float x, float y, float z,
                                            const nsc::Geometry& g,
                                            const Edges& e) {
  if (!(isfinite(x) && isfinite(y) && isfinite(z))) return make_int2(-1, 0);
  const float xy = __fadd_rn(nsc::clip_sq(x), nsc::clip_sq(y));
  const float rng = __fsqrt_rn(__fadd_rn(xy, nsc::clip_sq(z)));
  if (!(rng >= g.min_range && rng <= g.max_range)) return make_int2(-1, 0);
  const float s = __fsqrt_rn(xy);
  const int n_az = g.n_azim, n_el = e.n_el;
  const float ta = atan2_guess(y, x), te = atan2_guess(z, s);
  const int ga = min(max((int)floorf((ta + nsc::kPi) * e.az_scale), 0), n_az);
  const int ge = min(
      max((int)floorf((te - g.elev_min) * e.el_scale) + g.drop, 0), n_el);
  const float na = fabsf(x) + fabsf(y), ne = fabsf(z) + s;
  // azimuth levels: 0 .. n_az - 1 are the bins, n_az wraps to bin 0; the
  // two ends of the circle also need the sign of y
  int la = na > 0x1p-60f ? edge_walk(y, x, ga, n_az, e.az, na * 0x1p-40f) : -1;
  if ((la == 0 && !(y < 0.0f)) || (la == n_az && !(y > 0.0f))) la = -1;
  // elevation levels: the bins in clip mode; in drop mode 0 and n_el are
  // outside the band and level l keeps bin l - 1
  const int le =
      ne > 0x1p-60f ? edge_walk(z, s, ge, n_el, e.el, ne * 0x1p-40f) : -1;
  if (la < 0 || le < 0) return make_int2(-2, 0);
  int row = le;
  if (g.drop) {
    if (le == 0 || le == n_el) return make_int2(-1, 0);
    row = le - 1;
  }
  return make_int2(row * n_az + (la == n_az ? 0 : la), __float_as_int(rng));
}

// The float64 path (common.cuh), out of line: rarely taken.
__device__ __noinline__ int2 exact_pixel(float x, float y, float z,
                                         nsc::Geometry g) {
  float rng = 0.0f;
  int ab = 0, eb = 0;
  if (!nsc::project_point(x, y, z, g, true, &rng, &ab, &eb))
    return make_int2(-1, 0);
  return make_int2(eb * g.n_azim + ab, __float_as_int(rng));
}

__device__ __forceinline__ float4 load_point(const float* p, long long i,
                                             const Plan& plan) {
  if (plan.vec4) return __ldg(reinterpret_cast<const float4*>(p) + i);
  const float* v = p + i * plan.n_chan;
  return make_float4(__ldg(v), __ldg(v + 1), __ldg(v + 2), 0.0f);
}

__device__ __forceinline__ unsigned atom_add_acq_rel(unsigned* p, unsigned v) {
  unsigned old;
  asm volatile("atom.acq_rel.gpu.global.add.u32 %0, [%1], %2;"
               : "=r"(old) : "l"(p), "r"(v) : "memory");
  return old;
}
__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];"
               : "=r"(v) : "l"(p) : "memory");
  return v;
}
__device__ __forceinline__ unsigned ld_relaxed(const unsigned* p) {
  unsigned v;
  asm volatile("ld.relaxed.gpu.global.u32 %0, [%1];"
               : "=r"(v) : "l"(p) : "memory");
  return v;
}
__device__ __forceinline__ void st_relaxed(unsigned* p, unsigned v) {
  asm volatile("st.relaxed.gpu.global.u32 [%0], %1;" :: "l"(p), "r"(v)
               : "memory");
}
__device__ __forceinline__ void red_release_add(unsigned* p, unsigned v) {
  asm volatile("red.release.gpu.global.add.u32 [%0], %1;" :: "l"(p), "r"(v)
               : "memory");
}

__global__ void __launch_bounds__(kThreads)
project_points_kernel(const float* __restrict__ pts, float* __restrict__ img,
                      unsigned* __restrict__ scratch,
                      unsigned* __restrict__ ctl, Plan plan, nsc::Geometry g,
                      Edges e) {
  __shared__ int chunk;
  __shared__ int n_defer;
  __shared__ int defer[kMaxChunk];
  const int tid = threadIdx.x;
  const int n_pix = g.n_elev * g.n_azim;
  const int total = plan.batch * plan.chunks;
  unsigned gen0 = 0, next = 0;
  if (tid == 0) {
    gen0 = ld_relaxed(ctl + kGeneration);   // cannot move before we arrive
    chunk = (int)atomicAdd(ctl + kNextChunk, 1u);
    n_defer = 0;
  }
  __syncthreads();

  // 1-2. chunks of points: scatter-min into the scan's scratch image
  for (int c = chunk; c < total; c = chunk) {
    if (tid == 0) next = atomicAdd(ctl + kNextChunk, 1u);   // ahead of need
    const int b = c / plan.chunks;
    const long long lo = (long long)(c - b * plan.chunks) * plan.per_chunk;
    const long long hi = min(lo + plan.per_chunk, plan.n_points);
    const float* p = pts + (long long)b * plan.n_points * plan.n_chan;
    unsigned* sc = scratch + (long long)b * plan.n_quads * 4;
    for (long long i = lo + tid; i < hi; i += kThreads) {
      const float4 v = load_point(p, i, plan);
      const int2 hit = point_pixel(v.x, v.y, v.z, g, e);
      if (hit.x >= 0) atomicMin(sc + hit.x, (unsigned)hit.y);
      else if (hit.x == -2) defer[atomicAdd(&n_defer, 1)] = (int)(i - lo);
    }
    __syncthreads();
    if (n_defer > 0) {
      for (int k = tid; k < n_defer; k += kThreads) {
        const float4 v = load_point(p, lo + defer[k], plan);
        const int2 hit = exact_pixel(v.x, v.y, v.z, g);
        if (hit.x >= 0) atomicMin(sc + hit.x, (unsigned)hit.y);
      }
      __syncthreads();
      if (tid == 0) n_defer = 0;
    }
    if (tid == 0) chunk = (int)next;
    __syncthreads();
  }

  // 3. grid barrier: the last CTA to arrive resets the control words and
  // advances the generation; its acquire-release arrival orders every
  // CTA's atomics before the decode
  if (tid == 0) {
    if (atom_add_acq_rel(ctl + kArrivals, 1u) == gridDim.x - 1) {
      st_relaxed(ctl + kArrivals, 0u);
      st_relaxed(ctl + kNextChunk, 0u);
      red_release_add(ctl + kGeneration, 1u);
    } else {
      while (ld_acquire(ctl + kGeneration) == gen0) {
      }
    }
  }
  __syncthreads();
  const uint4 inf4 = make_uint4(nsc::kInfBits, nsc::kInfBits, nsc::kInfBits,
                                nsc::kInfBits);
  uint4* sc4 = reinterpret_cast<uint4*>(scratch);
  const long long words = (long long)plan.batch * plan.n_quads;
  for (long long w = (long long)blockIdx.x * kThreads + tid; w < words;
       w += (long long)gridDim.x * kThreads) {
    const uint4 m = __ldcg(sc4 + w);
    __stcg(sc4 + w, inf4);
    const int b = (int)(w / plan.n_quads);
    store_word(img + (long long)b * n_pix,
               (int)(w - (long long)b * plan.n_quads), m, n_pix);
  }
}

// CTAs that fit each device at once, read on its first launch (0: not yet)
int g_grid[nsc::kMaxDevices] = {};

}  // namespace

// points (B, N, n_chan) float32 contiguous; img (B, n_elev, n_azim) float32,
// every pixel written here; scratch (B, 4 * n_quads) uint32 at +inf and
// control (96,) uint32 at 0, left so; az_edges (n_azim, 4) and el_edges
// (n_el, 4) float32 (projection_kernel.edge_table); per_chunk <= 1024.
// Returns the launch's cudaError_t.
extern "C" int nsc_project_points(
    const void* points, void* img, void* scratch, void* control,
    const void* az_edges, const void* el_edges, int n_el, int batch,
    long long n_points, int n_chan, int chunks, int per_chunk, int n_quads,
    int n_elev, int n_azim, float min_range, float max_range, float elev_min,
    float elev_max, float elev_span, int drop, void* stream) {
  if (per_chunk > kMaxChunk) return (int)cudaErrorInvalidValue;
  int dev = 0;
  cudaError_t dev_err = nsc::current_device(&dev);
  if (dev_err != cudaSuccess) return (int)dev_err;
  if (g_grid[dev] == 0) {
    int sms = 0, per_sm = 0;
    cudaError_t err =
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, project_points_kernel, kThreads, 0);
    if (err != cudaSuccess) return (int)err;
    g_grid[dev] = per_sm * sms;
  }
  const nsc::Geometry g{n_elev, n_azim, min_range, max_range,
                        elev_min, elev_max, elev_span, drop};
  const int vec4 =
      n_chan == 4 && reinterpret_cast<std::uintptr_t>(points) % 16 == 0;
  const Plan plan{n_points, n_chan, vec4, batch, chunks, per_chunk, n_quads};
  const Edges e{static_cast<const float4*>(az_edges),
                static_cast<const float4*>(el_edges), n_el,
                (float)n_azim * 0.159154943f, (float)n_elev / elev_span};
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(g_grid[dev], 1, 1);  // co-resident: the barrier needs it
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(
      &cfg, project_points_kernel, static_cast<const float*>(points),
      static_cast<float*>(img), static_cast<unsigned*>(scratch),
      static_cast<unsigned*>(control), plan, g, e);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

extern "C" const void* nsc_spectral_kernel_handle();
extern "C" const void* nsc_ring_fold_kernel_handle(int slot);
extern "C" const void* nsc_nearest_kernel_handle();
extern "C" const void* nsc_knn_kernel_handle();
extern "C" const void* nsc_knn_pca_kernel_handle();
extern "C" const void* nsc_kabsch_kernel_handle();
extern "C" const void* nsc_mine_kernel_handle(int which);
extern "C" const void* nsc_gather_bwd_kernel_handle(int dtype);

// Census of a captured CUDA graph (a cudaGraph_t: the serving executables of
// models/serving.py, the registration and prepare executables of
// retrieval/verification.py, the mining and train-step executables of
// training/), read back from its nodes. out (kCensusWords,):
//   0 nodes, 1 kernel nodes, 2 memcpy nodes, 3 memset nodes, 4 other nodes,
//   5 nodes of this file's kernel, 6 of those with the cooperative launch
//   attribute set (its grid barrier needs every CTA resident at once),
//   7 spectral-kernel nodes, 8 the cluster width its function requires
//   (__cluster_dims__; 0 none), 9 the cluster-dimension attribute of its
//   last node (x; 0 when the launch set none), 10 ring-fold nodes,
//   11 kernel nodes whose parameters the runtime could not read,
//   12 nearest-neighbour nodes (nearest.cu), 13 k-NN nodes (knn.cu),
//   14 the cluster width the nearest-neighbour function requires
//   (__cluster_dims__; 0 none), read when the graph holds one,
//   15 k-NN PCA nodes (knn_pca.cu), 16 point-to-point update nodes
//   (kernel R, kabsch.cu; its solve-only entry is not counted),
//   17 and 18 the two mining kernels' nodes (counts and hard negatives, the
//   draw; kernel M, mine.cu), 19 row-gather backward nodes (kernel G,
//   gather_bwd.cu, either type).
// Returns the first error of the graph queries (cudaSuccess: out is whole).
constexpr int kCensusWords = 20;

extern "C" int nsc_graph_census(void* graph_handle, long long* out) {
  for (int i = 0; i < kCensusWords; ++i) out[i] = 0;
  const auto graph = static_cast<cudaGraph_t>(graph_handle);
  size_t n = 0;
  cudaError_t err = cudaGraphGetNodes(graph, nullptr, &n);
  if (err != cudaSuccess) return (int)err;
  std::vector<cudaGraphNode_t> nodes(n);
  if (n > 0) {
    err = cudaGraphGetNodes(graph, nodes.data(), &n);
    if (err != cudaSuccess) return (int)err;
  }
  const void* project = reinterpret_cast<const void*>(project_points_kernel);
  const void* spectral = nsc_spectral_kernel_handle();
  const void* ring[2] = {nsc_ring_fold_kernel_handle(0),
                         nsc_ring_fold_kernel_handle(1)};
  const void* nearest = nsc_nearest_kernel_handle();
  const void* knn = nsc_knn_kernel_handle();
  const void* knn_pca = nsc_knn_pca_kernel_handle();
  const void* kabsch = nsc_kabsch_kernel_handle();
  const void* mine[2] = {nsc_mine_kernel_handle(0), nsc_mine_kernel_handle(1)};
  const void* gather_bwd[2] = {nsc_gather_bwd_kernel_handle(0),
                               nsc_gather_bwd_kernel_handle(1)};
  out[0] = (long long)n;
  for (size_t i = 0; i < n; ++i) {
    cudaGraphNodeType type;
    err = cudaGraphNodeGetType(nodes[i], &type);
    if (err != cudaSuccess) return (int)err;
    if (type == cudaGraphNodeTypeMemcpy) { ++out[2]; continue; }
    if (type == cudaGraphNodeTypeMemset) { ++out[3]; continue; }
    if (type != cudaGraphNodeTypeKernel) { ++out[4]; continue; }
    ++out[1];
    cudaKernelNodeParams params = {};
    if (cudaGraphKernelNodeGetParams(nodes[i], &params) != cudaSuccess) {
      cudaGetLastError();   // a kernel the runtime cannot describe: count it
      ++out[11];
      continue;
    }
    if (params.func == project) {
      ++out[5];
      cudaLaunchAttributeValue v = {};
      err = cudaGraphKernelNodeGetAttribute(
          nodes[i], cudaLaunchAttributeCooperative, &v);
      if (err != cudaSuccess) return (int)err;
      out[6] += v.cooperative != 0;
    } else if (params.func == spectral) {
      ++out[7];
      cudaFuncAttributes attrs = {};
      err = cudaFuncGetAttributes(&attrs, spectral);
      if (err != cudaSuccess) return (int)err;
      out[8] = attrs.requiredClusterWidth;
      cudaLaunchAttributeValue v = {};
      err = cudaGraphKernelNodeGetAttribute(
          nodes[i], cudaLaunchAttributeClusterDimension, &v);
      if (err != cudaSuccess) return (int)err;
      out[9] = v.clusterDim.x;
    } else if (params.func == ring[0] || params.func == ring[1]) {
      ++out[10];
    } else if (params.func == nearest) {
      ++out[12];
      cudaFuncAttributes attrs = {};
      err = cudaFuncGetAttributes(&attrs, nearest);
      if (err != cudaSuccess) return (int)err;
      out[14] = attrs.requiredClusterWidth;
    } else if (params.func == knn) {
      ++out[13];
    } else if (params.func == knn_pca) {
      ++out[15];
    } else if (params.func == kabsch) {
      ++out[16];
    } else if (params.func == mine[0]) {
      ++out[17];
    } else if (params.func == mine[1]) {
      ++out[18];
    } else if (params.func == gather_bwd[0] || params.func == gather_bwd[1]) {
      ++out[19];
    }
  }
  return (int)cudaSuccess;
}

extern "C" const char* nsc_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
