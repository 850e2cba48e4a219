// Shared device helpers for the projection kernels (project.cu, ring_fold.cu),
// and the per-device launch state every source keeps (current_device).
//
// The per-point formulas reproduce neural_spectral_codec_tpu/ops/range_image.py
// (_spherical, _valid_mask and the bin formulas of project_points) and
// ops/ring_path.py (_ring_keys) operation for operation, with the rounding
// PyTorch's own CUDA operators use, so that a kernel's image is bit-equal to
// its plain PyTorch version on the same card:
//   * every product and sum is rounded on its own (__fmul_rn / __fadd_rn /
//     __fsub_rn): nvcc would otherwise contract x*x + y*y into an FMA, which
//     PyTorch's separate elementwise kernels never do;
//   * divisions are IEEE (__fdiv_rn) and sqrt is IEEE (__fsqrt_rn), which
//     the plain version matches by rounding a float64 sqrt once
//     (ops/range_image.sqrt_f32);
//   * order as in JAX: az / (2*pi) * n_azim and (elev - emin) / span * n_elev;
//   * mod is fmod with a sign adjustment, as jnp.mod and torch.remainder are;
//   * float constants equal float(math.pi) and float(2 * math.pi);
//   * both angles are double atan2 rounded once to float (as
//     ops/range_image.atan2_f32): float atan2 differs by an ulp between
//     CUDA and the CPU libraries, which moves points near a bin edge into
//     the next pixel; the correctly rounded angle is the same everywhere.
#pragma once

#include <cuda_runtime.h>

namespace nsc {

constexpr float kPi = 3.141592653589793f;
constexpr float kTwoPi = 6.283185307179586f;
constexpr unsigned kInfBits = 0x7f800000u;   // bits of +inf (float)

struct Geometry {
  int n_elev;
  int n_azim;
  float min_range;
  float max_range;
  float elev_min;
  float elev_max;
  float elev_span;   // float(elevation_max - elevation_min), rounded once
  int drop;          // elevation_mode == "drop"
};

__device__ __forceinline__ float atan2_f32(float y, float x) {
  return __double2float_rn(atan2((double)y, (double)x));
}

// fmodf(t, kTwoPi) for |t| < 2 * kTwoPi, exactly: there fmod subtracts at
// most one kTwoPi, and that difference is exact (Sterbenz).
__device__ __forceinline__ float mod_two_pi(float t) {
  if (t >= kTwoPi) return __fsub_rn(t, kTwoPi);
  if (t <= -kTwoPi) return __fadd_rn(t, kTwoPi);
  return t;
}

// The azimuth bin of an angle in [-pi, pi]: mod 2*pi of angle + pi, then
// floor(az / 2*pi * n_azim), clipped, each step rounded as the JAX
// reference rounds it.
__device__ __forceinline__ int azimuth_bin_of(float angle, int n_azim) {
  float az = mod_two_pi(__fadd_rn(angle, kPi));
  if (az != 0.0f && az < 0.0f) az = __fadd_rn(az, kTwoPi);
  const int ab = (int)floorf(__fmul_rn(__fdiv_rn(az, kTwoPi), (float)n_azim));
  return min(max(ab, 0), n_azim - 1);
}

__device__ __forceinline__ float clip_sq(float v) {
  return fminf(fmaxf(__fmul_rn(v, v), 0.0f), 1e10f);
}

// Range, gates and bins of one point. Returns false for a point the gates
// drop (non-finite, out of the range band, or out of the elevation band in
// drop mode). The elevation bin is computed only when want_elev is set.
__device__ __forceinline__ bool project_point(float x, float y, float z,
                                              const Geometry& g, bool want_elev,
                                              float* range, int* az_bin,
                                              int* el_bin) {
  if (!(isfinite(x) && isfinite(y) && isfinite(z))) return false;
  const float xs = clip_sq(x), ys = clip_sq(y), zs = clip_sq(z);
  const float xy = __fadd_rn(xs, ys);
  const float rng = __fsqrt_rn(__fadd_rn(xy, zs));
  if (!(rng >= g.min_range && rng <= g.max_range)) return false;
  float elev = 0.0f;
  if (want_elev || g.drop) {
    elev = atan2_f32(z, __fsqrt_rn(xy));
    if (g.drop && !(elev >= g.elev_min && elev <= g.elev_max)) return false;
  }
  *az_bin = azimuth_bin_of(atan2_f32(y, x), g.n_azim);
  if (want_elev) {
    const float v = __fmul_rn(
        __fdiv_rn(__fsub_rn(elev, g.elev_min), g.elev_span), (float)g.n_elev);
    *el_bin = min(max((int)floorf(v), 0), g.n_elev - 1);
  }
  *range = rng;
  return true;
}

// Facts a launch needs that differ between devices (SM count, occupancy, the
// dynamic shared memory a kernel was opted into, which cudaFuncSetAttribute
// sets for the current device only) are kept in arrays of kMaxDevices
// entries, indexed by the device a launch runs on, and filled on that
// device's first launch.
constexpr int kMaxDevices = 64;

// The current device's ordinal in [0, kMaxDevices), or the error
// (cudaErrorInvalidDevice for an ordinal beyond the arrays).
inline cudaError_t current_device(int* dev) {
  const cudaError_t err = cudaGetDevice(dev);
  if (err != cudaSuccess) return err;
  return *dev >= 0 && *dev < kMaxDevices ? cudaSuccess
                                         : cudaErrorInvalidDevice;
}

}  // namespace nsc
