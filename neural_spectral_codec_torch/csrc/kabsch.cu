// Kernel R: the weighted Kabsch solve of one point-to-point ICP step.
//
// Not a Pallas kernel: the hand-written form of the SVD step inside the
// JAX package's registration program,
// neural_spectral_codec_tpu/retrieval/verification.py _icp_kernel p2p_step
// (:133-146):
//     U, S, V^T = svd(H),  d = sign(det(V U^T)),
//     R = V diag(1, 1, d) U^T,  t = q_c - R p_c,  Tn = [R t; 0 0 0 1]
// from H (3 x 3) = sum_i w_i (p_i - p_c)(q_i - q_c)^T and the weighted
// centroids p_c, q_c (3,), which the step forms with torch reductions.
// That R is the proper rotation that maximises trace(R H). So is the one
// of Horn's unit quaternion (Horn 1987, "Closed-form solution of absolute
// orientation using unit quaternions"): the eigenvector of the largest
// eigenvalue of the symmetric 4 x 4
//     [ Sxx+Syy+Szz  Syz-Szy      Szx-Sxz      Sxy-Syx     ]
//     [ Syz-Szy      Sxx-Syy-Szz  Sxy+Syx      Szx+Sxz     ]
//     [ Szx-Sxz      Sxy+Syx     -Sxx+Syy-Szz  Syz+Szy     ]
//     [ Sxy-Syx      Szx+Sxz      Syz+Szy     -Sxx-Syy+Szz ]
// with S = H, solved here with sym3.cuh's Jacobi in float64 in one
// thread's registers, so that neither svd nor det (both of which copy
// through the host in PyTorch's CUDA path) is left in the step. Where the
// optimum is unique (H of rank 2 or 3 whose two smaller singular values
// differ, a reflection included) the two formulas give the same R; for
// H = 0 (no point matched) the Jacobi solve leaves the identity and the
// first of the four equal eigenvalues is taken, q = (1, 0, 0, 0), R = I,
// as JAX's SVD of 0 gives; for H of rank 1 every rotation that maps the
// one direction onto the other is optimal and the kernel returns one of
// them, a proper rotation. R and t are computed in float64 and rounded
// once. The plain version is retrieval/pca_kernel.py kabsch_plain: JAX's
// formula with torch.linalg.svd and det.
//
// What bounds it: neither bytes (124) nor operations; it is one thread's
// chain of dependent float64 work (48 rotations at most, most skipped
// once converged), a few microseconds, one node of the registration graph
// per iteration. One launch of one warp, lane 0 working.
#include "sym3.cuh"

namespace {

__global__ void __launch_bounds__(32)
    kabsch_kernel(const float* __restrict__ h, const float* __restrict__ pc,
                  const float* __restrict__ qc, float* __restrict__ t_out) {
  if (threadIdx.x != 0) return;
  const double sxx = h[0], sxy = h[1], sxz = h[2];
  const double syx = h[3], syy = h[4], syz = h[5];
  const double szx = h[6], szy = h[7], szz = h[8];
  double a[4][4] = {
      {sxx + syy + szz, syz - szy, szx - sxz, sxy - syx},
      {syz - szy, sxx - syy - szz, sxy + syx, szx + sxz},
      {szx - sxz, sxy + syx, -sxx + syy - szz, syz + szy},
      {sxy - syx, szx + sxz, syz + szy, -sxx - syy + szz}};
  double v[4][4];
  nsc::jacobi_eigen<4>(a, v);
  // the eigenvector of the largest eigenvalue, the first of equal ones
  int top = 0;
  double best = a[0][0];
#pragma unroll
  for (int j = 1; j < 4; ++j) {
    if (a[j][j] > best) {
      best = a[j][j];
      top = j;
    }
  }
  double q[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    q[r] = top == 0 ? v[r][0]
                    : (top == 1 ? v[r][1] : (top == 2 ? v[r][2] : v[r][3]));
  }
  const double inv =
      1.0 / sqrt(q[0] * q[0] + q[1] * q[1] + q[2] * q[2] + q[3] * q[3]);
  const double w = q[0] * inv, x = q[1] * inv, y = q[2] * inv,
               z = q[3] * inv;
  const double rot[3][3] = {
      {w * w + x * x - y * y - z * z, 2.0 * (x * y - w * z),
       2.0 * (x * z + w * y)},
      {2.0 * (y * x + w * z), w * w - x * x + y * y - z * z,
       2.0 * (y * z - w * x)},
      {2.0 * (z * x - w * y), 2.0 * (z * y + w * x),
       w * w - x * x - y * y + z * z}};
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    const double tr = static_cast<double>(qc[r]) - (rot[r][0] * pc[0] +
                                                    rot[r][1] * pc[1] +
                                                    rot[r][2] * pc[2]);
#pragma unroll
    for (int s = 0; s < 3; ++s) {
      t_out[4 * r + s] = static_cast<float>(rot[r][s]);
    }
    t_out[4 * r + 3] = static_cast<float>(tr);
  }
  t_out[12] = 0.0f;
  t_out[13] = 0.0f;
  t_out[14] = 0.0f;
  t_out[15] = 1.0f;
}

}  // namespace

// h (3, 3), pc (3,), qc (3,) float32 in, t_out (4, 4) float32 row-major
// out, all on the current device; launched on `stream`.
extern "C" int nsc_kabsch(const void* h, const void* pc, const void* qc,
                          void* t_out, void* stream) {
  kabsch_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(h), static_cast<const float*>(pc),
      static_cast<const float*>(qc), static_cast<float*>(t_out));
  return (int)cudaGetLastError();
}

// The kernel's function, for the census of captured graphs
// (nsc_graph_census in project.cu).
extern "C" const void* nsc_kabsch_kernel_handle() {
  return reinterpret_cast<const void*>(kabsch_kernel);
}
