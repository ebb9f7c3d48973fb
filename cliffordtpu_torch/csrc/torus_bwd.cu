// Clifford-torus embedding, backward, for sm_90a, with the keyed sampler's
// concentration gradient as an optional epilogue.
//
// Replaces cliffordtpu/kernels/torus_pallas.py::_bwd_kernel (the
// pallas_call in _torus_fused_bwd), which is also the d theta of the fused
// samplers' custom VJP (sampler_pallas.py::_sample_embed_bwd).  For every
// row r of R latents with d angles, every free angle k = 1..d-1 and the
// output gradient g (R, 2d):
//
//   gc = sum_col g[r, col] C[k, col],  gs = sum_col g[r, col] S[k, col]
//   dtheta[r, k] = -sin(theta[r, k]) gc + cos(theta[r, k]) gs
//
// with the transposed basis made on the device (torus_basis.cuh, the roles
// of k and col swapped against the forward).  When the sampler's residuals
// u, v and its concentration kappa are given, the same launch also writes
//
//   dkappa = dtheta * 2 * [2 c / (1 + c^2 w)] * [1 / (2 sqrt(max(w, 1e-30)))]
//                   * (2 ln u / nu^2) (1 + w)
//   c = cos(2 pi v), w = expm1(-(2/nu) ln u), nu = 2 (kappa + 1e-7) + 1
//
// which the TPU package computes as elementwise XLA ops after its kernel;
// fusing it saves about fifteen launches per training step.
//
// dtheta and dkappa are written at a leading dimension and a column offset
// the caller chooses: (R, d-1) tight for the embedding's own backward, or
// (R, d) with column 0 set to zero for the sampler's (angle 0 is pinned, so
// loc[:, 0] and kappa[:, 0] get no gradient).
//
// What bounds it: at the flagship shape (R = 4096, d = 16) the function
// moves about 1.6 MB, half a microsecond of HBM time, so the kernel is
// bound by its instructions (an accurate sincosf per basis term, as in the
// forward sampler kernel) and its launch.  One thread per (row, angle) sums
// over the 2d columns of its row's g, staged in shared memory, with the
// basis value in registers: no basis in HBM and one launch.  The work is
// O(R d 2d) scalar: fine at d = 16; large latents (d in the thousands)
// need a tensor-core GEMM whose basis operand is synthesised in shared
// memory.

#include <cuda_runtime.h>

#include "torus_basis.cuh"

namespace {

__global__ void torus_bwd_kernel(
    const float* __restrict__ theta, const float* __restrict__ g,
    float* __restrict__ dtheta, int ld, int off, const float* __restrict__ u,
    const float* __restrict__ v, const float* __restrict__ kappa,
    int kap_row_stride, int kap_col_stride, float* __restrict__ dkappa, int R,
    int d, int rows_per_block) {
  extern __shared__ float gsm[];  // rows_per_block x 2d
  const int m = d - 1;            // free angles 1..d-1
  const int n = 2 * d;
  const int row0 = blockIdx.x * rows_per_block;
  const int rows = min(rows_per_block, R - row0);

  for (int e = threadIdx.x; e < rows * n; e += blockDim.x)
    gsm[e] = g[(size_t)row0 * n + e];
  __syncthreads();

  const float step = torus_phase_step(d);
  for (int e = threadIdx.x; e < rows * m; e += blockDim.x) {
    const int lr = e / m;
    const int k = e % m + 1;
    const int r = row0 + lr;
    const float* gr = gsm + lr * n;
    float gc = 0.0f, gs = 0.0f;
    for (int col = 0; col < n; ++col) {
      float cb, sb;
      torus_basis(k, col, d, step, &cb, &sb);
      gc = fmaf(gr[col], cb, gc);
      gs = fmaf(gr[col], sb, gs);
    }
    const size_t i = (size_t)r * m + (k - 1);
    float st, ct;
    sincosf(theta[i], &st, &ct);
    const float dth = -st * gc + ct * gs;
    const size_t o = (size_t)r * ld + off + (k - 1);
    dtheta[o] = dth;
    if (off > 0 && k == 1) dtheta[(size_t)r * ld] = 0.0f;
    if (dkappa != nullptr) {
      const float kap =
          kappa[(size_t)r * kap_row_stride + (size_t)k * kap_col_stride];
      const float nu = 2.0f * (kap + 1e-7f) + 1.0f;
      const float lnu = logf(u[i]);
      const float w = expm1f((-2.0f / nu) * lnu);
      const float c = cosf((float)6.283185307179586476925 * v[i]);
      const float sqw = sqrtf(fmaxf(w, 1e-30f));
      const float dth_dnu = (2.0f * c / (1.0f + c * c * w)) *
                            (1.0f / (2.0f * sqw)) *
                            ((2.0f * lnu / (nu * nu)) * (1.0f + w));
      dkappa[o] = dth * dth_dnu * 2.0f;  // d nu / d kappa = 2
      if (off > 0 && k == 1) dkappa[(size_t)r * ld] = 0.0f;
    }
  }
}

}  // namespace

// C ABI, bound with ctypes by cliffordtpu_torch/kernels/torus.py.
// theta (R, d-1) and g (R, 2d) float32 and contiguous; dtheta written at
// r*ld + off + (k-1), with column 0 zeroed when off is 1.  u, v (R, d-1),
// kappa (read at r*kap_row_stride + k*kap_col_stride, k = 1..d-1) and
// dkappa (laid out as dtheta) are all given or all null.  The wrapper keeps
// rows_per_block * 2d floats within 48 KB of shared memory.  Returns
// cudaGetLastError() after the launch.
extern "C" int torus_bwd(const float* theta, const float* g, float* dtheta,
                         int ld, int off, const float* u, const float* v,
                         const float* kappa, int kap_row_stride,
                         int kap_col_stride, float* dkappa, int R, int d,
                         int rows_per_block, void* stream) {
  const size_t smem = (size_t)rows_per_block * 2 * d * sizeof(float);
  const int blocks = (R + rows_per_block - 1) / rows_per_block;
  torus_bwd_kernel<<<blocks, 256, smem, (cudaStream_t)stream>>>(
      theta, g, dtheta, ld, off, u, v, kappa, kap_row_stride, kap_col_stride,
      dkappa, R, d, rows_per_block);
  return (int)cudaGetLastError();
}
