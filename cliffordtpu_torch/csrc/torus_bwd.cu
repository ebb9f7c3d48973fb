// Clifford-torus embedding, backward, for sm_90a, with the fused samplers'
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
// with the basis looked up in the shared-memory table of torus_basis.cuh
// (the roles of k and col swapped against the forward).  When the sampler's
// residuals u, v and its concentration kappa are given, the same launch
// also writes
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
// What bounds it: operations.  At R = 64, d = 4096 the function moves
// 7.3 MB with the epilogue (2 microseconds of HBM time) and does 8.6 GFLOP
// of float32 multiply-adds (0.13 ms at the CUDA cores' peak); at the
// flagship shape (R = 4096, d = 16) both are under a microsecond and the
// launch is what is left.  One block owns 64 rows x 32 angles: a warp owns 2
// angles, lane l rows l and l + 32, so a basis lookup is one address per
// warp shared by 64 rows and 8 accumulators.  The block walks the 2d
// columns of its rows' g in chunks of 64 staged through shared memory
// (each block reads its rows' g once; the 128 angle tiles of a row tile at
// d = 4096 read it from L2).

#include <cuda_runtime.h>

#include "torus_basis.cuh"

namespace {

__global__ void __launch_bounds__(kTorusThreads) torus_bwd_kernel(
    const float* __restrict__ theta, const float* __restrict__ g,
    float* __restrict__ dtheta, int ld, int off, const float* __restrict__ u,
    const float* __restrict__ v, const float* __restrict__ kappa,
    int kap_row_stride, int kap_col_stride, float* __restrict__ dkappa, int R,
    int d) {
  extern __shared__ __align__(16) float smem[];
  const int m = d - 1;  // free angles 1..d-1
  const int n = 2 * d;
  float2* tab = reinterpret_cast<float2*>(smem);
  float* gsm = smem + 2 * n;  // kTorusChunk columns x kTorusPitch
  const int row0 = blockIdx.x * kTorusRows;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int k_first = 1 + blockIdx.y * kTorusAngles + warp * kTorusApw;
  torus_table_fill(tab, d);
  const char* tab_bytes = reinterpret_cast<const char*>(tab);
  const int n8 = n * (int)sizeof(float2);
  // the phase of angle j at the current column, and its step per column,
  // both in bytes of the table
  int kj[kTorusApw], idx[kTorusApw];
  float gc0[kTorusApw], gs0[kTorusApw], gc1[kTorusApw], gs1[kTorusApw];
#pragma unroll
  for (int j = 0; j < kTorusApw; ++j) {
    // an angle past the end steps by 0
    kj[j] = k_first + j <= m ? (k_first + j) * (int)sizeof(float2) : 0;
    idx[j] = 0;  // (k * col) mod n at col 0
    gc0[j] = gs0[j] = gc1[j] = gs1[j] = 0.0f;
  }
  for (int c0 = 0; c0 < n; c0 += kTorusChunk) {
    const int cc_n = min(kTorusChunk, n - c0);
    __syncthreads();  // the table is filled; the last chunk is consumed
    for (int e = threadIdx.x; e < kTorusRows * kTorusChunk; e += blockDim.x) {
      const int cc = e % kTorusChunk;
      const int lr = e / kTorusChunk;
      const int r = row0 + lr;
      gsm[cc * kTorusPitch + lr] =
          (cc < cc_n && r < R) ? g[(size_t)r * n + c0 + cc] : 0.0f;
    }
    __syncthreads();
    if (k_first > m) continue;
#pragma unroll kTorusUnroll
    for (int cc = 0; cc < cc_n; ++cc) {
      const float g0 = gsm[cc * kTorusPitch + lane];
      const float g1 = gsm[cc * kTorusPitch + lane + 32];
#pragma unroll
      for (int j = 0; j < kTorusApw; ++j) {
        const float2 t = *reinterpret_cast<const float2*>(tab_bytes + idx[j]);
        gc0[j] = fmaf(g0, t.x, gc0[j]);
        gs0[j] = fmaf(g0, t.y, gs0[j]);
        gc1[j] = fmaf(g1, t.x, gc1[j]);
        gs1[j] = fmaf(g1, t.y, gs1[j]);
        idx[j] += kj[j];  // col + 1
        if (idx[j] >= n8) idx[j] -= n8;
      }
    }
  }
#pragma unroll
  for (int j = 0; j < kTorusApw; ++j) {
    const int k = k_first + j;
    if (k > m) continue;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = row0 + lane + 32 * half;
      if (r >= R) continue;
      const float gc = half ? gc1[j] : gc0[j];
      const float gs = half ? gs1[j] : gs0[j];
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
}

}  // namespace

// C ABI, bound with ctypes by cliffordtpu_torch/kernels/torus.py.
// theta (R, d-1) and g (R, 2d) float32 and contiguous; dtheta written at
// r*ld + off + (k-1), with column 0 zeroed when off is 1.  u, v (R, d-1),
// kappa (read at r*kap_row_stride + k*kap_col_stride, k = 1..d-1) and
// dkappa (laid out as dtheta) are all given or all null.  Returns the CUDA
// error of the shared-memory attribute call or of the launch.
extern "C" int torus_bwd(const float* theta, const float* g, float* dtheta,
                         int ld, int off, const float* u, const float* v,
                         const float* kappa, int kap_row_stride,
                         int kap_col_stride, float* dkappa, int R, int d,
                         void* stream) {
  const size_t smem = torus_smem_bytes(d, 1);
  cudaError_t err = torus_allow_smem(torus_bwd_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((R + kTorusRows - 1) / kTorusRows,
                  (d - 1 + kTorusAngles - 1) / kTorusAngles);
  torus_bwd_kernel<<<grid, kTorusThreads, smem, (cudaStream_t)stream>>>(
      theta, g, dtheta, ld, off, u, v, kappa, kap_row_stride, kap_col_stride,
      dkappa, R, d);
  return (int)cudaGetLastError();
}
