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
// with the real-DFT basis of torus_basis.cuh.  When the sampler's
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
// Two forms, chosen by d (kernels/torus.py::form says which ran):
//
// * FFT form, d a power of two.  With n = 2d, G = the forward real DFT of
//   the row of g, gc = (2/n) Re G_k and gs = (2/n) Im G_k, so
//     dtheta_k = (1/d) Im(G_k exp(-i theta_k)).
//   The n-point real transform is one d-point complex one: the row packed
//   as z_m = g[2m] + i g[2m+1], Z its forward DFT, taken as the conjugate
//   of torus_fft.cuh's inverse of conj(z) (no second FFT), and with
//   w_k = exp(i pi k / d), E = (Z_k + conj Z_{d-k}) / 2 and
//   O = (Z_k - conj Z_{d-k}) / 2,
//     G_k = E - i conj(w_k) O,  G_{d-k} = conj(E + i conj(w_k) O).
//   A thread owns the pair (k, d-k), as the forward's packing does in
//   reverse, and runs the epilogue of both angles.  That epilogue (the
//   accurate sincosf, logf, expm1f, cosf, sqrtf: some hundred dependent
//   instructions an angle) would cost a thread of the passes (d/16 a row)
//   more than the passes do, so a row has up to one thread a pair, 1024
//   at most, half as many where R rows of them would not all be resident
//   (torus_fft.cuh::fft_wide_threads), and the row's first d/16 run the
//   passes.  What bounds
//   the function is its bytes (g, theta, u, v, kappa read; dtheta, dkappa
//   written: 29 MB at R = 256, d = 4096 with the epilogue, 8.8 us at
//   3.35 TB/s); at these sizes a thread's dependent chain and the launch
//   bound the kernel.
//
// * Table form, any other d: the dense product against the basis looked
//   up in the shared-memory table of torus_basis.cuh (the roles of k and
//   col swapped against the forward): 8.6 GFLOP of float32 multiply-adds
//   at R = 64, d = 4096 (0.13 ms at the CUDA cores' peak).  One block owns
//   64 rows x 32 angles: a warp owns 2 angles, lane l rows l and l + 32, so
//   a basis lookup is one address per warp shared by 64 rows and 8
//   accumulators.  The block walks the 2d columns of its rows' g in chunks
//   of 64 staged through shared memory.

#include <cuda_runtime.h>

#include "torus_basis.cuh"
#include "torus_fft.cuh"

namespace {

// Angle k of row r, from gc = (g C^T)_k and gs = (g S^T)_k: writes d theta
// and, when dkappa is given, d kappa (column 0 zeroed with angle 1 when
// off is 1).
__device__ __forceinline__ void torus_bwd_angle(
    const float* __restrict__ theta, float gc, float gs,
    float* __restrict__ dtheta, int ld, int off, const float* __restrict__ u,
    const float* __restrict__ v, const float* __restrict__ kappa,
    int kap_row_stride, int kap_col_stride, float* __restrict__ dkappa,
    int r, int k, int d) {
  const size_t i = (size_t)r * (d - 1) + (k - 1);
  float st, ct;
  sincosf(theta[i], &st, &ct);
  const float dth = -st * gc + ct * gs;
  const size_t o = (size_t)r * ld + off + (k - 1);
  dtheta[o] = dth;
  if (off > 0 && k == 1) dtheta[(size_t)r * ld] = 0.0f;
  if (dkappa == nullptr) return;
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
      torus_bwd_angle(theta, half ? gc1[j] : gc0[j], half ? gs1[j] : gs0[j],
                      dtheta, ld, off, u, v, kappa, kap_row_stride,
                      kap_col_stride, dkappa, r, k, d);
    }
  }
}

// The FFT form: DT threads a row (fft_wide_threads), the block's rows
// side by side, two padded buffers per row.
__global__ void __launch_bounds__(kFftRowThreads) torus_bwd_fft_kernel(
    const float* __restrict__ theta, const float* __restrict__ g,
    float* __restrict__ dtheta, int ld, int off, const float* __restrict__ u,
    const float* __restrict__ v, const float* __restrict__ kappa,
    int kap_row_stride, int kap_col_stride, float* __restrict__ dkappa, int R,
    int d, int DT) {
  extern __shared__ __align__(16) float2 buf[];
  const FftWideRow w = fft_wide_row(buf, R, d, DT);
  const int row = w.row;
  if (w.live) {
    const float* gr = g + (size_t)row * 2 * d;
    for (int m = w.t; m < d; m += w.DT)  // conj(z_m)
      w.a[fft_pad(m)] = make_float2(gr[2 * m], -gr[2 * m + 1]);
  }
  // y = the inverse DFT of conj(z) = conj(Z)
  const float2* y = fft_inverse(w.a, w.b, d, w.t, w.T, w.live && w.t < w.T);
  if (!w.live) return;
  const float inv_d = 1.0f / (float)d;  // a power of two: exact
  for (int k = 1 + w.t; k <= d / 2; k += w.DT) {
    const float2 yk = y[fft_pad(k)];      // conj Z_k
    const float2 yr = y[fft_pad(d - k)];  // conj Z_{d-k}
    // E = (Z_k + conj Z_{d-k}) / 2, O = (Z_k - conj Z_{d-k}) / 2
    const float ex = 0.5f * (yk.x + yr.x), ey = 0.5f * (yr.y - yk.y);
    const float ox = 0.5f * (yk.x - yr.x), oy = -0.5f * (yk.y + yr.y);
    // P = i conj(w_k) O
    float sw, cw;
    sincospif((float)k / (float)d, &sw, &cw);
    const float px = sw * ox - cw * oy, py = cw * ox + sw * oy;
    // G_k = E - P, then G_{d-k} = conj(E + P): gc = Re G / d,
    // gs = Im G / d.  One call site, so one copy of the epilogue (two
    // inlined copies spilled registers at the 64 the launch bound allows)
#pragma unroll 1
    for (int h = 0; h < (k != d - k ? 2 : 1); ++h)
      torus_bwd_angle(theta, (h ? ex + px : ex - px) * inv_d,
                      (h ? -(ey + py) : ey - py) * inv_d, dtheta, ld, off, u,
                      v, kappa, kap_row_stride, kap_col_stride, dkappa, row,
                      h ? d - k : k, d);
  }
}

}  // namespace

// C ABI, bound with ctypes by cliffordtpu_torch/kernels/torus.py.
// theta (R, d-1) and g (R, 2d) float32 and contiguous; dtheta written at
// r*ld + off + (k-1), with column 0 zeroed when off is 1.  u, v (R, d-1),
// kappa (read at r*kap_row_stride + k*kap_col_stride, k = 1..d-1) and
// dkappa (laid out as dtheta) are all given or all null.  Returns the CUDA
// error of the shared-memory attribute call or of the launch.  The FFT
// form for d a power of two, else the table form.
extern "C" int torus_bwd(const float* theta, const float* g, float* dtheta,
                         int ld, int off, const float* u, const float* v,
                         const float* kappa, int kap_row_stride,
                         int kap_col_stride, float* dkappa, int R, int d,
                         void* stream) {
  if (fft_is_pow2(d))
    return fft_wide_launch(torus_bwd_fft_kernel, R, d, stream, theta, g,
                           dtheta, ld, off, u, v, kappa, kap_row_stride,
                           kap_col_stride, dkappa, R, d);
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
