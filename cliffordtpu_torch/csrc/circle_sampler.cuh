// The fused Clifford-torus sampler + embedding, shared by the keyed
// (threefry) and the Philox kernels, which differ only in where the two
// uniforms of an angle come from.
//
// For every row r of R latents with d angles and every free angle
// k = 1..d-1 (angle 0 is pinned):
//
//   (u, v) = draw(r*d + k)            the generator's two uniforms
//   theta  = loc + 2 atan(cos(2 pi v) sqrt(expm1(-(2/nu) ln u))),
//            nu = 2 (kappa + 1e-7) + 1
//   x      = the real-DFT torus embedding of theta (torus_basis.cuh)
//
// and theta, u, v are written too (the residuals a backward pass needs).
// One launch, no intermediate in device memory, in one of two forms:
//
// * FFT form, d a power of two (sample_embed_fft_kernel): the row's
//   threads take the angle pairs (k, d - k); sample_pack_pair draws,
//   samples and writes the pair and packs it into the row's complex
//   spectrum, as torus_fwd.cu's FFT form packs given angles, and the
//   inverse FFT of torus_fft.cuh gives x.  Every angle is drawn once per
//   launch.
//
// * Table form, any other d (sample_embed_tile): a block owns 64 rows x 64
//   output columns (torus_embed_tile) and draws and samples its rows'
//   angles chunk by chunk into shared memory.  Blocks that share rows (the
//   column tiles of one row tile) each draw those rows again: the draw is
//   a pure function of (key, r, k), so they agree, and the blocks of
//   column tile 0 write theta, u and v.
//
// sample_embed_launch picks the form for both samplers' C ABIs.
//
// IEEE division and square root and the accurate logf / expm1f / atanf /
// cosf / sincosf: built without fast math.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "torus_basis.cuh"
#include "torus_fft.cuh"

// mantissa trick: a float in [1, 2) from the top 23 bits, minus 1
__device__ __forceinline__ float unit_float(uint32_t bits) {
  return __uint_as_float((bits >> 9) | 0x3F800000u) - 1.0f;
}

// the closed-form PowerSpherical circle sampler (Bailey's polar form)
__device__ __forceinline__ float circle_theta(float loc, float kap, float u,
                                              float v) {
  const float nu = 2.0f * (kap + 1e-7f) + 1.0f;
  const float w = expm1f((-2.0f / nu) * logf(u));
  const float two_pi_v = (float)6.283185307179586476925 * v;
  return loc + 2.0f * atanf(cosf(two_pi_v) * sqrtf(w));
}

// `draw(q, &u, &v)` gives the uniforms of flat element q = r*d + k.
// loc (R, d) contiguous; kappa read at r*kap_row_stride + k*kap_col_stride;
// x (R, 2d) and theta, u, v (R, d-1) contiguous.
template <typename Draw>
__device__ __forceinline__ void sample_embed_tile(
    Draw draw, const float* __restrict__ loc, const float* __restrict__ kappa,
    int kap_row_stride, int kap_col_stride, float* __restrict__ x,
    float* __restrict__ theta, float* __restrict__ u_out,
    float* __restrict__ v_out, int R, int d, float* smem) {
  const int m = d - 1;
  const bool writer = blockIdx.y == 0;
  torus_embed_tile(
      [&](int k0, int kc, int row0, float* cs, float* sn) {
        for (int e = threadIdx.x; e < kTorusRows * kTorusChunk;
             e += blockDim.x) {
          const int kk = e % kTorusChunk;
          const int lr = e / kTorusChunk;
          const int r = row0 + lr;
          float c = 0.0f, s = 0.0f;
          if (kk < kc && r < R) {
            const int k = k0 + kk;
            float u, v;
            draw((uint32_t)r * (uint32_t)d + (uint32_t)k, &u, &v);
            const float kap = kappa[(size_t)r * kap_row_stride +
                                    (size_t)k * kap_col_stride];
            const float t = circle_theta(loc[(size_t)r * d + k], kap, u, v);
            if (writer) {
              const size_t o = (size_t)r * m + (k - 1);
              theta[o] = t;
              u_out[o] = u;
              v_out[o] = v;
            }
            sincosf(t, &s, &c);
          }
          cs[kk * kTorusPitch + lr] = c;
          sn[kk * kTorusPitch + lr] = s;
        }
      },
      x, R, d, smem);
}

// Angle k (1 <= k < d) of row r: draw element r*d + k, sample it, write
// theta, u and v at column k - 1; returns theta.
template <typename Draw>
__device__ __forceinline__ float sample_angle(
    Draw draw, const float* __restrict__ loc, const float* __restrict__ kappa,
    int kap_row_stride, int kap_col_stride, float* __restrict__ theta,
    float* __restrict__ u_out, float* __restrict__ v_out, int r, int k,
    int d) {
  float u, v;
  draw((uint32_t)r * (uint32_t)d + (uint32_t)k, &u, &v);
  const float kap =
      kappa[(size_t)r * kap_row_stride + (size_t)k * kap_col_stride];
  const float t = circle_theta(loc[(size_t)r * d + k], kap, u, v);
  const size_t o = (size_t)r * (d - 1) + (k - 1);
  theta[o] = t;
  u_out[o] = u;
  v_out[o] = v;
  return t;
}

// The FFT form's packing of the angle pair (k, d - k), 1 <= k <= d/2, of
// row r into z (the row's spectrum, padded layout of torus_fft.cuh), with
// the angles drawn and sampled here (each once; once in all when
// k = d - k).  With X_k = exp(i theta_k) and w_k = exp(i pi k / d):
//   Z_k = A_k + i w_k B_k,  Z_{d-k} = conj(A_k - i w_k B_k),
//   A_k = X_k + conj(X_{d-k}),  B_k = X_k - conj(X_{d-k}).
template <typename Draw>
__device__ __forceinline__ void sample_pack_pair(
    Draw draw, const float* __restrict__ loc, const float* __restrict__ kappa,
    int kap_row_stride, int kap_col_stride, float* __restrict__ theta,
    float* __restrict__ u_out, float* __restrict__ v_out, int r, int k, int d,
    float2* z) {
  float s1, c1, s2, c2, sw, cw;
  sincosf(sample_angle(draw, loc, kappa, kap_row_stride, kap_col_stride,
                       theta, u_out, v_out, r, k, d),
          &s1, &c1);
  if (k != d - k) {
    sincosf(sample_angle(draw, loc, kappa, kap_row_stride, kap_col_stride,
                         theta, u_out, v_out, r, d - k, d),
            &s2, &c2);
  } else {
    s2 = s1;
    c2 = c1;
  }
  sincospif((float)k / (float)d, &sw, &cw);
  const float ax = c1 + c2, ay = s1 - s2;  // A_k
  const float bx = c1 - c2, by = s1 + s2;  // B_k
  const float wbx = cw * bx - sw * by, wby = cw * by + sw * bx;
  z[fft_pad(k)] = make_float2(ax - wby, ay + wbx);
  if (k != d - k) z[fft_pad(d - k)] = make_float2(ax + wby, wbx - ay);
}

// The two forms as kernels, for a generator `Draw`: a functor
// draw(ctr, &u, &v) that a kernel receives by value.
//
// The FFT form, d a power of two, launched by fft_wide_launch with DT
// threads a row.  A row's threads take the pairs k = 1..d/2 (and Z_0);
// then its first d/16 run the passes, and all store x as float4 (x
// 16-byte aligned).
template <typename Draw>
__global__ void __launch_bounds__(kFftRowThreads) sample_embed_fft_kernel(
    Draw draw, const float* __restrict__ loc, const float* __restrict__ kappa,
    int kap_row_stride, int kap_col_stride, float* __restrict__ x,
    float* __restrict__ theta, float* __restrict__ u_out,
    float* __restrict__ v_out, int R, int d, int DT) {
  extern __shared__ __align__(16) float2 buf[];
  const FftWideRow w = fft_wide_row(buf, R, d, DT);
  if (w.live) {
    for (int k = w.t; k <= d / 2; k += w.DT) {
      if (k == 0) {
        w.a[0] = make_float2(2.0f, 0.0f);  // Z_0: X_0 = X_d = 1
        continue;
      }
      sample_pack_pair(draw, loc, kappa, kap_row_stride, kap_col_stride,
                       theta, u_out, v_out, w.row, k, d, w.a);
    }
  }
  const float2* z = fft_inverse(w.a, w.b, d, w.t, w.T, w.live && w.t < w.T);
  if (!w.live) return;
  const float inv_n = 1.0f / (float)(2 * d);  // a power of two: exact
  float4* xr = reinterpret_cast<float4*>(x + (size_t)w.row * 2 * d);
  for (int e = w.t; e < d / 2; e += w.DT) {
    const float2 z0 = z[fft_pad(2 * e)];
    const float2 z1 = z[fft_pad(2 * e + 1)];
    xr[e] = make_float4(z0.x * inv_n, z0.y * inv_n, z1.x * inv_n,
                        z1.y * inv_n);
  }
}

// The table form (sample_embed_tile), any d.
template <typename Draw>
__global__ void __launch_bounds__(kTorusThreads) sample_embed_table_kernel(
    Draw draw, const float* __restrict__ loc, const float* __restrict__ kappa,
    int kap_row_stride, int kap_col_stride, float* __restrict__ x,
    float* __restrict__ theta, float* __restrict__ u_out,
    float* __restrict__ v_out, int R, int d) {
  extern __shared__ __align__(16) float smem[];
  sample_embed_tile(draw, loc, kappa, kap_row_stride, kap_col_stride, x,
                    theta, u_out, v_out, R, d, smem);
}

// Launch the FFT form for d a power of two (x 16-byte aligned), else the
// table form (a grid of 64-row x 64-column tiles).  Returns the CUDA
// error of the shared-memory attribute call or of the launch.
template <typename Draw>
inline int sample_embed_launch(Draw draw, const float* loc,
                               const float* kappa, int kap_row_stride,
                               int kap_col_stride, float* x, float* theta,
                               float* u, float* v, int R, int d,
                               void* stream) {
  if (fft_is_pow2(d))
    return fft_wide_launch(sample_embed_fft_kernel<Draw>, R, d, stream, draw,
                           loc, kappa, kap_row_stride, kap_col_stride, x,
                           theta, u, v, R, d);
  const cudaStream_t st = (cudaStream_t)stream;
  const size_t smem = torus_embed_smem_bytes(d);
  cudaError_t err = torus_allow_smem(sample_embed_table_kernel<Draw>, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((R + kTorusRows - 1) / kTorusRows,
                  (2 * d + kTorusCols - 1) / kTorusCols);
  sample_embed_table_kernel<Draw><<<grid, kTorusThreads, smem, st>>>(
      draw, loc, kappa, kap_row_stride, kap_col_stride, x, theta, u, v, R, d);
  return (int)cudaGetLastError();
}
