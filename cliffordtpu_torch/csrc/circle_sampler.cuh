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
// One launch, no intermediate in device memory.  A block owns 64 rows x 64
// output columns (torus_embed_tile); it draws and samples its rows' angles
// chunk by chunk into shared memory.  Blocks that share rows (the column
// tiles of one row tile) each draw those rows again: the draw is a pure
// function of (key, r, k), so they agree, and the blocks of column tile 0
// write theta, u and v.  At d = 4096 that is 128 column tiles per row
// tile: the draws cost about as much as the embedding there.
//
// A kernel whose d is a power of two can instead draw in front of the
// FFT form of the embedding (torus_fft.cuh): sample_pack_pair draws,
// samples and writes the angle pair (k, d - k) of one row and packs it
// into the row's complex spectrum, as torus_fwd.cu's FFT form packs given
// angles, so that every angle is drawn once per launch.
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
