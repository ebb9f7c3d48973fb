// A complex inverse FFT of power-of-two length d (2 <= d <= 4096) on rows
// held in shared memory: the core of the torus embedding's FFT form
// (torus_fwd.cu), written so that a kernel that differentiates or draws
// in front of the embedding can reuse it.
//
//   z_m = sum_{k<d} Z_k exp(+2 pi i k m / d),  m = 0..d-1  (no 1/d)
//
// Stockham autosort passes (ordered output, no bit-reversal pass): a pass
// of radix R with Ns points already transformed takes butterfly j (0 <=
// j < d/R) from src[j + r d/R], r < R, multiplies element r by
// exp(2 pi i (j mod Ns) r / (Ns R)), takes the R-point inverse DFT in
// registers, and writes element r to dst[(j - j mod Ns) R + j mod Ns +
// r Ns].  Passes are radix 16 while 16 divides what is left, then one of
// radix 8, 4 or 2: d = 4096 is three passes, d = 2048 two of 16 and one of
// 8, d = 16 one.  Rows ping-pong between two shared-memory buffers.
//
// Twiddles come from the accurate sincospif (the port builds without
// --use_fast_math) of exact binary fractions: exp(2 pi i f p) for p = 1, 2,
// 4, 8 directly, the other powers as products of at most three of them,
// so the error stays a few ulp.  A table lookup would be indexed by
// (j mod Ns) r d / (Ns R), which strides lanes by a multiple of 32 banks.
//
// Shared memory is addressed through fft_pad(i) = i + i/16: the radix-16
// first pass writes at a stride of 16 points, which the pad turns into 17
// (conflict-free for 8-byte accesses); every other access is at unit
// stride within a half-warp.
#pragma once

#include <cuda_runtime.h>

__device__ __forceinline__ float2 cadd(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}
__device__ __forceinline__ float2 csub(float2 a, float2 b) {
  return make_float2(a.x - b.x, a.y - b.y);
}
__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

__host__ __device__ constexpr int fft_pad(int i) { return i + (i >> 4); }

// Points of one row in a buffer: the padded length, and at least one
// point more, so that rows held by neighbouring lanes (d < 16, one thread
// per row) start on different banks.
__host__ __device__ constexpr int fft_pitch(int d) {
  return d + (d >= 16 ? d / 16 : 1);
}

// Threads that share a row: one radix-16 butterfly each per pass.
__host__ __device__ constexpr int fft_row_threads(int d) {
  return d >= 16 ? d / 16 : 1;
}

// cos(2 pi k / 16), k = 0..15
__device__ __forceinline__ float cos16(int k) {
  constexpr float c[16] = {1.0f,
                           0.92387953251128674f,
                           0.70710678118654752f,
                           0.38268343236508977f,
                           0.0f,
                           -0.38268343236508977f,
                           -0.70710678118654752f,
                           -0.92387953251128674f,
                           -1.0f,
                           -0.92387953251128674f,
                           -0.70710678118654752f,
                           -0.38268343236508977f,
                           0.0f,
                           0.38268343236508977f,
                           0.70710678118654752f,
                           0.92387953251128674f};
  return c[k & 15];
}

// t * exp(2 pi i k / 16) for a k known at compile time after unrolling:
// k = 0 and k = 4 (a multiply by i) cost no multiply.
__device__ __forceinline__ float2 rot16(float2 t, int k) {
  if (k == 0) return t;
  if (k == 4) return make_float2(-t.y, t.x);
  return cmul(t, make_float2(cos16(k), cos16(k + 12)));
}

template <int R>
__host__ __device__ constexpr int fft_log2() {
  return R <= 1 ? 0 : 1 + fft_log2<R / 2>();
}

__host__ __device__ constexpr int fft_bitrev(int i, int bits) {
  int r = 0;
  for (int b = 0; b < bits; ++b) r |= ((i >> b) & 1) << (bits - 1 - b);
  return r;
}

// One radix-2 decimation-in-frequency stage on blocks of LEN points, then
// the stages below it; a template per stage, so that every loop has a
// constant trip count and every register index is known once unrolled.
template <int R, int LEN>
__device__ __forceinline__ void dif_stages(float2 (&v)[R]) {
  if constexpr (LEN >= 2) {
    constexpr int kHalf = LEN / 2;
#pragma unroll
    for (int s = 0; s < R; s += LEN) {
#pragma unroll
      for (int i = 0; i < kHalf; ++i) {
        const float2 a = v[s + i];
        const float2 b = v[s + i + kHalf];
        v[s + i] = cadd(a, b);
        v[s + i + kHalf] = rot16(csub(a, b), i * (16 / LEN));
      }
    }
    dif_stages<R, LEN / 2>(v);
  }
}

// In-register inverse DFT of R = 2, 4, 8 or 16 points: radix-2
// decimation in frequency, then the bit-reversal, which is a renaming of
// registers once unrolled.
template <int R>
__device__ __forceinline__ void dft_inv(float2 (&v)[R]) {
  constexpr int kLog = fft_log2<R>();
  dif_stages<R, R>(v);
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int r = fft_bitrev(i, kLog);
    if (i < r) {
      const float2 t = v[i];
      v[i] = v[r];
      v[r] = t;
    }
  }
}

// v[r] *= exp(2 pi i f r), f an exact binary fraction
template <int R>
__device__ __forceinline__ void fft_twiddle(float2 (&v)[R], float f) {
  float2 w[R];
  w[0] = make_float2(1.0f, 0.0f);
#pragma unroll
  for (int b = 0; b < fft_log2<R>(); ++b) {
    float s, c;
    sincospif(2.0f * f * (float)(1 << b), &s, &c);
    w[1 << b] = make_float2(c, s);
  }
#pragma unroll
  for (int r = 3; r < R; ++r) {
    const int low = r & -r;  // r = low + a smaller power already made
    if (low != r) w[r] = cmul(w[low], w[r - low]);
  }
#pragma unroll
  for (int r = 1; r < R; ++r) v[r] = cmul(v[r], w[r]);
}

// One Stockham pass of radix R over a row of d points; the row's T
// threads take butterflies t, t + T, ...
template <int R>
__device__ __forceinline__ void fft_pass(const float2* __restrict__ src,
                                         float2* __restrict__ dst, int d,
                                         int Ns, int t, int T) {
  const int stride = d / R;
  for (int j = t; j < stride; j += T) {
    float2 v[R];
#pragma unroll
    for (int r = 0; r < R; ++r) v[r] = src[fft_pad(j + r * stride)];
    const int jm = j & (Ns - 1);
    if (Ns > 1) fft_twiddle<R>(v, (float)jm / (float)(Ns * R));
    dft_inv<R>(v);
    const int out0 = (j - jm) * R + jm;
#pragma unroll
    for (int r = 0; r < R; ++r) dst[fft_pad(out0 + r * Ns)] = v[r];
  }
}

// The inverse DFT of the row in `a` (padded layout), with `b` as the
// other buffer; every thread of the block calls it (it synchronises the
// block between passes), `live` says whether this thread's row exists.
// Returns the buffer that holds z.
__device__ __forceinline__ float2* fft_inverse(float2* a, float2* b, int d,
                                               int t, int T, bool live) {
  int Ns = 1;
  for (int rem = d; rem > 1;) {
    const int R = rem >= 16 ? 16 : rem;
    __syncthreads();  // the previous pass (or the caller's fill) is done
    if (live) {
      switch (R) {
        case 16: fft_pass<16>(a, b, d, Ns, t, T); break;
        case 8: fft_pass<8>(a, b, d, Ns, t, T); break;
        case 4: fft_pass<4>(a, b, d, Ns, t, T); break;
        default: fft_pass<2>(a, b, d, Ns, t, T); break;
      }
    }
    Ns *= R;
    rem /= R;
    float2* s = a;
    a = b;
    b = s;
  }
  __syncthreads();
  return a;
}
