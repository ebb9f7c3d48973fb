// Clifford-torus embedding, forward, for sm_90a.
//
// Replaces cliffordtpu/kernels/torus_pallas.py::_fwd_kernel (the pallas_call
// in _torus_fused_fwd_impl, reached through angles_to_torus_fused).  For
// every row r of R latents with free angles theta[r, k], k = 1..d-1 (angle 0
// is pinned to phase 0), and every output column j of n = 2d:
//
//   x[r, j] = (1/n) [1 + (-1)^j + 2 sum_k cos(theta[r, k] + 2 pi k j / n)]
//
// which is the inverse real DFT of the Hermitian spectrum X = (1,
// exp(i theta_1), ..., exp(i theta_{d-1}), 1) of length n, and also the
// dense product c + cos(theta) C + sin(theta) S with the basis of
// torus_basis.cuh.  x is written at (R, 2d) exactly.
//
// Two forms, chosen by d (kernels/torus.py::fwd_form says which ran):
//
// * FFT form, d a power of two (every latent the models and scripts run:
//   16, 128..4096).  The n-point real transform is one d-point complex
//   transform: with w_k = exp(i pi k / d),
//     Z_0 = 2,  Z_k = A_k + i w_k B_k  (k = 1..d-1),
//     A_k = X_k + conj(X_{d-k}),  B_k = X_k - conj(X_{d-k}),
//   z = the inverse DFT of Z (torus_fft.cuh), and x_{2m} = Re z_m / n,
//   x_{2m+1} = Im z_m / n.  A thread packs the pair (k, d-k) from one
//   accurate sincosf per angle and one sincospif for w_k (Z_{d-k} =
//   conj(A_k - i w_k B_k)); the row's z stays in shared memory (2 x 34 KB
//   at d = 4096, two buffers); x leaves as float4 stores.  A row has d/16
//   threads (one radix-16 butterfly each per pass), a block of 256 threads
//   (64 below d = 256) holds 256 / (d/16) rows, so R = 64, d = 4096 is 64
//   blocks of one row and R = 4096, d = 16 is 64 blocks of 64 rows (one
//   thread per row).  What bounds the function is its bytes (theta read,
//   x written: 3.1 MB at R 64, d 4096, about 1 us at 3.35 TB/s); the
//   kernel does ~2.5 n log2 n flops per row (17 MFLOP) and a few hundred
//   dependent instructions per thread, so at these sizes its launch and
//   its latency chain bound it.
//
// * Table form, any other d (the table-form tile of torus_basis.cuh, which
//   the samplers share): at R = 64, d = 4096 it would do 4 R (d-1) 2d =
//   8.6 GFLOP of float32 multiply-adds (0.13 ms at the CUDA cores' peak),
//   looking the basis up in a shared-memory table of the 2d phases.  One
//   block owns 64 rows x 64 columns and walks the angles in chunks of 64
//   whose cos and sin it computes once into shared memory.

#include <cuda_runtime.h>

#include "torus_basis.cuh"
#include "torus_fft.cuh"

namespace {

__global__ void __launch_bounds__(kTorusThreads)
    torus_fwd_table_kernel(const float* __restrict__ theta,
                           float* __restrict__ x, int R, int d) {
  extern __shared__ __align__(16) float smem[];
  const int m = d - 1;
  torus_embed_tile(
      [&](int k0, int kc, int row0, float* cs, float* sn) {
        for (int e = threadIdx.x; e < kTorusRows * kTorusChunk;
             e += blockDim.x) {
          const int kk = e % kTorusChunk;
          const int lr = e / kTorusChunk;
          const int r = row0 + lr;
          float c = 0.0f, s = 0.0f;
          if (kk < kc && r < R)
            sincosf(theta[(size_t)r * m + (k0 - 1 + kk)], &s, &c);
          cs[kk * kTorusPitch + lr] = c;
          sn[kk * kTorusPitch + lr] = s;
        }
      },
      x, R, d, smem);
}

// The FFT form: one row per d/16 threads (one thread per row below
// d = 16), `rows` rows per block, two padded buffers per row.
__global__ void __launch_bounds__(256)
    torus_fwd_fft_kernel(const float* __restrict__ theta,
                         float* __restrict__ x, int R, int d) {
  extern __shared__ __align__(16) float2 buf[];
  const int T = fft_row_threads(d);
  const int rows = blockDim.x / T;
  const int pitch = fft_pitch(d);
  const int lr = threadIdx.x / T;
  const int t = threadIdx.x % T;
  const int row = blockIdx.x * rows + lr;
  const bool live = row < R;
  float2* a = buf + lr * pitch;
  float2* b = buf + (rows + lr) * pitch;
  if (live) {
    const float* th = theta + (size_t)row * (d - 1);
    for (int k = t; k <= d / 2; k += T) {
      if (k == 0) {
        a[0] = make_float2(2.0f, 0.0f);
        continue;
      }
      float s1, c1, s2, c2, sw, cw;
      sincosf(th[k - 1], &s1, &c1);      // X_k
      sincosf(th[d - k - 1], &s2, &c2);  // X_{d-k}
      sincospif((float)k / (float)d, &sw, &cw);
      const float ax = c1 + c2, ay = s1 - s2;  // A_k
      const float bx = c1 - c2, by = s1 + s2;  // B_k
      const float wbx = cw * bx - sw * by, wby = cw * by + sw * bx;
      a[fft_pad(k)] = make_float2(ax - wby, ay + wbx);
      if (k != d - k) a[fft_pad(d - k)] = make_float2(ax + wby, wbx - ay);
    }
  }
  const float2* z = fft_inverse(a, b, d, t, T, live);
  if (!live) return;
  const float inv_n = 1.0f / (float)(2 * d);  // a power of two: exact
  float4* xr = reinterpret_cast<float4*>(x + (size_t)row * 2 * d);
  for (int e = t; e < d / 2; e += T) {
    const float2 z0 = z[fft_pad(2 * e)];
    const float2 z1 = z[fft_pad(2 * e + 1)];
    xr[e] = make_float4(z0.x * inv_n, z0.y * inv_n, z1.x * inv_n,
                        z1.y * inv_n);
  }
}

constexpr bool is_pow2(int d) { return d >= 2 && (d & (d - 1)) == 0; }

// Block threads of the FFT form, and its shared memory.
constexpr int fft_threads(int d) { return d >= 256 ? 256 : 64; }
constexpr size_t fft_smem_bytes(int d) {
  return sizeof(float2) * 2 * (size_t)(fft_threads(d) / fft_row_threads(d)) *
         (size_t)fft_pitch(d);
}
static_assert(fft_smem_bytes(kTorusMaxDim) <= kTorusMaxSmem,
              "a row's two buffers must fit a block at the largest d");

}  // namespace

// C ABI, bound with ctypes by cliffordtpu_torch/kernels/torus.py.
// theta (R, d-1) and x (R, 2d) float32 and contiguous, 2 <= d <= 4096, x
// 16-byte aligned; the FFT form for d a power of two, else the table form.
// Returns the CUDA error of the shared-memory attribute call or of the
// launch.
extern "C" int torus_fwd(const float* theta, float* x, int R, int d,
                         void* stream) {
  if (is_pow2(d)) {
    const int threads = fft_threads(d);
    const int rows = threads / fft_row_threads(d);
    const size_t smem = fft_smem_bytes(d);
    cudaError_t err = torus_allow_smem(torus_fwd_fft_kernel, smem);
    if (err != cudaSuccess) return (int)err;
    torus_fwd_fft_kernel<<<(R + rows - 1) / rows, threads, smem,
                           (cudaStream_t)stream>>>(theta, x, R, d);
    return (int)cudaGetLastError();
  }
  const size_t smem = torus_embed_smem_bytes(d);
  cudaError_t err = torus_allow_smem(torus_fwd_table_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((R + kTorusRows - 1) / kTorusRows,
                  (2 * d + kTorusCols - 1) / kTorusCols);
  torus_fwd_table_kernel<<<grid, kTorusThreads, smem, (cudaStream_t)stream>>>(
      theta, x, R, d);
  return (int)cudaGetLastError();
}
