// Fused half-split RoPE + non-causal attention, backward, for sm_90a.
//
// Replaces cliffordtpu/kernels/attention_pallas.py::_bwd_kernel (the
// pallas_call in _attn_bwd, the custom VJP of fused_attention).  Given
// q, k, v and the output gradient dO, all (B, S, H, hd):
//
//   Qr = rot(q), Kr = rot(k)            rot as in attention_fwd.cu
//   P  = softmax(scale Qr Kr^T)          recomputed, never read from HBM
//   dV = P^T dO
//   dP = dO V^T
//   dS = P o (dP - rowsum(dP o P)) scale
//   dQr = dS Kr,  dKr = dS^T Qr
//   dq = rot^-1(dQr), dk = rot^-1(dKr)   rot^-1(x) = [x0 c + x1 s | x1 c - x0 s]
//
// All arithmetic is float32; dq, dk, dv are written in the input type
// (float32 or bfloat16) at the (B, S, H, hd) strides.
//
// Design: one block per (batch, head), like the forward kernel, so each
// block owns its dq, dk, dv slices and needs no atomics.  It loads and
// rotates q and k, loads v and dO, and keeps two S x S tiles (P and dS) in
// shared memory, over the real S (no padding and no -1e30 mask, where the
// TPU kernel padded S to a sublane multiple).  Rows of k and v are padded
// by one float: the score and dP loops walk them with the row index
// varying across a warp.  The last two products compute the output pair
// (i, i + hd/2) in one thread, so the inverse rotation needs no exchange.
// At the flagship shape (S = 68, hd = 64) the working set is 107,168
// bytes, above the 48 KB default, so the launcher raises the kernel's
// dynamic shared memory limit, once per device.
//
// What bounds it: at B = 64, H = 8 the function moves seven tensors,
// 62.4 MB in float32 (31.2 MB in bfloat16), and does 1.5 GFLOP in five
// products, so float32 CUDA-core arithmetic bounds the float32 function
// (22.6 us at 67 TFLOP/s) and HBM bandwidth the bfloat16 one (9.3 us).
// This first version is scalar float32 code whose inner loops issue about
// two shared-memory loads per fused multiply-add, so shared-memory traffic
// bounds the kernel, as in the forward (PERF.md).  Register tiles and
// tensor-core products are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include <atomic>

namespace {

constexpr int kMaxDevices = 64;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

template <typename T>
__global__ void attention_bwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const float* __restrict__ cos_t, const float* __restrict__ sin_t,
    const T* __restrict__ d_out, T* __restrict__ dq, T* __restrict__ dk,
    T* __restrict__ dv, int S, int H, int hd, float scale) {
  extern __shared__ float smem[];
  const int half = hd / 2;
  const int pad = hd + 1;       // padded rows of k and v
  float* qs = smem;             // S x hd, rotated
  float* dos = qs + S * hd;     // S x hd
  float* ks = dos + S * hd;     // S x (hd + 1), rotated
  float* vs = ks + S * pad;     // S x (hd + 1)
  float* p = vs + S * pad;      // S x S probabilities
  float* ds = p + S * S;        // S x S: dP, then dS

  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const size_t tok = (size_t)H * hd;  // stride between tokens
  const size_t base = (size_t)b * S * tok + (size_t)h * hd;

  // 1. load; rotate the pairs (i, i + hd/2) of q and k
  for (int e = threadIdx.x; e < S * half; e += blockDim.x) {
    const int s = e / half;
    const int i = e % half;
    const size_t g = base + s * tok + i;
    float c = 1.0f, sn = 0.0f;
    if (cos_t != nullptr) {
      c = cos_t[s * half + i];
      sn = sin_t[s * half + i];
    }
    const float q0 = to_f32(q[g]), q1 = to_f32(q[g + half]);
    qs[s * hd + i] = q0 * c - q1 * sn;
    qs[s * hd + i + half] = q0 * sn + q1 * c;
    const float k0 = to_f32(k[g]), k1 = to_f32(k[g + half]);
    ks[s * pad + i] = k0 * c - k1 * sn;
    ks[s * pad + i + half] = k0 * sn + k1 * c;
    vs[s * pad + i] = to_f32(v[g]);
    vs[s * pad + i + half] = to_f32(v[g + half]);
    dos[s * hd + i] = to_f32(d_out[g]);
    dos[s * hd + i + half] = to_f32(d_out[g + half]);
  }
  __syncthreads();

  // 2. scores and dP = dO V^T
  for (int e = threadIdx.x; e < S * S; e += blockDim.x) {
    const int i = e / S;
    const int j = e % S;
    const float* qi = qs + i * hd;
    const float* doi = dos + i * hd;
    const float* kj = ks + j * pad;
    const float* vj = vs + j * pad;
    float acc = 0.0f, dacc = 0.0f;
    for (int d = 0; d < hd; ++d) {
      acc = fmaf(qi[d], kj[d], acc);
      dacc = fmaf(doi[d], vj[d], dacc);
    }
    p[e] = scale * acc;
    ds[e] = dacc;
  }
  __syncthreads();

  // 3. per row, one warp: softmax over the S real keys, then
  //    dS = P (dP - sum_j dP P) scale
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int nwarps = blockDim.x / 32;
  for (int i = warp; i < S; i += nwarps) {
    float* row = p + i * S;
    float* drow = ds + i * S;
    float mx = -INFINITY;
    for (int j = lane; j < S; j += 32) mx = fmaxf(mx, row[j]);
    for (int o = 16; o > 0; o >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    float sum = 0.0f;
    for (int j = lane; j < S; j += 32) {
      const float ex = expf(row[j] - mx);
      row[j] = ex;
      sum += ex;
    }
    for (int o = 16; o > 0; o >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, o);
    float delta = 0.0f;
    for (int j = lane; j < S; j += 32) {
      const float pj = row[j] / sum;
      row[j] = pj;
      delta = fmaf(drow[j], pj, delta);
    }
    for (int o = 16; o > 0; o >>= 1)
      delta += __shfl_xor_sync(0xffffffffu, delta, o);
    for (int j = lane; j < S; j += 32)
      drow[j] = row[j] * (drow[j] - delta) * scale;
  }
  __syncthreads();

  // 4. dV = P^T dO
  for (int e = threadIdx.x; e < S * hd; e += blockDim.x) {
    const int j = e / hd;
    const int d = e % hd;
    float acc = 0.0f;
    for (int i = 0; i < S; ++i) acc = fmaf(p[i * S + j], dos[i * hd + d], acc);
    store(dv + base + j * tok + d, acc);
  }

  // 5. dQr = dS Kr and dKr = dS^T Qr for the pair (d, d + hd/2) of one
  //    token, then the inverse rotation
  for (int e = threadIdx.x; e < S * half; e += blockDim.x) {
    const int t = e / half;
    const int d = e % half;
    float q0 = 0.0f, q1 = 0.0f, k0 = 0.0f, k1 = 0.0f;
    for (int j = 0; j < S; ++j) {
      const float dsq = ds[t * S + j];  // dS[t, j]
      const float dsk = ds[j * S + t];  // dS[j, t]
      q0 = fmaf(dsq, ks[j * pad + d], q0);
      q1 = fmaf(dsq, ks[j * pad + d + half], q1);
      k0 = fmaf(dsk, qs[j * hd + d], k0);
      k1 = fmaf(dsk, qs[j * hd + d + half], k1);
    }
    float c = 1.0f, sn = 0.0f;
    if (cos_t != nullptr) {
      c = cos_t[t * half + d];
      sn = sin_t[t * half + d];
    }
    const size_t g = base + t * tok + d;
    store(dq + g, q0 * c + q1 * sn);
    store(dq + g + half, q1 * c - q0 * sn);
    store(dk + g, k0 * c + k1 * sn);
    store(dk + g + half, k1 * c - k0 * sn);
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const float* cos_t,
           const float* sin_t, const void* d_out, void* dq, void* dk, void* dv,
           int B, int S, int H, int hd, void* stream) {
  const int smem = (int)(sizeof(float) * ((size_t)S * hd * 2 +
                                          (size_t)S * (hd + 1) * 2 +
                                          (size_t)S * S * 2));
  // The block's dynamic shared-memory limit is raised to the device's
  // opt-in maximum once per (type, device), not on every launch; the
  // wrapper refuses shapes above that maximum.
  static std::atomic<bool> raised[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (!raised[dev].load()) {
    int optin = 0;
    err = cudaDeviceGetAttribute(&optin,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err != cudaSuccess) return (int)err;
    err = cudaFuncSetAttribute(attention_bwd_kernel<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               optin);
    if (err != cudaSuccess) return (int)err;
    raised[dev].store(true);
  }
  const float scale = 1.0f / sqrtf((float)hd);
  attention_bwd_kernel<T><<<B * H, 256, smem, (cudaStream_t)stream>>>(
      (const T*)q, (const T*)k, (const T*)v, cos_t, sin_t, (const T*)d_out,
      (T*)dq, (T*)dk, (T*)dv, S, H, hd, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// C ABI, bound with ctypes by cliffordtpu_torch/kernels/attention.py.
// q, k, v, d_out, dq, dk, dv contiguous (B, S, H, hd); cos, sin contiguous
// (S, hd/2) float32 or both null.  The wrapper checks shapes, types and
// the shared memory size.  Returns the CUDA error of the attribute call or
// launch.
extern "C" int attention_bwd_f32(const void* q, const void* k, const void* v,
                                 const float* cos_t, const float* sin_t,
                                 const void* d_out, void* dq, void* dk,
                                 void* dv, int B, int S, int H, int hd,
                                 void* stream) {
  return launch<float>(q, k, v, cos_t, sin_t, d_out, dq, dk, dv, B, S, H, hd,
                       stream);
}

extern "C" int attention_bwd_bf16(const void* q, const void* k, const void* v,
                                  const float* cos_t, const float* sin_t,
                                  const void* d_out, void* dq, void* dk,
                                  void* dv, int B, int S, int H, int hd,
                                  void* stream) {
  return launch<__nv_bfloat16>(q, k, v, cos_t, sin_t, d_out, dq, dk, dv, B, S,
                               H, hd, stream);
}
