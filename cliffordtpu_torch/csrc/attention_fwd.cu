// Fused half-split RoPE + non-causal attention, forward, for sm_90a.
//
// Replaces cliffordtpu/kernels/attention_pallas.py::_fwd_kernel (the
// pallas_call in _attn_fwd_call, public entry fused_attention):
//
//   out = softmax(rot(q) rot(k)^T / sqrt(hd)) v
//   rot(x) = [x0 cos - x1 sin | x0 sin + x1 cos],  x = [x0 | x1]
//
// with q, k, v, out in (B, S, H, hd) and cos, sin in (S, hd/2) float32
// (null for no rotation).  One block per (batch, head) reads its q, k, v
// rows straight from the (B, S, H, hd) strides with 16-byte loads (no
// transpose or pad in HBM), rotates q and k in float32 as it stages them
// in shared memory, and takes the softmax over the S real keys.  Scores
// never touch HBM.
//
// What bounds it: at the flagship shape (B 64, S 68, H 8, hd 64) the
// function moves 17.8 MB in bfloat16 (35.7 MB in float32) and does 0.6
// GFLOP, so HBM bandwidth bounds it in bfloat16 (5.3 us at 3.35 TB/s) and
// the CUDA cores' float32 rate in float32 (0.6 GFLOP = 9 us at 67
// TFLOP/s; its bytes take 10.6 us).
//
// bfloat16 (attention_fwd_mma): the products run on the tensor cores as
// mma.sync.m16n8k16 (bfloat16 operands, float32 accumulators).  A warp
// owns 16 query rows (S = 68 pads to 80: five warps; wgmma's 64-row tiles
// would pad to 128), holds its rotated q as A fragments in registers, and
// walks the keys 16 at a time: scores in registers, an online softmax on
// the fragments (quad shuffles, exp2 with the scale folded in), P rounded
// to bfloat16 and reused in registers as the A fragment of P v (the
// accumulator layout of two m16n8 tiles is the A layout of m16n8k16), v
// read with ldmatrix.trans.  The numerics are FlashAttention's: rotated q
// and k, and P, in bfloat16; scores, softmax and sums in float32.  Rows of
// 64 + 8 bfloat16 make every ldmatrix conflict-free; q, k, v take 34.6 KB
// of shared memory at the flagship shape.  The output is staged through
// the warp's own q rows and stored 16 bytes at a time.
//
// float32 (attention_fwd_simt): float32 on the CUDA cores (the 1e-5 bar
// against the plain version rules out TF32), with register tiles: for the
// scores a thread owns 4 query rows x 4 keys (rows and keys strided by
// S/4, so that neighbouring lanes read neighbouring rows), for P v 4 rows x
// 4 columns, both read as float4 from shared memory padded against bank
// conflicts: 8 multiply-adds per 16-byte load, where a scalar loop does
// one per two 4-byte loads.  The S x S probabilities live in shared
// memory; softmax one warp per row.  74 KB of shared memory at the
// flagship shape, so the launcher raises the kernel's dynamic shared
// memory limit to the device's opt-in maximum once per device.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int kMaxDevices = 64;
constexpr int kMmaMaxWarps = 8;     // a warp loops over 16-row tiles
constexpr int kSimtMaxThreads = 512;

// ---------------------------------------------------------------- bf16 --

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}

// c += a b, a 16 x 16 (row), b 16 x 8 (col), bfloat16 in, float32 sums
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats -> bfloat16 x 2 (round to nearest even), the first in the
// low half, as an mma fragment register holds them
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  return (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(lo)) |
         ((uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(hi)) << 16);
}

// The two bfloat16 of a register, exactly, as floats.
__device__ __forceinline__ float bf16_lo(uint32_t w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float bf16_hi(uint32_t w) {
  return __uint_as_float(w & 0xffff0000u);
}

// a, b: two bfloat16 of the first and the second half of a row, rotated
// in float32 by their angles' cos c0, c1 and sin s0, s1, rounded back.
__device__ __forceinline__ void rotate2(uint32_t& a, uint32_t& b, float c0,
                                        float c1, float s0, float s1) {
  const float a0 = bf16_lo(a), a1 = bf16_hi(a);
  const float b0 = bf16_lo(b), b1 = bf16_hi(b);
  a = pack_bf16(a0 * c0 - b0 * s0, a1 * c1 - b1 * s1);
  b = pack_bf16(a0 * s0 + b0 * c0, a1 * s1 + b1 * c1);
}

// x0, x1: 8 bfloat16 each of the first and the second half of a row; c,
// s: the 8 angles' cos and sin as two float4 each.
__device__ __forceinline__ void rotate8(uint4& x0, uint4& x1, float4 c0,
                                        float4 c1, float4 s0, float4 s1) {
  rotate2(x0.x, x1.x, c0.x, c0.y, s0.x, s0.y);
  rotate2(x0.y, x1.y, c0.z, c0.w, s0.z, s0.w);
  rotate2(x0.z, x1.z, c1.x, c1.y, s1.x, s1.y);
  rotate2(x0.w, x1.w, c1.z, c1.w, s1.z, s1.w);
}

// Rows of HD + 8 bfloat16: ldmatrix's eight 16-byte row reads land on
// eight different 4-bank groups.
template <int HD>
__host__ __device__ constexpr int mma_pitch() {
  return HD + 8;
}

template <int HD>
__global__ void __launch_bounds__(kMmaMaxWarps * 32)
    attention_fwd_mma(const __nv_bfloat16* __restrict__ q,
                      const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v,
                      const float* __restrict__ cos_t,
                      const float* __restrict__ sin_t,
                      __nv_bfloat16* __restrict__ out, int S, int H,
                      float scale_log2) {
  constexpr int P = mma_pitch<HD>();
  constexpr int HALF = HD / 2;
  constexpr int CH = HALF / 8;  // 16-byte chunks in half a row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int Sk = (S + 15) & ~15;  // rows of q, k, v, zero beyond S
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* ks = qs + Sk * P;
  __nv_bfloat16* vs = ks + Sk * P;

  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const size_t tok = (size_t)H * HD;
  const size_t base = (size_t)b * S * tok + (size_t)h * HD;

  // 1. stage q, k (rotated) and v; the ten 16-byte loads of a chunk pair
  //    go out before any is used
  for (int e = threadIdx.x; e < Sk * CH; e += blockDim.x) {
    const int s = e / CH;
    const int col = (e % CH) * 8;
    uint4 q0 = make_uint4(0, 0, 0, 0), q1 = q0, k0 = q0, k1 = q0, v0 = q0,
          v1 = q0;
    if (s < S) {
      const size_t g = base + (size_t)s * tok + col;
      q0 = *reinterpret_cast<const uint4*>(q + g);
      q1 = *reinterpret_cast<const uint4*>(q + g + HALF);
      k0 = *reinterpret_cast<const uint4*>(k + g);
      k1 = *reinterpret_cast<const uint4*>(k + g + HALF);
      v0 = *reinterpret_cast<const uint4*>(v + g);
      v1 = *reinterpret_cast<const uint4*>(v + g + HALF);
      if (cos_t != nullptr) {
        const float4* cp =
            reinterpret_cast<const float4*>(cos_t + s * HALF + col);
        const float4* sp =
            reinterpret_cast<const float4*>(sin_t + s * HALF + col);
        const float4 c0 = cp[0], c1 = cp[1], s0 = sp[0], s1 = sp[1];
        rotate8(q0, q1, c0, c1, s0, s1);
        rotate8(k0, k1, c0, c1, s0, s1);
      }
    }
    *reinterpret_cast<uint4*>(qs + s * P + col) = q0;
    *reinterpret_cast<uint4*>(qs + s * P + col + HALF) = q1;
    *reinterpret_cast<uint4*>(ks + s * P + col) = k0;
    *reinterpret_cast<uint4*>(ks + s * P + col + HALF) = k1;
    *reinterpret_cast<uint4*>(vs + s * P + col) = v0;
    *reinterpret_cast<uint4*>(vs + s * P + col + HALF) = v1;
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;  // fragment row (and row + 8)
  const int t = lane & 3;   // fragment column pair
  for (int m0 = warp * 16; m0 < Sk; m0 += (blockDim.x >> 5) * 16) {
    // 2. this tile's rotated q as A fragments, hd / 16 of them
    uint32_t qa[HD / 16][4];
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      ldsm_x4(qa[kk], qs + (m0 + (lane & 15)) * P + kk * 16 + (lane >> 4) * 8);
    float o[HD / 8][4];
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0;
    float mx[2] = {-INFINITY, -INFINITY};  // running max, rows g and g + 8
    float l[2] = {0.0f, 0.0f};  // this thread's part of the running sums

    for (int n0 = 0; n0 < Sk; n0 += 16) {
      // 3. scores of 16 rows x 16 keys, two m16n8 tiles
      float sc[2][4] = {{0, 0, 0, 0}, {0, 0, 0, 0}};
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        uint32_t kb[4];
        ldsm_x4(kb, ks + (n0 + (lane & 7) + ((lane >> 4) << 3)) * P + kk * 16 +
                        ((lane >> 3) & 1) * 8);
        mma_bf16(sc[0], qa[kk], kb[0], kb[1]);
        mma_bf16(sc[1], qa[kk], kb[2], kb[3]);
      }
      // 4. online softmax in base 2; keys past S get probability 0
      float rmax[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = n0 + nt * 8 + 2 * t + (e & 1);
          sc[nt][e] = key < S ? sc[nt][e] * scale_log2 : -INFINITY;
          rmax[e >> 1] = fmaxf(rmax[e >> 1], sc[nt][e]);
        }
      float corr[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        rmax[r] = fmaxf(rmax[r], __shfl_xor_sync(0xffffffffu, rmax[r], 1));
        rmax[r] = fmaxf(rmax[r], __shfl_xor_sync(0xffffffffu, rmax[r], 2));
        const float m_new = fmaxf(mx[r], rmax[r]);  // finite: key 0 is real
        corr[r] = exp2f(mx[r] - m_new);
        mx[r] = m_new;
        l[r] *= corr[r];
      }
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          sc[nt][e] = exp2f(sc[nt][e] - mx[e >> 1]);
          l[e >> 1] += sc[nt][e];
        }
#pragma unroll
      for (int n = 0; n < HD / 8; ++n) {
        o[n][0] *= corr[0];
        o[n][1] *= corr[0];
        o[n][2] *= corr[1];
        o[n][3] *= corr[1];
      }
      // 5. o += P v: P's accumulators are its A fragment
      const uint32_t pa[4] = {pack_bf16(sc[0][0], sc[0][1]),
                              pack_bf16(sc[0][2], sc[0][3]),
                              pack_bf16(sc[1][0], sc[1][1]),
                              pack_bf16(sc[1][2], sc[1][3])};
#pragma unroll
      for (int dp = 0; dp < HD / 16; ++dp) {
        uint32_t vb[4];
        ldsm_x4_trans(vb, vs + (n0 + (lane & 7) + ((lane >> 3) & 1) * 8) * P +
                              dp * 16 + (lane >> 4) * 8);
        mma_bf16(o[2 * dp], pa, vb[0], vb[1]);
        mma_bf16(o[2 * dp + 1], pa, vb[2], vb[3]);
      }
    }

    // 6. normalise, stage the tile in its own q rows, store 16 bytes a lane
    float inv[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      inv[r] = 1.0f / l[r];
    }
    __nv_bfloat16* os = qs + m0 * P;
    __syncwarp();
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) {
      const int col = n * 8 + 2 * t;
      *reinterpret_cast<uint32_t*>(os + g * P + col) =
          pack_bf16(o[n][0] * inv[0], o[n][1] * inv[0]);
      *reinterpret_cast<uint32_t*>(os + (g + 8) * P + col) =
          pack_bf16(o[n][2] * inv[1], o[n][3] * inv[1]);
    }
    __syncwarp();
    for (int e = lane; e < 16 * (HD / 8); e += 32) {
      const int r = e / (HD / 8);
      const int col = (e % (HD / 8)) * 8;
      if (m0 + r < S)
        *reinterpret_cast<uint4*>(out + base + (size_t)(m0 + r) * tok + col) =
            *reinterpret_cast<const uint4*>(os + r * P + col);
    }
  }
}

// ---------------------------------------------------------------- f32 --

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

// acc += p * v, componentwise over v's four columns
__device__ __forceinline__ void axpy4(float p, float4 v, float4& acc) {
  acc.x = fmaf(p, v.x, acc.x);
  acc.y = fmaf(p, v.y, acc.y);
  acc.z = fmaf(p, v.z, acc.z);
  acc.w = fmaf(p, v.w, acc.w);
}

// Shared-memory layout of the float32 kernel, in floats: q and k rows of
// hd + 4, v rows of hd, probability rows of Sp + 4, Sp = S rounded up to 4.
struct SimtLayout {
  int Sp, qp, pp;
  __host__ __device__ SimtLayout(int S, int hd)
      : Sp((S + 3) & ~3), qp(hd + 4), pp(((S + 3) & ~3) + 4) {}
  __host__ __device__ size_t floats(int hd) const {
    return (size_t)Sp * (2 * qp + hd + pp);
  }
};

__global__ void __launch_bounds__(kSimtMaxThreads)
    attention_fwd_simt(const float* __restrict__ q, const float* __restrict__ k,
                       const float* __restrict__ v,
                       const float* __restrict__ cos_t,
                       const float* __restrict__ sin_t,
                       float* __restrict__ out, int S, int H, int hd,
                       float scale) {
  extern __shared__ __align__(16) float smem[];
  const SimtLayout L(S, hd);
  const int Sp = L.Sp, QP = L.qp, PP = L.pp;
  const int Ni = Sp / 4;  // a thread's rows (and keys) are Ni apart
  float* qs = smem;
  float* ks = qs + Sp * QP;
  float* vs = ks + Sp * QP;
  float* p = vs + Sp * hd;

  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const size_t tok = (size_t)H * hd;
  const size_t base = (size_t)b * S * tok + (size_t)h * hd;
  const int half = hd / 2;
  const int CH = half / 4;

  // 1. stage q, k (rotated) and v, 16 bytes at a time; rows S..Sp-1 zero
  for (int e = threadIdx.x; e < Sp * CH; e += blockDim.x) {
    const int s = e / CH;
    const int col = (e % CH) * 4;
    const float4 zero = make_float4(0, 0, 0, 0);
    float4 q0 = zero, q1 = zero, k0 = zero, k1 = zero, v0 = zero, v1 = zero;
    if (s < S) {
      const size_t g = base + (size_t)s * tok + col;
      q0 = ld4(q + g);
      q1 = ld4(q + g + half);
      k0 = ld4(k + g);
      k1 = ld4(k + g + half);
      v0 = ld4(v + g);
      v1 = ld4(v + g + half);
      if (cos_t != nullptr) {
        const float4 c = ld4(cos_t + s * half + col);
        const float4 sn = ld4(sin_t + s * half + col);
        const float4 a = q0, bq = q1, ka = k0, kb = k1;
        q0 = make_float4(a.x * c.x - bq.x * sn.x, a.y * c.y - bq.y * sn.y,
                         a.z * c.z - bq.z * sn.z, a.w * c.w - bq.w * sn.w);
        q1 = make_float4(a.x * sn.x + bq.x * c.x, a.y * sn.y + bq.y * c.y,
                         a.z * sn.z + bq.z * c.z, a.w * sn.w + bq.w * c.w);
        k0 = make_float4(ka.x * c.x - kb.x * sn.x, ka.y * c.y - kb.y * sn.y,
                         ka.z * c.z - kb.z * sn.z, ka.w * c.w - kb.w * sn.w);
        k1 = make_float4(ka.x * sn.x + kb.x * c.x, ka.y * sn.y + kb.y * c.y,
                         ka.z * sn.z + kb.z * c.z, ka.w * sn.w + kb.w * c.w);
      }
    }
    *reinterpret_cast<float4*>(qs + s * QP + col) = q0;
    *reinterpret_cast<float4*>(qs + s * QP + col + half) = q1;
    *reinterpret_cast<float4*>(ks + s * QP + col) = k0;
    *reinterpret_cast<float4*>(ks + s * QP + col + half) = k1;
    *reinterpret_cast<float4*>(vs + s * hd + col) = v0;
    *reinterpret_cast<float4*>(vs + s * hd + col + half) = v1;
  }
  __syncthreads();

  // 2. scores: rows ti + a Ni and keys tj + c Ni, a, c < 4
  for (int e = threadIdx.x; e < Ni * Ni; e += blockDim.x) {
    const int ti = e / Ni;
    const int tj = e % Ni;
    float acc[4][4] = {};
    for (int d = 0; d < hd; d += 4) {
      float4 qa[4], kb[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        qa[a] = ld4(qs + (ti + a * Ni) * QP + d);
        kb[a] = ld4(ks + (tj + a * Ni) * QP + d);
      }
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[a][c] = dot4(qa[a], kb[c], acc[a][c]);
    }
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        p[(ti + a * Ni) * PP + tj + c * Ni] = scale * acc[a][c];
  }
  __syncthreads();

  // 3. row softmax over the S real keys, one warp per row; keys S..Sp-1
  //    get probability 0
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int nwarps = blockDim.x / 32;
  for (int i = warp; i < S; i += nwarps) {
    float* row = p + i * PP;
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
    for (int j = lane; j < Sp; j += 32) row[j] = j < S ? row[j] / sum : 0.0f;
  }
  __syncthreads();

  // 4. out = P v: rows ti + a Ni, columns 4 tc .. 4 tc + 3
  const int C4 = hd / 4;
  for (int e = threadIdx.x; e < Ni * C4; e += blockDim.x) {
    const int ti = e / C4;
    const int tc = e % C4;
    float4 acc[4];
#pragma unroll
    for (int a = 0; a < 4; ++a) acc[a] = make_float4(0, 0, 0, 0);
    for (int j = 0; j < Sp; j += 4) {
      float4 pa[4], vb[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        pa[a] = ld4(p + (ti + a * Ni) * PP + j);
        vb[a] = ld4(vs + (j + a) * hd + 4 * tc);
      }
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        axpy4(pa[a].x, vb[0], acc[a]);
        axpy4(pa[a].y, vb[1], acc[a]);
        axpy4(pa[a].z, vb[2], acc[a]);
        axpy4(pa[a].w, vb[3], acc[a]);
      }
    }
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int i = ti + a * Ni;
      if (i < S)
        *reinterpret_cast<float4*>(out + base + (size_t)i * tok + 4 * tc) =
            acc[a];
    }
  }
}

// --------------------------------------------------------------- launch --

// A kernel's dynamic shared-memory limit is raised to the device's opt-in
// maximum once per (kernel, device), not on every launch; the wrapper
// refuses shapes above that maximum.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, std::atomic<bool> (&raised)[kMaxDevices]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (raised[dev].load()) return cudaSuccess;
  int optin = 0;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             optin);
  if (err != cudaSuccess) return err;
  raised[dev].store(true);
  return cudaSuccess;
}

template <int HD>
int launch_mma(const void* q, const void* k, const void* v, const float* cos_t,
               const float* sin_t, void* out, int B, int S, int H,
               void* stream) {
  static std::atomic<bool> raised[kMaxDevices];
  cudaError_t err = allow_smem(attention_fwd_mma<HD>, raised);
  if (err != cudaSuccess) return (int)err;
  const int Sk = (S + 15) / 16 * 16;
  const size_t smem = sizeof(__nv_bfloat16) * 3 * (size_t)Sk * mma_pitch<HD>();
  const int warps = Sk / 16 < kMmaMaxWarps ? Sk / 16 : kMmaMaxWarps;
  const float scale_log2 = 1.4426950408889634f / sqrtf((float)HD);
  attention_fwd_mma<HD><<<B * H, warps * 32, smem, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
      (const __nv_bfloat16*)v, cos_t, sin_t, (__nv_bfloat16*)out, S, H,
      scale_log2);
  return (int)cudaGetLastError();
}

}  // namespace

// C ABI, bound with ctypes by cliffordtpu_torch/kernels/attention.py.
// q, k, v, out contiguous (B, S, H, hd) and 16-byte aligned; cos, sin
// contiguous (S, hd/2) float32, 16-byte aligned, or both null.  float32
// takes hd a multiple of 8, bfloat16 hd 16, 32, 64 or 128.  The wrapper
// checks shapes, types, alignment and the shared memory size.  Returns the
// CUDA error of the attribute call or launch.
extern "C" int attention_fwd_f32(const void* q, const void* k, const void* v,
                                 const float* cos_t, const float* sin_t,
                                 void* out, int B, int S, int H, int hd,
                                 void* stream) {
  static std::atomic<bool> raised[kMaxDevices];
  cudaError_t err = allow_smem(attention_fwd_simt, raised);
  if (err != cudaSuccess) return (int)err;
  const SimtLayout L(S, hd);
  const int Ni = L.Sp / 4;
  const int items = Ni * (Ni > hd / 4 ? Ni : hd / 4);
  const int threads = items >= kSimtMaxThreads ? kSimtMaxThreads
                                               : (items + 31) / 32 * 32;
  attention_fwd_simt<<<B * H, threads, sizeof(float) * L.floats(hd),
                       (cudaStream_t)stream>>>(
      (const float*)q, (const float*)k, (const float*)v, cos_t, sin_t,
      (float*)out, S, H, hd, 1.0f / sqrtf((float)hd));
  return (int)cudaGetLastError();
}

extern "C" int attention_fwd_bf16(const void* q, const void* k, const void* v,
                                  const float* cos_t, const float* sin_t,
                                  void* out, int B, int S, int H, int hd,
                                  void* stream) {
  switch (hd) {
    case 16: return launch_mma<16>(q, k, v, cos_t, sin_t, out, B, S, H, stream);
    case 32: return launch_mma<32>(q, k, v, cos_t, sin_t, out, B, S, H, stream);
    case 64: return launch_mma<64>(q, k, v, cos_t, sin_t, out, B, S, H, stream);
    case 128:
      return launch_mma<128>(q, k, v, cos_t, sin_t, out, B, S, H, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}
