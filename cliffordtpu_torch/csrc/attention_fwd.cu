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
// never touch HBM.  These whole-sequence forms take the shapes whose
// sequence fits half an SM's shared memory; the key-tiled forms (section
// "tiled" below) take the longer sequences that JAX's attention_supported
// admits.
//
// q, k and v are read at a token stride ld_tok and a head stride ld_head
// (elements; the batch stride is S ld_tok): H hd and hd for contiguous
// (B, S, H, hd) tensors, 3 H hd and 3 hd for the views of one packed
// (B, S, H, 3, hd) projection (fused_proj's wqkv product), which are read
// in place, with no copy.  out is contiguous (B, S, H, hd).
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

#include "attention_tiles.cuh"

namespace {

constexpr int kMmaMaxWarps = 8;     // a warp loops over 16-row tiles
constexpr int kSimtMaxThreads = 512;

// ---------------------------------------------------------------- bf16 --
// The fragment helpers, rotate8 and mma_pitch are attention_tiles.cuh's.

template <int HD>
__global__ void __launch_bounds__(kMmaMaxWarps * 32)
    attention_fwd_mma(const __nv_bfloat16* __restrict__ q,
                      const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v,
                      const float* __restrict__ cos_t,
                      const float* __restrict__ sin_t,
                      __nv_bfloat16* __restrict__ out, int S, int H,
                      int ld_tok, int ld_head, float scale_log2) {
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
  const size_t ibase = (size_t)b * S * ld_tok + (size_t)h * ld_head;

  // 1. stage q, k (rotated) and v; the ten 16-byte loads of a chunk pair
  //    go out before any is used
  for (int e = threadIdx.x; e < Sk * CH; e += blockDim.x) {
    const int s = e / CH;
    const int col = (e % CH) * 8;
    uint4 q0 = make_uint4(0, 0, 0, 0), q1 = q0, k0 = q0, k1 = q0, v0 = q0,
          v1 = q0;
    if (s < S) {
      const size_t g = ibase + (size_t)s * ld_tok + col;
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
// ld4, dot4 and axpy4 are attention_tiles.cuh's.

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
                       int ld_tok, int ld_head, float scale) {
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
  const size_t ibase = (size_t)b * S * ld_tok + (size_t)h * ld_head;
  const int half = hd / 2;
  const int CH = half / 4;

  // 1. stage q, k (rotated) and v, 16 bytes at a time; rows S..Sp-1 zero
  for (int e = threadIdx.x; e < Sp * CH; e += blockDim.x) {
    const int s = e / CH;
    const int col = (e % CH) * 4;
    const float4 zero = make_float4(0, 0, 0, 0);
    float4 q0 = zero, q1 = zero, k0 = zero, k1 = zero, v0 = zero, v1 = zero;
    if (s < S) {
      const size_t g = ibase + (size_t)s * ld_tok + col;
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

// -------------------------------------------------------------- tiled --
//
// The key-tiled forms (attention_fwd_tiled_f32, attention_fwd_tiled_bf16)
// replace the same pallas_call (_attn_fwd_call) at the shapes whose whole
// sequence does not fit half an SM's shared memory
// (kernels/attention.py::route): S 260 at image 256 (default_config(256),
// 8 heads of 64) needs 482,560 bytes in the float32 form above, and the
// bfloat16 one, at 117,504, would run 32 blocks on 132 SMs.  A block owns
// 16-row query units of one (batch, head) and walks the keys a tile at a
// time through a ring of shared-memory stages filled by cp.async
// (attention_tiles.cuh): the next tiles' copies are in flight during a
// tile's products, K is rotated by the threads that copied it, and each
// unit's walk is split among several warps, each with its own online
// softmax (a running maximum and sum per row in float32, the partial
// output rescaled by exp(m_old - m_new)), merged in split order at the end
// through shared memory.  Keys past S are masked to -1e30
// (attention_pallas.py::_NEG); query rows past S are zero and never
// stored.  Shared memory does not depend on S.  With a non-null lse the
// block also writes each row's log-sum-exp of the scaled scores, float32
// (B, H, S), which the tiled backward reads to recompute P.
//
// What bounds it: at image 256's shape (B 4, S 260, H 8, hd 64) the
// function moves 8.6 MB in float32 (q, k, v, out, the tables; 4.3 MB in
// bfloat16) and does 4 B H S^2 hd = 0.55 GFLOP: the float32 form is bound
// by the CUDA cores' rate (8.3 us at 67 TFLOP/s; its bytes take 2.6 us),
// the bfloat16 form by HBM bandwidth (1.3 us at 3.35 TB/s; the tensor
// cores need 0.56 us).  Neither comes near.  With 32 (batch, head)s each
// unit's walk of 260 keys is long: the float32 form is held by
// shared-memory reads (a float4 read takes four cycles of the SM's 128
// bytes a cycle) and the warps an SM holds, the bfloat16 one by the walk's
// chain of dependent steps (a tile's copies, its rotation, its products,
// the softmax between them) in few warps.  The design: a unit's keys are
// split among warps, so each walks a third (float32) or half (bfloat16) of
// them, and a block holds every unit it can, so that each block's copies
// and rotation of K serve more rows.
//
// float32 (attention_fwd_tiled_simt): up to head_dim 64, blocks of 5
// units whose keys are split among 3 warps (15 warps; 4 blocks of 4 or 5
// units a (batch, head), 128 blocks, one wave): rounds of 96 keys, a
// 32-key sub-tile for each split, in two stages; scores in a 4 x 4
// register tile a thread (attention_tiles.cuh, float32 tiled forms), the
// row maximum by shuffles among the row's 8 lanes, P through the warp's
// own scratch rows, and O with each row's maximum and sum in registers for
// the whole walk (4 rows x 8 columns a thread at hd 64).  185 KB of shared
// memory at hd 64, one block an SM.  Up to 128, 4 units and no split;
// wider head_dims (up to 440) keep the first tiled form, its partial output in
// shared memory (attention_fwd_tiled_simt_wide).
//
// bfloat16 (attention_fwd_tiled_mma): blocks of 6 units whose key tiles of
// 64 are split between 2 warps (12 warps; 3 blocks of 5 or 6 units a
// (batch, head), 96 blocks), two stages.  Each warp keeps its rotated q
// rows as A fragments and takes its half of a landed tile at once: the
// scores of 32 keys (four independent m16n8 sums), one online-softmax step
// on the fragments, P reused in registers for P v.  66 KB at hd 64.

// The float32 tiled forward's geometry by head_dim: up to 64, blocks of
// up to 5 own units, each unit's keys split among 3 warps (15 warps); up to
// kSimtMaxHd, up to 4 units and no split (their ring would not fit).
__host__ __device__ constexpr int simt_fwd_splits(int hd) {
  return hd <= 64 ? 3 : 1;
}
__host__ __device__ constexpr int simt_fwd_units(int hd) {
  return hd <= 64 ? 5 : 4;
}

// floats of shared memory of the float32 tiled forward: the block's query
// rows; a ring of two stages of a key round (KS sub-tiles of 32 keys) and
// its values, in rows of hd + 4; one round's RoPE tables; each warp's
// probabilities.  The split warps' partial outputs are merged through the
// ring once the walk is done.
__host__ __device__ inline size_t tiled_simt_floats(int hd) {
  const int U = simt_fwd_units(hd), KS = simt_fwd_splits(hd);
  return (size_t)(16 * U + 4 * KS * kSimtWalk) * (hd + 4) +
         (size_t)KS * kSimtWalk * hd + (size_t)U * KS * 16 * kSimtScratch;
}

// floats of the wide form: q, k, v and the partial output in rows of
// hd + 4, the probabilities in rows of 36, three row vectors
__host__ __device__ inline size_t tiled_simt_wide_floats(int hd) {
  return (size_t)4 * kTileF32 * (hd + 4) + kTileF32 * (kTileF32 + 4) +
         3 * kTileF32;
}

// bytes of the bfloat16 tiled forward: the block's query rows and the ring
// of key and value tiles in rows of hd + 8, the RoPE tables of the tiles in
// flight
template <int HD>
constexpr size_t tiled_mma_bytes() {
  return sizeof(__nv_bfloat16) *
             (16 * kMmaFwdUnits + 2 * kMmaFwdStages * kMmaFwdWalk) *
             mma_pitch<HD>() +
         sizeof(float) * (kMmaFwdStages - 1) * kMmaFwdWalk * HD;
}

// NP: 16-byte column pairs a lane owns (1 up to head_dim 64, 2 up to 128);
// KS: key splits (simt_fwd_splits), U: own units a block at most.
template <int NP, int KS, int U>
__global__ void __launch_bounds__(U * KS * 32)
    attention_fwd_tiled_simt(const float* __restrict__ q,
                             const float* __restrict__ k,
                             const float* __restrict__ v,
                             const float* __restrict__ cos_t,
                             const float* __restrict__ sin_t,
                             float* __restrict__ out, float* __restrict__ lse,
                             int S, int H, int hd, int ld_tok, int ld_head,
                             float scale) {
  constexpr int TW = kSimtWalk;  // keys of a warp's sub-tile
  constexpr int RW = KS * TW;    // keys of a round
  constexpr int PP = kSimtScratch;
  extern __shared__ __align__(16) float smem[];
  const int QP = hd + 4;
  const int half = hd / 2;
  float* qs = smem;                 // the block's query rows
  float* ring = qs + 16 * U * QP;   // a stage: a round's K rows, then V
  float* cs = ring + 4 * RW * QP;   // the round in flight's tables
  float* sn = cs + RW * half;
  float* scratch = sn + RW * half;  // each warp's P

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh % H;
  const UnitSpan span = unit_span((S + 15) / 16, gridDim.y, blockIdx.y);
  const int warp = threadIdx.x >> 5;
  const int nw = span.n * KS;  // warps with work: (unit, split)
  if (warp >= nw) return;      // leave before any barrier
  const int unit = warp % span.n;
  const int split = warp / span.n;
  const int tid = threadIdx.x;
  const int nthreads = nw * 32;
  const int lane = tid & 31;
  const int rg = lane >> 3;  // rows rg + 4 a of the warp's unit
  const int cg = lane & 7;   // keys cg + 8 c of a sub-tile; columns 4 cg + 32 i
  const int q0 = span.u0 * 16;
  const size_t tok = (size_t)H * hd;
  const size_t base = (size_t)b * S * tok + (size_t)h * hd;
  const size_t ibase = (size_t)b * S * ld_tok + (size_t)h * ld_head;
  const bool rope = cos_t != nullptr;
  const int nrounds = (S + RW - 1) / RW;
  const float* qw = qs + unit * 16 * QP;
  float* ps = scratch + warp * 16 * PP;

  auto issue = [&](int r) {  // K (with its tables) and V of round r
    float* st = ring + (r & 1) * 2 * RW * QP;
    async_pairs(st, QP, cs, sn, k, ibase, ld_tok, cos_t, sin_t, r * RW, RW,
                S, half, tid, nthreads);
    async_rows(st + RW * QP, QP, v, ibase, ld_tok, r * RW, RW, S, hd, tid,
               nthreads);
    cp_async_commit();
  };
  issue(0);
  stage_rows_f32(qs, QP, q, ibase, ld_tok, q0, span.n * 16, S, hd, cos_t,
                 sin_t, tid, nthreads);

  float4 o0[4][NP], o1[4][NP];  // O at columns 4 cg + 32 i, + hd/2
  float m[4], l[4];             // running maximum; this lane's share of sums
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    m[a] = -INFINITY;
    l[a] = 0.0f;
#pragma unroll
    for (int i = 0; i < NP; ++i) o0[a][i] = o1[a][i] = make_float4(0, 0, 0, 0);
  }

  for (int r = 0; r < nrounds; ++r) {
    cp_async_wait<0>();  // this thread's copies of round r
    float* st = ring + (r & 1) * 2 * RW * QP;
    if (rope) rotate_pairs_f32(st, QP, cs, sn, RW, half, tid, nthreads);
    bar_sync(nthreads);  // round r ready; round r - 1, the tables unread
    if (r + 1 < nrounds) issue(r + 1);
    const int k0 = r * RW + split * TW;  // the warp's sub-tile
    if (k0 >= S) continue;
    const float* ks = st + split * TW * QP;
    const float* vs = st + (RW + split * TW) * QP;
    // 1. scores of rows rg + 4 a and keys cg + 8 c
    float s[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[a][c] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < hd; d += 4) {
      float4 qa[4], kb[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) qa[a] = ld4(qw + (rg + 4 * a) * QP + d);
#pragma unroll
      for (int c = 0; c < 4; ++c) kb[c] = ld4(ks + (cg + 8 * c) * QP + d);
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[a][c] = dot4(qa[a], kb[c], s[a][c]);
    }
    // 2. online softmax: a row's 32 keys lie in its 8 lanes
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      float mt = kNeg;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        s[a][c] = k0 + cg + 8 * c < S ? scale * s[a][c] : kNeg;
        mt = fmaxf(mt, s[a][c]);
      }
      mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 1));
      mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 2));
      mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 4));
      const float m_new = fmaxf(m[a], mt);  // finite: key k0 is real
      const float corr = expf(m[a] - m_new);
      m[a] = m_new;
      l[a] *= corr;
#pragma unroll
      for (int i = 0; i < NP; ++i) {
        scale4(o0[a][i], corr);
        scale4(o1[a][i], corr);
      }
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float p = expf(s[a][c] - m_new);
        l[a] += p;
        ps[(rg + 4 * a) * PP + cg + 8 * c] = p;
      }
    }
    __syncwarp();
    // 3. O += P V
#pragma unroll 2
    for (int jj = 0; jj < TW; jj += 4) {
      float4 pa[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) pa[a] = ld4(ps + (rg + 4 * a) * PP + jj);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float* vr = vs + (jj + u) * QP;
#pragma unroll
        for (int i = 0; i < NP; ++i) {
          const int c = 4 * cg + 32 * i;
          if (c >= half) continue;
          const float4 v0 = ld4(vr + c), v1 = ld4(vr + c + half);
#pragma unroll
          for (int a = 0; a < 4; ++a) {
            const float w = comp(pa[a], u);
            axpy4(w, v0, o0[a][i]);
            axpy4(w, v1, o1[a][i]);
          }
        }
      }
    }
    __syncwarp();  // P is rewritten by the next sub-tile
  }

  // 4. a row's sum over its 8 lanes; the splits past the first hand their
  //    maximum, sum and partial output to the first through the ring, which
  //    merges them in split order
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    l[a] += __shfl_xor_sync(0xffffffffu, l[a], 1);
    l[a] += __shfl_xor_sync(0xffffffffu, l[a], 2);
    l[a] += __shfl_xor_sync(0xffffffffu, l[a], 4);
  }
  const int MS = 16 * (hd + 2);  // floats of a handed-over unit
  if (KS > 1) {
    bar_sync(nthreads);  // every warp is done with the ring
    if (split > 0) {
      float* mo = ring + ((split - 1) * span.n + unit) * MS;
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int rr = rg + 4 * a;
#pragma unroll
        for (int i = 0; i < NP; ++i) {
          const int c = 4 * cg + 32 * i;
          if (c >= half) continue;
          st4(mo + rr * hd + c, o0[a][i]);
          st4(mo + rr * hd + c + half, o1[a][i]);
        }
        if (cg == 0) {
          mo[16 * hd + rr] = m[a];
          mo[16 * hd + 16 + rr] = l[a];
        }
      }
    }
    bar_sync(nthreads);
    if (split > 0) return;
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int rr = rg + 4 * a;
      float mm = m[a];
#pragma unroll
      for (int x = 1; x < KS; ++x)
        mm = fmaxf(mm, ring[((x - 1) * span.n + unit) * MS + 16 * hd + rr]);
      const float w = expf(m[a] - mm);
      l[a] *= w;
#pragma unroll
      for (int i = 0; i < NP; ++i) {
        scale4(o0[a][i], w);
        scale4(o1[a][i], w);
      }
#pragma unroll
      for (int x = 1; x < KS; ++x) {
        const float* mo = ring + ((x - 1) * span.n + unit) * MS;
        const float wx = expf(mo[16 * hd + rr] - mm);
        l[a] = fmaf(mo[16 * hd + 16 + rr], wx, l[a]);
#pragma unroll
        for (int i = 0; i < NP; ++i) {
          const int c = 4 * cg + 32 * i;
          if (c >= half) continue;
          axpy4(wx, ld4(mo + rr * hd + c), o0[a][i]);
          axpy4(wx, ld4(mo + rr * hd + c + half), o1[a][i]);
        }
      }
      m[a] = mm;
    }
  }

  // 5. out = O / l, and the log-sum-exp m + log l
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int row = q0 + unit * 16 + rg + 4 * a;
    if (row >= S) continue;
    const float inv = 1.0f / l[a];
    float* dst = out + base + (size_t)row * tok;
#pragma unroll
    for (int i = 0; i < NP; ++i) {
      const int c = 4 * cg + 32 * i;
      if (c >= half) continue;
      float4 x0 = o0[a][i], x1 = o1[a][i];
      scale4(x0, inv);
      scale4(x1, inv);
      st4(dst + c, x0);
      st4(dst + c + half, x1);
    }
    if (lse != nullptr && cg == 0)
      lse[(size_t)bh * S + row] = m[a] + logf(l[a]);
  }
}

// The first float32 tiled forward, for head_dims above kSimtMaxHd (no model
// of the repo has one): tiles of 32 queries and 32 keys, 128 threads; a
// thread computes 2 query rows x 4 keys of the scores, the softmax takes
// one warp a row, and the partial output lives in shared memory.
__global__ void __launch_bounds__(kTiledF32Threads)
    attention_fwd_tiled_simt_wide(const float* __restrict__ q,
                                  const float* __restrict__ k,
                                  const float* __restrict__ v,
                                  const float* __restrict__ cos_t,
                                  const float* __restrict__ sin_t,
                                  float* __restrict__ out,
                                  float* __restrict__ lse, int S, int H,
                                  int hd, int ld_tok, int ld_head,
                                  float scale) {
  constexpr int T = kTileF32;
  constexpr int PP = T + 4;
  extern __shared__ __align__(16) float smem[];
  const int QP = hd + 4;
  float* qs = smem;
  float* ks = qs + T * QP;
  float* vs = ks + T * QP;
  float* os = vs + T * QP;  // the partial output
  float* ps = os + T * QP;  // scores, then probabilities
  float* m_s = ps + T * PP;
  float* l_s = m_s + T;
  float* corr_s = l_s + T;

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh % H;
  const int q0 = blockIdx.y * T;
  const size_t tok = (size_t)H * hd;
  const size_t base = (size_t)b * S * tok + (size_t)h * hd;
  const size_t ibase = (size_t)b * S * ld_tok + (size_t)h * ld_head;
  const int C4 = hd / 4;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int nwarps = nt / 32;

  stage_rows_f32(qs, QP, q, ibase, ld_tok, q0, T, S, hd, cos_t, sin_t, tid,
                 nt);
  for (int e = tid; e < T * QP; e += nt) os[e] = 0.0f;
  for (int r = tid; r < T; r += nt) {
    m_s[r] = -INFINITY;
    l_s[r] = 0.0f;
  }
  for (int k0 = 0; k0 < S; k0 += T) {
    __syncthreads();  // the last tile's k, v and P are no longer read
    stage_rows_f32(ks, QP, k, ibase, ld_tok, k0, T, S, hd, cos_t, sin_t, tid,
                   nt);
    stage_rows_f32(vs, QP, v, ibase, ld_tok, k0, T, S, hd, nullptr, nullptr,
                   tid, nt);
    __syncthreads();
    // 1. scores of rows ti + 16 a (a < 2) and keys tj + 8 c (c < 4)
    for (int e = tid; e < 16 * 8; e += nt) {
      const int ti = e / 8;
      const int tj = e % 8;
      float acc[2][4] = {};
      for (int d = 0; d < hd; d += 4) {
        float4 qa[2], kb[4];
#pragma unroll
        for (int a = 0; a < 2; ++a) qa[a] = ld4(qs + (ti + 16 * a) * QP + d);
#pragma unroll
        for (int c = 0; c < 4; ++c) kb[c] = ld4(ks + (tj + 8 * c) * QP + d);
#pragma unroll
        for (int a = 0; a < 2; ++a)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[a][c] = dot4(qa[a], kb[c], acc[a][c]);
      }
#pragma unroll
      for (int a = 0; a < 2; ++a)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int key = tj + 8 * c;
          ps[(ti + 16 * a) * PP + key] =
              k0 + key < S ? scale * acc[a][c] : kNeg;
        }
    }
    __syncthreads();
    // 2. online softmax, a warp a row, lane j on key j
    for (int i = warp; i < T; i += nwarps) {
      const float s = ps[i * PP + lane];
      float mt = s;
      for (int o = 16; o > 0; o >>= 1)
        mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, o));
      const float m_old = m_s[i];
      const float m_new = fmaxf(m_old, mt);  // finite: key k0 is real
      const float p = expf(s - m_new);
      float sum = p;
      for (int o = 16; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      ps[i * PP + lane] = p;
      __syncwarp();
      if (lane == 0) {
        const float corr = expf(m_old - m_new);
        corr_s[i] = corr;
        l_s[i] = l_s[i] * corr + sum;
        m_s[i] = m_new;
      }
    }
    __syncthreads();
    // 3. O = O corr + P v: rows ti + 16 a, columns 4 tc .. 4 tc + 3
    for (int e = tid; e < 16 * C4; e += nt) {
      const int ti = e / C4;
      const int tc = e % C4;
      float4 acc[2];
#pragma unroll
      for (int a = 0; a < 2; ++a) {
        const int r = ti + 16 * a;
        const float c = corr_s[r];
        const float4 o = ld4(os + r * QP + 4 * tc);
        acc[a] = make_float4(o.x * c, o.y * c, o.z * c, o.w * c);
      }
      for (int j = 0; j < T; j += 4) {
        float4 pa[2], vb[4];
#pragma unroll
        for (int a = 0; a < 2; ++a) pa[a] = ld4(ps + (ti + 16 * a) * PP + j);
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) vb[jj] = ld4(vs + (j + jj) * QP + 4 * tc);
#pragma unroll
        for (int a = 0; a < 2; ++a) {
          axpy4(pa[a].x, vb[0], acc[a]);
          axpy4(pa[a].y, vb[1], acc[a]);
          axpy4(pa[a].z, vb[2], acc[a]);
          axpy4(pa[a].w, vb[3], acc[a]);
        }
      }
#pragma unroll
      for (int a = 0; a < 2; ++a)
        st4(os + (ti + 16 * a) * QP + 4 * tc, acc[a]);
    }
  }
  __syncthreads();
  // 4. out = O / l, and the log-sum-exp m + log l
  for (int e = tid; e < T * C4; e += nt) {
    const int r = e / C4;
    const int tc = e % C4;
    if (q0 + r >= S) continue;
    const float inv = 1.0f / l_s[r];
    const float4 o = ld4(os + r * QP + 4 * tc);
    st4(out + base + (size_t)(q0 + r) * tok + 4 * tc,
        make_float4(o.x * inv, o.y * inv, o.z * inv, o.w * inv));
  }
  if (lse != nullptr)
    for (int r = tid; r < T; r += nt)
      if (q0 + r < S) lse[(size_t)bh * S + q0 + r] = m_s[r] + logf(l_s[r]);
}

template <int HD>
__global__ void __launch_bounds__(kMmaFwdUnits * kMmaFwdSplits * 32)
    attention_fwd_tiled_mma(const __nv_bfloat16* __restrict__ q,
                            const __nv_bfloat16* __restrict__ k,
                            const __nv_bfloat16* __restrict__ v,
                            const float* __restrict__ cos_t,
                            const float* __restrict__ sin_t,
                            __nv_bfloat16* __restrict__ out,
                            float* __restrict__ lse, int S, int H, int ld_tok,
                            int ld_head, float scale_log2) {
  constexpr int P = mma_pitch<HD>();
  constexpr int HALF = HD / 2;
  constexpr int TW = kMmaFwdWalk;
  constexpr int KS = kMmaFwdSplits;
  constexpr int NC = TW / 16 / KS;  // 16-key chunks of a warp's share
  constexpr int STAGES = kMmaFwdStages;
  constexpr int MS = 32 * (HD / 2 + 4);  // floats a handed-over warp
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // the block's query rows; a ring of STAGES stages of a K tile and a V
  // tile; the tables of the STAGES - 1 key tiles in flight
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* ring = qs + 16 * kMmaFwdUnits * P;
  float* tables = reinterpret_cast<float*>(ring + STAGES * 2 * TW * P);

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh % H;
  const UnitSpan span = unit_span((S + 15) / 16, gridDim.y, blockIdx.y);
  const int warp = threadIdx.x >> 5;
  const int nw = span.n * KS;  // warps with work: (unit, split)
  if (warp >= nw) return;      // leave before any barrier
  const int unit = warp % span.n;
  const int split = warp / span.n;  // takes chunks split NC.. of a tile
  const int tid = threadIdx.x;
  const int nthreads = nw * 32;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int q0 = span.u0 * 16;
  const int m0 = unit * 16;  // the warp's rows of the block's
  const size_t tok = (size_t)H * HD;
  const size_t base = (size_t)b * S * tok + (size_t)h * HD;
  const size_t ibase = (size_t)b * S * ld_tok + (size_t)h * ld_head;
  const bool rope = cos_t != nullptr;
  const int ntiles = (S + TW - 1) / TW;

  auto issue = [&](int j) {  // K (with its tables) and V of key tile j
    if (j < ntiles) {
      __nv_bfloat16* ks = ring + (j % STAGES) * 2 * TW * P;
      float* cs = tables + (j % (STAGES - 1)) * TW * HD;
      async_pairs(ks, P, cs, cs + TW * HALF, k, ibase, ld_tok, cos_t, sin_t,
                  j * TW, TW, S, HALF, tid, nthreads);
      async_rows(ks + TW * P, P, v, ibase, ld_tok, j * TW, TW, S, HD, tid,
                 nthreads);
    }
    cp_async_commit();  // one group a tile, empty past the last
  };
  for (int j = 0; j < STAGES - 1; ++j) issue(j);
  stage_rows_mma<HD>(qs, q, ibase, ld_tok, q0, span.n * 16, S, cos_t, sin_t,
                     tid, nthreads);
  bar_sync(nthreads);
  uint32_t qa[HD / 16][4];
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk)
    ldsm_x4(qa[kk], qs + (m0 + (lane & 15)) * P + kk * 16 + (lane >> 4) * 8);
  float o[HD / 8][4];
#pragma unroll
  for (int n = 0; n < HD / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0;
  float mx[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.0f, 0.0f};

  for (int j = 0; j < ntiles; ++j) {
    cp_async_wait<STAGES - 2>();  // this thread's copies of tile j
    __nv_bfloat16* ks = ring + (j % STAGES) * 2 * TW * P;
    if (rope) {
      const float* cs = tables + (j % (STAGES - 1)) * TW * HD;
      rotate_pairs_mma<HD>(ks, cs, cs + TW * HALF, TW, tid, nthreads);
    }
    bar_sync(nthreads);  // tile j ready; tile j - 1 and its tables unread
    issue(j + STAGES - 1);
    const int k0 = j * TW + split * NC * 16;  // the warp's first key
    const int nc = min(NC, (S - k0 + 15) >> 4);  // chunks with a real key
    if (nc <= 0) continue;
    ks += split * NC * 16 * P;
    const __nv_bfloat16* vs = ks + TW * P;
    // 1. the share's scores at once: 2 NC independent m16n8 sums
    float sc[2 * NC][4];
#pragma unroll
    for (int n = 0; n < 2 * NC; ++n)
      sc[n][0] = sc[n][1] = sc[n][2] = sc[n][3] = 0;
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
#pragma unroll
      for (int c = 0; c < NC; ++c)
        if (c < nc) {
          uint32_t kb[4];
          ldsm_x4(kb, ks + (16 * c + (lane & 7) + ((lane >> 4) << 3)) * P +
                          kk * 16 + ((lane >> 3) & 1) * 8);
          mma_bf16(sc[2 * c], qa[kk], kb[0], kb[1]);
          mma_bf16(sc[2 * c + 1], qa[kk], kb[2], kb[3]);
        }
    // 2. one online-softmax step for the share, in base 2; keys past S get
    //    probability 0
    float rmax[2] = {kNeg, kNeg};
#pragma unroll
    for (int n = 0; n < 2 * NC; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + n * 8 + 2 * t + (e & 1);
        sc[n][e] = key < S ? sc[n][e] * scale_log2 : kNeg;
        rmax[e >> 1] = fmaxf(rmax[e >> 1], sc[n][e]);
      }
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      rmax[r] = fmaxf(rmax[r], __shfl_xor_sync(0xffffffffu, rmax[r], 1));
      rmax[r] = fmaxf(rmax[r], __shfl_xor_sync(0xffffffffu, rmax[r], 2));
      const float m_new = fmaxf(mx[r], rmax[r]);  // finite: key k0 is real
      corr[r] = exp2f(mx[r] - m_new);
      mx[r] = m_new;
      l[r] *= corr[r];
    }
#pragma unroll
    for (int n = 0; n < 2 * NC; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        sc[n][e] = exp2f(sc[n][e] - mx[e >> 1]);
        l[e >> 1] += sc[n][e];
      }
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) {
      o[n][0] *= corr[0];
      o[n][1] *= corr[0];
      o[n][2] *= corr[1];
      o[n][3] *= corr[1];
    }
    // 3. o += P v, a chunk of 16 keys a k-step: P's accumulators are its A
    //    fragment
#pragma unroll
    for (int c = 0; c < NC; ++c)
      if (c < nc) {
        const uint32_t pa[4] = {pack_bf16(sc[2 * c][0], sc[2 * c][1]),
                                pack_bf16(sc[2 * c][2], sc[2 * c][3]),
                                pack_bf16(sc[2 * c + 1][0], sc[2 * c + 1][1]),
                                pack_bf16(sc[2 * c + 1][2], sc[2 * c + 1][3])};
#pragma unroll
        for (int dp = 0; dp < HD / 16; ++dp) {
          uint32_t vb[4];
          ldsm_x4_trans(vb, vs + (16 * c + (lane & 7) + ((lane >> 3) & 1) * 8) *
                                     P +
                                 dp * 16 + (lane >> 4) * 8);
          mma_bf16(o[2 * dp], pa, vb[0], vb[1]);
          mma_bf16(o[2 * dp + 1], pa, vb[2], vb[3]);
        }
      }
  }

  // 4. a row's sum over its quad; the splits past the first hand their
  //    maximum, sum and output fragments to the first through the ring,
  //    which merges them in split order
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  if (KS > 1) {
    float* mrg = reinterpret_cast<float*>(ring);
    bar_sync(nthreads);  // every warp is done with the ring
    if (split > 0) {
      float* mo = mrg + ((split - 1) * span.n + unit) * MS + lane * 4;
#pragma unroll
      for (int n = 0; n < HD / 8; ++n)
        *reinterpret_cast<float4*>(mo + 128 + n * 128) =
            make_float4(o[n][0], o[n][1], o[n][2], o[n][3]);
      *reinterpret_cast<float4*>(mo) = make_float4(mx[0], mx[1], l[0], l[1]);
    }
    bar_sync(nthreads);
    if (split > 0) return;
#pragma unroll
    for (int x = 1; x < KS; ++x) {
      const float* mo = mrg + ((x - 1) * span.n + unit) * MS + lane * 4;
      const float4 ml = *reinterpret_cast<const float4*>(mo);
      const float mxx[2] = {ml.x, ml.y}, lx[2] = {ml.z, ml.w};
      float w[2], wx[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float mm = fmaxf(mx[r], mxx[r]);
        w[r] = exp2f(mx[r] - mm);
        wx[r] = exp2f(mxx[r] - mm);
        l[r] = l[r] * w[r] + lx[r] * wx[r];
        mx[r] = mm;
      }
#pragma unroll
      for (int n = 0; n < HD / 8; ++n) {
        const float4 ox = *reinterpret_cast<const float4*>(mo + 128 + n * 128);
        o[n][0] = o[n][0] * w[0] + ox.x * wx[0];
        o[n][1] = o[n][1] * w[0] + ox.y * wx[0];
        o[n][2] = o[n][2] * w[1] + ox.z * wx[1];
        o[n][3] = o[n][3] * w[1] + ox.w * wx[1];
      }
    }
  }

  // 5. normalise; the log-sum-exp in natural units; the output staged in
  //    the warp's own q rows (read by this warp alone) and stored 16 bytes
  //    a lane
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    inv[r] = 1.0f / l[r];
    const int row = q0 + m0 + g + 8 * r;
    if (lse != nullptr && t == 0 && row < S)
      lse[(size_t)bh * S + row] = (mx[r] + log2f(l[r])) * 0.6931471805599453f;
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
    if (q0 + m0 + r < S)
      *reinterpret_cast<uint4*>(out + base + (size_t)(q0 + m0 + r) * tok +
                                col) =
          *reinterpret_cast<const uint4*>(os + r * P + col);
  }
}

// --------------------------------------------------------------- launch --

template <int HD>
int launch_mma(const void* q, const void* k, const void* v, const float* cos_t,
               const float* sin_t, void* out, int B, int S, int H,
               int ld_tok, int ld_head, void* stream) {
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
      ld_tok, ld_head, scale_log2);
  return (int)cudaGetLastError();
}

template <int HD>
int launch_tiled_mma(const void* q, const void* k, const void* v,
                     const float* cos_t, const float* sin_t, void* out,
                     float* lse, int B, int S, int H, int ld_tok, int ld_head,
                     void* stream) {
  static std::atomic<bool> raised[kMaxDevices];
  cudaError_t err = allow_smem(attention_fwd_tiled_mma<HD>, raised);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(B * H, blocks_per_head(S, kMmaFwdUnits));
  attention_fwd_tiled_mma<HD>
      <<<grid, kMmaFwdUnits * kMmaFwdSplits * 32, tiled_mma_bytes<HD>(),
        (cudaStream_t)stream>>>(
          (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
          (const __nv_bfloat16*)v, cos_t, sin_t, (__nv_bfloat16*)out, lse, S,
          H, ld_tok, ld_head, kLog2e / sqrtf((float)HD));
  return (int)cudaGetLastError();
}

template <int NP, int KS, int U>
int launch_tiled_simt(const void* q, const void* k, const void* v,
                      const float* cos_t, const float* sin_t, void* out,
                      float* lse, int B, int S, int H, int hd, int ld_tok,
                      int ld_head, void* stream) {
  static std::atomic<bool> raised[kMaxDevices];
  cudaError_t err = allow_smem(attention_fwd_tiled_simt<NP, KS, U>, raised);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(B * H, blocks_per_head(S, U));
  attention_fwd_tiled_simt<NP, KS, U><<<grid, U * KS * 32,
                                        sizeof(float) * tiled_simt_floats(hd),
                                        (cudaStream_t)stream>>>(
      (const float*)q, (const float*)k, (const float*)v, cos_t, sin_t,
      (float*)out, lse, S, H, hd, ld_tok, ld_head, 1.0f / sqrtf((float)hd));
  return (int)cudaGetLastError();
}

int launch_tiled_simt_wide(const void* q, const void* k, const void* v,
                           const float* cos_t, const float* sin_t, void* out,
                           float* lse, int B, int S, int H, int hd,
                           int ld_tok, int ld_head, void* stream) {
  static std::atomic<bool> raised[kMaxDevices];
  cudaError_t err = allow_smem(attention_fwd_tiled_simt_wide, raised);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(B * H, (S + kTileF32 - 1) / kTileF32);
  attention_fwd_tiled_simt_wide<<<grid, kTiledF32Threads,
                                  sizeof(float) * tiled_simt_wide_floats(hd),
                                  (cudaStream_t)stream>>>(
      (const float*)q, (const float*)k, (const float*)v, cos_t, sin_t,
      (float*)out, lse, S, H, hd, ld_tok, ld_head, 1.0f / sqrtf((float)hd));
  return (int)cudaGetLastError();
}

}  // namespace

// C ABI, bound with ctypes by cliffordtpu_torch/kernels/attention.py.
// q, k, v at token stride ld_tok and head stride ld_head (elements, each a
// multiple of 8), out contiguous (B, S, H, hd), all 16-byte aligned; cos, sin
// contiguous (S, hd/2) float32, 16-byte aligned, or both null.  float32
// takes hd a multiple of 8, bfloat16 hd 16, 32, 64 or 128.  The wrapper
// checks shapes, types, alignment and the shared memory size.  Returns the
// CUDA error of the attribute call or launch.
extern "C" int attention_fwd_f32(const void* q, const void* k, const void* v,
                                 const float* cos_t, const float* sin_t,
                                 void* out, int B, int S, int H, int hd,
                                 int ld_tok, int ld_head, void* stream) {
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
      (float*)out, S, H, hd, ld_tok, ld_head, 1.0f / sqrtf((float)hd));
  return (int)cudaGetLastError();
}

extern "C" int attention_fwd_bf16(const void* q, const void* k, const void* v,
                                  const float* cos_t, const float* sin_t,
                                  void* out, int B, int S, int H, int hd,
                                  int ld_tok, int ld_head, void* stream) {
  switch (hd) {
    case 16:
      return launch_mma<16>(q, k, v, cos_t, sin_t, out, B, S, H, ld_tok,
                             ld_head, stream);
    case 32:
      return launch_mma<32>(q, k, v, cos_t, sin_t, out, B, S, H, ld_tok,
                             ld_head, stream);
    case 64:
      return launch_mma<64>(q, k, v, cos_t, sin_t, out, B, S, H, ld_tok,
                             ld_head, stream);
    case 128:
      return launch_mma<128>(q, k, v, cos_t, sin_t, out, B, S, H, ld_tok,
                             ld_head, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The key-tiled forms (the "tiled" section above), with the same layout
// rules; lse is null, or float32 (B, H, S) contiguous, which receives each
// row's log-sum-exp of the scaled scores.  float32 takes hd a multiple of 8
// whose tiles fit the shared memory (kernels/attention.py::
// tiled_smem_bytes), bfloat16 hd 16, 32, 64 or 128.
extern "C" int attention_fwd_tiled_f32(const void* q, const void* k,
                                       const void* v, const float* cos_t,
                                       const float* sin_t, void* out,
                                       float* lse, int B, int S, int H, int hd,
                                       int ld_tok, int ld_head, void* stream) {
  if (hd > kSimtMaxHd)
    return launch_tiled_simt_wide(q, k, v, cos_t, sin_t, out, lse, B, S, H,
                                  hd, ld_tok, ld_head, stream);
  if (hd > 64)
    return launch_tiled_simt<2, simt_fwd_splits(128), simt_fwd_units(128)>(
        q, k, v, cos_t, sin_t, out, lse, B, S, H, hd, ld_tok, ld_head, stream);
  return launch_tiled_simt<1, simt_fwd_splits(64), simt_fwd_units(64)>(
      q, k, v, cos_t, sin_t, out, lse, B, S, H, hd, ld_tok, ld_head, stream);
}

extern "C" int attention_fwd_tiled_bf16(const void* q, const void* k,
                                        const void* v, const float* cos_t,
                                        const float* sin_t, void* out,
                                        float* lse, int B, int S, int H,
                                        int hd, int ld_tok, int ld_head,
                                        void* stream) {
  switch (hd) {
    case 16:
      return launch_tiled_mma<16>(q, k, v, cos_t, sin_t, out, lse, B, S, H,
                                  ld_tok, ld_head, stream);
    case 32:
      return launch_tiled_mma<32>(q, k, v, cos_t, sin_t, out, lse, B, S, H,
                                  ld_tok, ld_head, stream);
    case 64:
      return launch_tiled_mma<64>(q, k, v, cos_t, sin_t, out, lse, B, S, H,
                                  ld_tok, ld_head, stream);
    case 128:
      return launch_tiled_mma<128>(q, k, v, cos_t, sin_t, out, lse, B, S, H,
                                   ld_tok, ld_head, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}
