// Shared by attention_fwd.cu and attention_bwd.cu: the tensor-core fragment
// helpers, the half-split RoPE rotation, and what the key-tiled forms of
// both kernels are built from (their tiles, the unit split of a block, the
// asynchronous copies of a ring of shared-memory stages, and the staging
// and in-place rotation of row tiles).  Each source still builds alone:
// everything here is internal to the file that includes it.
//
// The key-tiled forms' scheme, at image 256's shape (B 4, S 260, 8 heads of
// 64), where the whole sequence fits no block:
//   * A block owns "units" of 16 rows of one (batch, head); the units of a
//     (batch, head) are split as evenly as the blocks allow (unit_span),
//     so that a block whose rows end at S holds fewer warps, and a warp
//     with no unit leaves before any barrier: no warp spends a launch on
//     rows past S.  The block's barriers count its active warps alone
//     (bar_sync).  In the forwards a unit's walk is split among several
//     warps (the splits), each with its own online softmax, merged in
//     split order at the end; in the backwards one warp walks a unit.
//   * The other side of the product (the keys for a query block, the
//     queries for a key block) is walked a tile at a time through a ring
//     of shared-memory stages filled by cp.async 16-byte copies: the next
//     tiles' copies are in flight during the current tile's products.
//     Rows past S are zero-filled by the copy itself.
//   * A thread prepares what it copied itself, after its own cp.async
//     wait and before the tile's one barrier: it rotates the row chunks
//     it copied (with the RoPE tables' chunks it copied beside them), and
//     in the backward's key blocks sums the row term delta over the O and
//     dO chunks it copied, four lanes a row.  So a tile costs one barrier
//     and no pass of its own.  What only this preparation reads (the
//     tables, O) needs a buffer for each tile in flight but not a stage.
//   * The rotation is in float32 on the bfloat16 or float32 values and
//     rounded once, as the whole-sequence forms round it when they stage.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int kMaxDevices = 64;
constexpr float kNeg = -1e30f;  // attention_pallas.py::_NEG
constexpr float kLog2e = 1.4426950408889634f;

// ---------------------------------------------------------- fragments --

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

// ------------------------------------------------------------ float32 --

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void st4(float* p, float4 x) {
  *reinterpret_cast<float4*>(p) = x;
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

__device__ __forceinline__ void scale4(float4& x, float c) {
  x.x *= c;
  x.y *= c;
  x.z *= c;
  x.w *= c;
}

// component u (0..3, unrolled) of x
__device__ __forceinline__ float comp(float4 x, int u) {
  return u == 0 ? x.x : u == 1 ? x.y : u == 2 ? x.z : x.w;
}

__device__ __forceinline__ void rotate4(float4& x0, float4& x1, float4 c,
                                        float4 s) {
  const float4 a = x0, b = x1;
  x0 = make_float4(a.x * c.x - b.x * s.x, a.y * c.y - b.y * s.y,
                   a.z * c.z - b.z * s.z, a.w * c.w - b.w * s.w);
  x1 = make_float4(a.x * s.x + b.x * c.x, a.y * s.y + b.y * c.y,
                   a.z * s.z + b.z * c.z, a.w * s.w + b.w * c.w);
}

// the inverse rotation rot(-theta): [x0 c + x1 s | x1 c - x0 s]
__device__ __forceinline__ void rotate4_back(float4& x0, float4& x1, float4 c,
                                             float4 s) {
  const float4 a = x0, b = x1;
  x0 = make_float4(a.x * c.x + b.x * s.x, a.y * c.y + b.y * s.y,
                   a.z * c.z + b.z * s.z, a.w * c.w + b.w * s.w);
  x1 = make_float4(b.x * c.x - a.x * s.x, b.y * c.y - a.y * s.y,
                   b.z * c.z - a.z * s.z, b.w * c.w - a.w * s.w);
}

// -------------------------------------------------------------- tiles --

// float32 tiled forms (attention_*_tiled_simt): units of 16 rows (the
// forward's keys split among warps, attention_fwd.cu::simt_fwd_splits);
// the other side walked 32 rows a tile.
// A warp's lanes are 4 row groups x 8 column groups: a thread owns rows
// rg + 4a (a < 4) of its unit and walk rows cg + 8c (c < 4) of a tile, a
// 4 x 4 register tile of the scores (a float4 read feeds 16 multiply-adds),
// and, of the (unit x hd) accumulators, its 4 rows at the columns
// 4 cg + 32 i .. + 3 and their partners hd/2 further (i < NP), so that the
// inverse rotation needs no exchange.  head_dims up to 64 NP; the wider
// ones keep the shared-memory form (attention_*_tiled_simt_wide).
constexpr int kSimtBwdUnits = 9;  // the backward's units a block up to hd 64
constexpr int kSimtWalk = 32;   // rows of a walked tile
constexpr int kSimtScratch = kSimtWalk + 8;  // pitch of a warp's P / dS rows
constexpr int kSimtMaxHd = 128;  // the register forms' widest head_dim

// bfloat16 tiled forms (attention_*_tiled_mma): units of 16 rows (the
// m16n8k16 tile); the forward walks 64 keys a tile, each split between two
// warps, the backward 32 rows.
constexpr int kMmaFwdUnits = 6;  // units a block, at most
constexpr int kMmaFwdSplits = 2;  // warps a unit's key tiles split among
constexpr int kMmaFwdStages = 2;  // the forward's ring
constexpr int kMmaBwdUnits = 9;
constexpr int kMmaBwdStages = 4;  // the backward's ring up to hd 64
constexpr int kMmaBwdProducers = 2;  // the backward's copying warps
constexpr int kMmaFwdWalk = 64;
constexpr int kMmaBwdWalk = 32;

// float32 shared-memory forms for head_dims above kSimtMaxHd (the first):
// tiles of 32 queries and 32 keys, 128 threads.
constexpr int kTileF32 = 32;
constexpr int kTiledF32Threads = 128;

// The 16-row units [u0, u0 + n) that block y of nb holds, of a (batch,
// head)'s `units`: as even a split as nb blocks allow, n >= 1 when
// units >= nb.
struct UnitSpan {
  int u0, n;
};
__device__ __forceinline__ UnitSpan unit_span(int units, int nb, int y) {
  const int u0 = units * y / nb;
  return {u0, units * (y + 1) / nb - u0};
}

__host__ __device__ inline int blocks_per_head(int S, int max_units) {
  const int units = (S + 15) / 16;
  return (units + max_units - 1) / max_units;
}

// A barrier of the block's first `nthreads` threads (its active warps);
// warps past them have left.
__device__ __forceinline__ void bar_sync(int nthreads) {
  asm volatile("bar.sync 1, %0;\n" ::"r"(nthreads) : "memory");
}

// A named barrier (ids 2..15) of `count` threads: bar_arrive signals it
// and goes on, bar_wait waits for it; what the arriving threads wrote to
// shared memory before is visible to the waiting ones after.
__device__ __forceinline__ void bar_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}
__device__ __forceinline__ void bar_wait(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// ------------------------------------------------------------- copies --

// 16 bytes global -> shared, asynchronous; zero-filled when !valid (src
// must still be a mapped address: it is not read)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's committed copy groups are pending
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Rows t0..t0+rows-1 of x (row s at xbase + s ld elements, `cols`
// elements, a multiple of 16 bytes) into xs (`pitch` elements a row),
// asynchronously; rows at or past S zero-filled.
template <typename T>
__device__ __forceinline__ void async_rows(T* xs, int pitch,
                                           const T* __restrict__ x,
                                           size_t xbase, size_t ld, int t0,
                                           int rows, int S, int cols,
                                           int tid, int nthreads) {
  constexpr int V = 16 / sizeof(T);
  const int CH = cols / V;
  for (int e = tid; e < rows * CH; e += nthreads) {
    const int r = e / CH;
    const int c = (e % CH) * V;
    const int s = t0 + r;
    const bool ok = s < S;
    cp_async16(xs + r * pitch + c, x + (ok ? xbase + (size_t)s * ld + c : 0),
               ok);
  }
}

// values x[xbase + t0 .. + rows - 1] into xs, asynchronously; past S zero
__device__ __forceinline__ void async_values(float* xs,
                                             const float* __restrict__ x,
                                             size_t xbase, int t0, int rows,
                                             int S, int tid, int nthreads) {
  for (int r = tid; r < rows; r += nthreads) {
    const bool ok = t0 + r < S;
    cp_async4(xs + r, x + (ok ? xbase + t0 + r : 0), ok);
  }
}

// A tile of rows to be rotated, copied in pairs: the 16-byte chunk at
// column c of a row's first half and its partner hd/2 further, and, when
// cos_t is given, the tables' chunk (row, c) into cs and sn (rows of hd/2
// floats).  The thread that copies a pair rotates it (rotate_pairs_*),
// after its own wait.
template <typename T>
__device__ __forceinline__ void async_pairs(
    T* xs, int pitch, float* cs, float* sn, const T* __restrict__ x,
    size_t xbase, size_t ld, const float* __restrict__ cos_t,
    const float* __restrict__ sin_t, int t0, int rows, int S, int half,
    int tid, int nthreads) {
  constexpr int V = 16 / sizeof(T);
  const int CH = half / V;
  for (int e = tid; e < rows * CH; e += nthreads) {
    const int r = e / CH;
    const int c = (e % CH) * V;
    const int s = t0 + r;
    const bool ok = s < S;
    const size_t g = ok ? xbase + (size_t)s * ld + c : 0;
    cp_async16(xs + r * pitch + c, x + g, ok);
    cp_async16(xs + r * pitch + c + half, x + (ok ? g + half : 0), ok);
    if (cos_t != nullptr) {
      const size_t tg = ok ? (size_t)s * half + c : 0;
#pragma unroll
      for (int i = 0; i < V; i += 4) {
        cp_async16(cs + r * half + c + i, cos_t + (ok ? tg + i : 0), ok);
        cp_async16(sn + r * half + c + i, sin_t + (ok ? tg + i : 0), ok);
      }
    }
  }
}

// Rotate in place the float32 pairs this thread copied (async_pairs'
// loop), by the tables' chunks it copied beside them.
__device__ __forceinline__ void rotate_pairs_f32(float* xs, int pitch,
                                                 const float* cs,
                                                 const float* sn, int rows,
                                                 int half, int tid,
                                                 int nthreads) {
  const int CH = half / 4;
  for (int e = tid; e < rows * CH; e += nthreads) {
    const int r = e / CH;
    const int c = (e % CH) * 4;
    float* p = xs + r * pitch + c;
    float4 x0 = ld4(p), x1 = ld4(p + half);
    rotate4(x0, x1, ld4(cs + r * half + c), ld4(sn + r * half + c));
    st4(p, x0);
    st4(p + half, x1);
  }
}

// The bfloat16 counterpart: each value rotated in float32, rounded once.
template <int HD>
__device__ __forceinline__ void rotate_pairs_mma(__nv_bfloat16* xs,
                                                 const float* cs,
                                                 const float* sn, int rows,
                                                 int tid, int nthreads) {
  constexpr int P = mma_pitch<HD>();
  constexpr int HALF = HD / 2;
  constexpr int CH = HALF / 8;
  for (int e = tid; e < rows * CH; e += nthreads) {
    const int r = e / CH;
    const int c = (e % CH) * 8;
    uint4* p0 = reinterpret_cast<uint4*>(xs + r * P + c);
    uint4* p1 = reinterpret_cast<uint4*>(xs + r * P + c + HALF);
    uint4 x0 = *p0, x1 = *p1;
    const float4* cp = reinterpret_cast<const float4*>(cs + r * HALF + c);
    const float4* sp = reinterpret_cast<const float4*>(sn + r * HALF + c);
    rotate8(x0, x1, cp[0], cp[1], sp[0], sp[1]);
    *p0 = x0;
    *p1 = x1;
  }
}

// The output gradient dO of a query tile (gs, used by every warp after the
// barrier) and the forward's output O (os, for the row term alone), rows
// of `cols` elements, copied four lanes a row: lane l of a row's four
// copies its chunks l, l + 4, ...  (row_delta_* then sums what it copied.)
template <typename T>
__device__ __forceinline__ void async_quads(T* gs, T* os, int pitch,
                                            const T* __restrict__ d_out,
                                            const T* __restrict__ o,
                                            size_t base, size_t tok, int t0,
                                            int rows, int S, int cols,
                                            int tid, int nthreads) {
  constexpr int V = 16 / sizeof(T);
  for (int e = tid; e < 4 * rows; e += nthreads) {
    const int r = e >> 2;
    const int s = t0 + r;
    const bool ok = s < S;
    for (int c = (e & 3) * V; c < cols; c += 4 * V) {
      const size_t g = ok ? base + (size_t)s * tok + c : 0;
      cp_async16(gs + r * pitch + c, d_out + g, ok);
      cp_async16(os + r * pitch + c, o + g, ok);
    }
  }
}

// Rows t0..t0+rows-1 of x (tokens at stride ld from xbase) into xs (rows
// of `pitch` floats), rotated in float32 when cos_t is given; rows past S
// zero.  Synchronous: a block's own rows, loaded once.
__device__ __forceinline__ void stage_rows_f32(
    float* xs, int pitch, const float* __restrict__ x, size_t xbase,
    size_t ld, int t0, int rows, int S, int hd,
    const float* __restrict__ cos_t, const float* __restrict__ sin_t,
    int tid, int nthreads) {
  const int half = hd / 2;
  const int CH = half / 4;
  for (int e = tid; e < rows * CH; e += nthreads) {
    const int r = e / CH;
    const int col = (e % CH) * 4;
    const int s = t0 + r;
    float4 x0 = make_float4(0, 0, 0, 0), x1 = x0;
    if (s < S) {
      const size_t g = xbase + (size_t)s * ld + col;
      x0 = ld4(x + g);
      x1 = ld4(x + g + half);
      if (cos_t != nullptr)
        rotate4(x0, x1, ld4(cos_t + s * half + col),
                ld4(sin_t + s * half + col));
    }
    st4(xs + r * pitch + col, x0);
    st4(xs + r * pitch + col + half, x1);
  }
}

// The bfloat16 counterpart, rows of HD + 8.
template <int HD>
__device__ __forceinline__ void stage_rows_mma(
    __nv_bfloat16* xs, const __nv_bfloat16* __restrict__ x, size_t xbase,
    size_t ld, int t0, int rows, int S, const float* __restrict__ cos_t,
    const float* __restrict__ sin_t, int tid, int nthreads) {
  constexpr int P = mma_pitch<HD>();
  constexpr int HALF = HD / 2;
  constexpr int CH = HALF / 8;
  for (int e = tid; e < rows * CH; e += nthreads) {
    const int r = e / CH;
    const int col = (e % CH) * 8;
    const int s = t0 + r;
    uint4 x0 = make_uint4(0, 0, 0, 0), x1 = x0;
    if (s < S) {
      const size_t g = xbase + (size_t)s * ld + col;
      x0 = *reinterpret_cast<const uint4*>(x + g);
      x1 = *reinterpret_cast<const uint4*>(x + g + HALF);
      if (cos_t != nullptr) {
        const float4* cp =
            reinterpret_cast<const float4*>(cos_t + s * HALF + col);
        const float4* sp =
            reinterpret_cast<const float4*>(sin_t + s * HALF + col);
        rotate8(x0, x1, cp[0], cp[1], sp[0], sp[1]);
      }
    }
    *reinterpret_cast<uint4*>(xs + r * P + col) = x0;
    *reinterpret_cast<uint4*>(xs + r * P + col + HALF) = x1;
  }
}

// ------------------------------------------------------------- launch --

// A kernel's dynamic shared-memory limit is raised to the device's opt-in
// maximum once per (kernel, device), not on every launch; the wrapper
// refuses shapes above that maximum.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel,
                       std::atomic<bool> (&raised)[kMaxDevices]) {
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

}  // namespace
