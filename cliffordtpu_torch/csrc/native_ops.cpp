// cliffordtpu_native: the serving path's kernels as C++ operators.
//
// A program that calls a Python operator cannot run without Python, so the
// Python-free serving path (serving.export_serving(native=True) and the
// host in native/serve.cc) calls these instead.  They register through
// TORCH_LIBRARY, so AOTInductor's generated code finds them in the
// dispatcher of any process that has loaded this library:
//
//   attention_fwd(q, k, v, cos?, sin?)   kernel A (csrc/attention_fwd.cu) on
//       CUDA, in the form kernels/attention.py::route gives the shape
//       without a gradient (whole-sequence where it fits, else key-tiled);
//       on the CPU kernels/attention.py::attention_plain in ATen ops.
//   sample_embed(key, loc, kappa, route) the clifford draw of (R, d) rows on
//       the SAMPLING key, returning (x, theta, u, v): route 0 "keyed" is
//       kernel F (csrc/sampler_keyed.cu), 1 "unfused" threefry uniforms, the
//       circle formula and the torus embedding (kernel C, csrc/torus_fwd.cu,
//       for 2048 <= d <= 4096 on CUDA), 2 "rng" kernel E
//       (csrc/sampler_rng.cu); on the CPU the plain versions of
//       kernels/sampler.py and ops/torus.py.
//   draw_latent(rng, mu, param2, family, l2_normalize, route, scale)
//       kernels/ops.py::draw_latent: the key of flax's make_rng("sample")
//       from the apply rng, then distributions/reparam.py::draw_flat for
//       family 0 normal / gaussian, 1 powerspherical, 2 vmf, 3 clifford.
//   cast(x, dtype)                       x.to(dtype) as a copy, the dtype an
//       int (kernels/native.py::CAST_DTYPES).
//   group_norm(x, groups, weight?, bias?, eps)   at::group_norm as eager
//       calls it, its layout chosen at run time.
// native/compile.py writes each cast and group norm of a low-precision
// program as these calls: torch 2.11's proxy executor misreads the dtype
// argument of aten::_to_copy; and the copy to a contiguous layout that
// group_norm makes on CUDA depends on strides known only at run time
// (cuDNN's convolutions answer in channels-last where tracing saw
// contiguous tensors).
//
// The draws are the Python ones written out op for op in ATen, so on one
// device they give the same numbers; the threefry and Philox words are
// exact integers, so u and v are jax.random's bit for bit on every device.
// The operators read the rng's two words on the host (one copy for a
// device tensor).  Each kernel counts its launches in the library, read by
// cliffordtpu_native_launches() (C) from the host or from Python.  Nothing
// falls back: built without CUDA (CLIFFORDTPU_CUDA undefined) the library
// registers no CUDA implementation, and the dispatcher raises for a CUDA
// tensor; with it, a kernel that fails to launch raises.

#include <ATen/ATen.h>
#include <torch/library.h>

#include <atomic>
#include <cmath>
#include <cstdint>
#include <iterator>
#include <map>
#include <mutex>
#include <tuple>
#include <utility>
#include <vector>

#ifdef CLIFFORDTPU_CUDA
#include <c10/cuda/CUDAGuard.h>
#include <c10/cuda/CUDAStream.h>

extern "C" {
int attention_fwd_f32(const void* q, const void* k, const void* v,
                      const float* cos_t, const float* sin_t, void* out,
                      int B, int S, int H, int hd, int ld_tok, int ld_head,
                      void* stream);
int attention_fwd_bf16(const void* q, const void* k, const void* v,
                       const float* cos_t, const float* sin_t, void* out,
                       int B, int S, int H, int hd, int ld_tok, int ld_head,
                       void* stream);
int attention_fwd_tiled_f32(const void* q, const void* k, const void* v,
                            const float* cos_t, const float* sin_t, void* out,
                            float* lse, int B, int S, int H, int hd,
                            int ld_tok, int ld_head, void* stream);
int attention_fwd_tiled_bf16(const void* q, const void* k, const void* v,
                             const float* cos_t, const float* sin_t,
                             void* out, float* lse, int B, int S, int H,
                             int hd, int ld_tok, int ld_head, void* stream);
int keyed_sample_embed(const float* loc, const float* kappa,
                       int kap_row_stride, int kap_col_stride, float* x,
                       float* theta, float* u, float* v, int R, int d,
                       int row0, uint32_t ku0, uint32_t ku1, uint32_t kv0,
                       uint32_t kv1, void* stream);
int rng_sample_embed(const float* loc, const float* kappa, int kap_row_stride,
                     int kap_col_stride, float* x, float* theta, float* u,
                     float* v, int R, int d, int row0, uint32_t s0,
                     uint32_t s1, void* stream);
int torus_fwd(const float* theta, float* x, int R, int d, void* stream);
}
#endif

namespace {

using at::Tensor;

// ---- launch counts ----

enum Kernel { kAttention = 0, kKeyed, kRng, kTorusFwd, kNumKernels };
std::atomic<int64_t> g_launches[kNumKernels];

// ---- constants (the Python modules') ----

constexpr int64_t kMask = 0xFFFFFFFFLL;
constexpr uint32_t kParity = 0x1BD11BDA;
constexpr uint32_t kMakeRngData = 3213575472u;  // random.MAKE_RNG_DATA
constexpr uint32_t kRngFold = 0x7A11A5;         // sampler.RNG_FOLD
constexpr double kUMin = 1e-12;                 // sampler.U_MIN
constexpr double kPsEps = 1e-7;                 // power_spherical._EPS
constexpr int64_t kGammaBudget = 6;             // gamma._BUDGET
constexpr double kTiny = 1e-20;                 // gamma._TINY
constexpr int64_t kRejectionRounds = 32;        // von_mises_fisher
constexpr int64_t kMatmulMaxDim = 4096;         // ops/torus.py
constexpr int64_t kKernelMinDim = 2048;
constexpr int64_t kHostConstMaxDim = 512;
constexpr int64_t kSmemMax = 232448;            // attention._SMEM_MAX
constexpr int64_t kJaxWorkingMax = 6 * 1024 * 1024;  // attention.py

enum Family { kNormal = 0, kPowerSpherical = 1, kVmf = 2, kClifford = 3 };
enum Route { kNoRoute = -1, kRouteKeyed = 0, kRouteUnfused = 1, kRouteRng = 2 };

using Key = std::pair<uint32_t, uint32_t>;

// ---- threefry-2x32 and Philox-4x32-10 (random.py) ----

inline uint32_t rotl32(uint32_t x, int r) { return (x << r) | (x >> (32 - r)); }

const int kRotations[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};

Key threefry_words(uint32_t k0, uint32_t k1, uint32_t x0, uint32_t x1) {
  const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ kParity};
  x0 += ks[0];
  x1 += ks[1];
  for (int i = 0; i < 5; ++i) {
    for (int r : kRotations[i % 2]) {
      x0 += x1;
      x1 = rotl32(x1, r) ^ x0;
    }
    x0 += ks[(i + 1) % 3];
    x1 += ks[(i + 2) % 3] + static_cast<uint32_t>(i + 1);
  }
  return {x0, x1};
}

std::vector<Key> split_words(Key key, int num = 2) {
  std::vector<Key> out;
  for (int i = 0; i < num; ++i)
    out.push_back(threefry_words(key.first, key.second, 0, i));
  return out;
}

Key fold_in_words(Key key, uint32_t data) {
  return threefry_words(key.first, key.second, 0, data);
}

Tensor mask32(const Tensor& x) { return at::bitwise_and(x, kMask); }

Tensor rotl_t(const Tensor& x, int r) {
  return mask32(at::bitwise_or(at::bitwise_left_shift(x, r),
                               at::bitwise_right_shift(x, 32 - r)));
}

// x0 ^ x1 of threefry2x32(key, (0, q)) for q < n: jax.random.bits' words,
// int64 tensors on ``device``
Tensor random_bits(Key key, at::IntArrayRef shape, const at::Device& device) {
  int64_t n = 1;
  for (auto s : shape) n *= s;
  TORCH_CHECK(n <= (int64_t(1) << 32),
              "counters beyond 2**32 need the hi word; not ported");
  const int64_t ks[3] = {key.first, key.second,
                         int64_t(key.first ^ key.second ^ kParity)};
  Tensor x1 = at::arange(n, at::TensorOptions().dtype(at::kLong).device(device));
  Tensor x0 = mask32(at::zeros_like(x1) + ks[0]);
  x1 = mask32(x1 + ks[1]);
  for (int i = 0; i < 5; ++i) {
    for (int r : kRotations[i % 2]) {
      x0 = mask32(x0 + x1);
      x1 = at::bitwise_xor(rotl_t(x1, r), x0);
    }
    x0 = mask32(x0 + ks[(i + 1) % 3]);
    x1 = mask32(x1 + (ks[(i + 2) % 3] + i + 1));
  }
  return at::bitwise_xor(x0, x1).reshape(shape);
}

// random.uniform_from_bits: the mantissa float, then jax's
// max(lo, f * (hi - lo) + lo) with the product and the sum fused
Tensor uniform_from_bits(const Tensor& bits, double minval, double maxval) {
  Tensor f = at::bitwise_or(at::bitwise_right_shift(bits, 9), 0x3F800000)
                 .to(at::kInt)
                 .view(at::kFloat) -
             1.0;
  if (minval == 0.0 && maxval == 1.0) return f;
  const float lo = static_cast<float>(minval);
  const double scale = static_cast<double>(static_cast<float>(maxval) - lo);
  Tensor fma = (f.to(at::kDouble) * scale + static_cast<double>(lo))
                   .to(at::kFloat);
  return at::clamp_min(fma, static_cast<double>(lo));
}

Tensor uniform(Key key, at::IntArrayRef shape, double minval, double maxval,
               const at::Device& device) {
  return uniform_from_bits(random_bits(key, shape, device), minval, maxval);
}

Tensor normal(Key key, at::IntArrayRef shape, const at::Device& device) {
  const double lo = std::nextafter(-1.0f, 0.0f);
  Tensor u = uniform(key, shape, lo, 1.0, device);
  return at::special_erfinv(u) *
         static_cast<double>(static_cast<float>(std::sqrt(2.0)));
}

// Philox-4x32-10 words 0 and 1 at counters (q, 0, 0, 0), q < n (the Philox
// sampler's draw, kernels/sampler.py::rng_uniforms), on the host
std::pair<Tensor, Tensor> philox_words(Key seed, int64_t n) {
  Tensor w0 = at::empty({n}, at::kLong), w1 = at::empty({n}, at::kLong);
  int64_t* p0 = w0.data_ptr<int64_t>();
  int64_t* p1 = w1.data_ptr<int64_t>();
  for (int64_t q = 0; q < n; ++q) {
    uint32_t c0 = static_cast<uint32_t>(q), c1 = 0, c2 = 0, c3 = 0;
    uint32_t k0 = seed.first, k1 = seed.second;
    for (int i = 0; i < 10; ++i) {
      const uint64_t p0_ = uint64_t(0xD2511F53u) * c0;
      const uint64_t p1_ = uint64_t(0xCD9E8D57u) * c2;
      const uint32_t hi0 = p0_ >> 32, lo0 = static_cast<uint32_t>(p0_);
      const uint32_t hi1 = p1_ >> 32, lo1 = static_cast<uint32_t>(p1_);
      const uint32_t n0 = hi1 ^ c1 ^ k0, n2 = hi0 ^ c3 ^ k1;
      c0 = n0;
      c1 = lo1;
      c2 = n2;
      c3 = lo0;
      k0 += 0x9E3779B9u;
      k1 += 0xBB67AE85u;
    }
    p0[q] = c0;
    p1[q] = c1;
  }
  return {w0, w1};
}

// ---- the rng ----

Key key_of(const Tensor& rng) {
  Tensor w = rng.to(at::kCPU).to(at::kLong).reshape(-1).contiguous();
  TORCH_CHECK(w.numel() == 2, "cliffordtpu_native: the rng is two uint32 "
              "words, got ", w.numel());
  const int64_t* p = w.data_ptr<int64_t>();
  for (int i = 0; i < 2; ++i)
    TORCH_CHECK(p[i] >= 0 && p[i] <= kMask,
                "cliffordtpu_native: rng words must lie in [0, 2**32)");
  return {static_cast<uint32_t>(p[0]), static_cast<uint32_t>(p[1])};
}

// ---- the torus embedding (ops/torus.py) ----

std::mutex g_bases_lock;

// (C, S, c) on the CPU for d <= kHostConstMaxDim: float64, then float32
std::tuple<Tensor, Tensor, Tensor> host_bases(int64_t d) {
  static auto* cache = new std::map<int64_t, std::tuple<Tensor, Tensor, Tensor>>;
  std::lock_guard<std::mutex> g(g_bases_lock);
  auto it = cache->find(d);
  if (it != cache->end()) return it->second;
  const int64_t n = 2 * d;
  Tensor cb = at::empty({d - 1, n}, at::kFloat);
  Tensor sb = at::empty({d - 1, n}, at::kFloat);
  Tensor cst = at::empty({n}, at::kFloat);
  float* pc = cb.data_ptr<float>();
  float* ps = sb.data_ptr<float>();
  const double two_over_n = 2.0 / n;
  for (int64_t k = 1; k < d; ++k)
    for (int64_t j = 0; j < n; ++j) {
      const double phase = 2.0 * M_PI * static_cast<double>(k * j) / n;
      pc[(k - 1) * n + j] = static_cast<float>(two_over_n * std::cos(phase));
      ps[(k - 1) * n + j] = static_cast<float>(-two_over_n * std::sin(phase));
    }
  float* pk = cst.data_ptr<float>();
  for (int64_t j = 0; j < n; ++j)
    pk[j] = static_cast<float>((1.0 + std::cos(M_PI * static_cast<double>(j))) / n);
  auto out = std::make_tuple(cb, sb, cst);
  (*cache)[d] = out;
  return out;
}

std::tuple<Tensor, Tensor, Tensor> torus_bases(int64_t d, const at::Device& device) {
  if (d <= kHostConstMaxDim) {
    auto [c, s, k] = host_bases(d);
    return {c.to(device), s.to(device), k.to(device)};
  }
  // int32 phases (k*j) mod n, exact where k*j is not in float32
  const int64_t n = 2 * d;
  auto opts = at::TensorOptions().dtype(at::kInt).device(device);
  Tensor k = at::arange(1, d, opts);
  Tensor j = at::arange(n, opts);
  Tensor kj = at::remainder(k.unsqueeze(1) * j.unsqueeze(0), n);
  Tensor step = at::scalar_tensor(2.0 * M_PI / n,
                                  at::TensorOptions().dtype(at::kFloat));
  Tensor phase = kj.to(at::kFloat) * step;
  Tensor cb = at::cos(phase) * (2.0 / n);
  Tensor sb = at::sin(phase) * (-(2.0 / n));
  Tensor cst = (at::cos(j.to(at::kFloat) * M_PI) + 1.0) / static_cast<double>(n);
  return {cb, sb, cst};
}

Tensor angles_to_torus_matmul(const Tensor& angles) {
  const int64_t d = angles.size(-1);
  auto [cb, sb, cst] = torus_bases(d, angles.device());
  cb = cb.to(angles.scalar_type());
  sb = sb.to(angles.scalar_type());
  cst = cst.to(angles.scalar_type());
  Tensor th = angles.narrow(-1, 1, d - 1);
  return at::matmul(at::cos(th), cb) + at::matmul(at::sin(th), sb) + cst;
}

Tensor angles_to_torus_fft(const Tensor& angles) {
  const int64_t d = angles.size(-1);
  Tensor th = angles.narrow(-1, 1, d - 1);
  Tensor zero = at::zeros_like(angles.narrow(-1, 0, 1));
  Tensor theta_s = at::cat({zero, th, zero, at::neg(at::flip(th, {-1}))}, -1);
  Tensor spectrum = at::polar(at::ones_like(theta_s, at::kFloat),
                              theta_s.to(at::kFloat));
  return at::real(at::fft_ifft(spectrum, c10::nullopt, -1))
      .to(angles.scalar_type());
}

#ifdef CLIFFORDTPU_CUDA
void* stream_of(const Tensor& t) {
  return c10::cuda::getCurrentCUDAStream(t.device().index()).stream();
}

void check_rc(int rc, const char* what) {
  TORCH_CHECK(rc == 0, "cliffordtpu_native: ", what,
              " kernel failed: CUDA error ", rc);
}

// kernel C on the free angles (R, d-1) -> x (R, 2d)
Tensor torus_fwd_kernel(const Tensor& theta_in) {
  Tensor theta = theta_in.contiguous();
  const int64_t R = theta.size(0), d = theta.size(1) + 1;
  TORCH_CHECK(d >= 2 && d <= kMatmulMaxDim, "torus_fwd: d=", d,
              " outside [2, ", kMatmulMaxDim, "]");
  Tensor x = at::empty({R, 2 * d}, theta.options());
  check_rc(torus_fwd(theta.data_ptr<float>(), x.data_ptr<float>(), R, d,
                     stream_of(theta)),
           "torus_fwd");
  g_launches[kTorusFwd]++;
  return x;
}
#endif

// ops/torus.py::angles_to_torus, method "auto"
Tensor angles_to_torus(const Tensor& angles) {
  const int64_t d = angles.size(-1);
  if (angles.is_cuda() && d >= kKernelMinDim && d <= kMatmulMaxDim) {
#ifdef CLIFFORDTPU_CUDA
    Tensor theta = angles.reshape({-1, d}).narrow(1, 1, d - 1).to(at::kFloat);
    std::vector<int64_t> shape(angles.sizes().begin(), angles.sizes().end());
    shape.back() = 2 * d;
    return torus_fwd_kernel(theta).reshape(shape).to(angles.scalar_type());
#else
    TORCH_CHECK(false, "cliffordtpu_native was built without CUDA");
#endif
  }
  return d <= kMatmulMaxDim ? angles_to_torus_matmul(angles)
                            : angles_to_torus_fft(angles);
}

// ---- the clifford draw (kernels/sampler.py) ----

// the closed-form PowerSpherical circle sampler
Tensor circle_angles(const Tensor& loc, const Tensor& kappa, const Tensor& u,
                     const Tensor& v) {
  Tensor nu = (kappa + kPsEps) * 2.0 + 1.0;
  Tensor w = at::expm1(at::div(at::scalar_tensor(-2.0, nu.options()), nu) *
                       at::log(u));
  return loc + at::atan(at::cos(v * (2.0 * M_PI)) * at::sqrt(w))
                       .to(loc.scalar_type()) *
                   2.0;
}

// (x (R, 2d), theta, u, v (R, d-1)) of the route on the sampling key
std::tuple<Tensor, Tensor, Tensor, Tensor> sample_embed_rows(
    Key key, const Tensor& loc_in, const Tensor& kappa_in, int64_t route) {
  TORCH_CHECK(loc_in.dim() == 2, "sample_embed: loc must be (R, d)");
  const int64_t R = loc_in.size(0), d = loc_in.size(1);
  TORCH_CHECK(d >= 2, "sample_embed: d must be >= 2, got ", d);
  Tensor loc = loc_in.to(at::kFloat);
  Tensor kappa = kappa_in.to(at::kFloat).expand({R, d});
  const at::Device dev = loc.device();
  TORCH_CHECK(kappa.device() == dev, "sample_embed: loc and kappa must lie "
              "on one device");
  if (loc.is_cuda() && route != kRouteUnfused) {
#ifdef CLIFFORDTPU_CUDA
    c10::cuda::CUDAGuard guard(dev);
    TORCH_CHECK(d <= kMatmulMaxDim, "sample_embed: d=", d, " outside [2, ",
                kMatmulMaxDim, "]");
    TORCH_CHECK(R * d < (int64_t(1) << 32),
                "sample_embed: R*d must stay below 2**32");
    loc = loc.contiguous();
    Tensor x = at::empty({R, 2 * d}, loc.options());
    Tensor theta = at::empty({R, d - 1}, loc.options());
    Tensor u = at::empty_like(theta), v = at::empty_like(theta);
    if (route == kRouteKeyed) {
      auto kk = split_words(key);
      check_rc(keyed_sample_embed(
                   loc.data_ptr<float>(), kappa.data_ptr<float>(),
                   kappa.stride(0), kappa.stride(1), x.data_ptr<float>(),
                   theta.data_ptr<float>(), u.data_ptr<float>(),
                   v.data_ptr<float>(), R, d, 0, kk[0].first, kk[0].second,
                   kk[1].first, kk[1].second, stream_of(loc)),
               "keyed_sample_embed");
      g_launches[kKeyed]++;
    } else {
      TORCH_CHECK(route == kRouteRng, "sample_embed: unknown route ", route);
      Key seed = fold_in_words(key, kRngFold);
      check_rc(rng_sample_embed(
                   loc.data_ptr<float>(), kappa.data_ptr<float>(),
                   kappa.stride(0), kappa.stride(1), x.data_ptr<float>(),
                   theta.data_ptr<float>(), u.data_ptr<float>(),
                   v.data_ptr<float>(), R, d, 0, seed.first, seed.second,
                   stream_of(loc)),
               "rng_sample_embed");
      g_launches[kRng]++;
    }
    return {x, theta, u, v};
#else
    TORCH_CHECK(false, "cliffordtpu_native was built without CUDA");
#endif
  }
  Tensor u, v;
  if (route == kRouteKeyed || route == kRouteUnfused) {
    auto kk = split_words(key);
    u = uniform(kk[0], {R, d}, kUMin, 1.0, dev);
    v = uniform(kk[1], {R, d}, 0.0, 1.0, dev);
  } else {
    TORCH_CHECK(route == kRouteRng, "sample_embed: unknown route ", route);
    auto [w0, w1] = philox_words(fold_in_words(key, kRngFold), R * d);
    u = at::clamp_min(uniform_from_bits(w0, 0.0, 1.0), kUMin)
            .reshape({R, d}).to(dev);
    v = uniform_from_bits(w1, 0.0, 1.0).reshape({R, d}).to(dev);
  }
  Tensor theta = circle_angles(loc, kappa, u, v);
  Tensor x = route == kRouteUnfused ? angles_to_torus(theta)
                                    : angles_to_torus_matmul(theta);
  return {x, theta.narrow(1, 1, d - 1), u.narrow(1, 1, d - 1),
          v.narrow(1, 1, d - 1)};
}

// ---- Gamma, PowerSpherical, vMF (distributions/) ----

Tensor first_accept_index(const Tensor& accept) {
  return at::where(accept.any(0), accept.to(at::kByte).argmax(0),
                   at::Scalar(accept.size(0) - 1));
}

Tensor take_first(const Tensor& proposals, const Tensor& idx) {
  return at::gather(proposals, 0, idx.unsqueeze(0)).select(0, 0);
}

std::vector<int64_t> prepend(int64_t k, at::IntArrayRef shape) {
  std::vector<int64_t> out{k};
  out.insert(out.end(), shape.begin(), shape.end());
  return out;
}

std::vector<int64_t> append(at::IntArrayRef shape, int64_t k) {
  std::vector<int64_t> out(shape.begin(), shape.end());
  out.push_back(k);
  return out;
}

// gamma.py::_gamma_fixed: six Marsaglia-Tsang proposals, first accept
Tensor gamma_sample(Key key, const Tensor& alpha_in, at::IntArrayRef shape) {
  Tensor alpha = alpha_in.to(at::kFloat).expand(shape).contiguous();
  const at::Device dev = alpha.device();
  Tensor boost = alpha < 1.0;
  Tensor a = at::where(boost, alpha + 1.0, alpha);
  Tensor d = a - 1.0 / 3.0;
  Tensor c = at::reciprocal(at::sqrt(d * 9.0)) * 1.0;
  auto keys = split_words(key, 3);
  auto pshape = prepend(kGammaBudget, shape);
  Tensor x = normal(keys[0], pshape, dev);
  Tensor u = uniform(keys[1], pshape, kTiny, 1.0, dev);
  Tensor t = c * x + 1.0;
  Tensor v = t * t * t;
  Tensor v_pos = v > 0.0;
  Tensor log_v = at::log(at::where(v_pos, v, at::Scalar(1.0)));
  Tensor accept = at::logical_and(
      v_pos, at::log(u) < x * 0.5 * x + d - d * v + d * log_v);
  Tensor v_sel = take_first(v, first_accept_index(accept));
  Tensor z = d * at::clamp_min(v_sel, kTiny);
  Tensor u3 = uniform(keys[2], shape, kTiny, 1.0, dev);
  return at::where(
      boost, z * at::pow(u3, at::reciprocal(at::clamp_min(alpha, kTiny)) * 1.0),
      z);
}

Tensor vector_norm(const Tensor& x) {
  return at::linalg_vector_norm(x, 2, at::IntArrayRef{-1}, true, c10::nullopt);
}

Tensor householder_reflect(const Tensor& x, const Tensor& loc, double eps) {
  Tensor u = at::neg(loc);
  u.select(-1, 0).add_(1.0);
  u = u / (vector_norm(u) + eps);
  return x - (x * u).sum({-1}, true) * 2.0 * u;
}

// power_spherical.py::PowerSpherical.sample
Tensor powerspherical_sample(Key key, const Tensor& loc, const Tensor& scale) {
  const int64_t d = loc.size(-1);
  at::IntArrayRef shape = loc.sizes().slice(0, loc.dim() - 1);
  const at::Device dev = loc.device();
  auto kt_kv = split_words(key);
  Tensor alpha = (scale + kPsEps + (d - 1) / 2.0).expand(shape);
  // beta_half_sample(k_t, alpha, d - 1, shape)
  auto kx_ky = split_words(kt_kv[0]);
  Tensor gx = gamma_sample(kx_ky[0], alpha, shape);
  Tensor z = normal(kx_ky[1], append(shape, d - 1), dev);
  Tensor gy = (z * z).sum({-1}) * 0.5;
  Tensor t = gx / (gx + gy) * 2.0 - 1.0;
  // _unit_tangent(k_v, shape + (d - 1,))
  Tensor v = normal(kt_kv[1], append(shape, d - 1), dev);
  v = v / (vector_norm(v) + kPsEps);
  // t_transform, then the Householder map
  Tensor tt = t.unsqueeze(-1).to(loc.scalar_type());
  v = v.to(loc.scalar_type());
  Tensor y = at::cat(
      {tt, v * at::sqrt(at::clamp_min(at::rsub(at::pow(tt, 2), 1.0), kPsEps))},
      -1);
  return householder_reflect(y, loc, kPsEps);
}

// von_mises_fisher.py::VonMisesFisher.sample
Tensor vmf_sample(Key key, const Tensor& loc, const Tensor& scale_in) {
  const int64_t m_int = loc.size(-1);
  const double m = static_cast<double>(m_int);
  Tensor s = scale_in;
  if (s.dim() < loc.dim())
    s = s.unsqueeze(-1);
  else if (s.size(-1) != 1)
    s = s.narrow(-1, 0, 1);
  Tensor kappa = s.expand(append(loc.sizes().slice(0, loc.dim() - 1), 1));
  const at::Device dev = loc.device();
  auto kw_kv = split_words(key);
  Tensor w;
  if (m_int == 3) {
    Tensor u = uniform(kw_kv[0], kappa.sizes(), 1e-7, 1.0 - 1e-7, dev);
    Tensor lse = at::logaddexp(at::log(u), at::log1p(at::neg(u)) - kappa * 2.0);
    w = lse / kappa + 1.0;
  } else {
    Tensor c = at::sqrt(at::pow(kappa, 2) * 4.0 + (m - 1.0) * (m - 1.0));
    Tensor b_true = (kappa * -2.0 + c) / (m - 1.0);
    Tensor b_app = at::reciprocal(kappa * 4.0) * (m - 1.0);
    Tensor sw = at::minimum(at::maximum(kappa - 10.0, at::zeros_like(kappa)),
                            at::ones_like(kappa));
    Tensor b = b_app * sw + b_true * at::rsub(sw, 1.0);
    Tensor a = (kappa * 2.0 + (m - 1.0) + c) / 4.0;
    Tensor d = a * 4.0 * b / (b + 1.0) - (m - 1.0) * std::log(m - 1.0);
    auto ke_ku = split_words(kw_kv[0]);
    const double con = (m - 1.0) / 2.0;
    auto ke = split_words(ke_ku[0]);
    auto shape = prepend(kRejectionRounds, kappa.sizes());
    Tensor con_t = at::scalar_tensor(con, at::TensorOptions()
                                              .dtype(at::kFloat)
                                              .device(dev));
    Tensor gx = gamma_sample(ke[0], con_t, shape);
    Tensor gy = gamma_sample(ke[1], con_t, shape);
    Tensor e = (gx / (gx + gy)).to(kappa.scalar_type());
    Tensor u = uniform(ke_ku[1], shape, 1e-7, 1.0 - 1e-7, dev);
    Tensor denom = at::rsub(at::rsub(b, 1.0) * e, 1.0);
    Tensor wp = at::rsub((b + 1.0) * e, 1.0) / denom;
    Tensor t = a * 2.0 * b / denom;
    Tensor accept = at::log(t) * (m - 1.0) - t + d > at::log(u);
    w = take_first(wp, first_accept_index(accept));
  }
  Tensor v = normal(kw_kv[1], append(loc.sizes().slice(0, loc.dim() - 1),
                                     m_int - 1),
                    dev);
  v = v.to(loc.scalar_type());
  v = v / vector_norm(v);
  Tensor w_ = at::sqrt(at::clamp_min(at::rsub(at::pow(w, 2), 1.0), 1e-10));
  return householder_reflect(at::cat({w, w_ * v}, -1), loc, 1e-5);
}

// ---- the operators ----

std::tuple<Tensor, Tensor, Tensor, Tensor> sample_embed_op(
    const Tensor& key, const Tensor& loc, const Tensor& kappa, int64_t route) {
  auto [x, theta, u, v] = sample_embed_rows(key_of(key), loc, kappa, route);
  return {x.contiguous(), theta.contiguous(), u.contiguous(), v.contiguous()};
}

Tensor draw_latent_op(const Tensor& rng, const Tensor& mu,
                      const Tensor& param2, int64_t family,
                      int64_t l2_normalize, int64_t route, double scale) {
#ifdef CLIFFORDTPU_CUDA
  c10::OptionalDeviceGuard guard;
  if (mu.is_cuda()) guard.reset_device(mu.device());
#endif
  const Key key = fold_in_words(key_of(rng), kMakeRngData);
  TORCH_CHECK(family == kClifford || route == kNoRoute,
              "draw_latent: a sampler route names a clifford draw; family ",
              family, " has none");
  Tensor z;
  if (family == kNormal) {
    Tensor std_ = at::exp(param2 * 0.5) + 1e-6;
    auto shape = at::infer_size(mu.sizes(), std_.sizes());
    Tensor eps = normal(key, shape, mu.device());
    z = mu + std_ * eps.to(mu.scalar_type());
    if (l2_normalize) z = z / vector_norm(z);
  } else if (family == kPowerSpherical) {
    Tensor s = param2;
    if (s.dim() == mu.dim()) s = s.select(-1, 0);
    z = powerspherical_sample(key, mu, s);
  } else if (family == kVmf) {
    z = vmf_sample(key, mu, param2);
  } else {
    TORCH_CHECK(family == kClifford, "draw_latent: unknown family ", family);
    TORCH_CHECK(route >= kRouteKeyed && route <= kRouteRng,
                "draw_latent: unknown route ", route);
    Tensor kappa = param2.dim() < mu.dim() ? param2.unsqueeze(-1) : param2;
    auto both = at::broadcast_tensors({mu, kappa});
    const int64_t d = mu.size(-1);
    Tensor loc = both[0], kap = both[1];
    auto rows = sample_embed_rows(key, loc.reshape({-1, d}),
                                  kap.reshape({-1, d}), route);
    auto shape = append(loc.sizes().slice(0, loc.dim() - 1), 2 * d);
    z = std::get<0>(rows).reshape(shape).to(mu.scalar_type());
  }
  if (scale != 1.0) z = z * scale;
  return z.reshape({z.size(0), -1}).to(mu.scalar_type()).contiguous();
}

Tensor apply_rotary_half(const Tensor& x, const Tensor& cos_t,
                         const Tensor& sin_t) {
  const int64_t S = x.size(1), half = x.size(-1) / 2;
  Tensor x0 = x.narrow(-1, 0, half), x1 = x.narrow(-1, half, half);
  Tensor c = cos_t.narrow(0, 0, S).unsqueeze(0).unsqueeze(2).to(x.scalar_type());
  Tensor s = sin_t.narrow(0, 0, S).unsqueeze(0).unsqueeze(2).to(x.scalar_type());
  return at::cat({x0 * c - x1 * s, x0 * s + x1 * c}, -1);
}

void check_attention(const Tensor& q, const Tensor& k, const Tensor& v,
                     const c10::optional<Tensor>& cos_t,
                     const c10::optional<Tensor>& sin_t) {
  TORCH_CHECK(q.dim() == 4 && q.sizes() == k.sizes() && q.sizes() == v.sizes(),
              "attention_fwd: q, k, v must share one (B, S, H, hd) shape");
  TORCH_CHECK(q.scalar_type() == k.scalar_type() &&
                  q.scalar_type() == v.scalar_type() &&
                  (q.scalar_type() == at::kFloat ||
                   q.scalar_type() == at::kBFloat16),
              "attention_fwd: q, k, v must all be float32 or bfloat16");
  TORCH_CHECK(q.device() == k.device() && q.device() == v.device(),
              "attention_fwd: q, k, v must lie on one device");
  TORCH_CHECK(cos_t.has_value() == sin_t.has_value(),
              "attention_fwd: pass both cos and sin, or neither");
  const int64_t S = q.size(1), hd = q.size(3);
  TORCH_CHECK(hd >= 2 && hd % 2 == 0, "attention_fwd: head_dim must be even");
  if (cos_t.has_value())
    for (const Tensor& t : {*cos_t, *sin_t})
      TORCH_CHECK(t.dim() == 2 && t.size(0) >= S && t.size(1) == hd / 2 &&
                      t.scalar_type() == at::kFloat && t.device() == q.device(),
                  "attention_fwd: cos/sin must be float32 (S' >= ", S, ", ",
                  hd / 2, ") on q's device");
}

// kernels/attention.py::attention_plain
Tensor attention_fwd_cpu(const Tensor& q, const Tensor& k, const Tensor& v,
                         const c10::optional<Tensor>& cos_t,
                         const c10::optional<Tensor>& sin_t) {
  check_attention(q, k, v, cos_t, sin_t);
  const int64_t hd = q.size(-1);
  Tensor qf = q.to(at::kFloat), kf = k.to(at::kFloat), vf = v.to(at::kFloat);
  if (cos_t.has_value()) {
    Tensor c = cos_t->to(at::kFloat), s = sin_t->to(at::kFloat);
    qf = apply_rotary_half(qf, c, s);
    kf = apply_rotary_half(kf, c, s);
  }
  Tensor sc = at::einsum("bqhd,bkhd->bhqk", {qf, kf}) *
              (1.0 / std::sqrt(static_cast<double>(hd)));
  Tensor p = at::softmax(sc, -1);
  return at::einsum("bhqk,bkhd->bqhd", {p, vf})
      .to(q.scalar_type())
      .contiguous();
}

#ifdef CLIFFORDTPU_CUDA
int64_t round_up(int64_t n, int64_t m) { return (n + m - 1) / m * m; }

Tensor aligned(const Tensor& t) {
  Tensor c = t.contiguous();
  return reinterpret_cast<uintptr_t>(c.data_ptr()) % 16 ? c.clone() : c;
}

// kernel A, on the shapes that kernels/attention.py::kernel_fits holds,
// in the form its route gives them without a gradient: the whole-sequence
// form where its block needs at most half of an SM's shared memory, else
// the key-tiled one, else the whole one where it fits at all
// (attention.py::smem_bytes, tiled_smem_bytes, jax_supported, _route_problem)
Tensor attention_fwd_cuda(const Tensor& q_in, const Tensor& k_in,
                          const Tensor& v_in,
                          const c10::optional<Tensor>& cos_t,
                          const c10::optional<Tensor>& sin_t) {
  check_attention(q_in, k_in, v_in, cos_t, sin_t);
  c10::cuda::CUDAGuard guard(q_in.device());
  const int64_t B = q_in.size(0), S = q_in.size(1), H = q_in.size(2),
                hd = q_in.size(3);
  const bool bf16 = q_in.scalar_type() == at::kBFloat16;
  // the tiled forms' shared memory (kernels/attention.py::tiled_smem_bytes,
  // geometry): bfloat16 up to 6 units of 16 own rows a block, walked key
  // tiles of 64 in a ring of 2 stages, the tables of the tile in flight;
  // float32 up to head_dim 64 5 units whose
  // keys are split among 3 warps, rounds of 3 sub-tiles of 32 keys in 2
  // stages, up to 128 4 units and tiles of 32, above 128 tiles of 32 with
  // the output in shared memory
  int64_t whole, tiled;
  if (bf16) {
    TORCH_CHECK(hd == 16 || hd == 32 || hd == 64 || hd == 128,
                "attention_fwd: the bfloat16 kernel takes head_dim 16, 32, "
                "64 or 128, got ", hd);
    whole = 2 * 3 * round_up(S, 16) * (hd + 8);
    tiled = 2 * (16 * 6 + 2 * 2 * 64) * (hd + 8) + 4 * 64 * hd;
  } else {
    TORCH_CHECK(hd % 8 == 0, "attention_fwd: the float32 kernel takes "
                "head_dim a multiple of 8, got ", hd);
    const int64_t Sp = round_up(S, 4);
    whole = 4 * Sp * (2 * (hd + 4) + hd + Sp + 4);
    const int64_t units = hd <= 64 ? 5 : 4, splits = hd <= 64 ? 3 : 1;
    const int64_t fown = 16 * units, walk = 32 * splits;
    tiled = hd > 128 ? 4 * (4 * 32 * (hd + 4) + 32 * 36 + 3 * 32)
                     : 4 * ((fown + 4 * walk) * (hd + 4) + walk * hd +
                            fown * splits * 40);
  }
  const int64_t Sj = round_up(S, 8);
  const int64_t working = (7 * H * Sj * hd + 2 * Sj * hd + 3 * Sj * Sj) * 4;
  TORCH_CHECK(working < kJaxWorkingMax && S >= 2, "attention_fwd: S=", S,
              ", H=", H, ", hd=", hd, " lies beyond the JAX package's "
              "attention_supported (its XLA branch's shapes)");
  const bool use_tiled = whole > kSmemMax / 2 && tiled <= kSmemMax;
  TORCH_CHECK(use_tiled || whole <= kSmemMax, "attention_fwd: hd=", hd,
              " needs ", tiled, " bytes of shared memory in the tiled form "
              "and S=", S, " does not fit the whole-sequence one, above ",
              kSmemMax);
  Tensor q = aligned(q_in), k = aligned(k_in), v = aligned(v_in);
  Tensor c, s;
  if (cos_t.has_value()) {
    c = aligned(cos_t->narrow(0, 0, S));
    s = aligned(sin_t->narrow(0, 0, S));
  }
  Tensor out = at::empty(q.sizes(), q.options());
  const float* cp = c.defined() ? c.data_ptr<float>() : nullptr;
  const float* sp = s.defined() ? s.data_ptr<float>() : nullptr;
  if (use_tiled) {
    auto launch = bf16 ? attention_fwd_tiled_bf16 : attention_fwd_tiled_f32;
    check_rc(launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), cp, sp,
                    out.data_ptr(), nullptr, B, S, H, hd, H * hd, hd,
                    stream_of(q)),
             "attention_fwd (tiled)");
  } else {
    auto launch = bf16 ? attention_fwd_bf16 : attention_fwd_f32;
    check_rc(launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), cp, sp,
                    out.data_ptr(), B, S, H, hd, H * hd, hd, stream_of(q)),
             "attention_fwd");
  }
  g_launches[kAttention]++;
  return out;
}
#endif

// ---- casts and group norms (any device, Meta included) ----

// kernels/native.py::CAST_DTYPES, in this order
const at::ScalarType kCastDtypes[] = {at::kFloat, at::kBFloat16, at::kHalf};

Tensor cast_op(const Tensor& x, int64_t dtype) {
  TORCH_CHECK(dtype >= 0 && dtype < int64_t(std::size(kCastDtypes)),
              "cliffordtpu_native::cast: unknown dtype code ", dtype);
  return x.to(kCastDtypes[dtype], /*non_blocking=*/false, /*copy=*/true);
}

Tensor group_norm_op(const Tensor& x, int64_t groups,
                     const c10::optional<Tensor>& weight,
                     const c10::optional<Tensor>& bias, double eps) {
  return at::group_norm(x, groups, weight, bias, eps,
                        at::globalContext().userEnabledCuDNN());
}

// ---- shapes for tracing (Meta) ----

Tensor attention_fwd_meta(const Tensor& q, const Tensor&, const Tensor&,
                          const c10::optional<Tensor>&,
                          const c10::optional<Tensor>&) {
  return at::empty(q.sizes(), q.options());
}

Tensor draw_latent_meta(const Tensor&, const Tensor& mu, const Tensor&,
                        int64_t family, int64_t, int64_t, double) {
  int64_t width = 1;
  for (int64_t i = 1; i < mu.dim(); ++i) width *= mu.size(i);
  if (family == kClifford) width *= 2;
  return at::empty({mu.size(0), width}, mu.options());
}

std::tuple<Tensor, Tensor, Tensor, Tensor> sample_embed_meta(
    const Tensor&, const Tensor& loc, const Tensor&, int64_t) {
  const int64_t R = loc.size(0), d = loc.size(1);
  auto opts = loc.options().dtype(at::kFloat);
  return {at::empty({R, 2 * d}, opts), at::empty({R, d - 1}, opts),
          at::empty({R, d - 1}, opts), at::empty({R, d - 1}, opts)};
}

}  // namespace

// the ABI of the operators' schemas, which a bundle's manifest records
extern "C" int64_t cliffordtpu_native_abi() { return 2; }

// the kernels whose launches are counted, in the order of the counts
extern "C" const char* cliffordtpu_native_kernels() {
  return "attention_fwd,sampler_keyed,sampler_rng,torus_fwd";
}

extern "C" void cliffordtpu_native_launches(int64_t* out) {
  for (int i = 0; i < kNumKernels; ++i) out[i] = g_launches[i].load();
}

extern "C" void cliffordtpu_native_reset_launches() {
  for (int i = 0; i < kNumKernels; ++i) g_launches[i].store(0);
}

extern "C" int cliffordtpu_native_has_cuda() {
#ifdef CLIFFORDTPU_CUDA
  return 1;
#else
  return 0;
#endif
}

TORCH_LIBRARY(cliffordtpu_native, m) {
  m.def("attention_fwd(Tensor q, Tensor k, Tensor v, Tensor? cos, "
        "Tensor? sin) -> Tensor");
  m.def("draw_latent(Tensor rng, Tensor mu, Tensor param2, int family, "
        "int l2_normalize, int route, float scale) -> Tensor");
  m.def("sample_embed(Tensor key, Tensor loc, Tensor kappa, int route) -> "
        "(Tensor, Tensor, Tensor, Tensor)");
  m.def("cast(Tensor x, int dtype) -> Tensor");
  m.def("group_norm(Tensor x, int groups, Tensor? weight, Tensor? bias, "
        "float eps) -> Tensor");
}

TORCH_LIBRARY_IMPL(cliffordtpu_native, CompositeExplicitAutograd, m) {
  m.impl("cast", cast_op);
  m.impl("group_norm", group_norm_op);
}

TORCH_LIBRARY_IMPL(cliffordtpu_native, CPU, m) {
  m.impl("attention_fwd", attention_fwd_cpu);
  m.impl("draw_latent", draw_latent_op);
  m.impl("sample_embed", sample_embed_op);
}

#ifdef CLIFFORDTPU_CUDA
TORCH_LIBRARY_IMPL(cliffordtpu_native, CUDA, m) {
  m.impl("attention_fwd", attention_fwd_cuda);
  m.impl("draw_latent", draw_latent_op);
  m.impl("sample_embed", sample_embed_op);
}
#endif

TORCH_LIBRARY_IMPL(cliffordtpu_native, Meta, m) {
  m.impl("attention_fwd", attention_fwd_meta);
  m.impl("draw_latent", draw_latent_meta);
  m.impl("sample_embed", sample_embed_meta);
}
