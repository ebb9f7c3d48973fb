// cliffordtpu_serve: serve a bundle of serving.export_serving(native=True)
// with no Python in the process (the port's counterpart of the JAX
// package's PJRT host).  C++ against libtorch only.
//
//   cliffordtpu_serve --ops libcliffordtpu_native-<variant>-<hash>.so \
//       --bundle DIR --fn encode_z --device cuda|cpu \
//       --input rng.npy --input x.npy --output z.npy [--bench N] [--warmup K]
//
// What it does:
//   1. parses manifest.json (the minimal JSON reader below); its "native"
//      section names the AOTInductor package of each function and platform
//      (<fn>.native.<platform>.pt2), the fixed batch, the operator
//      library's ABI and the flat calling convention: the weights in
//      "param_order", then the function's array arguments ("args": the rng
//      as uint32[2], which the program takes as int64, the images or the
//      latents as float32 at the fixed batch);
//   2. reads params.npz (ZIP stored / deflate, zlib) with its ::bf16 and
//      ::int8 + ::scale storage dequantized to float32, and makes each
//      weight by the manifest's param_layout (a flip, then a transpose);
//   3. dlopens the operator library (--ops) before it loads a package, so
//      that the package's calls to cliffordtpu_native::* find their
//      kernels in the dispatcher, and checks its ABI;
//   4. turns TF32 off for cuBLAS and cuDNN, as every float32 bar assumes;
//   5. uploads the weights and the --input arrays to the device ONCE and
//      runs the package through torch::inductor::AOTIModelPackageLoader:
//      one request, or --warmup K requests and a --bench N latency loop
//      (each request timed to the end of its work on the device), then
//      one more request whose output --output writes (.npy; a bfloat16
//      output is written as float32).
//
// Prints exactly one JSON line on stdout: the JAX host's keys (fn,
// platform, and out_shape / out_dtype / ms for one request, or batch /
// mean_ms / p50_ms / p90_ms / requests_per_s / samples_per_s for --bench;
// compile_ms is the package's load time, since AOTInductor compiled it at
// export), plus "launches": the operator library's kernel launches during
// the request whose output is written.  Diagnostics go to stderr; any
// error exits non-zero.

#include <dlfcn.h>
#include <zlib.h>

#include <algorithm>
#include <chrono>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <exception>
#include <fstream>
#include <map>
#include <memory>
#include <sstream>
#include <string>
#include <vector>

#include <ATen/ATen.h>
#include <torch/csrc/inductor/aoti_package/model_package_loader.h>

#ifdef CLIFFORDTPU_CUDA
#include <c10/cuda/CUDAFunctions.h>
#endif

namespace {

[[noreturn]] void die(const std::string& msg) {
  fprintf(stderr, "cliffordtpu_serve: %s\n", msg.c_str());
  exit(1);
}

// ---------------------------------------------------------------------------
// Minimal JSON: objects, arrays, strings, numbers, bools, null
// ---------------------------------------------------------------------------

struct Json {
  enum Kind { kNull, kBool, kNum, kStr, kArr, kObj } kind = kNull;
  bool b = false;
  double num = 0;
  std::string str;
  std::vector<Json> arr;
  std::map<std::string, Json> obj;

  const Json& at(const std::string& k) const {
    auto it = obj.find(k);
    if (kind != kObj || it == obj.end())
      die("manifest: missing key '" + k + "'");
    return it->second;
  }
  bool has(const std::string& k) const { return kind == kObj && obj.count(k); }
  int64_t as_int() const {
    if (kind == kNum) return static_cast<int64_t>(num);
    if (kind == kStr) return strtoll(str.c_str(), nullptr, 10);
    die("manifest: expected an integer");
  }
  const std::string& as_str() const {
    if (kind != kStr) die("manifest: expected a string");
    return str;
  }
};

struct JsonParser {
  const char* p;
  const char* end;
  explicit JsonParser(const std::string& s)
      : p(s.data()), end(s.data() + s.size()) {}
  void ws() {
    while (p < end && (*p == ' ' || *p == '\t' || *p == '\n' || *p == '\r')) ++p;
  }
  char peek() {
    ws();
    if (p >= end) die("json: unexpected end");
    return *p;
  }
  void expect(char c) {
    if (peek() != c) die(std::string("json: expected '") + c + "'");
    ++p;
  }
  void lit(const char* s) {
    ws();
    size_t n = strlen(s);
    if (p + n > end || strncmp(p, s, n) != 0) die("json: bad literal");
    p += n;
  }
  Json parse() {
    char c = peek();
    Json j;
    if (c == '{') return obj();
    if (c == '[') return arr();
    if (c == '"') {
      j.kind = Json::kStr;
      j.str = str();
    } else if (c == 't') {
      lit("true");
      j.kind = Json::kBool;
      j.b = true;
    } else if (c == 'f') {
      lit("false");
      j.kind = Json::kBool;
    } else if (c == 'n') {
      lit("null");
    } else {
      char* e = nullptr;
      j.kind = Json::kNum;
      j.num = strtod(p, &e);
      if (e == p) die("json: bad number");
      p = e;
    }
    return j;
  }
  std::string str() {
    expect('"');
    std::string out;
    while (p < end && *p != '"') {
      if (*p != '\\') {
        out += *p++;
        continue;
      }
      if (++p >= end) die("json: bad escape");
      switch (*p) {
        case 'n': out += '\n'; break;
        case 't': out += '\t'; break;
        case 'r': out += '\r'; break;
        case 'b': out += '\b'; break;
        case 'f': out += '\f'; break;
        case 'u': {
          if (p + 4 >= end) die("json: bad \\u escape");
          unsigned v = strtoul(std::string(p + 1, p + 5).c_str(), nullptr, 16);
          p += 4;
          if (v < 0x80) {
            out += static_cast<char>(v);
          } else if (v < 0x800) {
            out += static_cast<char>(0xC0 | (v >> 6));
            out += static_cast<char>(0x80 | (v & 0x3F));
          } else {
            out += static_cast<char>(0xE0 | (v >> 12));
            out += static_cast<char>(0x80 | ((v >> 6) & 0x3F));
            out += static_cast<char>(0x80 | (v & 0x3F));
          }
          break;
        }
        default: out += *p;
      }
      ++p;
    }
    if (p >= end) die("json: unterminated string");
    ++p;
    return out;
  }
  Json arr() {
    expect('[');
    Json j;
    j.kind = Json::kArr;
    if (peek() == ']') {
      ++p;
      return j;
    }
    while (true) {
      j.arr.push_back(parse());
      if (peek() == ']') {
        ++p;
        return j;
      }
      expect(',');
    }
  }
  Json obj() {
    expect('{');
    Json j;
    j.kind = Json::kObj;
    if (peek() == '}') {
      ++p;
      return j;
    }
    while (true) {
      std::string k = str();
      expect(':');
      j.obj[k] = parse();
      if (peek() == '}') {
        ++p;
        return j;
      }
      expect(',');
    }
  }
};

// ---------------------------------------------------------------------------
// npy / npz (np.savez's ZIP of stored or deflated .npy members)
// ---------------------------------------------------------------------------

struct HostArray {
  std::string dtype;  // numpy descr without byte order, e.g. "f4"
  std::vector<int64_t> dims;
  std::vector<uint8_t> data;  // C order
  int64_t nelem() const {
    int64_t n = 1;
    for (auto d : dims) n *= d;
    return n;
  }
};

std::string read_file(const std::string& path) {
  std::ifstream f(path, std::ios::binary);
  if (!f) die("cannot read " + path);
  std::ostringstream ss;
  ss << f.rdbuf();
  return ss.str();
}

uint16_t rd16(const uint8_t* p) { return p[0] | (p[1] << 8); }
uint32_t rd32(const uint8_t* p) {
  return p[0] | (p[1] << 8) | (uint32_t(p[2]) << 16) | (uint32_t(p[3]) << 24);
}

HostArray parse_npy(const uint8_t* p, size_t n, const std::string& what) {
  if (n < 10 || memcmp(p, "\x93NUMPY", 6) != 0) die(what + ": bad npy magic");
  size_t hlen, hoff;
  if (p[6] == 1) {
    hlen = rd16(p + 8);
    hoff = 10;
  } else {
    if (n < 12) die(what + ": truncated npy header");
    hlen = rd32(p + 8);
    hoff = 12;
  }
  if (hoff + hlen > n) die(what + ": truncated npy header");
  std::string hdr(reinterpret_cast<const char*>(p + hoff), hlen);
  HostArray out;
  auto dp = hdr.find("'descr'");
  if (dp == std::string::npos) die(what + ": no descr");
  auto q1 = hdr.find('\'', dp + 7);
  auto q2 = hdr.find('\'', q1 + 1);
  std::string descr = hdr.substr(q1 + 1, q2 - q1 - 1);
  if (!descr.empty() && (descr[0] == '<' || descr[0] == '|' || descr[0] == '='))
    descr = descr.substr(1);
  else if (!descr.empty() && descr[0] == '>')
    die(what + ": big-endian arrays are not supported");
  out.dtype = descr;
  if (hdr.find("'fortran_order': True") != std::string::npos)
    die(what + ": Fortran-order arrays are not supported");
  auto sp = hdr.find("'shape'");
  auto b1 = hdr.find('(', sp);
  auto b2 = hdr.find(')', b1);
  std::stringstream ss(hdr.substr(b1 + 1, b2 - b1 - 1));
  std::string tok;
  while (std::getline(ss, tok, ',')) {
    tok.erase(std::remove(tok.begin(), tok.end(), ' '), tok.end());
    if (!tok.empty()) out.dims.push_back(strtoll(tok.c_str(), nullptr, 10));
  }
  size_t itemsize = strtoul(descr.c_str() + 1, nullptr, 10);
  if (itemsize == 0) die(what + ": bad descr '" + descr + "'");
  size_t want = itemsize * static_cast<size_t>(out.nelem());
  if (hoff + hlen + want > n) die(what + ": truncated npy payload");
  out.data.assign(p + hoff + hlen, p + hoff + hlen + want);
  return out;
}

HostArray read_npy_file(const std::string& path) {
  std::string blob = read_file(path);
  return parse_npy(reinterpret_cast<const uint8_t*>(blob.data()), blob.size(),
                   path);
}

void write_npy_file(const std::string& path, const HostArray& a) {
  std::string shp = "(";
  for (size_t i = 0; i < a.dims.size(); ++i) {
    shp += std::to_string(a.dims[i]);
    if (i + 1 < a.dims.size()) shp += ", ";
  }
  if (a.dims.size() == 1) shp += ",";
  shp += ")";
  std::string hdr = "{'descr': '<" + a.dtype +
                    "', 'fortran_order': False, 'shape': " + shp + ", }";
  hdr += std::string((64 - (10 + hdr.size() + 1) % 64) % 64, ' ');
  hdr += '\n';
  std::ofstream f(path, std::ios::binary);
  if (!f) die("cannot write " + path);
  f.write("\x93NUMPY\x01\x00", 8);
  const uint16_t hl = static_cast<uint16_t>(hdr.size());
  f.put(static_cast<char>(hl & 0xFF));
  f.put(static_cast<char>(hl >> 8));
  f.write(hdr.data(), hdr.size());
  f.write(reinterpret_cast<const char*>(a.data.data()), a.data.size());
  if (!f) die("cannot write " + path);
}

// the ZIP central directory; members stored (0) or deflated (8)
std::map<std::string, HostArray> read_npz(const std::string& path) {
  std::string blob = read_file(path);
  const uint8_t* base = reinterpret_cast<const uint8_t*>(blob.data());
  const size_t n = blob.size();
  if (n < 22) die(path + ": too small for a ZIP archive");
  size_t eocd = std::string::npos;
  for (size_t i = n - 22;; --i) {
    if (rd32(base + i) == 0x06054b50) {
      eocd = i;
      break;
    }
    if (i == 0) break;
  }
  if (eocd == std::string::npos) die(path + ": no ZIP end of central directory");
  const uint16_t entries = rd16(base + eocd + 10);
  size_t p = rd32(base + eocd + 16);
  std::map<std::string, HostArray> out;
  for (int e = 0; e < entries; ++e) {
    if (p + 46 > n || rd32(base + p) != 0x02014b50)
      die(path + ": bad central directory entry");
    const uint16_t method = rd16(base + p + 10);
    const uint32_t csize = rd32(base + p + 20), usize = rd32(base + p + 24);
    const uint16_t nlen = rd16(base + p + 28), xlen = rd16(base + p + 30),
                   clen = rd16(base + p + 32);
    const uint32_t lho = rd32(base + p + 42);
    std::string name(reinterpret_cast<const char*>(base + p + 46), nlen);
    p += 46 + nlen + xlen + clen;
    if (lho + 30 > n || rd32(base + lho) != 0x04034b50)
      die(path + ": bad local header");
    const uint8_t* payload =
        base + lho + 30 + rd16(base + lho + 26) + rd16(base + lho + 28);
    if (payload + csize > base + n) die(path + ": truncated member " + name);
    std::vector<uint8_t> raw;
    if (method == 0) {
      raw.assign(payload, payload + csize);
    } else if (method == 8) {
      raw.resize(usize);
      z_stream zs{};
      if (inflateInit2(&zs, -15) != Z_OK) die("inflateInit2 failed");
      zs.next_in = const_cast<uint8_t*>(payload);
      zs.avail_in = csize;
      zs.next_out = raw.data();
      zs.avail_out = usize;
      const int rc = inflate(&zs, Z_FINISH);
      inflateEnd(&zs);
      if (rc != Z_STREAM_END) die(path + ": inflate failed on " + name);
    } else {
      die(path + ": unsupported compression method");
    }
    if (name.size() > 4 && name.compare(name.size() - 4, 4, ".npy") == 0)
      name = name.substr(0, name.size() - 4);
    out[name] = parse_npy(raw.data(), raw.size(), path + ":" + name);
  }
  return out;
}

bool ends_with(const std::string& s, const char* tail) {
  const size_t n = strlen(tail);
  return s.size() > n && s.compare(s.size() - n, n, tail) == 0;
}

// serving.py::_dequantize_flat: ::bf16 words and ::int8 with a float32
// scale per output column (the last axis) become float32
std::map<std::string, HostArray> dequantize(std::map<std::string, HostArray> flat) {
  std::map<std::string, HostArray> out;
  for (auto& [k, v] : flat) {
    if (ends_with(k, "::scale")) continue;
    if (ends_with(k, "::bf16")) {
      if (v.dtype != "u2") die("params: " + k + " has dtype " + v.dtype);
      HostArray a;
      a.dims = v.dims;
      a.dtype = "f4";
      a.data.resize(v.nelem() * 4);
      const uint16_t* src = reinterpret_cast<const uint16_t*>(v.data.data());
      uint32_t* dst = reinterpret_cast<uint32_t*>(a.data.data());
      for (int64_t i = 0; i < v.nelem(); ++i) dst[i] = uint32_t(src[i]) << 16;
      out[k.substr(0, k.size() - 6)] = std::move(a);
    } else if (ends_with(k, "::int8")) {
      auto it = flat.find(k.substr(0, k.size() - 6) + "::scale");
      if (it == flat.end()) die("params: no ::scale for " + k);
      const HostArray& s = it->second;
      const int64_t cols = v.dims.empty() ? 1 : v.dims.back();
      if (v.dtype != "i1") die("params: " + k + " has dtype " + v.dtype);
      if (s.dtype != "f4" || s.nelem() != cols)
        die("params: the ::scale of " + k + " is not " + std::to_string(cols) +
            " float32 values");
      HostArray a;
      a.dims = v.dims;
      a.dtype = "f4";
      a.data.resize(v.nelem() * 4);
      const int8_t* q = reinterpret_cast<const int8_t*>(v.data.data());
      const float* sc = reinterpret_cast<const float*>(s.data.data());
      float* dst = reinterpret_cast<float*>(a.data.data());
      for (int64_t i = 0; i < v.nelem(); ++i)
        dst[i] = static_cast<float>(q[i]) * sc[i % cols];
      out[k.substr(0, k.size() - 6)] = std::move(a);
    } else {
      out[k] = std::move(v);
    }
  }
  return out;
}

// ---------------------------------------------------------------------------
// tensors
// ---------------------------------------------------------------------------

at::ScalarType scalar_type(const std::string& npy, const std::string& what) {
  if (npy == "f4") return at::kFloat;
  if (npy == "u4" || npy == "i8") return at::kLong;  // the rng's words
  die(what + ": unsupported dtype " + npy);
}

at::Tensor host_tensor(const HostArray& a, at::ScalarType from) {
  at::Tensor t = at::empty(a.dims, at::TensorOptions().dtype(from));
  memcpy(t.data_ptr(), a.data.data(), a.data.size());
  return t;
}

// an --input array, checked against the manifest's argument, on the device
at::Tensor input_tensor(const HostArray& a, const Json& spec,
                        const std::string& path, const c10::Device& device) {
  const auto& dims = spec.at("shape").arr;
  if (a.dims.size() != dims.size())
    die("input " + path + ": rank " + std::to_string(a.dims.size()) +
        ", the manifest says " + std::to_string(dims.size()));
  for (size_t i = 0; i < dims.size(); ++i)
    if (a.dims[i] != dims[i].as_int())
      die("input " + path + ": dim " + std::to_string(i) + " is " +
          std::to_string(a.dims[i]) + ", the manifest says " +
          std::to_string(dims[i].as_int()) +
          " (a native bundle's batch is fixed at export)");
  const std::string& want = spec.at("dtype").as_str();
  const std::string npy = want == "uint32" ? "u4" : want == "float32" ? "f4" : "";
  if (npy.empty() || a.dtype != npy)
    die("input " + path + ": dtype " + a.dtype + ", the manifest says " + want);
  at::Tensor t;
  if (npy == "u4") {  // uint32 words, which the program takes as int64
    t = at::empty(a.dims, at::TensorOptions().dtype(at::kLong));
    const uint32_t* src = reinterpret_cast<const uint32_t*>(a.data.data());
    int64_t* dst = t.data_ptr<int64_t>();
    for (int64_t i = 0; i < a.nelem(); ++i) dst[i] = src[i];
  } else {
    t = host_tensor(a, scalar_type(npy, path));
  }
  return t.to(device);
}

// serving.py::_apply_layout: flip, then transpose, of the JAX array
at::Tensor weight_tensor(const HostArray& a, const Json& entry,
                         const c10::Device& device) {
  if (a.dtype != "f4")
    die("params: " + entry.arr[1].as_str() + " has dtype " + a.dtype);
  at::Tensor t = host_tensor(a, at::kFloat);
  std::vector<int64_t> flip;
  for (const auto& f : entry.arr[2].arr) flip.push_back(f.as_int());
  if (!flip.empty()) t = at::flip(t, flip);
  if (entry.arr[3].kind == Json::kArr) {
    std::vector<int64_t> order;
    for (const auto& o : entry.arr[3].arr) order.push_back(o.as_int());
    t = t.permute(order);
  }
  return t.contiguous().to(device);
}

HostArray host_array(const at::Tensor& out) {
  at::Tensor t = out.to(at::kCPU);
  if (t.scalar_type() == at::kBFloat16 || t.scalar_type() == at::kHalf)
    t = t.to(at::kFloat);
  t = t.contiguous();
  HostArray a;
  switch (t.scalar_type()) {
    case at::kFloat: a.dtype = "f4"; break;
    case at::kDouble: a.dtype = "f8"; break;
    case at::kLong: a.dtype = "i8"; break;
    case at::kInt: a.dtype = "i4"; break;
    default: die("output: unsupported dtype " + std::string(c10::toString(t.scalar_type())));
  }
  a.dims.assign(t.sizes().begin(), t.sizes().end());
  const size_t bytes = t.numel() * t.element_size();
  a.data.resize(bytes);
  memcpy(a.data.data(), t.data_ptr(), bytes);
  return a;
}

// ---------------------------------------------------------------------------
// the operator library
// ---------------------------------------------------------------------------

struct Ops {
  std::vector<std::string> names;
  void (*launches)(int64_t*) = nullptr;

  std::vector<int64_t> counts() const {
    std::vector<int64_t> c(names.size());
    launches(c.data());
    return c;
  }
};

Ops load_ops(const std::string& path, int64_t want_abi) {
  void* h = dlopen(path.c_str(), RTLD_NOW | RTLD_GLOBAL);
  if (!h) die(std::string("dlopen ") + path + ": " + dlerror());
  auto abi = reinterpret_cast<int64_t (*)()>(dlsym(h, "cliffordtpu_native_abi"));
  auto kernels = reinterpret_cast<const char* (*)()>(
      dlsym(h, "cliffordtpu_native_kernels"));
  Ops ops;
  ops.launches = reinterpret_cast<void (*)(int64_t*)>(
      dlsym(h, "cliffordtpu_native_launches"));
  if (!abi || !kernels || !ops.launches)
    die(path + " is not the cliffordtpu_native operator library");
  if (abi() != want_abi)
    die(path + ": operator ABI " + std::to_string(abi()) +
        ", the bundle was exported for " + std::to_string(want_abi));
  std::stringstream ss(kernels());
  std::string name;
  while (std::getline(ss, name, ',')) ops.names.push_back(name);
  return ops;
}

void sync(const c10::Device& device) {
#ifdef CLIFFORDTPU_CUDA
  if (device.is_cuda()) c10::cuda::device_synchronize();
#else
  (void)device;
#endif
}

int serve(int argc, char** argv) {
  std::string ops_path, bundle, fn, device_name = "cuda", output;
  std::vector<std::string> inputs;
  long bench = 0, warmup = 2;
  for (int i = 1; i < argc; ++i) {
    const std::string a = argv[i];
    auto next = [&]() -> std::string {
      if (i + 1 >= argc) die("missing value for " + a);
      return argv[++i];
    };
    if (a == "--ops") ops_path = next();
    else if (a == "--bundle") bundle = next();
    else if (a == "--fn") fn = next();
    else if (a == "--device") device_name = next();
    else if (a == "--input") inputs.push_back(next());
    else if (a == "--output") output = next();
    else if (a == "--bench") bench = strtol(next().c_str(), nullptr, 10);
    else if (a == "--warmup") warmup = strtol(next().c_str(), nullptr, 10);
    else die("unknown flag " + a);
  }
  if (ops_path.empty() || bundle.empty() || fn.empty())
    die("--ops, --bundle and --fn are required");
  if (device_name != "cuda" && device_name != "cpu")
    die("--device must be cuda or cpu, got " + device_name);
#ifndef CLIFFORDTPU_CUDA
  if (device_name == "cuda") die("this host was built without CUDA");
#endif
  const c10::Device device(device_name == "cuda" ? c10::kCUDA : c10::kCPU, 0);

  // ---- bundle ----
  const Json manifest = JsonParser(read_file(bundle + "/manifest.json")).parse();
  if (!manifest.has("native"))
    die("the bundle has no 'native' section: export it with "
        "serving.export_serving(native=True)");
  const Json& nat = manifest.at("native");
  const Json& funcs = nat.at("functions");
  if (!funcs.has(fn)) die("the bundle has no native program of '" + fn + "'");
  const Json& nfn = funcs.at(fn);
  if (!nfn.at("packages").has(device_name))
    die("the bundle has no native program of '" + fn + "' for " + device_name);
  const std::string package = bundle + "/" + nfn.at("packages").at(device_name).as_str();

  // ---- operators, then the package ----
  Ops ops = load_ops(ops_path, nat.at("ops").at("abi").as_int());
  at::globalContext().setAllowTF32CuBLAS(false);
  at::globalContext().setAllowTF32CuDNN(false);
  const auto t_load = std::chrono::steady_clock::now();
  torch::inductor::AOTIModelPackageLoader loader(package);
  const double load_ms = std::chrono::duration<double, std::milli>(
                             std::chrono::steady_clock::now() - t_load)
                             .count();

  // ---- weights, then the array arguments: uploaded once ----
  auto params = dequantize(read_npz(bundle + "/params.npz"));
  std::map<std::string, const Json*> layout;
  for (const auto& e : manifest.at("param_layout").arr) layout[e.arr[0].as_str()] = &e;
  std::vector<at::Tensor> flat;
  for (const auto& port : nat.at("param_order").arr) {
    auto it = layout.find(port.as_str());
    if (it == layout.end()) die("param_layout has no entry for " + port.as_str());
    const std::string& key = it->second->arr[1].as_str();
    auto p = params.find(key);
    if (p == params.end()) die("params.npz has no '" + key + "'");
    flat.push_back(weight_tensor(p->second, *it->second, device));
  }
  const auto& args = nfn.at("args").arr;
  if (inputs.size() != args.size())
    die("'" + fn + "' takes " + std::to_string(args.size()) +
        " array input(s) (the manifest's args), got " +
        std::to_string(inputs.size()));
  for (size_t i = 0; i < inputs.size(); ++i)
    flat.push_back(input_tensor(read_npy_file(inputs[i]), args[i], inputs[i], device));

  auto run_once = [&](at::Tensor* out) -> double {
    sync(device);
    const auto t0 = std::chrono::steady_clock::now();
    std::vector<at::Tensor> outs = loader.run(flat);
    sync(device);
    const double ms = std::chrono::duration<double, std::milli>(
                          std::chrono::steady_clock::now() - t0)
                          .count();
    if (outs.size() != 1) die("the program returned " + std::to_string(outs.size()) + " outputs");
    if (out) *out = outs[0];
    return ms;
  };

  std::vector<double> lat;
  if (bench > 0) {
    for (long i = 0; i < warmup; ++i) run_once(nullptr);
    for (long i = 0; i < bench; ++i) lat.push_back(run_once(nullptr));
  }
  const std::vector<int64_t> before = ops.counts();
  at::Tensor out;
  const double ms = run_once(&out);
  const std::vector<int64_t> after = ops.counts();
  std::string launches = "{";
  for (size_t i = 0; i < ops.names.size(); ++i)
    launches += (i ? ", \"" : "\"") + ops.names[i] + "\": " +
                std::to_string(after[i] - before[i]);
  launches += "}";
  const HostArray result = host_array(out);
  if (!output.empty()) write_npy_file(output, result);

  if (bench > 0) {
    std::sort(lat.begin(), lat.end());
    double mean = 0;
    for (double v : lat) mean += v;
    mean /= lat.size();
    const double p50 = lat[lat.size() / 2];
    const double p90 = lat[static_cast<size_t>(lat.size() * 0.9)];
    const int64_t batch = result.dims.empty() ? 1 : result.dims[0];
    printf("{\"fn\": \"%s\", \"platform\": \"%s\", \"batch\": %lld, "
           "\"compile_ms\": %.1f, \"mean_ms\": %.4f, \"p50_ms\": %.4f, "
           "\"p90_ms\": %.4f, \"requests_per_s\": %.2f, "
           "\"samples_per_s\": %.2f, \"launches\": %s}\n",
           fn.c_str(), device_name.c_str(), static_cast<long long>(batch),
           load_ms, mean, p50, p90, 1000.0 / mean, 1000.0 / mean * batch,
           launches.c_str());
  } else {
    std::string dims = "[";
    for (size_t i = 0; i < result.dims.size(); ++i)
      dims += (i ? ", " : "") + std::to_string(result.dims[i]);
    dims += "]";
    printf("{\"fn\": \"%s\", \"platform\": \"%s\", \"out_shape\": %s, "
           "\"out_dtype\": \"%s\", \"compile_ms\": %.1f, \"ms\": %.4f, "
           "\"launches\": %s}\n",
           fn.c_str(), device_name.c_str(), dims.c_str(),
           result.dtype.c_str(), load_ms, ms, launches.c_str());
  }
  fflush(stdout);
  return 0;
}

}  // namespace

int main(int argc, char** argv) {
  try {
    return serve(argc, argv);
  } catch (const std::exception& e) {
    die(e.what());
  }
}
