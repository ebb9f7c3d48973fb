// Native data engine of cliffordtpu_torch (C++17, no deps beyond zlib):
// a copy of cliffordtpu/native/dataio.cc, C ABI version 1.
//
// A small shared library that the Python package loads with ctypes:
//
//   * idx file parsing (the MNIST/FashionMNIST container format,
//     plain or .gz) straight into a caller buffer, in place of the
//     Python struct/frombuffer path of data/loaders.py::_read_idx;
//   * a prefetching batch assembler: a worker thread that gathers
//     permuted (batch, sample) slices of the prepared float32 tensor
//     into a ring of staging buffers ahead of consumption, so batch
//     assembly overlaps device compute.  The permutation is supplied
//     by the CALLER (random.permutation, jax.random.permutation's
//     stream) so the keyed shuffle stream is bit-identical to the
//     numpy iterate_batches path.
//
// Build: cliffordtpu_torch/native/build.py (g++ -O3 -shared -fPIC ... -lz).
// Bindings and routing policy: cliffordtpu_torch/data/native.py.

#include <zlib.h>

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <mutex>
#include <thread>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// idx parsing
// ---------------------------------------------------------------------------

// idx container: 4-byte magic (0x00, 0x00, dtype, ndim) then ndim
// big-endian u32 dims, then row-major payload.  Only dtype 0x08 (u8) is
// used by the MNIST-family files (data/loaders.py::_read_idx mirrors
// this contract and its error behaviour).

static int read_exact(gzFile f, void* buf, unsigned len) {
  unsigned got = 0;
  char* p = static_cast<char*>(buf);
  while (got < len) {
    int r = gzread(f, p + got, len - got);
    if (r <= 0) return -1;
    got += static_cast<unsigned>(r);
  }
  return 0;
}

static uint32_t be32(const unsigned char* p) {
  return (uint32_t(p[0]) << 24) | (uint32_t(p[1]) << 16) |
         (uint32_t(p[2]) << 8) | uint32_t(p[3]);
}

// Parse the header: fills ndim and dims[0..2], returns the payload byte
// count, or -1 on malformed input / unsupported dtype.  gzopen reads
// plain files transparently, so one code path serves both.
int64_t idx_header(const char* path, int32_t* ndim_out, uint32_t dims_out[3]) {
  gzFile f = gzopen(path, "rb");
  if (!f) return -1;
  unsigned char magic[4];
  if (read_exact(f, magic, 4) != 0 || magic[0] != 0 || magic[1] != 0 ||
      magic[2] != 0x08 || magic[3] < 1 || magic[3] > 3) {
    gzclose(f);
    return -1;
  }
  int32_t ndim = magic[3];
  unsigned char dimbuf[12];
  if (read_exact(f, dimbuf, 4u * ndim) != 0) {
    gzclose(f);
    return -1;
  }
  gzclose(f);
  int64_t total = 1;
  for (int i = 0; i < ndim; ++i) {
    dims_out[i] = be32(dimbuf + 4 * i);
    total *= dims_out[i];
  }
  *ndim_out = ndim;
  return total;
}

// Stream the u8 payload into out (size from idx_header).  Returns 0 on
// success, -1 on short/corrupt files (incl. trailing-garbage payloads
// shorter than the header promises).
int32_t idx_payload(const char* path, unsigned char* out, int64_t n) {
  gzFile f = gzopen(path, "rb");
  if (!f) return -1;
  unsigned char magic[4];
  // Re-validate the header: the file may have changed since idx_header,
  // and 4*magic[3] must never exceed the dim buffer.
  if (read_exact(f, magic, 4) != 0 || magic[0] != 0 || magic[1] != 0 ||
      magic[2] != 0x08 || magic[3] < 1 || magic[3] > 3) {
    gzclose(f);
    return -1;
  }
  unsigned skip = 4u * magic[3];
  unsigned char dimbuf[12];
  if (read_exact(f, dimbuf, skip) != 0) { gzclose(f); return -1; }
  const int64_t CHUNK = 1 << 22;
  int64_t got = 0;
  while (got < n) {
    unsigned want = static_cast<unsigned>(std::min(CHUNK, n - got));
    if (read_exact(f, out + got, want) != 0) { gzclose(f); return -1; }
    got += want;
  }
  gzclose(f);
  return 0;
}

// ---------------------------------------------------------------------------
// prefetching batch assembler
// ---------------------------------------------------------------------------

struct Slot {
  std::vector<float> x;
  std::vector<int64_t> y;
  int64_t count = 0;  // samples staged in this slot
  bool full = false;
};

struct Batcher {
  const float* x;        // (n, row) prepared samples, borrowed from numpy
  const int64_t* y;      // (n,) labels, borrowed
  int64_t n = 0, row = 0, batch = 0, n_batches = 0;
  std::vector<int64_t> perm;  // owned copy of the caller's permutation
  std::vector<Slot> slots;
  size_t head = 0, tail = 0;  // producer / consumer slot cursors
  int64_t produced = 0, consumed = 0;
  std::mutex mu;
  std::condition_variable cv_prod, cv_cons;
  std::atomic<bool> stop{false};
  std::thread worker;

  void produce() {
    for (int64_t b = 0; b < n_batches && !stop.load(); ++b) {
      const int64_t start = b * batch;
      const int64_t count = std::min(batch, n - start);
      {
        std::unique_lock<std::mutex> lk(mu);
        cv_prod.wait(lk, [&] { return stop.load() || !slots[head].full; });
        if (stop.load()) return;
      }
      Slot& s = slots[head];
      for (int64_t i = 0; i < count; ++i) {
        const int64_t src = perm[start + i];
        std::memcpy(s.x.data() + i * row, x + src * row,
                    sizeof(float) * static_cast<size_t>(row));
        s.y[static_cast<size_t>(i)] = y[src];
      }
      s.count = count;
      {
        std::lock_guard<std::mutex> lk(mu);
        s.full = true;
        head = (head + 1) % slots.size();
        ++produced;
      }
      cv_cons.notify_one();
    }
  }
};

// x: (n, row) float32; y: (n,) int64; perm: (n,) int64 — all borrowed for
// the batcher's lifetime (the Python wrapper pins them).  drop_remainder
// mirrors iterate_batches; slots is the prefetch depth (>= 1).
void* batcher_create(const float* x, const int64_t* y, int64_t n,
                     int64_t row, const int64_t* perm, int64_t batch,
                     int32_t drop_remainder, int32_t n_slots) {
  if (n <= 0 || row <= 0 || batch <= 0 || n_slots < 1) return nullptr;
  auto* b = new Batcher();
  b->x = x;
  b->y = y;
  b->n = n;
  b->row = row;
  b->batch = batch;
  b->perm.assign(perm, perm + n);
  b->n_batches = drop_remainder ? n / batch : (n + batch - 1) / batch;
  b->slots.resize(static_cast<size_t>(n_slots));
  for (auto& s : b->slots) {
    s.x.resize(static_cast<size_t>(batch * row));
    s.y.resize(static_cast<size_t>(batch));
  }
  b->worker = std::thread([b] { b->produce(); });
  return b;
}

int64_t batcher_n_batches(void* h) {
  return static_cast<Batcher*>(h)->n_batches;
}

// Block until the next staged batch is ready, copy it into the caller's
// buffers (capacity >= batch samples), and return the sample count.
// Returns 0 when the epoch is exhausted, -1 on a stopped batcher.
int64_t batcher_next(void* h, float* x_out, int64_t* y_out) {
  auto* b = static_cast<Batcher*>(h);
  if (b->consumed >= b->n_batches) return 0;
  {
    std::unique_lock<std::mutex> lk(b->mu);
    b->cv_cons.wait(lk, [&] { return b->stop.load() || b->slots[b->tail].full; });
    if (b->stop.load()) return -1;
  }
  Slot& s = b->slots[b->tail];
  std::memcpy(x_out, s.x.data(),
              sizeof(float) * static_cast<size_t>(s.count * b->row));
  std::memcpy(y_out, s.y.data(),
              sizeof(int64_t) * static_cast<size_t>(s.count));
  const int64_t count = s.count;
  {
    std::lock_guard<std::mutex> lk(b->mu);
    s.full = false;
    b->tail = (b->tail + 1) % b->slots.size();
    ++b->consumed;
  }
  b->cv_prod.notify_one();
  return count;
}

void batcher_destroy(void* h) {
  auto* b = static_cast<Batcher*>(h);
  b->stop.store(true);
  b->cv_prod.notify_all();
  b->cv_cons.notify_all();
  if (b->worker.joinable()) b->worker.join();
  delete b;
}

int32_t dataio_abi_version() { return 1; }

}  // extern "C"
