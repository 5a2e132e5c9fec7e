// Threaded batch prefetcher for the host-streaming data path (--stream),
// the port's copy of the JAX package's native/prefetch.cpp.
//
// The train driver keeps datasets resident on the device by default,
// but a dataset larger than device memory streams from host memory or
// disk (memmapped .npy artifacts).  This assembles shuffled batches
// ahead of the consumer with worker threads that run while Python waits
// on the device (no GIL): each worker gathers permuted rows into a slot
// of a fixed ring of reusable buffers; the consumer acquires batches
// strictly in order, so results are byte-identical to the sequential
// numpy path (cs231_capsule_yolo_traffic_sign_detection_tpu_torch/
// data/stream.py binds it with ctypes).
//
// X rows are emitted as float32.  x_is_u8 selects a fused
// uint8 -> centered-float32 conversion ((v - 128) / 128, the loader's
// center_rgb) so raw-pixel stores stream at 1/4 the f32 footprint.
// Y rows are copied as opaque bytes (labels keep their native dtype).

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <mutex>
#include <thread>
#include <vector>

namespace {

struct Slot {
  std::vector<float> x;
  std::vector<uint8_t> y;
  int64_t rows = 0;
  int64_t batch_idx = -1;
  bool ready = false;
};

struct Prefetcher {
  const uint8_t* X = nullptr;
  const uint8_t* Y = nullptr;
  int x_is_u8 = 0;
  int64_t x_row_elems = 0;   // floats per X row
  int64_t y_row_bytes = 0;
  std::vector<int64_t> perm;      // row indices, concatenated batches
  std::vector<int64_t> offsets;   // n_batches + 1 boundaries into perm
  int64_t n_batches = 0;
  int ring = 0;

  std::vector<Slot> slots;
  std::atomic<int64_t> next_fill{0};
  int64_t next_consume = 0;
  bool stop = false;
  std::mutex mu;
  std::condition_variable cv;
  std::vector<std::thread> workers;
};

void fill_batch(Prefetcher* p, Slot* s, int64_t b) {
  const int64_t lo = p->offsets[b], hi = p->offsets[b + 1];
  const int64_t rows = hi - lo;
  for (int64_t r = 0; r < rows; ++r) {
    const int64_t src = p->perm[lo + r];
    float* dst = s->x.data() + r * p->x_row_elems;
    if (p->x_is_u8) {
      const uint8_t* srow = p->X + src * p->x_row_elems;
      for (int64_t e = 0; e < p->x_row_elems; ++e)
        dst[e] = (static_cast<float>(srow[e]) - 128.0f) / 128.0f;
    } else {
      std::memcpy(dst, p->X + src * p->x_row_elems * sizeof(float),
                  p->x_row_elems * sizeof(float));
    }
    std::memcpy(s->y.data() + r * p->y_row_bytes,
                p->Y + src * p->y_row_bytes, p->y_row_bytes);
  }
  s->rows = rows;
}

void worker(Prefetcher* p) {
  for (;;) {
    const int64_t b = p->next_fill.fetch_add(1);
    if (b >= p->n_batches) return;
    Slot* s = &p->slots[b % p->ring];
    {
      // the slot is free once its previous occupant (b - ring) has been
      // consumed; batches are assigned to slots round-robin
      std::unique_lock<std::mutex> lk(p->mu);
      p->cv.wait(lk, [&] {
        return p->stop || (!s->ready && p->next_consume + p->ring > b);
      });
      if (p->stop) return;
    }
    fill_batch(p, s, b);
    {
      std::lock_guard<std::mutex> lk(p->mu);
      s->batch_idx = b;
      s->ready = true;
    }
    p->cv.notify_all();
  }
}

}  // namespace

extern "C" {

void* pf_create(const void* X, const void* Y, int x_is_u8,
                int64_t x_row_elems, int64_t y_row_bytes,
                const int64_t* perm, const int64_t* offsets,
                int64_t n_batches, int ring, int n_threads) {
  auto* p = new Prefetcher();
  p->X = static_cast<const uint8_t*>(X);
  p->Y = static_cast<const uint8_t*>(Y);
  p->x_is_u8 = x_is_u8;
  p->x_row_elems = x_row_elems;
  p->y_row_bytes = y_row_bytes;
  p->offsets.assign(offsets, offsets + n_batches + 1);
  p->perm.assign(perm, perm + offsets[n_batches]);
  p->n_batches = n_batches;
  p->ring = ring < 1 ? 1 : ring;

  int64_t max_rows = 0;
  for (int64_t b = 0; b < n_batches; ++b) {
    const int64_t rows = offsets[b + 1] - offsets[b];
    if (rows > max_rows) max_rows = rows;
  }
  p->slots.resize(p->ring);
  for (auto& s : p->slots) {
    s.x.resize(static_cast<size_t>(max_rows) * x_row_elems);
    s.y.resize(static_cast<size_t>(max_rows) * y_row_bytes);
  }
  if (n_threads < 1) n_threads = 1;
  for (int t = 0; t < n_threads; ++t)
    p->workers.emplace_back(worker, p);
  return p;
}

// Blocks until the next in-order batch is ready; returns its row count
// (possibly 0 — np.array_split emits empty splits when n_batches > n)
// and pointers into the slot buffers (valid until pf_release).  Returns
// -1 after the last batch.
int64_t pf_acquire(void* h, float** x_out, void** y_out) {
  auto* p = static_cast<Prefetcher*>(h);
  if (p->next_consume >= p->n_batches) return -1;
  Slot* s = &p->slots[p->next_consume % p->ring];
  std::unique_lock<std::mutex> lk(p->mu);
  p->cv.wait(lk, [&] {
    return s->ready && s->batch_idx == p->next_consume;
  });
  *x_out = s->x.data();
  *y_out = s->y.data();
  return s->rows;
}

void pf_release(void* h) {
  auto* p = static_cast<Prefetcher*>(h);
  {
    std::lock_guard<std::mutex> lk(p->mu);
    p->slots[p->next_consume % p->ring].ready = false;
    ++p->next_consume;
  }
  p->cv.notify_all();
}

void pf_destroy(void* h) {
  auto* p = static_cast<Prefetcher*>(h);
  {
    std::lock_guard<std::mutex> lk(p->mu);
    p->stop = true;
  }
  p->cv.notify_all();
  for (auto& t : p->workers) t.join();
  delete p;
}

}  // extern "C"
