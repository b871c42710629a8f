// Native host runtime of the PyTorch port (the same C API as the JAX
// package's runtime/cpp/qsc_runtime.cpp, of which this is a copy).
//
// Two components, exposed with a C ABI for ctypes:
//
// 1. Batching MPMC queue: producers push single map payloads (fixed-size
//    byte blobs); a consumer pops device-batch-sized groups, blocking with
//    timeout, at native speed off the GIL.
//
// 2. Shard loader: mmap-backed random-batch sampler over a binary shard
//    of float32 maps [N, item_elems] with a threaded prefetch ring, and
//    ordered reads of whole row ranges (multi-process per-rank feeding) —
//    the native replacement for the reference's file-per-index
//    torch.load dataset (deep_prior/slf_dataset.py).
//
// Built at first use by runtime/native.py:
//   g++ -O3 -march=native -std=c++17 -shared -fPIC -o libqsc_runtime_<hash>.so qsc_runtime.cpp -lpthread

#include <atomic>
#include <chrono>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <deque>
#include <mutex>
#include <random>
#include <thread>
#include <vector>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

extern "C" {

// ------------------------------------------------------------------ queue

struct QscQueue {
  size_t item_bytes;
  size_t capacity;
  std::deque<std::vector<uint8_t>> items;
  std::mutex mu;
  std::condition_variable cv_push, cv_pop;
  std::atomic<uint64_t> pushed{0}, popped{0};
  bool closed = false;
};

QscQueue* qsc_queue_create(size_t capacity, size_t item_bytes) {
  auto* q = new QscQueue();
  q->capacity = capacity;
  q->item_bytes = item_bytes;
  return q;
}

// returns 1 on success, 0 if closed
int qsc_queue_push(QscQueue* q, const uint8_t* data, int timeout_ms) {
  std::unique_lock<std::mutex> lk(q->mu);
  auto pred = [&] { return q->items.size() < q->capacity || q->closed; };
  if (timeout_ms < 0) {
    q->cv_push.wait(lk, pred);
  } else if (!q->cv_push.wait_for(lk, std::chrono::milliseconds(timeout_ms),
                                  pred)) {
    return 0;
  }
  if (q->closed) return 0;
  q->items.emplace_back(data, data + q->item_bytes);
  q->pushed.fetch_add(1);
  lk.unlock();
  q->cv_pop.notify_one();
  return 1;
}

// pops up to max_items into out (contiguous), waiting up to timeout_ms for
// the FIRST item, then draining whatever is immediately available.
// returns number of items copied.
int qsc_queue_pop_batch(QscQueue* q, uint8_t* out, int max_items,
                        int timeout_ms) {
  std::unique_lock<std::mutex> lk(q->mu);
  auto pred = [&] { return !q->items.empty() || q->closed; };
  if (timeout_ms < 0) {
    q->cv_pop.wait(lk, pred);
  } else if (!q->cv_pop.wait_for(lk, std::chrono::milliseconds(timeout_ms),
                                 pred)) {
    return 0;
  }
  int n = 0;
  while (n < max_items && !q->items.empty()) {
    std::memcpy(out + size_t(n) * q->item_bytes, q->items.front().data(),
                q->item_bytes);
    q->items.pop_front();
    ++n;
  }
  q->popped.fetch_add(n);
  lk.unlock();
  q->cv_push.notify_all();
  return n;
}

void qsc_queue_close(QscQueue* q) {
  {
    std::lock_guard<std::mutex> lk(q->mu);
    q->closed = true;
  }
  q->cv_push.notify_all();
  q->cv_pop.notify_all();
}

uint64_t qsc_queue_pushed(QscQueue* q) { return q->pushed.load(); }
uint64_t qsc_queue_popped(QscQueue* q) { return q->popped.load(); }

void qsc_queue_destroy(QscQueue* q) {
  qsc_queue_close(q);
  delete q;
}

// ----------------------------------------------------------------- loader

struct QscLoader {
  int fd = -1;
  const float* data = nullptr;   // mmapped [num_items, item_elems]
  size_t num_items = 0;
  size_t item_elems = 0;
  size_t batch = 0;
  size_t map_bytes = 0;

  // prefetch ring of ready batches
  std::deque<std::vector<float>> ready;
  std::mutex mu;
  std::condition_variable cv_ready, cv_space;
  size_t ring_capacity = 4;
  std::vector<std::thread> workers;
  std::atomic<bool> stop{false};
  std::atomic<uint64_t> batches_served{0};
};

static void loader_worker(QscLoader* L, uint64_t seed) {
  std::mt19937_64 rng(seed);
  std::uniform_int_distribution<size_t> pick(0, L->num_items - 1);
  while (!L->stop.load()) {
    std::vector<float> buf(L->batch * L->item_elems);
    for (size_t b = 0; b < L->batch; ++b) {
      const float* src = L->data + pick(rng) * L->item_elems;
      std::memcpy(buf.data() + b * L->item_elems, src,
                  L->item_elems * sizeof(float));
    }
    std::unique_lock<std::mutex> lk(L->mu);
    L->cv_space.wait(lk, [&] {
      return L->ready.size() < L->ring_capacity || L->stop.load();
    });
    if (L->stop.load()) return;
    L->ready.emplace_back(std::move(buf));
    lk.unlock();
    L->cv_ready.notify_one();
  }
}

QscLoader* qsc_loader_open(const char* path, size_t item_elems, size_t batch,
                           int num_threads, uint64_t seed) {
  int fd = open(path, O_RDONLY);
  if (fd < 0) return nullptr;
  struct stat st;
  if (fstat(fd, &st) != 0) { close(fd); return nullptr; }
  size_t bytes = size_t(st.st_size);
  size_t item_bytes = item_elems * sizeof(float);
  if (bytes == 0 || bytes % item_bytes != 0) { close(fd); return nullptr; }
  void* p = mmap(nullptr, bytes, PROT_READ, MAP_PRIVATE, fd, 0);
  if (p == MAP_FAILED) { close(fd); return nullptr; }
  madvise(p, bytes, MADV_WILLNEED);

  auto* L = new QscLoader();
  L->fd = fd;
  L->data = static_cast<const float*>(p);
  L->num_items = bytes / item_bytes;
  L->item_elems = item_elems;
  L->batch = batch;
  L->map_bytes = bytes;
  for (int t = 0; t < num_threads; ++t)
    L->workers.emplace_back(loader_worker, L, seed + 0x9e3779b97f4a7c15ULL * t);
  return L;
}

// copy one ready batch [batch, item_elems] into out; returns 1, or 0 on
// timeout.
int qsc_loader_next(QscLoader* L, float* out, int timeout_ms) {
  std::unique_lock<std::mutex> lk(L->mu);
  auto pred = [&] { return !L->ready.empty(); };
  if (timeout_ms < 0) {
    L->cv_ready.wait(lk, pred);
  } else if (!L->cv_ready.wait_for(lk, std::chrono::milliseconds(timeout_ms),
                                   pred)) {
    return 0;
  }
  std::vector<float> buf = std::move(L->ready.front());
  L->ready.pop_front();
  lk.unlock();
  L->cv_space.notify_one();
  std::memcpy(out, buf.data(), buf.size() * sizeof(float));
  L->batches_served.fetch_add(1);
  return 1;
}

// ordered mmap read of items [start, start+count) into out; returns the
// number of items copied (short at EOF).  Complements the sampling path:
// deterministic whole-shard reads (multi-host per-host feeding) must not
// depend on sampler state.
int qsc_loader_read(QscLoader* L, size_t start, size_t count, float* out) {
  if (start >= L->num_items) return 0;
  size_t n = count < L->num_items - start ? count : L->num_items - start;
  std::memcpy(out, L->data + start * L->item_elems,
              n * L->item_elems * sizeof(float));
  return int(n);
}

size_t qsc_loader_num_items(QscLoader* L) { return L->num_items; }
uint64_t qsc_loader_batches_served(QscLoader* L) {
  return L->batches_served.load();
}

void qsc_loader_close(QscLoader* L) {
  L->stop.store(true);
  L->cv_space.notify_all();
  L->cv_ready.notify_all();
  for (auto& t : L->workers) t.join();
  munmap(const_cast<float*>(L->data), L->map_bytes);
  close(L->fd);
  delete L;
}

}  // extern "C"
