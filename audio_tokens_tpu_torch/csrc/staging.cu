// The serving program's input copy on the host: a client's pageable rows
// through pinned slots to the card (``utils/staging.py``).  Host code only;
// nothing here runs on the card.
//
// A pool (``atk_stage_pool_new``) owns ``threads - 1`` worker threads and
// ``slots`` pinned host buffers, each with an event.  ``atk_stage`` runs a
// plan that the Python side makes (``staging.stage_plan``): entry e copies
// source rows [lo[e], hi[e]) into slot slot[e], then sends the slot to rows
// [lo[e], hi[e]) of the device tensor by cudaMemcpyAsync on ``stream`` and
// records the slot's event behind that copy.  Worker w runs the entries with
// worker[e] == w in plan order; the calling thread is worker 0.  Before it
// fills a slot a worker waits on the slot's event if the slot's last copy is
// still in flight, and counts the wait; a slot smaller than its entry is
// then reallocated (cudaHostAlloc: at first use, or when a batch brings
// larger chunks).  The plan gives each worker slots of its own, so a slot's
// event is always its owner's last record.  ``atk_stage`` returns once every
// entry has been filled and its copy issued: the source has been read by
// then; the copies may still run.

#include <cuda_runtime.h>

#if defined(__SSE2__)
#include <emmintrin.h>
#endif

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <mutex>
#include <thread>
#include <vector>

#define ATK_EXPORT extern "C" __attribute__((visibility("default")))

ATK_EXPORT const char* atk_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

namespace {

// n bytes from ``from`` to ``to``.  Where it can, by streaming stores: the
// slot's lines are written without first being read into the cache, which
// saves a third of the fill's memory traffic, shared with the copies that
// read the slots.  The caller fences before a copy reads the slot.
void fill(char* to, const char* from, int64_t n) {
#if defined(__SSE2__)
  int64_t i = (16 - reinterpret_cast<uintptr_t>(to) % 16) % 16;
  if (i > n) i = n;
  std::memcpy(to, from, i);
  for (; i + 64 <= n; i += 64) {
    const __m128i* src = reinterpret_cast<const __m128i*>(from + i);
    __m128i* dst = reinterpret_cast<__m128i*>(to + i);
    const __m128i a = _mm_loadu_si128(src), b = _mm_loadu_si128(src + 1);
    const __m128i c = _mm_loadu_si128(src + 2), d = _mm_loadu_si128(src + 3);
    _mm_stream_si128(dst, a);
    _mm_stream_si128(dst + 1, b);
    _mm_stream_si128(dst + 2, c);
    _mm_stream_si128(dst + 3, d);
  }
  std::memcpy(to + i, from + i, n - i);
#else
  std::memcpy(to, from, n);
#endif
}

void fence() {
#if defined(__SSE2__)
  _mm_sfence();  // the streaming stores land before the copy is issued
#endif
}

struct Plan {
  const char* src;
  int64_t src_stride;  // bytes from one source row to the next
  int64_t row_bytes;
  char* dst;
  const int64_t* lo;
  const int64_t* hi;
  const int32_t* slot;
  const int32_t* worker;
  int64_t n;
  cudaStream_t stream;
  int device;
  std::atomic<int64_t> waits{0};
  std::atomic<int> error{0};
};

struct Pool {
  int device = 0;
  std::vector<cudaEvent_t> events;
  std::vector<char*> slots;  // pinned
  std::vector<int64_t> slot_bytes;
  std::vector<std::thread> threads;
  std::mutex m;
  std::condition_variable wake, done;
  Plan* job = nullptr;
  int active = 0;     // workers of the current job, the caller included
  int pending = 0;    // pool threads of the current job still running
  uint64_t generation = 0;
  bool stop = false;
  std::mutex serial;  // one job at a time

  void run(Plan& p, int w) {
    cudaError_t e = cudaSetDevice(p.device);
    for (int64_t i = 0; i < p.n && e == cudaSuccess; ++i) {
      if (p.worker[i] != w) continue;
      if (p.error.load(std::memory_order_relaxed)) return;
      cudaEvent_t ev = events[p.slot[i]];
      e = cudaEventQuery(ev);
      if (e == cudaErrorNotReady) {
        p.waits.fetch_add(1, std::memory_order_relaxed);
        e = cudaEventSynchronize(ev);
      }
      if (e != cudaSuccess) break;
      const int k = p.slot[i];
      const int64_t rows = p.hi[i] - p.lo[i];
      if (slot_bytes[k] < rows * p.row_bytes) {
        if (slots[k]) cudaFreeHost(slots[k]);
        slots[k] = nullptr;
        slot_bytes[k] = 0;
        e = cudaHostAlloc(reinterpret_cast<void**>(&slots[k]),
                          rows * p.row_bytes, cudaHostAllocDefault);
        if (e != cudaSuccess) break;
        slot_bytes[k] = rows * p.row_bytes;
      }
      char* to = slots[k];
      const char* from = p.src + p.lo[i] * p.src_stride;
      if (p.src_stride == p.row_bytes) {
        fill(to, from, rows * p.row_bytes);
      } else {
        for (int64_t r = 0; r < rows; ++r)
          fill(to + r * p.row_bytes, from + r * p.src_stride, p.row_bytes);
      }
      fence();
      e = cudaMemcpyAsync(p.dst + p.lo[i] * p.row_bytes, to,
                          rows * p.row_bytes, cudaMemcpyHostToDevice,
                          p.stream);
      if (e == cudaSuccess) e = cudaEventRecord(ev, p.stream);
    }
    if (e != cudaSuccess) {
      int none = 0;
      p.error.compare_exchange_strong(none, static_cast<int>(e));
    }
  }

  void serve(int w) {  // pool thread w (1 ..)
    uint64_t seen = 0;
    for (;;) {
      Plan* p;
      {
        std::unique_lock<std::mutex> lock(m);
        wake.wait(lock, [&] { return stop || generation != seen; });
        if (stop) return;
        seen = generation;
        if (w >= active) continue;
        p = job;
      }
      run(*p, w);
      std::lock_guard<std::mutex> lock(m);
      if (--pending == 0) done.notify_one();
    }
  }
};

}  // namespace

// A pool of ``threads`` workers (the caller and threads - 1 threads) and
// ``slots`` slots on ``device`` (their buffers come with their first use);
// null if an event cannot be made.
ATK_EXPORT void* atk_stage_pool_new(int threads, int slots, int device) {
  auto* pool = new Pool();
  pool->device = device;
  if (cudaSetDevice(device) != cudaSuccess) {
    delete pool;
    return nullptr;
  }
  for (int k = 0; k < slots; ++k) {
    cudaEvent_t ev;
    if (cudaEventCreateWithFlags(&ev, cudaEventDisableTiming) != cudaSuccess) {
      for (cudaEvent_t made : pool->events) cudaEventDestroy(made);
      delete pool;
      return nullptr;
    }
    pool->events.push_back(ev);
  }
  pool->slots.assign(slots, nullptr);
  pool->slot_bytes.assign(slots, 0);
  for (int w = 1; w < threads; ++w)
    pool->threads.emplace_back([pool, w] { pool->serve(w); });
  return pool;
}

ATK_EXPORT void atk_stage_pool_free(void* handle) {
  auto* pool = static_cast<Pool*>(handle);
  {
    std::lock_guard<std::mutex> lock(pool->m);
    pool->stop = true;
  }
  pool->wake.notify_all();
  for (auto& t : pool->threads) t.join();
  cudaSetDevice(pool->device);
  for (size_t k = 0; k < pool->events.size(); ++k) {
    cudaEventSynchronize(pool->events[k]);  // no copy reads a freed slot
    cudaEventDestroy(pool->events[k]);
    if (pool->slots[k]) cudaFreeHost(pool->slots[k]);
  }
  delete pool;
}

// Run a plan of ``n`` entries (file comment); ``waits`` gets the fills that
// waited on a slot's copy in flight.  Returns a CUDA error code, 0 if every
// copy was issued.
ATK_EXPORT int atk_stage(void* handle, const void* src, int64_t src_stride,
                         int64_t row_bytes, void* dst, const int64_t* lo,
                         const int64_t* hi, const int32_t* slot,
                         const int32_t* worker,
                         int64_t n, void* stream, int64_t* waits) {
  auto* pool = static_cast<Pool*>(handle);
  std::lock_guard<std::mutex> serial(pool->serial);
  Plan p;
  p.src = static_cast<const char*>(src);
  p.src_stride = src_stride;
  p.row_bytes = row_bytes;
  p.dst = static_cast<char*>(dst);
  p.lo = lo;
  p.hi = hi;
  p.slot = slot;
  p.worker = worker;
  p.n = n;
  p.stream = static_cast<cudaStream_t>(stream);
  p.device = pool->device;
  int workers = 1;
  for (int64_t i = 0; i < n; ++i) {
    if (slot[i] < 0 || slot[i] >= static_cast<int>(pool->events.size()) ||
        worker[i] < 0 || worker[i] > static_cast<int>(pool->threads.size()))
      return static_cast<int>(cudaErrorInvalidValue);
    if (worker[i] + 1 > workers) workers = worker[i] + 1;
  }
  if (workers > 1) {
    std::lock_guard<std::mutex> lock(pool->m);
    pool->job = &p;
    pool->active = workers;
    pool->pending = workers - 1;
    ++pool->generation;
  }
  if (workers > 1) pool->wake.notify_all();
  pool->run(p, 0);
  if (workers > 1) {
    std::unique_lock<std::mutex> lock(pool->m);
    pool->done.wait(lock, [&] { return pool->pending == 0; });
    pool->job = nullptr;
  }
  *waits = p.waits.load();
  return p.error.load();
}
