// A host-only stand-in for the CUDA runtime calls of csrc/staging.cu, for
// its CPU tests (tests/test_torch_serving.py builds the file against this
// header with g++).  A copy stays in flight until an event recorded after
// it is waited on, or stub_flush() runs: only then are its bytes read from
// the slot and written, so a slot refilled before its copy's event has
// completed lands the later bytes.
#pragma once

#include <cstddef>
#include <cstdlib>
#include <cstring>
#include <mutex>
#include <vector>

enum cudaError_t {
  cudaSuccess = 0,
  cudaErrorInvalidValue = 1,
  cudaErrorMemoryAllocation = 2,
  cudaErrorNotReady = 600,
};
enum cudaMemcpyKind { cudaMemcpyHostToDevice = 1 };
typedef struct StubStream* cudaStream_t;
struct StubEvent {
  size_t mark = 0;  // the copies issued before its last record
};
typedef StubEvent* cudaEvent_t;
#define cudaEventDisableTiming 2u
#define cudaHostAllocDefault 0u

namespace stub {
struct Copy {
  void* dst;
  const void* src;
  size_t n;
};
inline std::mutex mu;
inline std::vector<Copy> issued;
inline size_t landed = 0;

inline void land(size_t upto) {  // mu held
  for (; landed < upto; ++landed)
    std::memcpy(issued[landed].dst, issued[landed].src, issued[landed].n);
}
}  // namespace stub

inline const char* cudaGetErrorString(cudaError_t) { return "stub error"; }
inline cudaError_t cudaSetDevice(int) { return cudaSuccess; }
inline cudaError_t cudaEventCreateWithFlags(cudaEvent_t* e, unsigned) {
  *e = new StubEvent();
  return cudaSuccess;
}
inline cudaError_t cudaEventDestroy(cudaEvent_t e) {
  delete e;
  return cudaSuccess;
}
inline cudaError_t cudaEventRecord(cudaEvent_t e, cudaStream_t) {
  std::lock_guard<std::mutex> lock(stub::mu);
  e->mark = stub::issued.size();
  return cudaSuccess;
}
inline cudaError_t cudaEventQuery(cudaEvent_t e) {
  std::lock_guard<std::mutex> lock(stub::mu);
  return stub::landed >= e->mark ? cudaSuccess : cudaErrorNotReady;
}
inline cudaError_t cudaEventSynchronize(cudaEvent_t e) {
  std::lock_guard<std::mutex> lock(stub::mu);
  stub::land(e->mark);
  return cudaSuccess;
}
inline cudaError_t cudaMemcpyAsync(void* dst, const void* src, size_t n,
                                   cudaMemcpyKind, cudaStream_t) {
  std::lock_guard<std::mutex> lock(stub::mu);
  stub::issued.push_back({dst, src, n});
  return cudaSuccess;
}
inline cudaError_t cudaHostAlloc(void** p, size_t n, unsigned) {
  *p = std::malloc(n);
  return *p ? cudaSuccess : cudaErrorMemoryAllocation;
}
inline cudaError_t cudaFreeHost(void* p) {
  std::free(p);
  return cudaSuccess;
}

// the card finishing every copy issued so far
extern "C" __attribute__((visibility("default"))) void stub_flush() {
  std::lock_guard<std::mutex> lock(stub::mu);
  stub::land(stub::issued.size());
}
