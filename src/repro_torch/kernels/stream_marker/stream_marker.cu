// Region marks in CUDA stream order: a host function queued on a stream
// (cudaLaunchHostFunc) stores a region id into a slot when the stream
// reaches it, so a sampler that reads the slot sees the region whose
// device work is running, not the one the host is queueing.
//
// No kernel runs here and no Python is called back: the host function is
// plain C on CUDA's callback thread, so it takes no interpreter lock and
// cannot deadlock against a thread that waits on the stream while holding
// one. A slot is reference counted: its owner holds one reference and
// every queued store one more, so a store that fires after the owner let
// go still writes into live memory.

#include <cuda_runtime.h>

#include <atomic>
#include <new>

namespace {

struct Slot {
  std::atomic<int> value{0};
  std::atomic<int> refs{1};
};

struct Store {
  Slot* slot;
  int value;
};

void release(Slot* s) {
  if (s->refs.fetch_sub(1, std::memory_order_acq_rel) == 1) delete s;
}

void CUDART_CB store(void* arg) {
  Store* st = static_cast<Store*>(arg);
  st->slot->value.store(st->value, std::memory_order_release);
  release(st->slot);
  delete st;
}

}  // namespace

extern "C" {

// A new slot holding 0, with one reference (the caller's); NULL when out
// of memory.
void* sm_slot_new(void) { return new (std::nothrow) Slot; }

// Drop the caller's reference; stores still queued keep the slot alive.
void sm_slot_release(void* slot) { release(static_cast<Slot*>(slot)); }

// The slot's value as of now, and an immediate store (host order).
int sm_slot_get(void* slot) {
  return static_cast<Slot*>(slot)->value.load(std::memory_order_acquire);
}

void sm_slot_set(void* slot, int value) {
  static_cast<Slot*>(slot)->value.store(value, std::memory_order_release);
}

// Queue "store value into slot" on stream (device's); returns a
// cudaError_t, 0 on success. The store runs once all work queued on the
// stream before it has finished, and before any work queued after it.
int sm_mark(void* slot, int value, void* stream, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  Slot* s = static_cast<Slot*>(slot);
  Store* st = new (std::nothrow) Store{s, value};
  if (st == nullptr) return static_cast<int>(cudaErrorMemoryAllocation);
  s->refs.fetch_add(1, std::memory_order_acq_rel);
  err = cudaLaunchHostFunc(static_cast<cudaStream_t>(stream), store, st);
  if (err != cudaSuccess) {
    release(s);
    delete st;
  }
  return static_cast<int>(err);
}

const char* sm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
