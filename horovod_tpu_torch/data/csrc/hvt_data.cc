// hvt_data — native batch-assembly engine for the input pipeline.
//
// The runtime-layer slot the reference fills with Horovod's C++ core
// (SURVEY.md §2.3): where Horovod's native code coordinates collectives
// (obsolete under SPMD/XLA — the compiler owns that), the host-side cost
// that remains in this framework is batch assembly: per-epoch permutation,
// row gather, and staging, all GIL-bound in pure Python. This library runs
// them in a producer thread writing into a bounded ring of pre-allocated
// slots, overlapping batch assembly with the accelerator step.
//
// Exposed as a tiny C ABI consumed via ctypes (no pybind11 in this image):
//   hvt_loader_create(arr_ptrs, row_bytes, n_arrays, n_examples,
//                     batch, n_slots, seed, shuffle,
//                     start_epoch, batches_per_epoch)  -> handle
//   hvt_loader_next(handle)             -> slot id (blocks until filled)
//   hvt_loader_slot_ptr(handle, slot, array_idx) -> buffer pointer
//   hvt_loader_release(handle, slot)    -> recycle a consumed slot
//   hvt_loader_destroy(handle)
//
// Semantics match the Python ArrayDataset training path: a fresh full
// permutation per epoch (the reference's shuffle(10000)-over-60k behaves
// as one, tensorflow2_keras_mnist.py:40), repeating forever; batches never
// straddle an epoch boundary remainder (drop_remainder=True).
//
// Epoch anchoring (the durable-stream-cursor contract, data/stream.py):
// each pass's permutation is a PURE function of (seed, epoch, pass) — the
// RNG is reseeded via splitmix64 mixing and the permutation reset to
// identity at every pass start — so any position in the infinite stream
// is reconstructible without replaying the stream before it:
//   * start_epoch anchors the stream's first epoch to an absolute number;
//   * batches_per_epoch > 0 cuts epochs at exactly that many batches
//     (passes roll within an epoch when it is longer than one permutation;
//     the unconsumed tail of a pass is discarded at the epoch boundary);
//     0 keeps the historical pass-per-epoch semantics, now anchored.

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <mutex>
#include <thread>
#include <vector>

namespace {

// splitmix64 — the seed-mixing primitive (also used inside XorShift128Plus
// seeding); chains (seed, epoch, pass) into one well-distributed word so
// every pass draws an independent, ADDRESSABLE permutation.
inline uint64_t splitmix64(uint64_t x) {
  x += 0x9E3779B97F4A7C15ULL;
  uint64_t z = x;
  z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9ULL;
  z = (z ^ (z >> 27)) * 0x94D049BB133111EBULL;
  return z ^ (z >> 31);
}

inline uint64_t mix_seed(uint64_t seed, int64_t epoch, int64_t pass) {
  uint64_t s = splitmix64(seed);
  s = splitmix64(s ^ (static_cast<uint64_t>(epoch) + 0xA5A5A5A5A5A5A5A5ULL));
  s = splitmix64(s ^ (static_cast<uint64_t>(pass) + 0x5A5A5A5A5A5A5A5AULL));
  return s;
}

// xorshift128+ — deterministic, seedable, fast; quality is ample for
// shuffling (this is not a cryptographic context).
struct XorShift128Plus {
  uint64_t s0, s1;
  explicit XorShift128Plus(uint64_t seed) {
    // splitmix64 expansion of the seed into two non-zero words.
    auto next = [&seed]() {
      seed += 0x9E3779B97F4A7C15ULL;
      uint64_t z = seed;
      z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9ULL;
      z = (z ^ (z >> 27)) * 0x94D049BB133111EBULL;
      return z ^ (z >> 31);
    };
    s0 = next();
    s1 = next();
    if (s0 == 0 && s1 == 0) s0 = 1;
  }
  uint64_t operator()() {
    uint64_t x = s0;
    const uint64_t y = s1;
    s0 = y;
    x ^= x << 23;
    s1 = x ^ y ^ (x >> 17) ^ (y >> 26);
    return s1 + y;
  }
  // Unbiased bounded sample via rejection.
  uint64_t bounded(uint64_t n) {
    const uint64_t limit = UINT64_MAX - UINT64_MAX % n;
    uint64_t v;
    do {
      v = (*this)();
    } while (v >= limit);
    return v % n;
  }
};

struct Loader {
  std::vector<const uint8_t*> arrays;   // source base pointers (borrowed)
  std::vector<int64_t> row_bytes;       // bytes per example, per array
  int64_t n_examples = 0;
  int64_t batch = 0;
  int n_slots = 0;
  bool shuffle = true;
  int64_t start_epoch = 0;        // absolute epoch the stream starts at
  int64_t batches_per_epoch = 0;  // 0 = one permutation pass per epoch

  // slot_buffers[slot][array] — owned staging buffers.
  std::vector<std::vector<std::vector<uint8_t>>> slots;
  std::vector<int> ready;   // filled slot ids, FIFO
  std::vector<char> free_;  // free_[slot] == 1 → producer may fill it
  std::mutex mu;
  std::condition_variable cv_ready, cv_free, cv_quiesce;
  std::atomic<bool> stop{false};
  int consumers_in_next = 0;  // guarded by mu; destroy waits for 0
  std::thread producer;
  uint64_t seed;

  explicit Loader(uint64_t seed_) : seed(seed_) {}

  void fill(int slot, const std::vector<int64_t>& perm, int64_t offset) {
    for (size_t a = 0; a < arrays.size(); ++a) {
      const int64_t rb = row_bytes[a];
      uint8_t* dst = slots[slot][a].data();
      const uint8_t* src = arrays[a];
      for (int64_t i = 0; i < batch; ++i) {
        std::memcpy(dst + i * rb, src + perm[offset + i] * rb, rb);
      }
    }
  }

  // Reset the permutation to identity and Fisher-Yates it with the rng
  // derived purely from (seed, epoch, pass): the anchoring invariant.
  void reshuffle(std::vector<int64_t>* perm, int64_t epoch, int64_t pass) {
    for (int64_t i = 0; i < n_examples; ++i) (*perm)[i] = i;
    if (!shuffle) return;
    XorShift128Plus rng(mix_seed(seed, epoch, pass));
    for (int64_t i = n_examples - 1; i > 0; --i) {
      const int64_t j = static_cast<int64_t>(rng.bounded(i + 1));
      std::swap((*perm)[i], (*perm)[j]);
    }
  }

  void run() {
    std::vector<int64_t> perm(n_examples);
    int64_t epoch = start_epoch;
    int64_t pass = 0;
    int64_t emitted = 0;          // batches emitted within the epoch
    int64_t cursor = n_examples;  // force a reshuffle on first use
    const int64_t usable = n_examples - n_examples % batch;
    while (!stop.load(std::memory_order_relaxed)) {
      if (batches_per_epoch > 0 && emitted >= batches_per_epoch) {
        // Epoch boundary by batch count: discard the pass tail, advance.
        ++epoch;
        pass = 0;
        emitted = 0;
        cursor = n_examples;  // force the new epoch's first shuffle
      }
      if (cursor >= usable) {
        if (cursor != static_cast<int64_t>(n_examples) ||
            emitted > 0 || pass > 0) {
          // A pass genuinely ran dry (not the initial sentinel): with
          // batch-cut epochs the next pass stays inside this epoch;
          // with pass-per-epoch semantics the pass boundary IS the
          // epoch boundary.
          if (batches_per_epoch > 0) {
            ++pass;
          } else {
            ++epoch;
          }
        }
        reshuffle(&perm, epoch, pass);
        cursor = 0;
      }
      int slot = -1;
      {
        std::unique_lock<std::mutex> lk(mu);
        cv_free.wait(lk, [&] {
          if (stop.load(std::memory_order_relaxed)) return true;
          for (int s = 0; s < n_slots; ++s)
            if (free_[s]) return true;
          return false;
        });
        if (stop.load(std::memory_order_relaxed)) return;
        for (int s = 0; s < n_slots; ++s)
          if (free_[s]) { slot = s; break; }
        free_[slot] = 0;
      }
      fill(slot, perm, cursor);
      cursor += batch;
      ++emitted;
      {
        std::lock_guard<std::mutex> lk(mu);
        ready.push_back(slot);
      }
      cv_ready.notify_one();
    }
  }
};

}  // namespace

extern "C" {

// ABI handshake: bumped whenever hvt_loader_create's signature or the
// stream semantics change. The Python binding refuses to use a library
// reporting a different version (or lacking the symbol — a pre-handshake
// build): calling a stale 8-arg library with 10 args would silently
// ignore the anchoring arguments and produce a DIFFERENT byte stream
// than the cursors describe.
//   v2: (seed, epoch, pass)-anchored permutations; start_epoch /
//       batches_per_epoch create arguments.
int hvt_loader_abi_version() { return 2; }

void* hvt_loader_create(const uint8_t** arr_ptrs, const int64_t* row_bytes,
                        int n_arrays, int64_t n_examples, int64_t batch,
                        int n_slots, uint64_t seed, int shuffle,
                        int64_t start_epoch, int64_t batches_per_epoch) {
  if (n_arrays <= 0 || n_examples < batch || batch <= 0 || n_slots < 2 ||
      start_epoch < 0 || batches_per_epoch < 0)
    return nullptr;
  auto* L = new Loader(seed);
  L->arrays.assign(arr_ptrs, arr_ptrs + n_arrays);
  L->row_bytes.assign(row_bytes, row_bytes + n_arrays);
  L->n_examples = n_examples;
  L->batch = batch;
  L->n_slots = n_slots;
  L->shuffle = shuffle != 0;
  L->start_epoch = start_epoch;
  L->batches_per_epoch = batches_per_epoch;
  L->slots.resize(n_slots);
  for (int s = 0; s < n_slots; ++s) {
    L->slots[s].resize(n_arrays);
    for (int a = 0; a < n_arrays; ++a)
      L->slots[s][a].resize(static_cast<size_t>(batch) * row_bytes[a]);
  }
  L->free_.assign(n_slots, 1);
  L->producer = std::thread([L] { L->run(); });
  return L;
}

// Blocks until a slot is filled; returns its id (>= 0), or -1 after destroy.
int hvt_loader_next(void* handle) {
  auto* L = static_cast<Loader*>(handle);
  std::unique_lock<std::mutex> lk(L->mu);
  ++L->consumers_in_next;
  L->cv_ready.wait(lk, [&] {
    return L->stop.load(std::memory_order_relaxed) || !L->ready.empty();
  });
  int slot = -1;
  // Stop wins even if batches are queued: a destroy() in flight is about to
  // free the slot buffers this id would point into.
  if (!L->stop.load(std::memory_order_relaxed) && !L->ready.empty()) {
    slot = L->ready.front();
    L->ready.erase(L->ready.begin());
  }
  --L->consumers_in_next;
  if (L->consumers_in_next == 0 && L->stop.load(std::memory_order_relaxed)) {
    // Notify UNDER the mutex: destroy() cannot re-acquire it (and delete
    // this object) until we return and release — no use-after-free window.
    L->cv_quiesce.notify_all();
  }
  return slot;
}

const uint8_t* hvt_loader_slot_ptr(void* handle, int slot, int array_idx) {
  auto* L = static_cast<Loader*>(handle);
  return L->slots[slot][array_idx].data();
}

void hvt_loader_release(void* handle, int slot) {
  auto* L = static_cast<Loader*>(handle);
  {
    std::lock_guard<std::mutex> lk(L->mu);
    L->free_[slot] = 1;
  }
  L->cv_free.notify_one();
}

void hvt_loader_destroy(void* handle) {
  auto* L = static_cast<Loader*>(handle);
  {
    // stop must flip under the mutex: a waiter that has checked its
    // predicate but not yet blocked would otherwise miss the notify and
    // sleep forever.
    std::lock_guard<std::mutex> lk(L->mu);
    L->stop.store(true);
  }
  L->cv_free.notify_all();
  L->cv_ready.notify_all();
  if (L->producer.joinable()) L->producer.join();
  {
    // Wait for any consumer blocked in next() to drain before freeing.
    std::unique_lock<std::mutex> lk(L->mu);
    L->cv_quiesce.wait(lk, [&] { return L->consumers_in_next == 0; });
  }
  delete L;
}

}  // extern "C"
