// Native prefetching data loader: multi-threaded row-gather batch assembly
// into a bounded slot pool, consumed in deterministic step order.
//
// The port's copy of the JAX package's ``data/native/dataloader.cc``, with
// the same C ABI and the same splitmix64 epoch permutation, so a seed, batch
// size, remainder setting and epoch count give the same batch order in both
// packages. Python (``data/loader.py``) hands over raw source buffers
// (feature arrays or memory-mapped shards, row-major); worker threads
// assemble shuffled batches with memcpy, without the GIL, while the trainer
// consumes batch N and batches N+1..N+capacity are being gathered.
//
// Concurrency design:
//   free_q  : slot indices ready to be filled (bounded => backpressure)
//   done    : completed slots keyed by step, emitted strictly in step order
//             so training is deterministic regardless of thread scheduling.
//   Epoch permutations are derived from splitmix64(seed, epoch) so any
//   worker can regenerate epoch e's permutation independently.
//
// C ABI only (ctypes-friendly): create/set_source/start/next/release/destroy.
// Built with the host C++ compiler by ``ops/_build.py`` (``g++ -O2
// -std=c++17 -shared -fPIC -pthread``).

#include <algorithm>
#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <deque>
#include <map>
#include <mutex>
#include <thread>
#include <vector>

namespace {

// splitmix64: tiny, seedable, statistically solid for shuffling.
static inline uint64_t splitmix64(uint64_t& x) {
  x += 0x9e3779b97f4a7c15ULL;
  uint64_t z = x;
  z = (z ^ (z >> 30)) * 0xbf58476d1ce4e5b9ULL;
  z = (z ^ (z >> 27)) * 0x94d049bb133111ebULL;
  return z ^ (z >> 31);
}

// A feature's storage: one or more row-major shards (mmap'd dataset files or
// in-memory arrays — the gather path is agnostic). Global row r resolves to
// (shard, local row) through the prefix-sum offset table; the single-shard
// case short-circuits to plain pointer arithmetic.
struct Source {
  std::vector<const uint8_t*> bases;
  std::vector<uint64_t> offsets;  // offsets[k] = first global row of shard k
  uint64_t total_rows = 0;
  uint64_t row_bytes = 0;

  inline const uint8_t* row(uint64_t r) const {
    if (bases.size() == 1) return bases[0] + r * row_bytes;
    size_t k = static_cast<size_t>(
        std::upper_bound(offsets.begin(), offsets.end(), r) -
        offsets.begin() - 1);
    return bases[k] + (r - offsets[k]) * row_bytes;
  }
};

struct Slot {
  std::vector<std::vector<uint8_t>> bufs;  // one per source, batch*row_bytes
  int64_t step = -1;
};

class Loader {
 public:
  Loader(int n_sources, uint64_t n_rows, uint64_t batch, int capacity,
         int n_threads, int shuffle, uint64_t seed, int drop_remainder,
         int64_t num_epochs)
      : sources_(n_sources),
        n_rows_(n_rows),
        batch_(batch),
        capacity_(capacity < 1 ? 1 : capacity),
        n_threads_(n_threads < 1 ? 1 : n_threads),
        shuffle_(shuffle != 0),
        seed_(seed),
        drop_remainder_(drop_remainder != 0),
        num_epochs_(num_epochs) {
    full_batches_ = n_rows_ / batch_;
    batches_per_epoch_ =
        drop_remainder_ ? full_batches_
                        : (n_rows_ + batch_ - 1) / batch_;
    if (batches_per_epoch_ == 0) batches_per_epoch_ = 0;
  }

  ~Loader() { Stop(); }

  void SetSource(int i, const uint8_t* data, uint64_t row_bytes) {
    const uint8_t* bases[1] = {data};
    uint64_t rows[1] = {n_rows_};
    SetSourceShards(i, bases, rows, 1, row_bytes);
  }

  bool SetSourceShards(int i, const uint8_t** bases, const uint64_t* rows,
                       int n_shards, uint64_t row_bytes) {
    if (n_shards <= 0) return false;
    Source& src = sources_[i];
    src.bases.assign(bases, bases + n_shards);
    src.offsets.resize(n_shards);
    src.total_rows = 0;
    for (int k = 0; k < n_shards; ++k) {
      src.offsets[k] = src.total_rows;
      src.total_rows += rows[k];
    }
    src.row_bytes = row_bytes;
    return src.total_rows == n_rows_;
  }

  bool Start() {
    if (started_ || batches_per_epoch_ == 0) return batches_per_epoch_ != 0;
    for (const Source& s : sources_)
      if (s.total_rows != n_rows_ || s.bases.empty()) return false;
    slots_.resize(capacity_);
    for (int s = 0; s < capacity_; ++s) {
      slots_[s].bufs.resize(sources_.size());
      for (size_t i = 0; i < sources_.size(); ++i)
        slots_[s].bufs[i].resize(batch_ * sources_[i].row_bytes);
      free_q_.push_back(s);
    }
    started_ = true;
    for (int t = 0; t < n_threads_; ++t)
      threads_.emplace_back([this] { WorkerLoop(); });
    return true;
  }

  // Returns slot index >= 0, -1 on end-of-data, -2 on not-started.
  // out_ptrs receives one pointer per source; out_rows the batch's row count.
  int64_t Next(uint8_t** out_ptrs, uint64_t* out_rows) {
    if (!started_) return -2;
    std::unique_lock<std::mutex> lk(mu_);
    cv_full_.wait(lk, [this] {
      return Finished(emit_step_) ||
             (!done_.empty() && done_.begin()->first == emit_step_);
    });
    if (Finished(emit_step_) &&
        (done_.empty() || done_.begin()->first != emit_step_))
      return -1;
    int slot = done_.begin()->second;
    done_.erase(done_.begin());
    int64_t step = emit_step_++;
    for (size_t i = 0; i < sources_.size(); ++i)
      out_ptrs[i] = slots_[slot].bufs[i].data();
    *out_rows = RowsInBatch(step);
    return slot;
  }

  void Release(int slot) {
    {
      std::lock_guard<std::mutex> lk(mu_);
      free_q_.push_back(slot);
    }
    cv_free_.notify_one();
  }

  void Stop() {
    {
      std::lock_guard<std::mutex> lk(mu_);
      stop_ = true;
    }
    cv_free_.notify_all();
    cv_full_.notify_all();
    for (auto& t : threads_)
      if (t.joinable()) t.join();
    threads_.clear();
  }

  int64_t batches_per_epoch() const { return batches_per_epoch_; }

 private:
  bool Finished(int64_t step) const {
    return num_epochs_ >= 0 && step >= num_epochs_ * batches_per_epoch_;
  }

  uint64_t RowsInBatch(int64_t step) const {
    int64_t in_epoch = step % batches_per_epoch_;
    if (drop_remainder_ || in_epoch < full_batches_ || n_rows_ % batch_ == 0)
      return batch_;
    return n_rows_ % batch_;
  }

  // Row index for position `pos` of epoch `epoch` under this seed.
  // Fisher-Yates would need the whole permutation per lookup; instead each
  // worker materializes the epoch permutation once and caches it (epochs
  // advance monotonically, so a two-entry cache suffices).
  struct PermCache {
    int64_t epoch = -1;
    std::vector<uint64_t> perm;
  };

  const std::vector<uint64_t>& EpochPerm(int64_t epoch, PermCache& cache) {
    if (cache.epoch == epoch) return cache.perm;
    cache.perm.resize(n_rows_);
    for (uint64_t i = 0; i < n_rows_; ++i) cache.perm[i] = i;
    if (shuffle_) {
      uint64_t s = seed_ ^ (0x5851f42d4c957f2dULL * (uint64_t)(epoch + 1));
      for (uint64_t i = n_rows_ - 1; i > 0; --i) {
        uint64_t j = splitmix64(s) % (i + 1);
        std::swap(cache.perm[i], cache.perm[j]);
      }
    }
    cache.epoch = epoch;
    return cache.perm;
  }

  void WorkerLoop() {
    PermCache cache;
    for (;;) {
      int slot;
      int64_t step;
      {
        std::unique_lock<std::mutex> lk(mu_);
        cv_free_.wait(lk, [this] {
          return stop_ || (!free_q_.empty() && !Finished(fill_step_));
        });
        if (stop_ || Finished(fill_step_)) {
          // Wake peers so they can observe completion too.
          cv_free_.notify_all();
          cv_full_.notify_all();
          return;
        }
        slot = free_q_.front();
        free_q_.pop_front();
        step = fill_step_++;
      }
      Fill(slot, step, cache);
      {
        std::lock_guard<std::mutex> lk(mu_);
        slots_[slot].step = step;
        done_.emplace(step, slot);
      }
      cv_full_.notify_all();
    }
  }

  void Fill(int slot, int64_t step, PermCache& cache) {
    int64_t epoch = step / batches_per_epoch_;
    int64_t in_epoch = step % batches_per_epoch_;
    const auto& perm = EpochPerm(epoch, cache);
    uint64_t start = (uint64_t)in_epoch * batch_;
    uint64_t rows = RowsInBatch(step);
    for (size_t i = 0; i < sources_.size(); ++i) {
      const Source& src = sources_[i];
      uint8_t* dst = slots_[slot].bufs[i].data();
      for (uint64_t r = 0; r < rows; ++r)
        std::memcpy(dst + r * src.row_bytes, src.row(perm[start + r]),
                    src.row_bytes);
    }
  }

  std::vector<Source> sources_;
  const uint64_t n_rows_, batch_;
  const int capacity_, n_threads_;
  const bool shuffle_;
  const uint64_t seed_;
  const bool drop_remainder_;
  const int64_t num_epochs_;  // -1 => repeat forever
  uint64_t full_batches_ = 0;
  int64_t batches_per_epoch_ = 0;

  std::vector<Slot> slots_;
  std::vector<std::thread> threads_;
  std::mutex mu_;
  std::condition_variable cv_free_, cv_full_;
  std::deque<int> free_q_;
  std::map<int64_t, int> done_;
  int64_t fill_step_ = 0;   // next batch id to start filling
  int64_t emit_step_ = 0;   // next batch id to hand to the consumer
  bool started_ = false;
  bool stop_ = false;
};

}  // namespace

extern "C" {

void* ad_loader_create(int n_sources, uint64_t n_rows, uint64_t batch,
                       int capacity, int n_threads, int shuffle,
                       uint64_t seed, int drop_remainder, int64_t num_epochs) {
  if (n_sources <= 0 || n_rows == 0 || batch == 0) return nullptr;
  return new Loader(n_sources, n_rows, batch, capacity, n_threads, shuffle,
                    seed, drop_remainder, num_epochs);
}

void ad_loader_set_source(void* h, int i, const uint8_t* data,
                          uint64_t row_bytes) {
  static_cast<Loader*>(h)->SetSource(i, data, row_bytes);
}

// Sharded source (mmap'd dataset files): `bases[k]` holds `shard_rows[k]`
// row-major rows; shards concatenate to the loader's n_rows. Returns 0 on
// success, -1 when the shard rows don't sum to n_rows.
int ad_loader_set_source_shards(void* h, int i, const uint8_t** bases,
                                const uint64_t* shard_rows, int n_shards,
                                uint64_t row_bytes) {
  return static_cast<Loader*>(h)->SetSourceShards(i, bases, shard_rows,
                                                  n_shards, row_bytes)
             ? 0
             : -1;
}

int ad_loader_start(void* h) { return static_cast<Loader*>(h)->Start() ? 0 : -1; }

int64_t ad_loader_next(void* h, uint8_t** out_ptrs, uint64_t* out_rows) {
  return static_cast<Loader*>(h)->Next(out_ptrs, out_rows);
}

void ad_loader_release(void* h, int slot) {
  static_cast<Loader*>(h)->Release(slot);
}

int64_t ad_loader_batches_per_epoch(void* h) {
  return static_cast<Loader*>(h)->batches_per_epoch();
}

void ad_loader_destroy(void* h) { delete static_cast<Loader*>(h); }

}  // extern "C"
