// Native host-side data loader — the C++ tier of the input pipeline.
//
// Role in the framework: the reference rides on TF's native input machinery
// (its C++ runtime feeds sess.run via the wheel's compiled kernels); the
// guide's Python only ever sees ready numpy batches. This file, the PyTorch
// port's copy of the JAX package's loader (only this comment differs), is
// the framework's equivalent: a memory-mapped fixed-record reader with
// per-epoch shuffling, multi-threaded batch gather, and a background
// prefetch ring, exposed to Python over a plain C ABI (ctypes — no pybind11
// in this image). The Python fallback twin with identical semantics lives in
// ../native_loader.py; tests assert bit-identical batch streams.
//
// Determinism contract: given (seed, epoch, shard_id, num_shards) the batch
// stream is a pure function — the shuffle is a seeded xoshiro Fisher–Yates
// over the global index space, sharded by contiguous blocks, so multi-host
// runs read disjoint equal-size shards (SPMD data sharding, no PS).

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <mutex>
#include <thread>
#include <vector>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

// xoshiro256** — tiny, fast, seedable; NOT libc rand (reproducible across
// platforms, which the python twin mirrors exactly).
struct Rng {
  uint64_t s[4];
  explicit Rng(uint64_t seed) {
    // splitmix64 init
    for (int i = 0; i < 4; i++) {
      seed += 0x9e3779b97f4a7c15ULL;
      uint64_t z = seed;
      z = (z ^ (z >> 30)) * 0xbf58476d1ce4e5b9ULL;
      z = (z ^ (z >> 27)) * 0x94d049bb133111ebULL;
      s[i] = z ^ (z >> 31);
    }
  }
  static uint64_t rotl(uint64_t x, int k) { return (x << k) | (x >> (64 - k)); }
  uint64_t next() {
    uint64_t result = rotl(s[1] * 5, 7) * 9;
    uint64_t t = s[1] << 17;
    s[2] ^= s[0];
    s[3] ^= s[1];
    s[1] ^= s[2];
    s[0] ^= s[3];
    s[2] ^= t;
    s[3] = rotl(s[3], 45);
    return result;
  }
  // unbiased bounded draw (Lemire)
  uint64_t bounded(uint64_t n) {
    uint64_t x = next();
    __uint128_t m = (__uint128_t)x * n;
    uint64_t l = (uint64_t)m;
    if (l < n) {
      uint64_t t = (0 - n) % n;
      while (l < t) {
        x = next();
        m = (__uint128_t)x * n;
        l = (uint64_t)m;
      }
    }
    return (uint64_t)(m >> 64);
  }
};

struct Batch {
  std::vector<uint8_t> buf;
  int64_t seq = -1;        // which batch index this slot holds
  bool ready = false;
};

// Per-record augmentation seed: a distinct draw stream per
// (seed, epoch, record index) — the determinism contract. The Python twin
// (native_loader._aug_seed) mirrors this formula exactly; the constants
// differ from the shuffle's so crop draws never correlate with the
// permutation.
inline uint64_t aug_seed(uint64_t seed, int64_t epoch, int64_t idx) {
  return seed * 0x9e3779b97f4a7c15ULL +
         (uint64_t)(epoch + 1) * 0xbf58476d1ce4e5b9ULL + (uint64_t)idx;
}

// Horizontally-reversed row copy, specialized on channel count so the
// compiler vectorizes the pixel loop (the generic per-pixel memcpy(chan)
// measured ~2x slower at 224px — flips hit ~50% of records, and this is
// the only part of augmentation costlier than the memcpy it replaces).
template <int C>
void reverse_row_c(uint8_t* drow, const uint8_t* srow, int64_t w) {
  struct Px { uint8_t v[C]; };
  const Px* s = reinterpret_cast<const Px*>(srow);
  Px* d = reinterpret_cast<Px*>(drow);
  for (int64_t x = 0; x < w; x++) d[x] = s[w - 1 - x];
}

inline void reverse_row(uint8_t* drow, const uint8_t* srow, int64_t w,
                        int64_t chan) {
  switch (chan) {
    case 1: reverse_row_c<1>(drow, srow, w); break;
    case 3: reverse_row_c<3>(drow, srow, w); break;
    case 4: reverse_row_c<4>(drow, srow, w); break;
    default:
      for (int64_t x = 0; x < w; x++)
        std::memcpy(drow + x * chan, srow + (w - 1 - x) * chan,
                    (size_t)chan);
  }
}

struct Loader {
  // immutable config
  int fd = -1;
  const uint8_t* map = nullptr;
  size_t map_len = 0;
  int64_t record_bytes = 0;
  int64_t n_records = 0;       // global
  int64_t batch_size = 0;
  int64_t shard_id = 0, num_shards = 1;
  int64_t n_threads = 4;
  uint64_t seed = 0;
  bool shuffle = true;

  // image augmentation (train-time input pipeline tier): deterministic
  // random-crop + horizontal flip applied DURING the gather copy — the
  // augmented batch costs one pass over the bytes, same as the memcpy it
  // replaces, so the prefetch ring's overlap story is unchanged. Records
  // are image (in_h*in_w*c uint8, row-major) + extra bytes (labels etc.,
  // copied verbatim). Disabled when crop_h == 0.
  int64_t in_h = 0, in_w = 0, chan = 0;
  int64_t crop_h = 0, crop_w = 0;
  int64_t extra_bytes = 0;
  bool hflip = false;
  int64_t out_record_bytes = 0;  // == record_bytes when disabled

  // per-epoch state
  std::vector<int64_t> indices;  // this shard's record indices, epoch order
  int64_t epoch = -1;
  int64_t batches_per_epoch = 0;

  // prefetch ring
  std::vector<Batch> ring;
  int64_t next_produce = 0;      // batch seq the producer fills next
  int64_t next_consume = 0;      // batch seq the consumer takes next
  std::mutex mu;
  std::condition_variable cv_produce, cv_consume;
  std::thread producer;
  std::atomic<bool> stop{false};

  // persistent gather pool (workers live for the loader's lifetime — a
  // per-batch spawn/join would dominate small-batch gathers)
  std::vector<std::thread> workers;
  std::mutex pmu;
  std::condition_variable cv_work, cv_done;
  uint64_t work_gen = 0;
  std::atomic<int64_t> work_pending{0};
  uint8_t* work_dst = nullptr;
  int64_t work_base = 0;
  int64_t work_chunk = 0;

  ~Loader() {
    stop.store(true);
    cv_produce.notify_all();
    cv_consume.notify_all();
    {
      std::lock_guard<std::mutex> lk(pmu);
      work_gen++;  // wake workers so they observe stop
    }
    cv_work.notify_all();
    cv_done.notify_all();  // free a producer blocked in gather()'s wait
    if (producer.joinable()) producer.join();
    for (auto& w : workers)
      if (w.joinable()) w.join();
    if (map) munmap((void*)map, map_len);
    if (fd >= 0) close(fd);
  }

  void copy_range(uint8_t* dst, int64_t base, int64_t lo, int64_t hi) {
    if (crop_h == 0) {
      for (int64_t r = lo; r < hi; r++)
        std::memcpy(dst + r * record_bytes,
                    map + indices[base + r] * record_bytes,
                    (size_t)record_bytes);
      return;
    }
    // augmented copy. `epoch` is stable here: only the producer thread
    // writes it, and it never runs install_epoch while a gather is in
    // flight (see producer_loop).
    for (int64_t r = lo; r < hi; r++) {
      const int64_t idx = indices[base + r];
      const uint8_t* src = map + idx * record_bytes;
      uint8_t* out = dst + r * out_record_bytes;
      Rng rng(aug_seed(seed, epoch, idx));
      // draw order is part of the contract (python twin): y0, x0, flip
      const int64_t y0 = (int64_t)rng.bounded((uint64_t)(in_h - crop_h + 1));
      const int64_t x0 = (int64_t)rng.bounded((uint64_t)(in_w - crop_w + 1));
      const bool flip = hflip && (rng.next() & 1);
      const int64_t row_out = crop_w * chan;
      for (int64_t y = 0; y < crop_h; y++) {
        const uint8_t* srow = src + ((y0 + y) * in_w + x0) * chan;
        uint8_t* drow = out + y * row_out;
        if (!flip) {
          std::memcpy(drow, srow, (size_t)row_out);
        } else {
          reverse_row(drow, srow, crop_w, chan);
        }
      }
      if (extra_bytes)
        std::memcpy(out + crop_h * row_out,
                    src + in_h * in_w * chan, (size_t)extra_bytes);
    }
  }

  void worker_loop(int64_t id) {
    uint64_t seen = 0;
    while (true) {
      uint8_t* dst;
      int64_t base, lo, hi;
      {
        std::unique_lock<std::mutex> lk(pmu);
        cv_work.wait(lk, [&] { return stop.load() || work_gen != seen; });
        if (stop.load()) return;
        seen = work_gen;
        dst = work_dst;
        base = work_base;
        lo = id * work_chunk;
        hi = std::min(batch_size, lo + work_chunk);
      }
      if (lo < hi) copy_range(dst, base, lo, hi);
      if (work_pending.fetch_sub(1) == 1) {
        std::lock_guard<std::mutex> lk(pmu);
        cv_done.notify_all();
      }
    }
  }

  // Build epoch `ep`'s index list for this shard into `out`. Pure and
  // lock-free — the O(n_records) part, run off the consumer's critical path.
  // Returns false if aborted by `stop` (shutdown during a huge shuffle).
  bool build_indices(int64_t ep, std::vector<int64_t>& out) {
    int64_t shard_len = n_records / num_shards;  // drop tail remainder
    out.resize(shard_len);
    if (shuffle) {
      // global Fisher–Yates (every shard derives the same permutation, then
      // takes its contiguous block → disjoint cover, identical on all hosts)
      std::vector<int64_t> all(n_records);
      for (int64_t i = 0; i < n_records; i++) all[i] = i;
      Rng rng(seed * 0x9e3779b97f4a7c15ULL + (uint64_t)ep + 1);
      for (int64_t i = n_records - 1; i > 0; i--) {
        if ((i & 0xfffff) == 0 && stop.load()) return false;
        int64_t j = (int64_t)rng.bounded((uint64_t)i + 1);
        std::swap(all[i], all[j]);
      }
      std::memcpy(out.data(), all.data() + shard_id * shard_len,
                  shard_len * sizeof(int64_t));
    } else {
      for (int64_t i = 0; i < shard_len; i++)
        out[i] = shard_id * shard_len + i;
    }
    return true;
  }

  // Caller must guarantee no gather is in flight (only the producer thread
  // issues gathers, and dl_open installs before threads start).
  void install_epoch(int64_t ep, std::vector<int64_t>&& idx) {
    indices = std::move(idx);
    epoch = ep;
    batches_per_epoch =
        (int64_t)indices.size() / batch_size;  // drop_remainder semantics
  }

  // gather one batch (seq within current epoch) into dst. Small batches are
  // copied inline by the producer; larger ones fan out to the persistent
  // pool. Workers only run while the producer blocks in cv_done, so they
  // never race reshuffle()'s writes to `indices`.
  void gather(int64_t seq, uint8_t* dst) {
    const int64_t base = seq * batch_size;
    int64_t nw = (int64_t)workers.size();
    // inline threshold: pool dispatch costs ~2 wakeups; not worth it under
    // ~64KB of copy work
    if (nw == 0 || batch_size * record_bytes < (64 << 10)) {
      copy_range(dst, base, 0, batch_size);
      return;
    }
    {
      std::lock_guard<std::mutex> lk(pmu);
      work_dst = dst;
      work_base = base;
      work_chunk = (batch_size + nw - 1) / nw;
      work_pending.store(nw);
      work_gen++;
    }
    cv_work.notify_all();
    std::unique_lock<std::mutex> lk(pmu);
    // stop also releases this wait: a worker woken during shutdown returns
    // without decrementing work_pending, so the count may never hit zero.
    cv_done.wait(lk, [&] { return stop.load() || work_pending.load() == 0; });
  }

  void producer_loop() {
    while (!stop.load()) {
      std::unique_lock<std::mutex> lk(mu);
      // Epoch rollover happens HERE, on the producer thread: the consumer
      // keeps draining already-gathered ring slots while the O(n_records)
      // permutation is rebuilt with no lock held, so the training loop never
      // stalls on the shuffle. Safe w.r.t. workers: this thread issues every
      // gather, so none is in flight while it runs install_epoch.
      if (next_produce >= (epoch + 1) * batches_per_epoch) {
        int64_t ep = epoch + 1;
        lk.unlock();
        std::vector<int64_t> idx;
        if (!build_indices(ep, idx)) return;  // aborted by stop
        lk.lock();
        install_epoch(ep, std::move(idx));
      }
      int64_t slot = next_produce % (int64_t)ring.size();
      cv_produce.wait(lk, [&] { return stop.load() || !ring[slot].ready; });
      if (stop.load()) return;
      int64_t seq = next_produce;
      lk.unlock();
      gather(seq % batches_per_epoch, ring[slot].buf.data());
      lk.lock();
      ring[slot].seq = seq;
      ring[slot].ready = true;
      next_produce++;
      cv_consume.notify_all();
    }
  }
};

}  // namespace

namespace {

// Shared open path. Augmentation disabled when crop_h == 0; otherwise
// record_bytes must equal in_h*in_w*chan + extra_bytes and the crop must
// fit inside the stored image.
void* open_impl(const char* path, int64_t record_bytes, int64_t batch_size,
                int64_t shard_id, int64_t num_shards, int64_t prefetch,
                int64_t n_threads, uint64_t seed, int shuffle,
                int64_t in_h, int64_t in_w, int64_t chan,
                int64_t crop_h, int64_t crop_w, int64_t extra_bytes,
                int hflip) {
  if (record_bytes <= 0 || batch_size <= 0 || num_shards <= 0 ||
      shard_id < 0 || shard_id >= num_shards || prefetch <= 0)
    return nullptr;
  if (crop_h != 0) {
    if (in_h <= 0 || in_w <= 0 || chan <= 0 || crop_w <= 0 ||
        crop_h > in_h || crop_w > in_w || extra_bytes < 0 ||
        record_bytes != in_h * in_w * chan + extra_bytes)
      return nullptr;
  }
  int fd = open(path, O_RDONLY);
  if (fd < 0) return nullptr;
  struct stat st;
  if (fstat(fd, &st) != 0 || st.st_size == 0 ||
      st.st_size % record_bytes != 0) {
    close(fd);
    return nullptr;
  }
  void* map = mmap(nullptr, (size_t)st.st_size, PROT_READ, MAP_PRIVATE, fd, 0);
  if (map == MAP_FAILED) {
    close(fd);
    return nullptr;
  }
  madvise(map, (size_t)st.st_size, MADV_WILLNEED);
  auto* L = new Loader();
  L->fd = fd;
  L->map = (const uint8_t*)map;
  L->map_len = (size_t)st.st_size;
  L->record_bytes = record_bytes;
  L->n_records = st.st_size / record_bytes;
  L->batch_size = batch_size;
  L->shard_id = shard_id;
  L->num_shards = num_shards;
  L->n_threads = n_threads > 0 ? n_threads : 1;
  L->seed = seed;
  L->shuffle = shuffle != 0;
  L->in_h = in_h;
  L->in_w = in_w;
  L->chan = chan;
  L->crop_h = crop_h;
  L->crop_w = crop_w;
  L->extra_bytes = extra_bytes;
  L->hflip = hflip != 0;
  L->out_record_bytes =
      crop_h ? crop_h * crop_w * chan + extra_bytes : record_bytes;
  {
    std::vector<int64_t> idx;
    L->build_indices(0, idx);
    L->install_epoch(0, std::move(idx));
  }
  if (L->batches_per_epoch == 0) {
    delete L;
    return nullptr;
  }
  L->ring.resize((size_t)prefetch);
  for (auto& b : L->ring)
    b.buf.resize((size_t)(batch_size * L->out_record_bytes));
  int64_t nw = L->n_threads > batch_size ? batch_size : L->n_threads;
  if (nw > 1)
    for (int64_t i = 0; i < nw; i++)
      L->workers.emplace_back(&Loader::worker_loop, L, i);
  L->producer = std::thread(&Loader::producer_loop, L);
  return L;
}

}  // namespace

extern "C" {

// Returns nullptr on failure. record_bytes must divide file size.
void* dl_open(const char* path, int64_t record_bytes, int64_t batch_size,
              int64_t shard_id, int64_t num_shards, int64_t prefetch,
              int64_t n_threads, uint64_t seed, int shuffle) {
  return open_impl(path, record_bytes, batch_size, shard_id, num_shards,
                   prefetch, n_threads, seed, shuffle,
                   0, 0, 0, 0, 0, 0, 0);
}

// dl_open + train-time image augmentation: records are
// (in_h, in_w, chan) uint8 images followed by extra_bytes of verbatim
// payload; every gathered record is random-cropped to (crop_h, crop_w)
// and (optionally) horizontally flipped, with draws a pure function of
// (seed, epoch, record index). Batches come out at
// crop_h*crop_w*chan + extra_bytes per record (see dl_record_bytes_out).
void* dl_open_aug(const char* path, int64_t record_bytes, int64_t batch_size,
                  int64_t shard_id, int64_t num_shards, int64_t prefetch,
                  int64_t n_threads, uint64_t seed, int shuffle,
                  int64_t in_h, int64_t in_w, int64_t chan,
                  int64_t crop_h, int64_t crop_w, int64_t extra_bytes,
                  int hflip) {
  if (crop_h <= 0) return nullptr;  // use dl_open for the plain path
  return open_impl(path, record_bytes, batch_size, shard_id, num_shards,
                   prefetch, n_threads, seed, shuffle,
                   in_h, in_w, chan, crop_h, crop_w, extra_bytes, hflip);
}

int64_t dl_record_bytes_out(void* h) {
  return ((Loader*)h)->out_record_bytes;
}

int64_t dl_batches_per_epoch(void* h) {
  return ((Loader*)h)->batches_per_epoch;
}

int64_t dl_num_records(void* h) { return ((Loader*)h)->n_records; }

// Blocking: copy the next batch into out (batch_size*record_bytes bytes).
// Crossing an epoch boundary reshuffles transparently. Returns the global
// batch sequence number, or -1 on error.
int64_t dl_next(void* h, uint8_t* out) {
  auto* L = (Loader*)h;
  std::unique_lock<std::mutex> lk(L->mu);
  int64_t seq = L->next_consume;
  int64_t slot = seq % (int64_t)L->ring.size();
  // Epoch rollover is the producer's job (see producer_loop); the consumer
  // just waits for its slot.
  L->cv_consume.wait(lk, [&] {
    return L->stop.load() || (L->ring[slot].ready && L->ring[slot].seq == seq);
  });
  if (L->stop.load()) return -1;
  lk.unlock();
  std::memcpy(out, L->ring[slot].buf.data(),
              (size_t)(L->batch_size * L->out_record_bytes));
  lk.lock();
  L->ring[slot].ready = false;
  L->next_consume++;
  L->cv_produce.notify_all();
  return seq;
}

void dl_close(void* h) { delete (Loader*)h; }

}  // extern "C"
