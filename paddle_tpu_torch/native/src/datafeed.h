// Native data-feed pipeline — parity with the reference's C++ dataset stack:
// DataFeed/MultiSlotDataFeed (data_feed.h:61/:222), Dataset::LoadIntoMemory/
// LocalShuffle/GlobalShuffle (data_set.h:92-102). LoadIntoMemory keeps
// the file list's order whatever the thread count. TPU-native notes: the feed produces dense
// host buffers (float32 / int64) ready for jnp.asarray + device_put; ragged
// sparse slots come back as (flat ids, lod offsets) — the LoD contract of
// lod_tensor.h:52 preserved at the data layer where XLA can't express it.
#pragma once
#include <atomic>
#include <cstdint>
#include <memory>
#include <random>
#include <string>
#include <thread>
#include <vector>

#include "channel.h"

namespace ptnative {

enum SlotType : int32_t { kDense = 0, kSparse = 1 };

struct SlotDesc {
  std::string name;
  SlotType type;
  int32_t dim;       // dense: values per record; sparse: ignored (ragged ids)
  bool used = true;  // parity: data_feed.proto use_slots
};

// One training record: per-slot ragged payloads.
struct Record {
  std::vector<std::vector<float>> dense;      // [n_dense][dim]
  std::vector<std::vector<uint64_t>> sparse;  // [n_sparse][ragged]
  uint64_t hash = 0;  // content hash — the trainer-partition key
};

class Dataset {
 public:
  explicit Dataset(std::vector<SlotDesc> slots) : slots_(std::move(slots)) {}

  void SetFileList(std::vector<std::string> files) { files_ = std::move(files); }
  void SetTrainerInfo(int trainer_id, int trainer_num) {
    trainer_id_ = trainer_id;
    trainer_num_ = trainer_num;
  }

  // Multithreaded parse of the file list into memory (reference
  // data_set.cc LoadIntoMemory: thread-per-feed over channels).
  void LoadIntoMemory(int num_threads);
  void LocalShuffle(uint64_t seed);
  // Reference GlobalShuffle redistributes records across trainers by
  // record hash via the fleet RPC; single-host parity: shuffle with the
  // SHARED seed, then keep the hash shard belonging to this trainer.
  void GlobalShuffle(uint64_t seed);

  int64_t Size() const { return static_cast<int64_t>(records_.size()); }
  const std::vector<SlotDesc>& slots() const { return slots_; }
  const std::vector<Record>& records() const { return records_; }
  void ReleaseMemory() { records_.clear(); records_.shrink_to_fit(); }

  std::string last_error() const { return err_; }

 private:
  bool ParseLine(const char* line, size_t len, Record* rec);

  std::vector<SlotDesc> slots_;
  std::vector<std::string> files_;
  std::vector<Record> records_;
  int trainer_id_ = 0, trainer_num_ = 1;
  std::string err_;
};

// Batched iterator over a Dataset: fills per-slot host buffers.
// Dense slot i -> float32 [batch, dim]; sparse slot j -> int64 flat ids +
// int64 lod offsets [batch+1].
class BatchFeeder {
 public:
  BatchFeeder(const Dataset* ds, int batch_size, bool drop_last)
      : ds_(ds), bs_(batch_size), drop_last_(drop_last) {}

  // Returns actual batch rows (0 = epoch end). Buffers owned by the feeder,
  // valid until the next call.
  int Next();
  void Reset() { cursor_ = 0; }

  const float* dense_data(int slot) const { return dense_bufs_[slot].data(); }
  const int64_t* sparse_ids(int slot) const { return sparse_bufs_[slot].data(); }
  const int64_t* sparse_lod(int slot) const { return lod_bufs_[slot].data(); }
  int64_t sparse_len(int slot) const {
    return static_cast<int64_t>(sparse_bufs_[slot].size());
  }

 private:
  const Dataset* ds_;
  int bs_;
  bool drop_last_;
  size_t cursor_ = 0;
  std::vector<std::vector<float>> dense_bufs_;
  std::vector<std::vector<int64_t>> sparse_bufs_;
  std::vector<std::vector<int64_t>> lod_bufs_;
};

}  // namespace ptnative
