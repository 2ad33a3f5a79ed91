#include "datafeed.h"

#include <cstdio>
#include <cstring>
#include <functional>
#include <algorithm>

namespace ptnative {

// MultiSlot text format (reference MultiSlotDataFeed, data_feed.cc): each
// line holds, per used slot in declaration order, "<n> v1 ... vn".
bool Dataset::ParseLine(const char* line, size_t len, Record* rec) {
  // FNV-1a over the raw line: a content hash independent of load order,
  // used by GlobalShuffle to partition records across trainers
  uint64_t h = 1469598103934665603ull;
  for (size_t i = 0; i < len; ++i) {
    h ^= static_cast<unsigned char>(line[i]);
    h *= 1099511628211ull;
  }
  rec->hash = h;
  const char* p = line;
  const char* end = line + len;
  auto next_tok = [&](char* buf, size_t cap) -> bool {
    while (p < end && (*p == ' ' || *p == '\t')) ++p;
    if (p >= end) return false;
    size_t i = 0;
    while (p < end && *p != ' ' && *p != '\t' && i + 1 < cap) buf[i++] = *p++;
    buf[i] = 0;
    return i > 0;
  };
  char tok[64];
  for (const auto& s : slots_) {
    if (!next_tok(tok, sizeof tok)) return false;
    long n = strtol(tok, nullptr, 10);
    if (n < 0) return false;
    if (s.type == kDense) {
      std::vector<float> vals;
      vals.reserve(n);
      for (long i = 0; i < n; ++i) {
        if (!next_tok(tok, sizeof tok)) return false;
        vals.push_back(strtof(tok, nullptr));
      }
      // pad/trim to dim so feeds are rectangular (dense contract)
      vals.resize(s.dim, 0.f);
      if (s.used) rec->dense.emplace_back(std::move(vals));
    } else {
      std::vector<uint64_t> ids;
      ids.reserve(n);
      for (long i = 0; i < n; ++i) {
        if (!next_tok(tok, sizeof tok)) return false;
        ids.push_back(strtoull(tok, nullptr, 10));
      }
      if (s.used) rec->sparse.emplace_back(std::move(ids));
    }
  }
  return true;
}

void Dataset::LoadIntoMemory(int num_threads) {
  if (num_threads < 1) num_threads = 1;
  records_.clear();
  err_.clear();
  // Each file's records land in its own slot and the slots are joined in
  // file-list order, so the loaded order (and every seeded shuffle of
  // it) does not depend on which worker thread finished first.
  std::vector<std::vector<Record>> per_file(files_.size());
  std::atomic<size_t> file_idx{0};
  std::atomic<bool> failed{false};
  std::mutex err_mu;

  auto worker = [&]() {
    for (;;) {
      size_t i = file_idx.fetch_add(1);
      if (i >= files_.size() || failed) break;
      FILE* f = fopen(files_[i].c_str(), "r");
      if (!f) {
        std::lock_guard<std::mutex> lk(err_mu);
        err_ = "cannot open " + files_[i];
        failed = true;
        break;
      }
      auto& local = per_file[i];
      char* line = nullptr;
      size_t cap = 0;
      ssize_t n;
      while ((n = getline(&line, &cap, f)) != -1) {
        if (n > 0 && line[n - 1] == '\n') --n;
        if (n == 0) continue;
        Record rec;
        if (ParseLine(line, static_cast<size_t>(n), &rec)) {
          local.emplace_back(std::move(rec));
        } else {
          std::lock_guard<std::mutex> lk(err_mu);
          err_ = "parse error in " + files_[i];
          failed = true;
        }
        if (failed) break;
      }
      free(line);
      fclose(f);
      if (failed) break;
    }
  };

  std::vector<std::thread> ths;
  for (int t = 0; t < num_threads; ++t) ths.emplace_back(worker);
  for (auto& t : ths) t.join();
  if (failed) return;
  size_t total = 0;
  for (const auto& v : per_file) total += v.size();
  records_.reserve(total);
  for (auto& v : per_file)
    for (auto& r : v) records_.emplace_back(std::move(r));
}

void Dataset::LocalShuffle(uint64_t seed) {
  std::mt19937_64 rng(seed);
  std::shuffle(records_.begin(), records_.end(), rng);
}

void Dataset::GlobalShuffle(uint64_t seed) {
  // All trainers run this over the same file list; each keeps the shard
  // hash(record content) % trainer_num == trainer_id — a true partition
  // regardless of the in-memory order, matching
  // the reference's redistribute-by-record-hash semantics
  // (data_set.cc GlobalShuffle) without a cluster.
  if (trainer_num_ > 1) {
    std::vector<Record> mine;
    for (auto& r : records_) {
      uint64_t h = r.hash ^ (seed * 0x9E3779B97F4A7C15ull);
      if (static_cast<int>(h % trainer_num_) == trainer_id_)
        mine.emplace_back(std::move(r));
    }
    records_ = std::move(mine);
  }
  std::mt19937_64 rng(seed + 1 + trainer_id_);
  std::shuffle(records_.begin(), records_.end(), rng);
}

int BatchFeeder::Next() {
  const auto& slots = ds_->slots();
  const auto& recs = ds_->records();
  size_t remain = recs.size() - std::min(recs.size(), cursor_);
  size_t take = std::min<size_t>(bs_, remain);
  if (take == 0 || (drop_last_ && take < static_cast<size_t>(bs_))) return 0;

  size_t n_dense = 0, n_sparse = 0;
  for (const auto& s : slots)
    if (s.used) (s.type == kDense ? n_dense : n_sparse)++;
  dense_bufs_.assign(n_dense, {});
  sparse_bufs_.assign(n_sparse, {});
  lod_bufs_.assign(n_sparse, {});
  for (auto& l : lod_bufs_) l.push_back(0);

  for (size_t r = 0; r < take; ++r) {
    const Record& rec = recs[cursor_ + r];
    for (size_t d = 0; d < n_dense; ++d)
      dense_bufs_[d].insert(dense_bufs_[d].end(), rec.dense[d].begin(),
                            rec.dense[d].end());
    for (size_t sp = 0; sp < n_sparse; ++sp) {
      for (uint64_t id : rec.sparse[sp])
        sparse_bufs_[sp].push_back(static_cast<int64_t>(id));
      lod_bufs_[sp].push_back(static_cast<int64_t>(sparse_bufs_[sp].size()));
    }
  }
  cursor_ += take;
  return static_cast<int>(take);
}

}  // namespace ptnative
