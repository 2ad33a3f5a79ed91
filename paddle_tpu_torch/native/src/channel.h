// Bounded MPMC channel — parity with the reference's
// paddle/fluid/framework/channel.h + blocking_queue.h used by the data-feed
// pipeline (data_feed.h:222 InMemoryDataFeed channels). Same close semantics:
// writers Put until Close; readers Get until drained-and-closed.
#pragma once
#include <condition_variable>
#include <deque>
#include <mutex>
#include <vector>

namespace ptnative {

template <typename T>
class Channel {
 public:
  explicit Channel(size_t capacity = 0) : cap_(capacity) {}

  // returns false iff the channel is closed
  bool Put(T&& v) {
    std::unique_lock<std::mutex> lk(mu_);
    not_full_.wait(lk, [&] { return closed_ || cap_ == 0 || q_.size() < cap_; });
    if (closed_) return false;
    q_.emplace_back(std::move(v));
    not_empty_.notify_one();
    return true;
  }

  bool PutBatch(std::vector<T>&& vs) {
    std::unique_lock<std::mutex> lk(mu_);
    if (closed_) return false;
    for (auto& v : vs) q_.emplace_back(std::move(v));
    not_empty_.notify_all();
    return true;
  }

  // returns false iff closed AND drained
  bool Get(T* out) {
    std::unique_lock<std::mutex> lk(mu_);
    not_empty_.wait(lk, [&] { return closed_ || !q_.empty(); });
    if (q_.empty()) return false;
    *out = std::move(q_.front());
    q_.pop_front();
    not_full_.notify_one();
    return true;
  }

  void Close() {
    std::lock_guard<std::mutex> lk(mu_);
    closed_ = true;
    not_empty_.notify_all();
    not_full_.notify_all();
  }

  size_t Size() {
    std::lock_guard<std::mutex> lk(mu_);
    return q_.size();
  }

  // drain everything currently buffered (used to collect worker outputs)
  std::vector<T> DrainAll() {
    std::lock_guard<std::mutex> lk(mu_);
    std::vector<T> out(std::make_move_iterator(q_.begin()),
                       std::make_move_iterator(q_.end()));
    q_.clear();
    not_full_.notify_all();
    return out;
  }

 private:
  std::mutex mu_;
  std::condition_variable not_empty_, not_full_;
  std::deque<T> q_;
  size_t cap_;
  bool closed_ = false;
};

}  // namespace ptnative
