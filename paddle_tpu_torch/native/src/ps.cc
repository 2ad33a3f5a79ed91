#include "ps.h"

#include <arpa/inet.h>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <sys/socket.h>
#include <unistd.h>

#include <chrono>
#include <cmath>
#include <cstring>

namespace ptnative {

static double NowSec() {
  return std::chrono::duration<double>(
             std::chrono::steady_clock::now().time_since_epoch())
      .count();
}

// deterministic per-id init in (-r, r): splitmix64 hash → uniform
static float HashUniform(uint64_t id, uint32_t j, float r) {
  uint64_t z = id * 0x9E3779B97F4A7C15ull + j * 0xBF58476D1CE4E5B9ull;
  z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9ull;
  z = (z ^ (z >> 27)) * 0x94D049BB133111EBull;
  z ^= z >> 31;
  return (static_cast<float>(z >> 11) / 9007199254740992.0f * 2.f - 1.f) * r;
}

std::vector<float>& SparseTable::RowLocked(int shard, uint64_t id) {
  auto& m = shards[shard];
  auto it = m.find(id);
  if (it == m.end()) {
    size_t width = dim * (opt == kOptAdagrad ? 2 : 1);
    std::vector<float> row(width, 0.f);
    for (int32_t j = 0; j < dim; ++j) row[j] = HashUniform(id, j, init_range);
    it = m.emplace(id, std::move(row)).first;
  }
  return it->second;
}

// Requests touch each shard ONCE: ids are bucketed by shard first, then
// every shard's batch is processed under a single lock acquisition.
// The old per-id lock/unlock (batch=4096 → 4096 acquisitions) was the
// dominant contention source under concurrent trainers (PS_BENCH r4
// scaling_by_trainers regression).
void SparseTable::PullRows(const uint64_t* ids, uint64_t n, float* out) {
  std::vector<uint32_t> order[kShards];
  for (uint64_t i = 0; i < n; ++i)
    order[ids[i] % kShards].push_back((uint32_t)i);
  for (int sh = 0; sh < kShards; ++sh) {
    if (order[sh].empty()) continue;
    std::lock_guard<std::mutex> lk(mu[sh]);
    for (uint32_t i : order[sh]) {
      auto& row = RowLocked(sh, ids[i]);
      std::memcpy(out + (uint64_t)i * dim, row.data(),
                  dim * sizeof(float));
    }
  }
}

void SparseTable::PushGrads(const uint64_t* ids, uint64_t n,
                            const float* grads) {
  std::vector<uint32_t> order[kShards];
  for (uint64_t i = 0; i < n; ++i)
    order[ids[i] % kShards].push_back((uint32_t)i);
  for (int sh = 0; sh < kShards; ++sh) {
    if (order[sh].empty()) continue;
    std::lock_guard<std::mutex> lk(mu[sh]);
    auto& counts = update_count[sh];
    for (uint32_t i : order[sh]) {
      auto& row = RowLocked(sh, ids[i]);
      const float* g = grads + (uint64_t)i * dim;
      if (opt == kOptAdagrad) {
        for (int32_t j = 0; j < dim; ++j) {
          row[dim + j] += g[j] * g[j];
          row[j] -= lr * g[j] / (std::sqrt(row[dim + j]) + 1e-6f);
        }
      } else {
        for (int32_t j = 0; j < dim; ++j) row[j] -= lr * g[j];
      }
      counts[ids[i]]++;
    }
  }
}

uint64_t SparseTable::Shrink(uint64_t min_updates) {
  uint64_t dropped = 0;
  for (int sh = 0; sh < kShards; ++sh) {
    std::lock_guard<std::mutex> lk(mu[sh]);
    auto& m = shards[sh];
    auto& counts = update_count[sh];
    for (auto it = m.begin(); it != m.end();) {
      auto cit = counts.find(it->first);
      uint64_t c = cit == counts.end() ? 0 : cit->second;
      if (c < min_updates) {
        if (cit != counts.end()) counts.erase(cit);
        it = m.erase(it);
        ++dropped;
      } else {
        ++it;
      }
    }
    // drop counters with no backing row (shrunk earlier or never pulled):
    // a re-created row must not inherit a stale pre-shrink count
    for (auto cit = counts.begin(); cit != counts.end();) {
      if (m.find(cit->first) == m.end())
        cit = counts.erase(cit);
      else
        ++cit;
    }
  }
  return dropped;
}

uint64_t SparseTable::NumRows() {
  uint64_t n = 0;
  for (int sh = 0; sh < kShards; ++sh) {
    std::lock_guard<std::mutex> lk(mu[sh]);
    n += shards[sh].size();
  }
  return n;
}

void DenseTable::Push(const float* grads, uint64_t n) {
  std::lock_guard<std::mutex> lk(mu);
  if (n > param.size()) n = param.size();
  if (opt == kOptAdagrad) {
    for (uint64_t j = 0; j < n; ++j) {
      accum[j] += grads[j] * grads[j];
      param[j] -= lr * grads[j] / (std::sqrt(accum[j]) + 1e-6f);
    }
  } else {
    for (uint64_t j = 0; j < n; ++j) param[j] -= lr * grads[j];
  }
}

// ---- wire helpers -------------------------------------------------------

static bool WriteAll(int fd, const void* buf, size_t n) {
  const char* p = static_cast<const char*>(buf);
  while (n > 0) {
    ssize_t w = ::send(fd, p, n, MSG_NOSIGNAL);
    if (w <= 0) return false;
    p += w;
    n -= w;
  }
  return true;
}

static bool ReadAll(int fd, void* buf, size_t n) {
  char* p = static_cast<char*>(buf);
  while (n > 0) {
    ssize_t r = ::recv(fd, p, n, 0);
    if (r <= 0) return false;
    p += r;
    n -= r;
  }
  return true;
}

// request : u32 payload_len | u8 cmd | i32 table | payload
// response: u32 payload_len | u8 status(0 ok) | payload
static bool SendMsg(int fd, uint8_t cmd, int32_t table,
                    const std::string& payload) {
  uint32_t len = static_cast<uint32_t>(payload.size());
  char hdr[9];
  std::memcpy(hdr, &len, 4);
  hdr[4] = static_cast<char>(cmd);
  std::memcpy(hdr + 5, &table, 4);
  return WriteAll(fd, hdr, 9) &&
         (payload.empty() || WriteAll(fd, payload.data(), payload.size()));
}

// Bound a frame to 256 MiB: a garbage/hostile length from the wire must
// not turn into a multi-GiB allocation that std::terminate()s the trainer.
static constexpr uint32_t kMaxPayload = 256u << 20;

static bool RecvMsg(int fd, uint8_t* cmd, int32_t* table,
                    std::string* payload) {
  char hdr[9];
  if (!ReadAll(fd, hdr, 9)) return false;
  uint32_t len;
  std::memcpy(&len, hdr, 4);
  if (len > kMaxPayload) return false;
  *cmd = static_cast<uint8_t>(hdr[4]);
  std::memcpy(table, hdr + 5, 4);
  payload->resize(len);
  return len == 0 || ReadAll(fd, &(*payload)[0], len);
}

static bool SendReply(int fd, uint8_t status, const std::string& payload) {
  uint32_t len = static_cast<uint32_t>(payload.size());
  char hdr[5];
  std::memcpy(hdr, &len, 4);
  hdr[4] = static_cast<char>(status);
  return WriteAll(fd, hdr, 5) &&
         (payload.empty() || WriteAll(fd, payload.data(), payload.size()));
}

static bool RecvReply(int fd, uint8_t* status, std::string* payload) {
  char hdr[5];
  if (!ReadAll(fd, hdr, 5)) return false;
  uint32_t len;
  std::memcpy(&len, hdr, 4);
  *status = static_cast<uint8_t>(hdr[4]);
  payload->resize(len);
  return len == 0 || ReadAll(fd, &(*payload)[0], len);
}

// ---- server -------------------------------------------------------------

void PsServer::AddSparseTable(int32_t id, int32_t dim, PsOptimizer opt,
                              float lr, float init_range) {
  auto t = std::make_unique<SparseTable>();
  t->dim = dim;
  t->opt = opt;
  t->lr = lr;
  t->init_range = init_range;
  sparse_[id] = std::move(t);
}

void PsServer::AddDenseTable(int32_t id, int64_t size, PsOptimizer opt,
                             float lr) {
  auto t = std::make_unique<DenseTable>();
  t->param.assign(size, 0.f);
  if (opt == kOptAdagrad) t->accum.assign(size, 0.f);
  t->opt = opt;
  t->lr = lr;
  dense_[id] = std::move(t);
}

bool PsServer::Start() {
  listen_fd_ = ::socket(AF_INET, SOCK_STREAM, 0);
  if (listen_fd_ < 0) return false;
  int one = 1;
  setsockopt(listen_fd_, SOL_SOCKET, SO_REUSEADDR, &one, sizeof one);
  sockaddr_in addr{};
  addr.sin_family = AF_INET;
  addr.sin_addr.s_addr = htonl(INADDR_LOOPBACK);
  addr.sin_port = htons(static_cast<uint16_t>(port_));
  if (::bind(listen_fd_, reinterpret_cast<sockaddr*>(&addr), sizeof addr) != 0)
    return false;
  if (port_ == 0) {  // ephemeral: report the picked port
    socklen_t alen = sizeof addr;
    getsockname(listen_fd_, reinterpret_cast<sockaddr*>(&addr), &alen);
    port_ = ntohs(addr.sin_port);
  }
  if (::listen(listen_fd_, 64) != 0) return false;
  running_ = true;
  accept_thread_ = std::thread([this] { AcceptLoop(); });
  return true;
}

void PsServer::RequestStop() {
  if (!running_.exchange(false)) return;
  ::shutdown(listen_fd_, SHUT_RDWR);
  {
    // unblock connection threads parked in recv
    std::lock_guard<std::mutex> lk(conn_mu_);
    for (int fd : conn_fds_) ::shutdown(fd, SHUT_RDWR);
  }
  {
    std::lock_guard<std::mutex> lk(bar_mu_);
    bar_cv_.notify_all();
  }
}

void PsServer::Stop() {
  RequestStop();
  if (joined_.exchange(true)) return;
  if (accept_thread_.joinable()) accept_thread_.join();
  ::close(listen_fd_);
  std::vector<std::thread> ths;
  {
    std::lock_guard<std::mutex> lk(conn_mu_);
    ths.swap(conn_threads_);
  }
  for (auto& t : ths)
    if (t.joinable()) t.join();
  std::lock_guard<std::mutex> lk(conn_mu_);
  for (int fd : conn_fds_) ::close(fd);
  conn_fds_.clear();
}

void PsServer::AcceptLoop() {
  while (running_) {
    int fd = ::accept(listen_fd_, nullptr, nullptr);
    if (fd < 0) break;
    int one = 1;
    setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof one);
    std::lock_guard<std::mutex> lk(conn_mu_);
    conn_fds_.push_back(fd);
    conn_threads_.emplace_back([this, fd] { HandleConn(fd); });
  }
}

void PsServer::HandleConn(int fd) {
  uint8_t cmd;
  int32_t table;
  std::string payload, reply;
  while (running_ && RecvMsg(fd, &cmd, &table, &payload)) {
    reply.clear();
    uint8_t status = 0;
    switch (cmd) {
      case kPullSparse: {
        auto it = sparse_.find(table);
        if (it == sparse_.end()) { status = 1; break; }
        if (payload.size() % 8 != 0) { status = 3; break; }
        uint64_t n = payload.size() / 8;
        reply.resize(n * it->second->dim * sizeof(float));
        it->second->PullRows(
            reinterpret_cast<const uint64_t*>(payload.data()), n,
            reinterpret_cast<float*>(&reply[0]));
        break;
      }
      case kPushSparse: {
        auto it = sparse_.find(table);
        if (it == sparse_.end()) { status = 1; break; }
        int32_t dim = it->second->dim;
        size_t row_bytes = 8 + dim * sizeof(float);
        if (payload.size() % row_bytes != 0) { status = 3; break; }
        uint64_t n = payload.size() / row_bytes;
        const auto* ids = reinterpret_cast<const uint64_t*>(payload.data());
        const auto* g =
            reinterpret_cast<const float*>(payload.data() + n * 8);
        it->second->PushGrads(ids, n, g);
        break;
      }
      case kPullDense: {
        auto it = dense_.find(table);
        if (it == dense_.end()) { status = 1; break; }
        std::lock_guard<std::mutex> lk(it->second->mu);
        reply.assign(
            reinterpret_cast<const char*>(it->second->param.data()),
            it->second->param.size() * sizeof(float));
        break;
      }
      case kPushDense: {
        auto it = dense_.find(table);
        if (it == dense_.end()) { status = 1; break; }
        it->second->Push(reinterpret_cast<const float*>(payload.data()),
                         payload.size() / sizeof(float));
        break;
      }
      case kPushSparseSeq: {
        auto it = sparse_.find(table);
        if (it == sparse_.end()) { status = 1; break; }
        if (payload.size() < 16) { status = 3; break; }
        uint64_t push_id, seq;
        std::memcpy(&push_id, payload.data(), 8);
        std::memcpy(&seq, payload.data() + 8, 8);
        if (IsDuplicate(push_id, kPushSparseSeq, table, seq)) break;
        int32_t dim = it->second->dim;
        size_t row_bytes = 8 + dim * sizeof(float);
        size_t body = payload.size() - 16;
        if (body % row_bytes != 0) { status = 3; break; }
        uint64_t n = body / row_bytes;
        const auto* ids =
            reinterpret_cast<const uint64_t*>(payload.data() + 16);
        const auto* g =
            reinterpret_cast<const float*>(payload.data() + 16 + n * 8);
        it->second->PushGrads(ids, n, g);
        break;
      }
      case kPushDenseSeq: {
        auto it = dense_.find(table);
        if (it == dense_.end()) { status = 1; break; }
        if (payload.size() < 16) { status = 3; break; }
        uint64_t push_id, seq;
        std::memcpy(&push_id, payload.data(), 8);
        std::memcpy(&seq, payload.data() + 8, 8);
        if (IsDuplicate(push_id, kPushDenseSeq, table, seq)) break;
        it->second->Push(
            reinterpret_cast<const float*>(payload.data() + 16),
            (payload.size() - 16) / sizeof(float));
        break;
      }
      case kInitDense: {
        auto it = dense_.find(table);
        if (it == dense_.end()) { status = 1; break; }
        std::lock_guard<std::mutex> lk(it->second->mu);
        uint64_t n = payload.size() / sizeof(float);
        if (n > it->second->param.size()) n = it->second->param.size();
        std::memcpy(it->second->param.data(), payload.data(),
                    n * sizeof(float));
        break;
      }
      case kHeartbeat: {
        if (payload.size() < 4) { status = 3; break; }
        int32_t wid;
        std::memcpy(&wid, payload.data(), 4);
        std::lock_guard<std::mutex> lk(hb_mu_);
        last_beat_[wid] = NowSec();
        break;
      }
      case kBarrier: {
        int32_t wid = -1;
        if (payload.size() >= 4) std::memcpy(&wid, payload.data(), 4);
        std::unique_lock<std::mutex> lk(bar_mu_);
        // a worker evicted by the heartbeat monitor cannot rejoin the
        // group silently — its barrier fails loudly (status 5)
        if (evicted_.count(wid)) { status = 5; break; }
        uint64_t gen = bar_gen_;
        int effective = num_workers_ - static_cast<int>(evicted_.size());
        if (effective < 1) effective = 1;
        if (++bar_count_ >= effective) {
          bar_count_ = 0;
          ++bar_gen_;
          bar_cv_.notify_all();
        } else {
          bar_cv_.wait(lk, [&] { return bar_gen_ != gen || !running_; });
          // released by shutdown, not by the full worker set: report
          // failure so callers don't sail past an unreached sync point
          if (bar_gen_ == gen) status = 4;
        }
        break;
      }
      case kShrink: {
        auto it = sparse_.find(table);
        if (it == sparse_.end()) { status = 1; break; }
        if (payload.size() < 8) { status = 3; break; }
        uint64_t min_updates;
        std::memcpy(&min_updates, payload.data(), 8);
        uint64_t dropped = it->second->Shrink(min_updates);
        reply.assign(reinterpret_cast<const char*>(&dropped), 8);
        break;
      }
      case kStop: {
        SendReply(fd, 0, "");
        // no join and no close here (we ARE a connection thread; fds are
        // closed centrally in Stop(), driven by the owner)
        RequestStop();
        return;
      }
      default:
        status = 2;
    }
    if (!SendReply(fd, status, reply)) break;
  }
  // fd closed centrally in Stop() (it stays in conn_fds_; closing here
  // would let the kernel reuse the number and make RequestStop's shutdown
  // hit an unrelated socket)
}

bool PsServer::IsDuplicate(uint64_t push_id, uint8_t cmd, int32_t table,
                           uint64_t seq) {
  std::lock_guard<std::mutex> lk(seq_mu_);
  auto key = std::make_tuple(push_id, cmd, table);
  auto it = applied_seq_.find(key);
  if (it != applied_seq_.end() && seq <= it->second) return true;
  applied_seq_[key] = seq;
  return false;
}

void PsServer::EvictWorker(int32_t wid) {
  {
    std::unique_lock<std::mutex> lk(bar_mu_);
    evicted_.insert(wid);
    int effective = num_workers_ - static_cast<int>(evicted_.size());
    if (effective < 1) effective = 1;
    // the dead worker may have been the one the group was waiting on:
    // if every survivor is already parked, release the generation now
    if (bar_count_ > 0 && bar_count_ >= effective) {
      bar_count_ = 0;
      ++bar_gen_;
      bar_cv_.notify_all();
    }
  }
  // stop reporting it as lost (it is handled, not merely detected)
  std::lock_guard<std::mutex> lk(hb_mu_);
  last_beat_.erase(wid);
}

std::vector<int32_t> PsServer::LostWorkers(double timeout_sec) {
  std::vector<int32_t> lost;
  double now = NowSec();
  std::lock_guard<std::mutex> lk(hb_mu_);
  for (const auto& kv : last_beat_)
    if (now - kv.second > timeout_sec) lost.push_back(kv.first);
  return lost;
}

uint64_t PsServer::SparseRows(int32_t table) {
  auto it = sparse_.find(table);
  return it == sparse_.end() ? 0 : it->second->NumRows();
}

// ---- client -------------------------------------------------------------

PsClient::PsClient(std::vector<std::string> endpoints)
    : eps_(std::move(endpoints)) {
  fds_.assign(eps_.size(), -1);
  for (size_t i = 0; i < eps_.size(); ++i)
    mus_.emplace_back(new std::mutex());
}

PsClient::~PsClient() {
  for (int fd : fds_)
    if (fd >= 0) ::close(fd);
}

bool PsClient::Connect() {
  for (size_t i = 0; i < eps_.size(); ++i) {
    if (fds_[i] >= 0) continue;
    auto colon = eps_[i].rfind(':');
    if (colon == std::string::npos) { err_ = "bad endpoint " + eps_[i]; return false; }
    std::string host = eps_[i].substr(0, colon);
    int port = atoi(eps_[i].c_str() + colon + 1);
    int fd = ::socket(AF_INET, SOCK_STREAM, 0);
    sockaddr_in addr{};
    addr.sin_family = AF_INET;
    addr.sin_port = htons(static_cast<uint16_t>(port));
    if (host == "localhost") host = "127.0.0.1";
    if (inet_pton(AF_INET, host.c_str(), &addr.sin_addr) != 1) {
      err_ = "cannot resolve " + host;
      ::close(fd);
      return false;
    }
    // retry loop: servers may come up after workers (launch races);
    // bounded by SetConnectAttempts so a retry policy above can make
    // each reconnect attempt fast and own the backoff itself
    bool ok = false;
    for (int attempt = 0; attempt < connect_attempts_; ++attempt) {
      if (::connect(fd, reinterpret_cast<sockaddr*>(&addr), sizeof addr) == 0) {
        ok = true;
        break;
      }
      if (attempt + 1 < connect_attempts_)
        std::this_thread::sleep_for(
            std::chrono::milliseconds(connect_sleep_ms_));
    }
    if (!ok) {
      err_ = "cannot connect to " + eps_[i];
      ::close(fd);
      return false;
    }
    int one = 1;
    setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof one);
    fds_[i] = fd;
  }
  return true;
}

bool PsClient::Rpc(int server, uint8_t cmd, int32_t table,
                   const std::string& payload, std::string* reply) {
  std::lock_guard<std::mutex> lk(*mus_[server]);
  int fd = fds_[server];
  if (fd < 0) { err_ = "not connected to " + eps_[server]; return false; }
  // transport failures invalidate the fd so a later Connect() can
  // re-dial just this endpoint (the rpc_client.h reconnect story);
  // status errors keep the connection (the server answered).
  if (!SendMsg(fd, cmd, table, payload)) {
    ::close(fd);
    fds_[server] = -1;
    err_ = "send failed to " + eps_[server];
    return false;
  }
  uint8_t status;
  if (!RecvReply(fd, &status, reply)) {
    ::close(fd);
    fds_[server] = -1;
    err_ = "recv failed from " + eps_[server];
    return false;
  }
  if (status != 0) {
    err_ = "server error status " + std::to_string(status) + " from " +
           eps_[server];
    return false;
  }
  return true;
}

int PsClient::BrokenEndpoints(int32_t* out, int cap) {
  int n = 0;
  for (size_t i = 0; i < eps_.size() && n < cap; ++i) {
    std::lock_guard<std::mutex> lk(*mus_[i]);
    if (fds_[i] < 0) out[n++] = static_cast<int32_t>(i);
  }
  return n;
}

bool PsClient::PullSparse(int32_t table, const uint64_t* ids, uint64_t n,
                          int32_t dim, float* out) {
  size_t ns = eps_.size();
  std::vector<std::vector<uint64_t>> per(ns);     // ids per server
  std::vector<std::vector<uint64_t>> pos(ns);     // original index
  for (uint64_t i = 0; i < n; ++i) {
    int s = ServerFor(ids[i]);
    per[s].push_back(ids[i]);
    pos[s].push_back(i);
  }
  for (size_t s = 0; s < ns; ++s) {
    if (per[s].empty()) continue;
    std::string payload(reinterpret_cast<const char*>(per[s].data()),
                        per[s].size() * 8);
    std::string reply;
    if (!Rpc(static_cast<int>(s), kPullSparse, table, payload, &reply))
      return false;
    if (reply.size() != per[s].size() * dim * sizeof(float)) {
      err_ = "pull_sparse: dim mismatch with server table (reply " +
             std::to_string(reply.size() / sizeof(float) / per[s].size()) +
             " floats/row, caller dim " + std::to_string(dim) + ")";
      return false;
    }
    const float* rows = reinterpret_cast<const float*>(reply.data());
    for (size_t k = 0; k < per[s].size(); ++k)
      std::memcpy(out + pos[s][k] * dim, rows + k * dim,
                  dim * sizeof(float));
  }
  return true;
}

bool PsClient::PushSparse(int32_t table, const uint64_t* ids, uint64_t n,
                          int32_t dim, const float* grads) {
  size_t ns = eps_.size();
  std::vector<std::vector<uint64_t>> per(ns);
  std::vector<std::vector<float>> pg(ns);
  for (uint64_t i = 0; i < n; ++i) {
    int s = ServerFor(ids[i]);
    per[s].push_back(ids[i]);
    pg[s].insert(pg[s].end(), grads + i * dim, grads + (i + 1) * dim);
  }
  for (size_t s = 0; s < ns; ++s) {
    if (per[s].empty()) continue;
    std::string payload;
    payload.append(reinterpret_cast<const char*>(per[s].data()),
                   per[s].size() * 8);
    payload.append(reinterpret_cast<const char*>(pg[s].data()),
                   pg[s].size() * sizeof(float));
    std::string reply;
    if (!Rpc(static_cast<int>(s), kPushSparse, table, payload, &reply))
      return false;
  }
  return true;
}

bool PsClient::PushSparseSeq(int32_t table, uint64_t seq,
                             const uint64_t* ids, uint64_t n, int32_t dim,
                             const float* grads) {
  size_t ns = eps_.size();
  std::vector<std::vector<uint64_t>> per(ns);
  std::vector<std::vector<float>> pg(ns);
  for (uint64_t i = 0; i < n; ++i) {
    int s = ServerFor(ids[i]);
    per[s].push_back(ids[i]);
    pg[s].insert(pg[s].end(), grads + i * dim, grads + (i + 1) * dim);
  }
  for (size_t s = 0; s < ns; ++s) {
    if (per[s].empty()) continue;
    std::string payload;
    payload.append(reinterpret_cast<const char*>(&push_id_), 8);
    payload.append(reinterpret_cast<const char*>(&seq), 8);
    payload.append(reinterpret_cast<const char*>(per[s].data()),
                   per[s].size() * 8);
    payload.append(reinterpret_cast<const char*>(pg[s].data()),
                   pg[s].size() * sizeof(float));
    std::string reply;
    if (!Rpc(static_cast<int>(s), kPushSparseSeq, table, payload, &reply))
      return false;
  }
  return true;
}

bool PsClient::PushDenseSeq(int32_t table, uint64_t seq, const float* grads,
                            uint64_t n) {
  std::string payload;
  payload.append(reinterpret_cast<const char*>(&push_id_), 8);
  payload.append(reinterpret_cast<const char*>(&seq), 8);
  payload.append(reinterpret_cast<const char*>(grads), n * sizeof(float));
  std::string reply;
  return Rpc(table % static_cast<int>(eps_.size()), kPushDenseSeq, table,
             payload, &reply);
}

bool PsClient::PullDense(int32_t table, float* out, uint64_t n) {
  std::string reply;
  if (!Rpc(table % static_cast<int>(eps_.size()), kPullDense, table, "",
           &reply))
    return false;
  std::memcpy(out, reply.data(),
              std::min<size_t>(n * sizeof(float), reply.size()));
  return true;
}

bool PsClient::PushDense(int32_t table, const float* grads, uint64_t n) {
  std::string payload(reinterpret_cast<const char*>(grads),
                      n * sizeof(float));
  std::string reply;
  return Rpc(table % static_cast<int>(eps_.size()), kPushDense, table,
             payload, &reply);
}

bool PsClient::InitDense(int32_t table, const float* vals, uint64_t n) {
  std::string payload(reinterpret_cast<const char*>(vals),
                      n * sizeof(float));
  std::string reply;
  return Rpc(table % static_cast<int>(eps_.size()), kInitDense, table,
             payload, &reply);
}

bool PsClient::Heartbeat(int32_t worker_id) {
  std::string payload(reinterpret_cast<const char*>(&worker_id), 4);
  std::string reply;
  bool ok = true;
  for (size_t s = 0; s < eps_.size(); ++s)
    ok = Rpc(static_cast<int>(s), kHeartbeat, 0, payload, &reply) && ok;
  return ok;
}

bool PsClient::Barrier(int32_t worker_id) {
  std::string payload(reinterpret_cast<const char*>(&worker_id), 4);
  std::string reply;
  return Rpc(0, kBarrier, 0, payload, &reply);  // barrier on server 0
}

bool PsClient::Shrink(int32_t table, uint64_t min_updates) {
  std::string payload(reinterpret_cast<const char*>(&min_updates), 8);
  bool ok = true;
  for (size_t s = 0; s < eps_.size(); ++s) {
    std::string reply;
    ok = Rpc(static_cast<int>(s), kShrink, table, payload, &reply) && ok;
  }
  return ok;
}

bool PsClient::SendStop() {
  bool ok = true;
  for (size_t s = 0; s < eps_.size(); ++s) {
    std::lock_guard<std::mutex> lk(*mus_[s]);
    if (fds_[s] < 0) continue;
    ok = SendMsg(fds_[s], kStop, 0, "") && ok;
    uint8_t status;
    std::string reply;
    RecvReply(fds_[s], &status, &reply);
    ::close(fds_[s]);
    fds_[s] = -1;
  }
  return ok;
}

}  // namespace ptnative
