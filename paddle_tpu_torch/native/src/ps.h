// Native sparse parameter server — parity with the reference's PS stack:
// RPCClient/RPCServer (operators/distributed/rpc_client.h:34, rpc_server.h)
// with gRPC/brpc transports, listen_and_serv's request loop
// (listen_and_serv_op.cc:110), sharded sparse tables with server-side
// optimizers (pslib via FleetWrapper, framework/fleet/fleet_wrapper.h:76),
// and the HeartBeatMonitor (heart_beat_monitor.h:54).
//
// TPU-native redesign: the dense model trains on-chip with XLA collectives;
// this service exists for what XLA does NOT cover — host-resident
// high-dimensional sparse embeddings (DeepFM/CTR) pulled/pushed per step
// over DCN. Transport is a dependency-free length-prefixed binary protocol
// over TCP (the brpc/gRPC analogue), thread-per-connection like the
// reference's sync server loop.
#pragma once
#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <map>
#include <memory>
#include <mutex>
#include <set>
#include <string>
#include <thread>
#include <tuple>
#include <unordered_map>
#include <vector>

namespace ptnative {

enum PsCmd : uint8_t {
  kPullSparse = 1,
  kPushSparse = 2,
  kPullDense = 3,
  kPushDense = 4,
  kInitDense = 5,
  kHeartbeat = 6,
  kStop = 7,
  kBarrier = 8,
  kShrink = 9,   // drop rarely-updated rows (pslib shrink parity)
  // sequence-stamped pushes (rpc_client.h retry-policy parity): payload
  // is prefixed with u64 push_id | u64 seq; the server remembers the
  // last applied seq per (push_id, cmd, table) and silently skips
  // duplicates, so a client retrying an ambiguous failure (reply lost
  // after the push applied) cannot double-apply gradients
  kPushSparseSeq = 10,
  kPushDenseSeq = 11,
};

enum PsOptimizer : int32_t { kOptSGD = 0, kOptAdagrad = 1 };

struct SparseTable {
  int32_t dim = 8;
  PsOptimizer opt = kOptAdagrad;
  float lr = 0.05f;
  float init_range = 0.01f;
  static constexpr int kShards = 16;
  // row layout: [dim params][dim adagrad accumulators if kOptAdagrad]
  std::unordered_map<uint64_t, std::vector<float>> shards[kShards];
  std::mutex mu[kShards];
  std::unordered_map<uint64_t, uint64_t> update_count[kShards];

  void PullRows(const uint64_t* ids, uint64_t n, float* out);
  void PushGrads(const uint64_t* ids, uint64_t n, const float* grads);
  uint64_t Shrink(uint64_t min_updates);
  uint64_t NumRows();

 private:
  std::vector<float>& RowLocked(int shard, uint64_t id);
};

struct DenseTable {
  std::vector<float> param;
  std::vector<float> accum;  // adagrad
  PsOptimizer opt = kOptSGD;
  float lr = 0.01f;
  std::mutex mu;

  void Push(const float* grads, uint64_t n);
};

class PsServer {
 public:
  explicit PsServer(int port) : port_(port) {}
  ~PsServer() { Stop(); }

  void AddSparseTable(int32_t id, int32_t dim, PsOptimizer opt, float lr,
                      float init_range);
  void AddDenseTable(int32_t id, int64_t size, PsOptimizer opt, float lr);
  void SetNumWorkers(int n) { num_workers_ = n; }

  bool Start();  // spawns accept thread; false on bind failure
  // RequestStop: async-safe — flips running_, unblocks accept + all conn
  // reads; no joins (callable from a connection thread on kStop).
  void RequestStop();
  // Stop: RequestStop + join all threads. Idempotent.
  void Stop();
  bool running() const { return running_.load(); }
  int port() const { return port_; }

  // HeartBeatMonitor parity: worker ids silent for > timeout seconds
  std::vector<int32_t> LostWorkers(double timeout_sec);
  uint64_t SparseRows(int32_t table);

  // Remove a dead worker from the barrier group: the effective group
  // shrinks, waiters are released if the survivors are all present, and
  // later barrier attempts by the evicted id are rejected (status 5) —
  // consuming HeartBeatMonitor output so survivors don't deadlock.
  void EvictWorker(int32_t wid);

 private:
  void AcceptLoop();
  void HandleConn(int fd);
  // true (and reply-OK) when `seq` was already applied for this pusher;
  // otherwise records it as applied and returns false
  bool IsDuplicate(uint64_t push_id, uint8_t cmd, int32_t table,
                   uint64_t seq);

  int port_;
  int listen_fd_ = -1;
  std::atomic<bool> running_{false};
  std::atomic<bool> joined_{false};
  std::thread accept_thread_;
  std::vector<std::thread> conn_threads_;
  std::vector<int> conn_fds_;
  std::mutex conn_mu_;

  std::map<int32_t, std::unique_ptr<SparseTable>> sparse_;
  std::map<int32_t, std::unique_ptr<DenseTable>> dense_;

  // barrier (listen_and_serv sync-loop barrier parity)
  std::mutex bar_mu_;
  std::condition_variable bar_cv_;
  int num_workers_ = 1;
  int bar_count_ = 0;
  uint64_t bar_gen_ = 0;
  std::set<int32_t> evicted_;  // guarded by bar_mu_

  // at-most-once push dedup: (push_id, cmd, table) -> last applied seq
  std::mutex seq_mu_;
  std::map<std::tuple<uint64_t, uint8_t, int32_t>, uint64_t> applied_seq_;

  // heartbeats
  std::mutex hb_mu_;
  std::map<int32_t, double> last_beat_;
};

class PsClient {
 public:
  explicit PsClient(std::vector<std::string> endpoints);  // "host:port"
  ~PsClient();

  bool Connect();
  std::string last_error() const { return err_; }

  // retry/failover support: a failed RPC closes + invalidates the
  // endpoint's fd, so a later Connect() reconnects exactly the broken
  // ones. The caller bounds Connect()'s own retry loop here (the
  // default 50x100ms exists for launch races; a retry policy wants one
  // fast attempt per tick).
  void SetConnectAttempts(int attempts, int sleep_ms) {
    connect_attempts_ = attempts < 1 ? 1 : attempts;
    connect_sleep_ms_ = sleep_ms < 0 ? 0 : sleep_ms;
  }
  // indices of endpoints whose connection is currently down
  int BrokenEndpoints(int32_t* out, int cap);
  // identity for server-side push dedup (unique per logical pusher)
  void SetPushId(uint64_t id) { push_id_ = id; }

  // sparse ids are sharded across servers by id % n_servers
  bool PullSparse(int32_t table, const uint64_t* ids, uint64_t n,
                  int32_t dim, float* out);
  bool PushSparse(int32_t table, const uint64_t* ids, uint64_t n,
                  int32_t dim, const float* grads);
  // seq-stamped at-most-once variants: the caller owns `seq` and MUST
  // resend the same value when retrying an ambiguous failure
  bool PushSparseSeq(int32_t table, uint64_t seq, const uint64_t* ids,
                     uint64_t n, int32_t dim, const float* grads);
  bool PushDenseSeq(int32_t table, uint64_t seq, const float* grads,
                    uint64_t n);
  // dense table t lives wholly on server t % n_servers
  bool PullDense(int32_t table, float* out, uint64_t n);
  bool PushDense(int32_t table, const float* grads, uint64_t n);
  bool InitDense(int32_t table, const float* vals, uint64_t n);
  bool Heartbeat(int32_t worker_id);
  bool Barrier(int32_t worker_id);
  bool Shrink(int32_t table, uint64_t min_updates);
  bool SendStop();

 private:
  int ServerFor(uint64_t id) const {
    return static_cast<int>(id % eps_.size());
  }
  bool Rpc(int server, uint8_t cmd, int32_t table,
           const std::string& payload, std::string* reply);

  std::vector<std::string> eps_;
  std::vector<int> fds_;
  std::vector<std::unique_ptr<std::mutex>> mus_;
  std::string err_;
  int connect_attempts_ = 50;
  int connect_sleep_ms_ = 100;
  uint64_t push_id_ = 0;
};

}  // namespace ptnative
