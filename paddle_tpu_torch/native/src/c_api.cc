// C ABI for the native runtime — the pybind.cc analogue (reference
// paddle/fluid/pybind/pybind.cc) done dependency-free: plain C symbols
// consumed from Python via ctypes (pybind11 is not in this image).
#include <cstdint>
#include <cstring>
#include <memory>
#include <string>
#include <vector>

#include "datafeed.h"
#include "ps.h"

using namespace ptnative;

extern "C" {

// ---- dataset / data feed ------------------------------------------------

// slots described as parallel arrays: names (|-joined), types, dims
void* ptds_dataset_create(const char* names, const int32_t* types,
                          const int32_t* dims, int n_slots) {
  std::vector<SlotDesc> slots;
  std::string s(names);
  size_t start = 0;
  for (int i = 0; i < n_slots; ++i) {
    size_t bar = s.find('|', start);
    std::string name = s.substr(start, bar == std::string::npos
                                           ? std::string::npos
                                           : bar - start);
    start = bar == std::string::npos ? s.size() : bar + 1;
    slots.push_back({name, static_cast<SlotType>(types[i]), dims[i], true});
  }
  return new Dataset(std::move(slots));
}

void ptds_dataset_destroy(void* ds) { delete static_cast<Dataset*>(ds); }

void ptds_dataset_set_filelist(void* ds, const char* paths_joined) {
  std::vector<std::string> files;
  std::string s(paths_joined);
  size_t start = 0;
  while (start < s.size()) {
    size_t bar = s.find('|', start);
    if (bar == std::string::npos) {
      files.push_back(s.substr(start));
      break;
    }
    files.push_back(s.substr(start, bar - start));
    start = bar + 1;
  }
  static_cast<Dataset*>(ds)->SetFileList(std::move(files));
}

void ptds_dataset_set_trainer(void* ds, int trainer_id, int trainer_num) {
  static_cast<Dataset*>(ds)->SetTrainerInfo(trainer_id, trainer_num);
}

void ptds_dataset_load_into_memory(void* ds, int num_threads) {
  static_cast<Dataset*>(ds)->LoadIntoMemory(num_threads);
}

void ptds_dataset_local_shuffle(void* ds, uint64_t seed) {
  static_cast<Dataset*>(ds)->LocalShuffle(seed);
}

void ptds_dataset_global_shuffle(void* ds, uint64_t seed) {
  static_cast<Dataset*>(ds)->GlobalShuffle(seed);
}

int64_t ptds_dataset_size(void* ds) { return static_cast<Dataset*>(ds)->Size(); }

void ptds_dataset_release_memory(void* ds) {
  static_cast<Dataset*>(ds)->ReleaseMemory();
}

int ptds_dataset_last_error(void* ds, char* buf, int cap) {
  std::string e = static_cast<Dataset*>(ds)->last_error();
  int n = static_cast<int>(e.size());
  if (n >= cap) n = cap - 1;
  std::memcpy(buf, e.data(), n);
  buf[n] = 0;
  return n;
}

void* ptds_feeder_create(void* ds, int batch_size, int drop_last) {
  return new BatchFeeder(static_cast<Dataset*>(ds), batch_size,
                         drop_last != 0);
}

void ptds_feeder_destroy(void* f) { delete static_cast<BatchFeeder*>(f); }

int ptds_feeder_next(void* f) { return static_cast<BatchFeeder*>(f)->Next(); }

void ptds_feeder_reset(void* f) { static_cast<BatchFeeder*>(f)->Reset(); }

const float* ptds_feeder_dense(void* f, int slot) {
  return static_cast<BatchFeeder*>(f)->dense_data(slot);
}

const int64_t* ptds_feeder_sparse_ids(void* f, int slot) {
  return static_cast<BatchFeeder*>(f)->sparse_ids(slot);
}

const int64_t* ptds_feeder_sparse_lod(void* f, int slot) {
  return static_cast<BatchFeeder*>(f)->sparse_lod(slot);
}

int64_t ptds_feeder_sparse_len(void* f, int slot) {
  return static_cast<BatchFeeder*>(f)->sparse_len(slot);
}

// ---- parameter server ---------------------------------------------------

void* ptps_server_create(int port) { return new PsServer(port); }

void ptps_server_destroy(void* s) { delete static_cast<PsServer*>(s); }

void ptps_server_add_sparse_table(void* s, int32_t id, int32_t dim,
                                  int32_t opt, float lr, float init_range) {
  static_cast<PsServer*>(s)->AddSparseTable(
      id, dim, static_cast<PsOptimizer>(opt), lr, init_range);
}

void ptps_server_add_dense_table(void* s, int32_t id, int64_t size,
                                 int32_t opt, float lr) {
  static_cast<PsServer*>(s)->AddDenseTable(id, size,
                                           static_cast<PsOptimizer>(opt), lr);
}

void ptps_server_set_num_workers(void* s, int n) {
  static_cast<PsServer*>(s)->SetNumWorkers(n);
}

int ptps_server_start(void* s) {
  return static_cast<PsServer*>(s)->Start() ? 0 : -1;
}

int ptps_server_port(void* s) { return static_cast<PsServer*>(s)->port(); }

void ptps_server_stop(void* s) { static_cast<PsServer*>(s)->Stop(); }

int ptps_server_running(void* s) {
  return static_cast<PsServer*>(s)->running() ? 1 : 0;
}

uint64_t ptps_server_sparse_rows(void* s, int32_t table) {
  return static_cast<PsServer*>(s)->SparseRows(table);
}

int ptps_server_lost_workers(void* s, double timeout_sec, int32_t* out,
                             int cap) {
  auto lost = static_cast<PsServer*>(s)->LostWorkers(timeout_sec);
  int n = static_cast<int>(lost.size());
  if (n > cap) n = cap;
  std::memcpy(out, lost.data(), n * sizeof(int32_t));
  return n;
}

void ptps_server_evict_worker(void* s, int32_t wid) {
  static_cast<PsServer*>(s)->EvictWorker(wid);
}

void* ptps_client_create(const char* endpoints_joined) {
  std::vector<std::string> eps;
  std::string s(endpoints_joined);
  size_t start = 0;
  while (start < s.size()) {
    size_t bar = s.find('|', start);
    if (bar == std::string::npos) {
      eps.push_back(s.substr(start));
      break;
    }
    eps.push_back(s.substr(start, bar - start));
    start = bar + 1;
  }
  return new PsClient(std::move(eps));
}

void ptps_client_destroy(void* c) { delete static_cast<PsClient*>(c); }

int ptps_client_connect(void* c) {
  return static_cast<PsClient*>(c)->Connect() ? 0 : -1;
}

int ptps_client_last_error(void* c, char* buf, int cap) {
  std::string e = static_cast<PsClient*>(c)->last_error();
  int n = static_cast<int>(e.size());
  if (n >= cap) n = cap - 1;
  std::memcpy(buf, e.data(), n);
  buf[n] = 0;
  return n;
}

int ptps_client_pull_sparse(void* c, int32_t table, const uint64_t* ids,
                            uint64_t n, int32_t dim, float* out) {
  return static_cast<PsClient*>(c)->PullSparse(table, ids, n, dim, out) ? 0
                                                                        : -1;
}

int ptps_client_push_sparse(void* c, int32_t table, const uint64_t* ids,
                            uint64_t n, int32_t dim, const float* grads) {
  return static_cast<PsClient*>(c)->PushSparse(table, ids, n, dim, grads)
             ? 0
             : -1;
}

void ptps_client_set_connect_attempts(void* c, int attempts, int sleep_ms) {
  static_cast<PsClient*>(c)->SetConnectAttempts(attempts, sleep_ms);
}

void ptps_client_set_push_id(void* c, uint64_t id) {
  static_cast<PsClient*>(c)->SetPushId(id);
}

int ptps_client_broken_endpoints(void* c, int32_t* out, int cap) {
  return static_cast<PsClient*>(c)->BrokenEndpoints(out, cap);
}

int ptps_client_push_sparse_seq(void* c, int32_t table, uint64_t seq,
                                const uint64_t* ids, uint64_t n,
                                int32_t dim, const float* grads) {
  return static_cast<PsClient*>(c)->PushSparseSeq(table, seq, ids, n, dim,
                                                  grads)
             ? 0
             : -1;
}

int ptps_client_push_dense_seq(void* c, int32_t table, uint64_t seq,
                               const float* grads, uint64_t n) {
  return static_cast<PsClient*>(c)->PushDenseSeq(table, seq, grads, n)
             ? 0
             : -1;
}

int ptps_client_pull_dense(void* c, int32_t table, float* out, uint64_t n) {
  return static_cast<PsClient*>(c)->PullDense(table, out, n) ? 0 : -1;
}

int ptps_client_push_dense(void* c, int32_t table, const float* grads,
                           uint64_t n) {
  return static_cast<PsClient*>(c)->PushDense(table, grads, n) ? 0 : -1;
}

int ptps_client_init_dense(void* c, int32_t table, const float* vals,
                           uint64_t n) {
  return static_cast<PsClient*>(c)->InitDense(table, vals, n) ? 0 : -1;
}

int ptps_client_heartbeat(void* c, int32_t worker_id) {
  return static_cast<PsClient*>(c)->Heartbeat(worker_id) ? 0 : -1;
}

int ptps_client_barrier(void* c, int32_t worker_id) {
  return static_cast<PsClient*>(c)->Barrier(worker_id) ? 0 : -1;
}

int ptps_client_shrink(void* c, int32_t table, uint64_t min_updates) {
  return static_cast<PsClient*>(c)->Shrink(table, min_updates) ? 0 : -1;
}

int ptps_client_stop_servers(void* c) {
  return static_cast<PsClient*>(c)->SendStop() ? 0 : -1;
}

}  // extern "C"

// ---- inference C API ----------------------------------------------------
// Reference: paddle/fluid/inference/capi/c_api.h (PD_NewAnalysisConfig,
// PD_NewPredictor, PD_PredictorZeroCopyRun family). Backed by the native
// Program-IR interpreter (interp.h) — a C ABI a non-Python serving stack
// links against directly.
#include "interp.h"

namespace {

struct PdPredictor {
  // shared: Clone()d predictors serve the same loaded weights
  // (analysis_predictor.h:47 Clone contract); Model::run is const and
  // each call builds a private activation scope, so concurrent runs on
  // distinct PdPredictor handles are race-free
  std::shared_ptr<ptinterp::Model> model;
  std::map<std::string, ptinterp::Tensor> feeds;
  std::vector<ptinterp::Tensor> outputs;
  std::string last_error;
};

int dtype_code(npy::DType t) {
  switch (t) {
    case npy::DType::F32: return 0;
    case npy::DType::I64: return 1;
    case npy::DType::I32: return 2;
    case npy::DType::F64: return 3;
    case npy::DType::U8: return 4;
    case npy::DType::BOOL: return 5;
    case npy::DType::I8: return 6;
  }
  return 4;
}

npy::DType code_dtype(int c) {
  switch (c) {
    case 0: return npy::DType::F32;
    case 1: return npy::DType::I64;
    case 2: return npy::DType::I32;
    case 3: return npy::DType::F64;
    case 5: return npy::DType::BOOL;
    case 6: return npy::DType::I8;
    default: return npy::DType::U8;
  }
}

}  // namespace

extern "C" {

void* pd_predictor_create(const char* model_dir, const char* model_filename,
                          const char* params_filename, char* err,
                          int err_len) {
  try {
    auto model = std::make_shared<ptinterp::Model>(
        model_dir, model_filename ? model_filename : "",
        params_filename ? params_filename : "");
    auto* p = new PdPredictor;   // after the throwing ctor: no leak path
    p->model = std::move(model);
    return p;
  } catch (const std::exception& e) {
    if (err && err_len > 0) {
      std::strncpy(err, e.what(), err_len - 1);
      err[err_len - 1] = '\0';
    }
    return nullptr;
  }
}

void pd_predictor_destroy(void* h) {
  delete static_cast<PdPredictor*>(h);
}

void* pd_predictor_clone(void* h) {
  // share the Model (weights + parsed program); private feed/output
  // buffers per handle — the reference's Clone() semantics
  auto* p = new PdPredictor;
  p->model = static_cast<PdPredictor*>(h)->model;
  return p;
}

int pd_predictor_num_inputs(void* h) {
  return (int)static_cast<PdPredictor*>(h)->model->feed_names().size();
}

int pd_predictor_num_outputs(void* h) {
  return (int)static_cast<PdPredictor*>(h)->model->fetch_names().size();
}

const char* pd_predictor_input_name(void* h, int i) {
  return static_cast<PdPredictor*>(h)->model->feed_names()[i].c_str();
}

const char* pd_predictor_output_name(void* h, int i) {
  return static_cast<PdPredictor*>(h)->model->fetch_names()[i].c_str();
}

// zero-copy-in: caller's buffer is copied once into the feed tensor
int pd_predictor_set_input(void* h, const char* name, const void* data,
                           const int64_t* shape, int ndim, int dtype) {
  auto* p = static_cast<PdPredictor*>(h);
  ptinterp::Tensor t;
  t.dtype = code_dtype(dtype);
  t.shape.assign(shape, shape + ndim);
  size_t bytes = (size_t)t.numel() * npy::dtype_size(t.dtype);
  t.data.assign((const char*)data, (const char*)data + bytes);
  p->feeds[name] = std::move(t);
  return 0;
}

int pd_predictor_run(void* h) {
  auto* p = static_cast<PdPredictor*>(h);
  try {
    p->outputs = p->model->run(p->feeds);
    // feeds are per-request: clearing here makes a partial feed on the
    // NEXT run fail the interpreter's missing-feed check instead of
    // silently reusing stale inputs
    p->feeds.clear();
    return 0;
  } catch (const std::exception& e) {
    p->feeds.clear();
    p->last_error = e.what();
    return -1;
  }
}

int pd_predictor_last_error(void* h, char* buf, int len) {
  auto* p = static_cast<PdPredictor*>(h);
  if (buf && len > 0) {
    std::strncpy(buf, p->last_error.c_str(), len - 1);
    buf[len - 1] = '\0';
  }
  return (int)p->last_error.size();
}

// output introspection: shape then data pointer (valid until next run)
int pd_predictor_output_ndim(void* h, int i) {
  return (int)static_cast<PdPredictor*>(h)->outputs[i].shape.size();
}

void pd_predictor_output_shape(void* h, int i, int64_t* shape) {
  auto& t = static_cast<PdPredictor*>(h)->outputs[i];
  std::memcpy(shape, t.shape.data(), t.shape.size() * sizeof(int64_t));
}

int pd_predictor_output_dtype(void* h, int i) {
  return dtype_code(static_cast<PdPredictor*>(h)->outputs[i].dtype);
}

const void* pd_predictor_output_data(void* h, int i) {
  return static_cast<PdPredictor*>(h)->outputs[i].data.data();
}

}  // extern "C"
