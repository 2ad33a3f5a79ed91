// Native Program-IR interpreter — the C++ inference engine.
//
// Reference analogue: the C++ AnalysisPredictor executing a ProgramDesc
// op-by-op with native kernels (paddle/fluid/inference/api/
// analysis_predictor.h:47, framework/naive_executor.cc:40). Our IR is the
// JSON Program written by static/io.py save_inference_model; this engine
// loads __model__.json + the .npz params and serves feeds→fetches with
// no Python anywhere in the process.
//
// The TPU serving path is separate: export_stablehlo + PJRT (see
// pjrt_runner.cc). This interpreter is the portable CPU fallback — the
// same role the reference's native CPU kernels play for serving.
#pragma once
#include <map>
#include <memory>
#include <string>
#include <vector>

#include "npy.h"

namespace ptinterp {

using Tensor = npy::Array;

struct ModelImpl;

class Model {
 public:
  // model_dir must contain __model__.json + params (npz). Throws
  // std::runtime_error on malformed/unsupported programs.
  // `training=true` admits the training op set (autodiff/sgd/…): the
  // `autodiff` meta-op is executed by a native reverse-mode pass over
  // the recorded forward ops (demo_trainer.cc parity — Python-free
  // training on the saved Program).
  explicit Model(const std::string& model_dir,
                 const std::string& model_filename = "",
                 const std::string& params_filename = "",
                 bool training = false);
  ~Model();

  const std::vector<std::string>& feed_names() const;
  const std::vector<std::string>& fetch_names() const;

  // Run the global block; returns fetches in fetch_names() order.
  std::vector<Tensor> run(const std::map<std::string, Tensor>& feeds) const;

  // Training API: persistent state lives in `state` (seeded from the
  // loaded params via init_state). Each step feeds one batch, runs the
  // whole block (forward + autodiff + optimizer ops) mutating `state`,
  // and returns the value of `fetch` (e.g. the loss var).
  void init_state(std::map<std::string, Tensor>* state) const;
  Tensor train_step(std::map<std::string, Tensor>* state,
                    const std::map<std::string, Tensor>& feeds,
                    const std::string& fetch) const;

 private:
  std::unique_ptr<ModelImpl> impl_;
};

}  // namespace ptinterp
