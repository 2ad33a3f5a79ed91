// pt_train — Python-free training on a saved Program.
//
// Reference analogue: paddle/fluid/train/demo/demo_trainer.cc — load a
// ProgramDesc saved from Python, run the train loop from C++ with no
// Python in the process. Here: the JSON Program (with its `autodiff`
// backward marker and sgd/momentum ops) + params.npz; the interpreter's
// native reverse-mode pass evaluates the backward.
//
//   pt_train --model-dir DIR --loss LOSSVAR --steps N \
//            --input name=file.npy ... [--save-params out.npz-dir]
//
// Feeds are reused every step (the demo contract); prints one JSON line
// per step {"step": i, "loss": v} and a final summary line.
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

#include "interp.h"

int main(int argc, char** argv) {
  std::string model_dir, loss_name, model_filename, params_filename;
  std::string save_params;
  std::vector<std::pair<std::string, std::string>> inputs;
  int steps = 10;

  for (int i = 1; i < argc; ++i) {
    std::string a = argv[i];
    auto next = [&]() -> std::string {
      if (i + 1 >= argc) { std::fprintf(stderr, "missing value\n"); exit(2); }
      return argv[++i];
    };
    if (a == "--model-dir") model_dir = next();
    else if (a == "--loss") loss_name = next();
    else if (a == "--steps") steps = std::stoi(next());
    else if (a == "--model-filename") model_filename = next();
    else if (a == "--params-filename") params_filename = next();
    else if (a == "--save-params") save_params = next();
    else if (a == "--input") {
      std::string kv = next();
      size_t eq = kv.find('=');
      if (eq == std::string::npos) { std::fprintf(stderr, "bad --input\n"); return 2; }
      inputs.emplace_back(kv.substr(0, eq), kv.substr(eq + 1));
    } else {
      std::fprintf(stderr, "unknown arg %s\n", a.c_str());
      return 2;
    }
  }
  if (model_dir.empty() || loss_name.empty()) {
    std::fprintf(stderr,
                 "usage: pt_train --model-dir DIR --loss VAR --steps N "
                 "--input name=f.npy ...\n");
    return 2;
  }

  try {
    ptinterp::Model model(model_dir, model_filename, params_filename,
                          /*training=*/true);
    std::map<std::string, ptinterp::Tensor> feeds;
    for (auto& [name, path] : inputs) feeds[name] = npy::load_npy(path);

    std::map<std::string, ptinterp::Tensor> state;
    model.init_state(&state);
    std::vector<std::string> persistable_keys;
    for (auto& [k, v] : state) persistable_keys.push_back(k);

    double first = 0, last = 0;
    for (int s = 0; s < steps; ++s) {
      ptinterp::Tensor loss = model.train_step(&state, feeds, loss_name);
      double v = loss.dtype == npy::DType::F32
                     ? loss.f32()[0]
                     : *reinterpret_cast<double*>(loss.data.data());
      if (s == 0) first = v;
      last = v;
      std::printf("{\"step\": %d, \"loss\": %.6f}\n", s, v);
    }
    if (!save_params.empty()) {
      // persist only the original persistables (training filled the state
      // map with activations too) — numpy/load_persistables compatible
      std::map<std::string, npy::Array> out;
      for (auto& k : persistable_keys) out[k] = state.at(k);
      npy::save_npz(save_params, out);
    }
    std::printf("{\"ok\": true, \"steps\": %d, \"first_loss\": %.6f, "
                "\"last_loss\": %.6f%s}\n", steps, first, last,
                save_params.empty() ? "" : ", \"saved\": true");
    return 0;
  } catch (const std::exception& e) {
    std::fprintf(stderr, "pt_train: FAILED: %s\n", e.what());
    std::printf("{\"ok\": false, \"error\": \"%s\"}\n", e.what());
    return 1;
  }
}
