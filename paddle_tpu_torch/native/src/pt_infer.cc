// pt_infer — standalone native inference CLI (no Python in the process).
//
// Reference analogue: the C++ inference demos
// (paddle/fluid/inference/api/demo_ci/simple_on_word2vec.cc, and
// train/demo/demo_trainer.cc for the Python-free execution story).
//
//   pt_infer --model-dir DIR [--model-filename F] [--params-filename F]
//            --input name=path.npy ... --output-dir DIR
//            [--repeat N] [--engine interp]
//
// Reads feeds from .npy files, runs the native Program-IR interpreter,
// writes each fetch as <output-dir>/out_<i>.npy + an outputs.json index,
// and prints one JSON line with latency stats (the analyzer_*_tester.cc
// role: parity inputs/outputs + latency measurement in one binary).
#include <chrono>
#include <cstdio>
#include <cstring>
#include <fstream>
#include <iostream>
#include <string>
#include <vector>

#include "interp.h"

namespace {

void usage() {
  std::fprintf(stderr,
               "usage: pt_infer --model-dir DIR --input name=file.npy ... "
               "--output-dir DIR [--model-filename F] [--params-filename F] "
               "[--repeat N]\n");
}

}  // namespace

int main(int argc, char** argv) {
  std::string model_dir, model_filename, params_filename, output_dir;
  std::vector<std::pair<std::string, std::string>> inputs;
  int repeat = 1;

  for (int i = 1; i < argc; ++i) {
    std::string a = argv[i];
    auto next = [&]() -> std::string {
      if (i + 1 >= argc) { usage(); exit(2); }
      return argv[++i];
    };
    if (a == "--model-dir") model_dir = next();
    else if (a == "--model-filename") model_filename = next();
    else if (a == "--params-filename") params_filename = next();
    else if (a == "--output-dir") output_dir = next();
    else if (a == "--repeat") repeat = std::stoi(next());
    else if (a == "--engine") {
      std::string e = next();
      if (e != "interp") {
        std::fprintf(stderr, "pt_infer: unknown engine '%s' "
                     "(StableHLO/PJRT serving uses pt_pjrt_run)\n",
                     e.c_str());
        return 2;
      }
    } else if (a == "--input") {
      std::string kv = next();
      size_t eq = kv.find('=');
      if (eq == std::string::npos) { usage(); return 2; }
      inputs.emplace_back(kv.substr(0, eq), kv.substr(eq + 1));
    } else {
      usage();
      return 2;
    }
  }
  if (model_dir.empty() || output_dir.empty()) { usage(); return 2; }

  try {
    ptinterp::Model model(model_dir, model_filename, params_filename);

    std::map<std::string, ptinterp::Tensor> feeds;
    for (auto& [name, path] : inputs) feeds[name] = npy::load_npy(path);

    // warmup + timed runs (analyzer tester convention)
    std::vector<ptinterp::Tensor> outs = model.run(feeds);
    double best_ms = 1e30, total_ms = 0;
    for (int r = 0; r < repeat; ++r) {
      auto t0 = std::chrono::steady_clock::now();
      outs = model.run(feeds);
      double ms = std::chrono::duration<double, std::milli>(
                      std::chrono::steady_clock::now() - t0).count();
      best_ms = std::min(best_ms, ms);
      total_ms += ms;
    }

    std::ofstream idx(output_dir + "/outputs.json");
    idx << "{\"fetches\": [";
    for (size_t i = 0; i < outs.size(); ++i) {
      std::string fname = "out_" + std::to_string(i) + ".npy";
      npy::save_npy(output_dir + "/" + fname, outs[i]);
      idx << (i ? ", " : "") << "{\"name\": \"" << model.fetch_names()[i]
          << "\", \"file\": \"" << fname << "\"}";
    }
    idx << "]}\n";

    std::printf("{\"ok\": true, \"engine\": \"interp\", \"repeat\": %d, "
                "\"latency_ms_avg\": %.3f, \"latency_ms_best\": %.3f, "
                "\"n_outputs\": %zu}\n",
                repeat, total_ms / repeat, best_ms, outs.size());
    return 0;
  } catch (const std::exception& e) {
    std::fprintf(stderr, "pt_infer: FAILED: %s\n", e.what());
    std::printf("{\"ok\": false, \"error\": \"%s\"}\n", e.what());
    return 1;
  }
}
