// pt_aoti_run — run an AOTInductor package of an exported Program, no
// Python.
//
// The deployment path for the native tier of an `export_aot_bundle` rung
// (inference/export.py): the Program, its parameters held as constants,
// was exported with torch.export and compiled by AOTInductor into
// model.aoti.pt2; this binary loads that package through libtorch's
// AOTIModelPackageLoader, feeds .npy inputs and writes .npy outputs. It
// is the counterpart of the JAX package's pt_pjrt_run (StableHLO through
// a PJRT plugin), with the same command line but for the plugin:
//
//   pt_aoti_run --model-dir DIR --input name=in0.npy ... --output-dir OUT
//               [--repeat N]
//
// meta.json (written by the export) gives the feed order and the device;
// inputs are matched by name against it. A frozen int8 program calls K8,
// paddle_tpu_torch::fused_dequant_matmul, which aoti_ops.cc registers in
// this process. The last line of standard output is one JSON object:
// {"ok": true, "engine": "aoti", "repeat", "latency_ms_avg",
//  "latency_ms_best", "n_outputs", "device", "k8_launches"}, or
// {"ok": false, "error"} with exit code 1.
#include <ATen/ATen.h>
#include <torch/csrc/inductor/aoti_package/model_package_loader.h>
#include <torch/cuda.h>

#include <algorithm>
#include <chrono>
#include <cstdio>
#include <fstream>
#include <map>
#include <sstream>
#include <string>
#include <vector>

#include "minijson.h"
#include "npy.h"

extern "C" long long ptt_aoti_k8_launches();

namespace {

std::string json_escape(const std::string& s) {
  std::string out;
  for (char c : s) {
    switch (c) {
      case '"': out += "\\\""; break;
      case '\\': out += "\\\\"; break;
      case '\n': out += "\\n"; break;
      case '\r': out += "\\r"; break;
      case '\t': out += "\\t"; break;
      default:
        if ((unsigned char)c < 0x20) {
          char buf[8];
          snprintf(buf, sizeof(buf), "\\u%04x", c);
          out += buf;
        } else {
          out += c;
        }
    }
  }
  return out;
}

[[noreturn]] void die(const std::string& msg) {
  std::fprintf(stderr, "pt_aoti_run: FAILED: %s\n", msg.c_str());
  std::printf("{\"ok\": false, \"error\": \"%s\"}\n", json_escape(msg).c_str());
  exit(1);
}

std::string read_file(const std::string& path) {
  std::ifstream f(path, std::ios::binary);
  if (!f) die("cannot open " + path);
  std::ostringstream ss;
  ss << f.rdbuf();
  return ss.str();
}

at::ScalarType np_to_torch(npy::DType t) {
  switch (t) {
    case npy::DType::F32: return at::kFloat;
    case npy::DType::F64: return at::kDouble;
    case npy::DType::I32: return at::kInt;
    case npy::DType::I64: return at::kLong;
    case npy::DType::U8: return at::kByte;
    case npy::DType::BOOL: return at::kBool;
    case npy::DType::I8: return at::kChar;
  }
  return at::kFloat;
}

npy::DType torch_to_np(at::ScalarType t) {
  switch (t) {
    case at::kFloat: return npy::DType::F32;
    case at::kDouble: return npy::DType::F64;
    case at::kInt: return npy::DType::I32;
    case at::kLong: return npy::DType::I64;
    case at::kByte: return npy::DType::U8;
    case at::kBool: return npy::DType::BOOL;
    case at::kChar: return npy::DType::I8;
    default: die(std::string("unsupported output dtype ") + c10::toString(t));
  }
}

}  // namespace

int main(int argc, char** argv) {
  std::string model_dir, output_dir;
  int repeat = 1;
  std::vector<std::pair<std::string, std::string>> inputs;
  for (int i = 1; i < argc; ++i) {
    std::string a = argv[i];
    auto next = [&]() -> std::string {
      if (i + 1 >= argc) die("missing value for " + a);
      return argv[++i];
    };
    if (a == "--model-dir") model_dir = next();
    else if (a == "--output-dir") output_dir = next();
    else if (a == "--repeat") repeat = std::max(1, std::stoi(next()));
    else if (a == "--input") {
      std::string kv = next();
      auto eq = kv.find('=');
      if (eq == std::string::npos) die("--input needs name=path.npy");
      inputs.emplace_back(kv.substr(0, eq), kv.substr(eq + 1));
    } else {
      die("unknown argument " + a);
    }
  }
  if (model_dir.empty() || output_dir.empty())
    die("usage: pt_aoti_run --model-dir D --output-dir O --input name=f.npy ... [--repeat N]");

  // ---- meta: feed order and device ----
  std::shared_ptr<minijson::Value> meta;
  try {
    meta = minijson::parse(read_file(model_dir + "/meta.json"));
  } catch (const std::exception& e) {
    die(std::string("meta.json: ") + e.what());
  }
  if (!meta->has("feed_order"))
    die("meta.json has no feed_order (the feed order cannot be recovered from a JSON object)");
  std::vector<std::string> feed_order;
  for (auto& v : meta->at("feed_order")->as_arr()) feed_order.push_back(v->as_str());
  const std::string device_name = meta->get_str("device", "cpu");
  const at::Device device(device_name == "cuda" ? at::kCUDA : at::kCPU);

  // ---- inputs, in feed order, on the package's device ----
  std::map<std::string, std::string> in_paths(inputs.begin(), inputs.end());
  std::vector<at::Tensor> args;
  try {
    for (auto& name : feed_order) {
      auto it = in_paths.find(name);
      if (it == in_paths.end()) die("missing --input for feed '" + name + "'");
      npy::Array arr = npy::load_npy(it->second);
      at::Tensor host = at::from_blob(arr.data.data(), arr.shape,
                                      at::TensorOptions().dtype(np_to_torch(arr.dtype)))
                            .clone();
      args.push_back(host.to(device));
    }
  } catch (const std::exception& e) {
    die(std::string("inputs: ") + e.what());
  }

  // ---- load and run ----
  std::vector<at::Tensor> outs;
  double best_ms = 1e30, total_ms = 0;
  try {
    torch::inductor::AOTIModelPackageLoader loader(model_dir + "/model.aoti.pt2");
    for (int r = 0; r < repeat; ++r) {
      auto t0 = std::chrono::steady_clock::now();
      outs = loader.run(args);
      if (device.is_cuda()) torch::cuda::synchronize();
      double ms = std::chrono::duration<double, std::milli>(std::chrono::steady_clock::now() - t0)
                      .count();
      best_ms = std::min(best_ms, ms);
      total_ms += ms;
    }
  } catch (const std::exception& e) {
    die(std::string("run: ") + e.what());
  }

  // ---- outputs ----
  std::ofstream idx(output_dir + "/outputs.json");
  idx << "{\"fetches\": [";
  for (size_t i = 0; i < outs.size(); ++i) {
    at::Tensor host = outs[i].to(at::kCPU).contiguous();
    npy::Array out;
    out.dtype = torch_to_np(host.scalar_type());
    out.shape.assign(host.sizes().begin(), host.sizes().end());
    const char* p = static_cast<const char*>(host.data_ptr());
    out.data.assign(p, p + host.numel() * host.element_size());
    std::string fname = "out_" + std::to_string(i) + ".npy";
    npy::save_npy(output_dir + "/" + fname, out);
    idx << (i ? ", " : "") << "{\"file\": \"" << fname << "\"}";
  }
  idx << "]}\n";

  std::printf(
      "{\"ok\": true, \"engine\": \"aoti\", \"repeat\": %d, \"latency_ms_avg\": %.6f, "
      "\"latency_ms_best\": %.6f, \"n_outputs\": %zu, \"device\": \"%s\", \"k8_launches\": %lld}\n",
      repeat, total_ms / repeat, best_ms, outs.size(), device_name.c_str(),
      ptt_aoti_k8_launches());
  return 0;
}
