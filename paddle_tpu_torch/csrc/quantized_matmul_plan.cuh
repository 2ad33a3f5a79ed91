// K8's launch plan (quantized_matmul_plan.cu): its constants and entry
// point, shared by the kernel's launch (quantized_matmul.cu). Host code
// only.
#pragma once

constexpr int kK8SMs = 132;          // streaming multiprocessors of an H100 SXM
constexpr int kK8KTile = 64;         // k values per pipeline stage
constexpr int kK8MaxSplits = 16;
constexpr int kK8WoCounters = 256;   // arrival counters at the weight-only workspace's head

// tile_splits[0..2] = tile rows, tile columns, splits; *workspace_words =
// int32 words of the split-K workspace (0 without a split). Returns 0, or
// 1 on invalid arguments.
extern "C" int ptt_quantized_matmul_plan(int M, int K, int N, int int8_mode, int* tile_splits,
                                         long long* workspace_words);
