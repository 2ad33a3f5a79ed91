// K8's launch plan: the output tile, the split-K count and the int32
// workspace a call at (M, K, N) needs, in either mode. This file is the
// one copy of that rule: ptt_quantized_matmul launches by it, and its
// callers (the Python wrapper, native/src/aoti_ops.cc) size the
// workspace they hand over by it. Host code only, so g++ compiles it too
// (`g++ -x c++`).
//
//  * int8 mode: tiles of 32 x 64 up to M = 32 (the main path's batches),
//    else 64 x 256;
//  * weight-only mode: BM rows of x by 64 weight columns, BM the least of
//    8, 16, 32, 64 that holds M; above, 128 x 128 where those tiles fill
//    the card's 132 SMs, else 32 x 64;
//  * split-K: none when the output tiles alone fill the 132 SMs, else as
//    many k ranges as put one block on each SM, at most 16 and never
//    under two 64-k tiles each (8 at the ResNet-50 fc);
//  * workspace (split calls only): int8 mode M * N int32 sums, then one
//    arrival counter a tile; weight-only mode kWoCounters (256) arrival
//    counters (a split call has fewer tiles than SMs, so calls of every
//    shape share them), then splits x tiles x threads x BM / 2 float32
//    partial sums, threads = 2 x BN.
#include "quantized_matmul_plan.cuh"

#include <algorithm>

extern "C" int ptt_quantized_matmul_plan(int M, int K, int N, int int8_mode, int* tile_splits,
                                         long long* workspace_words) {
  if (M <= 0 || N <= 0 || K < 0 || tile_splits == nullptr || workspace_words == nullptr)
    return 1;
  int bm, bn;
  if (int8_mode) {
    bm = M <= 32 ? 32 : 64;
    bn = M <= 32 ? 64 : 256;
  } else {
    bm = M <= 8 ? 8 : M <= 16 ? 16 : M <= 32 ? 32 : M <= 64 ? 64 : 32;
    if (M > 64 && (long long)((M + 127) / 128) * ((N + 127) / 128) >= kK8SMs) bm = 128;
    bn = bm == 128 ? 128 : 64;
  }
  const long long tiles = (long long)((M + bm - 1) / bm) * ((N + bn - 1) / bn);
  int splits = 1;
  if (tiles < kK8SMs) {
    const long long k_tiles = (K + kK8KTile - 1) / kK8KTile;
    splits = static_cast<int>(
        std::max<long long>(1, std::min<long long>({kK8SMs / tiles, kK8MaxSplits, k_tiles / 2})));
  }
  long long words = 0;
  if (splits > 1)
    words = int8_mode ? (long long)M * N + tiles
                      : kK8WoCounters + (long long)splits * tiles * (2 * bn) * bm / 2;
  tile_splits[0] = bm;
  tile_splits[1] = bn;
  tile_splits[2] = splits;
  *workspace_words = words;
  return 0;
}
