// Decode attention for Hopper (sm_90a): kernels K5, K6 and K7 of the port.
//
// K5  ptt_decode_attention_f32 replaces
//     paddle_tpu/ops/pallas/flash_attention.py::_decode_kernel
//     (launched by flash_decode_attention): one query row per slot
//     against a contiguous cache [B, S, N, D], keys < lengths[b].
// K6  ptt_paged_decode_attention_f32 replaces
//     paddle_tpu/ops/pallas/flash_attention.py::_paged_decode_kernel
//     (launched by flash_paged_decode_attention): a chunk of C query rows
//     per slot against block pools [NB, bs, N, D] through block tables
//     [B, M]; row c attends to positions < lengths[b] + c + 1. Every C is
//     covered (the TPU kernel stopped at C <= 8). Two kernels split the
//     chunk sizes as K7's do: ptt_paged_decode_attention_f32 on the CUDA
//     cores (f32_decode_kernel, K5's kernel) takes decode ticks and
//     chunks below the wrapper's PAGED_TC_MIN_C, and
//     ptt_paged_prefill_attention_f32 on the bf16 tensor cores the
//     verify and prefill chunks (see paged_prefill_tc_kernel below).
// K7  ptt_quantized_paged_decode_attention replaces
//     paddle_tpu/ops/pallas/flash_attention.py::_quantized_paged_decode_kernel
//     (launched by flash_quantized_paged_decode_attention): K6 over pools
//     whose payload is int8 or float8 e4m3 (one byte an element), with one
//     float32 scale per pool row [NB, bs] and side (payload * scale ==
//     value). The scales fold where the TPU kernel folds them: s_k into
//     the logits, s = (q . k_q) * s_k * scale, and s_v into the
//     probabilities, acc += (p * s_v) * v_q, with l summing p itself. No
//     dequantized window exists anywhere. Two kernels split the chunk
//     sizes: ptt_quantized_paged_decode_attention on the CUDA cores
//     takes decode ticks (C = 1 only), and
//     ptt_quantized_paged_prefill_attention on the bf16 tensor cores
//     takes every C > 1 (verify and prefill chunks; see
//     qattn_prefill_tc_kernel below).
//
// What bounds them on this card: bytes. A decode row does 2 flops per
// key element it reads (q.k and p.v), far below the ~20 flops/byte where
// the H100's float32 CUDA-core rate (67 TFLOP/s) would take over from
// its 3.35 TB/s of HBM. Large prefill chunks (C in the hundreds) reuse
// each key across C rows and move toward the operation bound.
//
// K7 reads a quarter of K6's bytes for the same keys, so it sits at the
// same arithmetic per key with 4x less traffic: still bytes for decode.
//
// What the design does about it (f32_decode_kernel, K5 and K6's decode
// route; the other kernels below say what they do differently):
//  * One launch a call and no buffer a call. The keys of a (slot, head,
//    row tile) are striped in stages over a number of blocks set by the
//    window's capacity (S, or M * bs), not by its length: a block knows
//    its keys before the length arrives. The blocks of a tile are one
//    thread-block cluster and merge inside the same launch through
//    distributed shared memory, in block order (deterministic).
//  * Keys in flight: a group of D/4 lanes owns U = 4 keys of a stage and
//    copies their K and V rows (one float4 a lane, coalesced) into a
//    shared-memory ring by cp.async, 16 KB a stage, the next stage in
//    flight while a stage's softmax step runs. The length, q and the
//    first stages' table entries come in one round of loads before that.
//  * Every K/V byte of a window is read once per row tile, and every
//    key serves all CR <= 4 query rows of the tile; nothing beyond
//    lengths[b] (+c+1) is read, and a block with no stage below its
//    rows' limit issues no key load. No [B, N, S] logits reach device
//    memory; the softmax state (m, l, acc) stays in f32 registers, in
//    log2 units (log2 e folded into the scale, exp2f).
//  * The paged kernels look up their own table entries (the TPU
//    kernel's scalar prefetch has no counterpart here); entries are
//    clamped into [0, NB) as XLA's gather clamps, and loaded before the
//    keys that need them (K5/K6's decode kernel: a stage's entries in
//    registers while the stage before it is in flight; K7's decode kernel
//    and K6's chunk kernel: in shared memory).
//  * The chunk kernels (C >= 2 for K7, C >= PAGED_TC_MIN_C for K6) run
//    flash-decoding split-K with ranges cut from the length and a
//    second small kernel (attn_combine_kernel) to combine them.
//  * K7's decode kernel gives each lane 16 payload bytes of a key row in
//    one load (D / 16 lanes share a key) and converts them to float in
//    registers; a key's two scales are one broadcast load each for its
//    lane group.
//
// A window with no keys (length 0) writes zeros, as the Pallas kernels
// and the JAX references do. Masked logits in the references are -1e30,
// so they contribute exp(-1e30 - m) == 0 exactly; skipping them here is
// the same arithmetic.
//
// Plain C interface, loaded with ctypes: every function returns the
// cudaError_t of its launches (0 on success). Nothing here allocates or
// synchronises; the caller owns the outputs, the partial buffers and the
// stream.

#include <cooperative_groups.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>

#include "tc_common.cuh"

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 128;

struct Args {
  const float* q;
  const float* k;
  const float* v;
  const int* tables;   // [B, M] block ids; unused by the contiguous kernel
  const int* lengths;  // [B]
  float* out;          // [B, C, N, D] contiguous
  float* part_m;       // [B*C*N, nsplit]
  float* part_l;       // [B*C*N, nsplit]
  float* part_acc;     // [B*C*N, nsplit, D]
  int B, C, N, M, bs, nb;
  int cap;             // keys a window can hold: S, or M * bs
  int causal;          // 1: row c sees lengths[b] + c + 1 keys; 0: lengths[b]
  long long q_sb, q_sc, q_sn;
  long long k_sb, k_ss, k_sn;  // contiguous: batch/seq/head; paged: block/offset/head
  long long v_sb, v_ss, v_sn;
  int nsplit;
  float scale;
  // K7 only: 1-byte payloads and their per-row scales [NB, bs]
  const unsigned char* kq;
  const unsigned char* vq;
  const float* k_scale;
  const float* v_scale;
  long long ks_sb, vs_sb;  // row strides of the scale arrays
  // K7's decode route: arrival counters [B * N] and partial records
  // [B * N][nsplit][D + 4], zero between launches
  int* counters;
  float* records;
};

__device__ __forceinline__ float4 load4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

__device__ __forceinline__ float dot4(float4 a, float4 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
}

// Sum over the G lanes of one key group (aligned sub-warp of G lanes).
template <int G>
__device__ __forceinline__ float group_sum(float x, unsigned mask) {
#pragma unroll
  for (int off = G / 2; off > 0; off >>= 1) x += __shfl_xor_sync(mask, x, off);
  return x;
}

// grid: ceil(rows / (kThreads / G)); one key group per output row.
template <int D>
__global__ void __launch_bounds__(kThreads) attn_combine_kernel(Args a, long long rows) {
  constexpr int G = D / 4;
  const long long row = (long long)blockIdx.x * (kThreads / G) + threadIdx.x / G;
  const int ln = threadIdx.x % G;
  if (row >= rows) return;
  const float* pm = a.part_m + row * a.nsplit;
  const float* pl = a.part_l + row * a.nsplit;
  float mx = kNegInf;
  for (int s = 0; s < a.nsplit; ++s) mx = fmaxf(mx, pm[s]);
  float lsum = 0.f;
  float4 as = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int s = 0; s < a.nsplit; ++s) {
    const float w = expf(pm[s] - mx);
    const float4 x = reinterpret_cast<const float4*>(a.part_acc + (row * a.nsplit + s) * D)[ln];
    lsum += pl[s] * w;
    as.x += x.x * w;
    as.y += x.y * w;
    as.z += x.z * w;
    as.w += x.w * w;
  }
  const float inv = lsum > 0.f ? 1.f / lsum : 0.f;
  reinterpret_cast<float4*>(a.out + row * D)[ln] =
      make_float4(as.x * inv, as.y * inv, as.z * inv, as.w * inv);
}

// After a chunk kernel: the combine pass when the keys were split.
template <int D>
cudaError_t combine(const Args& a, cudaStream_t stream) {
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || a.nsplit == 1) return err;
  const long long rows = (long long)a.B * a.C * a.N;
  const long long per_block = kThreads / (D / 4);
  attn_combine_kernel<D><<<(unsigned)((rows + per_block - 1) / per_block), kThreads, 0,
                           stream>>>(a, rows);
  return cudaGetLastError();
}

bool bad_grid(const Args& a) {
  return a.B <= 0 || a.C <= 0 || a.N <= 0 || a.nsplit <= 0 || a.B * a.N > 65535 ||
         (a.C + 7) / 8 > 65535;
}

// ---------------------------------------------------------------------------
// K5 and K6's decode route: f32 on the CUDA cores, one launch a call
// ---------------------------------------------------------------------------
//
// f32_decode_kernel<D, CR, PAGED>: one block a (head, split, row tile
// of CR <= 4 rows of a slot); grid (N, nsplit, B * ceil(C / CR)), the
// heads of a split neighbouring blocks. The window is walked in stages
// of KS keys (16 KB of f32 K and V), striped over the nsplit blocks of a
// tile: block s takes stages s, s + nsplit, ... (nsplit from the
// capacity: the wrapper's f32_decode_split_count, 4 for a 1024-key
// window at D = 64). So a block knows its keys before the length
// arrives, and every window of nsplit stages or more spreads over all of
// the tile's blocks (contiguous ranges cut from the capacity leave a
// window shorter than the capacity on fewer blocks, each with a longer
// chain of stages; on the card that made the decode step's K5 calls
// slower). Each lane copies its
// own 16-byte chunks of a stage with cp.async into a two-stage ring in
// shared memory and reads back only what it copied, so the ring needs
// no barrier, and the next stage is in flight while a stage's softmax
// step runs. Blocks past the window's last stage issue no key load.
//
// The nsplit blocks of a tile are one thread-block cluster (launch
// attribute, up to 16 blocks): each leaves its (m, l, acc) record in its
// shared memory, and after a cluster barrier rank 0 reads the active
// blocks' records through distributed shared memory, merges them in
// block order (two calls give the same bits) and writes the rows. No
// workspace, no counter and no global round trip: on the card this
// merge ran as fast as a last-block merge through a zeroed workspace
// (K7's) at C = 1 and faster at C = 2 (PERF.md).
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kF32Splits = 16;  // blocks a tile may have: a cluster's most

template <int D, int CR>
struct F32Decode {
  static constexpr int G = D / 4;          // lanes a key (one float4 each)
  static constexpr int NG = kThreads / G;  // key groups a block
  static constexpr int U = 4;              // keys a group takes a stage
  static constexpr int KS = NG * U;        // keys a stage: 16 KB of K and V
  static constexpr int STAGE = 2 * KS * G; // float4s a stage: K, then V
  static constexpr int SMEM = 2 * STAGE * 16;  // the ring's bytes: two stages
  // the merge's scratch, in the ring once the keys are done
  static_assert(NG * CR * (G * 16 + 8) <= SMEM, "merge scratch exceeds the ring");
};

// query rows a block serves for a chunk of c rows
constexpr int f32_tile_rows(int c) { return c == 1 ? 1 : (c == 2 ? 2 : 4); }

// where this lane's keys of stage g sit: (block, offset) of key
// g * KS + u * NG + grp through slot b's table (clamped into [0, NB)),
// or the contiguous cache's position; keys past the capacity read
// nothing later
template <int D, int CR, bool PAGED>
struct StageKeys {
  int blk[F32Decode<D, CR>::U], off[F32Decode<D, CR>::U];
  __device__ __forceinline__ void load(const Args& a, int b, int g) {
    using P = F32Decode<D, CR>;
    const int grp = threadIdx.x / P::G;
#pragma unroll
    for (int u = 0; u < P::U; ++u) {
      const int p = g * P::KS + u * P::NG + grp;
      blk[u] = b;
      off[u] = p;
      if constexpr (PAGED) {
        const int e = p / a.bs;
        int raw = p < a.cap ? __ldg(a.tables + (long long)b * a.M + e) : 0;
        blk[u] = raw < 0 ? 0 : (raw >= a.nb ? a.nb - 1 : raw);
        off[u] = p - e * a.bs;
      }
    }
  }
};

// this lane's chunks of stage g (keys from k_hi on zero-filled, which
// reads nothing) into ring slot `slot`, as one cp.async group
template <int D, int CR, bool PAGED>
__device__ __forceinline__ void issue_f32_stage(const Args& a, int n, int g, int k_hi,
                                                const StageKeys<D, CR, PAGED>& keys,
                                                float4* slot) {
  using P = F32Decode<D, CR>;
  const int grp = threadIdx.x / P::G, lane = threadIdx.x % P::G;
#pragma unroll
  for (int u = 0; u < P::U; ++u) {
    const int key = u * P::NG + grp;
    const bool ok = g * P::KS + key < k_hi;
    long long ko = 0, vo = 0;
    if (ok) {
      ko = (long long)keys.blk[u] * a.k_sb + (long long)keys.off[u] * a.k_ss +
           (long long)n * a.k_sn + lane * 4;
      vo = (long long)keys.blk[u] * a.v_sb + (long long)keys.off[u] * a.v_ss +
           (long long)n * a.v_sn + lane * 4;
    }
    cp_async16(smem_u32(slot + key * P::G + lane), a.k + ko, ok);
    cp_async16(smem_u32(slot + (P::KS + key) * P::G + lane), a.v + vo, ok);
  }
  cp_async_commit();
}

// __launch_bounds__: six blocks an SM (<= 80 registers) for one row,
// five for two (80 spilled at D = 128), three for four
template <int D, int CR, bool PAGED>
__global__ void __launch_bounds__(kThreads, CR == 1 ? 6 : (CR == 2 ? 5 : 3))
    f32_decode_kernel(const Args a) {
  namespace cg = cooperative_groups;
  using P = F32Decode<D, CR>;
  constexpr int G = P::G, NG = P::NG, U = P::U, KS = P::KS;
  extern __shared__ float4 ring[];        // [2][K, V][KS][G]
  __shared__ float rec_m[CR], rec_l[CR];  // this block's record
  __shared__ float4 rec_acc[CR][G];
  __shared__ float all_m[kF32Splits][CR], all_l[kF32Splits][CR];
  // the heads of a (slot, split) are neighbouring blocks: they read the
  // same key positions at the same time
  const int n = blockIdx.x, split = blockIdx.y, nsplit = gridDim.y;
  const int tiles = gridDim.z / a.B;
  const int b = blockIdx.z / tiles, r0 = blockIdx.z % tiles * CR;
  const int tid = threadIdx.x, grp = tid / G, lane = tid % G;
  const unsigned gmask =
      (G == 32) ? 0xffffffffu : (((1u << G) - 1u) << ((tid % 32) / G * G));
  const float scale = a.scale * kLog2e;  // logits in log2 units

  // this block's stages (split, split + nsplit, ...) are known before
  // anything is loaded; one round of loads: the length, q and (paged)
  // the table entries of its first three stages
  int len = a.lengths[b];
  float4 qv[CR];
#pragma unroll
  for (int r = 0; r < CR; ++r)
    qv[r] = r0 + r < a.C ? load4(a.q + (long long)b * a.q_sb + (long long)(r0 + r) * a.q_sc +
                                 (long long)n * a.q_sn + lane * 4)
                         : make_float4(0.f, 0.f, 0.f, 0.f);
  StageKeys<D, CR, PAGED> k0, k1, k2;
  k0.load(a, b, split);
  k1.load(a, b, split + nsplit);
  k2.load(a, b, split + 2 * nsplit);
  len = max(len, 0);
  int lim[CR];
  int k_hi = 0;
#pragma unroll
  for (int r = 0; r < CR; ++r) {
    lim[r] = r0 + r < a.C ? min(len + (a.causal ? r0 + r + 1 : 0), a.cap) : 0;
    k_hi = max(k_hi, lim[r]);
  }
  // stages of the tile's window, and the blocks that hold some (at least
  // one: an empty window writes zeros)
  const int stages = (k_hi + KS - 1) / KS;
  const int active = max(1, min(nsplit, stages));
  cg::cluster_group cluster = cg::this_cluster();
  if (split >= active) {  // no key load, no record: only the barriers
    cluster.sync();
    cluster.sync();
    return;
  }
  const int mine = (stages - split + nsplit - 1) / nsplit;  // this block's stages

  // two stages in flight: every lane copies its own chunks and reads
  // back only those, so the ring needs no barrier
  if (mine > 0) issue_f32_stage<D, CR, PAGED>(a, n, split, k_hi, k0, ring);
  if (mine > 1) issue_f32_stage<D, CR, PAGED>(a, n, split + nsplit, k_hi, k1, ring + P::STAGE);
  float m[CR], l[CR];
  float4 acc[CR];
#pragma unroll
  for (int r = 0; r < CR; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
    acc[r] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  for (int j = 0; j < mine; ++j) {
    const int s0 = (split + j * nsplit) * KS;
    const int s_hi = min(s0 + KS, k_hi);
    float4* slot = ring + (j & 1) * P::STAGE;
    if (j + 1 < mine)
      cp_async_wait<1>();  // this lane's chunks of stage j are in
    else
      cp_async_wait<0>();
    float4 kk[U], vv[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      kk[u] = slot[(u * NG + grp) * G + lane];
      vv[u] = slot[(KS + u * NG + grp) * G + lane];
    }
#pragma unroll
    for (int r = 0; r < CR; ++r) {
      const int hi = min(s_hi, lim[r]);
      if (s0 >= hi) continue;  // uniform over the block
      float s[U];
      float mnew = m[r];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        s[u] = group_sum<G>(dot4(qv[r], kk[u]), gmask) * scale;
        if (s0 + u * NG + grp < hi) mnew = fmaxf(mnew, s[u]);
      }
      const float corr = exp2f(m[r] - mnew);
      float psum = 0.f;
      float4 av = make_float4(acc[r].x * corr, acc[r].y * corr, acc[r].z * corr,
                              acc[r].w * corr);
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const float pr = s0 + u * NG + grp < hi ? exp2f(s[u] - mnew) : 0.f;
        psum += pr;
        av.x += pr * vv[u].x;
        av.y += pr * vv[u].y;
        av.z += pr * vv[u].z;
        av.w += pr * vv[u].w;
      }
      acc[r] = av;
      l[r] = l[r] * corr + psum;
      m[r] = mnew;
    }
    // the slot is read: stage j + 2 takes it, and the table entries of
    // stage j + 3 come in while it flies
    if (j + 2 < mine) {
      issue_f32_stage<D, CR, PAGED>(a, n, split + (j + 2) * nsplit, k_hi, k2, slot);
      k2.load(a, b, split + (j + 3) * nsplit);
    }
  }

  // this block's record: the NG key groups merged through the ring's
  // space; thread (r, c4) < CR * G owns float4 column c4 of row r
  __syncthreads();
  float4* sm_acc = ring;                                      // [NG][CR][G]
  float* sm_m = reinterpret_cast<float*>(ring + NG * CR * G);  // [NG][CR]
  float* sm_l = sm_m + NG * CR;
#pragma unroll
  for (int r = 0; r < CR; ++r) {
    if (lane == 0) {
      sm_m[grp * CR + r] = m[r];
      sm_l[grp * CR + r] = l[r];
    }
    sm_acc[(grp * CR + r) * G + lane] = acc[r];
  }
  __syncthreads();
  const int rr = tid / G, c4 = tid % G;
  const bool owner = tid < CR * G;
  float mx = kNegInf, lsum = 0.f;
  float4 as = make_float4(0.f, 0.f, 0.f, 0.f);
  if (owner) {
#pragma unroll
    for (int g = 0; g < NG; ++g) mx = fmaxf(mx, sm_m[g * CR + rr]);
#pragma unroll
    for (int g = 0; g < NG; ++g) {
      const float w = exp2f(sm_m[g * CR + rr] - mx);
      const float4 x = sm_acc[(g * CR + rr) * G + c4];
      lsum += sm_l[g * CR + rr] * w;
      as.x += x.x * w;
      as.y += x.y * w;
      as.z += x.z * w;
      as.w += x.w * w;
    }
  }
  const int row = r0 + rr;
  float4* dst = reinterpret_cast<float4*>(a.out + (((long long)b * a.C + row) * a.N + n) * D);
  const bool writes = owner && row < a.C;

  if (owner) {
    rec_acc[rr][c4] = as;
    if (c4 == 0) {
      rec_m[rr] = mx;
      rec_l[rr] = lsum;
    }
  }
  cluster.sync();  // every active range's record is in its block
  if (split == 0) {
    if (tid < active * CR) {
      const int s = tid / CR, r = tid % CR;
      all_m[s][r] = cluster.map_shared_rank(rec_m, s)[r];
      all_l[s][r] = cluster.map_shared_rank(rec_l, s)[r];
    }
    __syncthreads();
    if (writes) {
      mx = kNegInf;
      for (int s = 0; s < active; ++s) mx = fmaxf(mx, all_m[s][rr]);
      lsum = 0.f;
      as = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int s = 0; s < active; ++s) {
        const float w = exp2f(all_m[s][rr] - mx);
        const float4 x = cluster.map_shared_rank(&rec_acc[0][0], s)[rr * G + c4];
        lsum += all_l[s][rr] * w;
        as.x += x.x * w;
        as.y += x.y * w;
        as.z += x.z * w;
        as.w += x.w * w;
      }
      const float inv = lsum > 0.f ? 1.f / lsum : 0.f;
      dst[c4] = make_float4(as.x * inv, as.y * inv, as.z * inv, as.w * inv);
    }
  }
  cluster.sync();  // rank 0 has read every record: the blocks may exit
}

template <int D, int CR, bool PAGED>
cudaError_t launch_f32_decode_d(const Args& a, cudaStream_t stream) {
  const dim3 grid(a.N, a.nsplit, a.B * ((a.C + CR - 1) / CR));
  const int bytes = F32Decode<D, CR>::SMEM;
  void (*kernel)(const Args) = f32_decode_kernel<D, CR, PAGED>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess && a.nsplit > 8)  // 9-16 blocks: a non-portable cluster size
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = a.nsplit;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, a);
}

template <int CR, bool PAGED>
cudaError_t launch_f32_decode_cr(const Args& a, int d, cudaStream_t stream) {
  switch (d) {
    case 32: return launch_f32_decode_d<32, CR, PAGED>(a, stream);
    case 64: return launch_f32_decode_d<64, CR, PAGED>(a, stream);
    case 128: return launch_f32_decode_d<128, CR, PAGED>(a, stream);
    default: return cudaErrorInvalidValue;
  }
}

// K5 (contiguous, C = 1) and K6's decode route (paged, any C; CR rows a
// tile): one launch, nsplit blocks a tile.
cudaError_t launch_f32_decode(Args a, int d, cudaStream_t stream) {
  const int cr = f32_tile_rows(a.C);
  if (bad_grid(a) || a.nsplit > kF32Splits ||
      (long long)a.B * ((a.C + cr - 1) / cr) > 65535)
    return cudaErrorInvalidValue;
  const bool paged = a.tables != nullptr;
  if (!paged)
    return a.C == 1 ? launch_f32_decode_cr<1, false>(a, d, stream) : cudaErrorInvalidValue;
  switch (cr) {
    case 1: return launch_f32_decode_cr<1, true>(a, d, stream);
    case 2: return launch_f32_decode_cr<2, true>(a, d, stream);
    default: return launch_f32_decode_cr<4, true>(a, d, stream);
  }
}

// ---------------------------------------------------------------------------
// K7: paged attention over 1-byte payloads with per-row scales
// ---------------------------------------------------------------------------

// Elements 2j and 2j + 1 of 16 payload bytes held as one uint4, as the
// values they store (int8, or float8 e4m3 with its subnormals), exactly
template <bool FP8>
__device__ __forceinline__ float2 payload_pair(const uint4& r, int j) {
  const unsigned w = j < 2 ? r.x : (j < 4 ? r.y : (j < 6 ? r.z : r.w));
  const unsigned pair = (w >> (16 * (j % 2))) & 0xffffu;
  float2 f;
  if constexpr (FP8) {
    __nv_fp8x2_e4m3 x;
    x.__x = static_cast<__nv_fp8x2_storage_t>(pair);
    f = static_cast<float2>(x);
  } else {
    f.x = static_cast<float>(static_cast<int>(pair << 24) >> 24);
    f.y = static_cast<float>(static_cast<int>(pair << 16) >> 24);
  }
  return f;
}

__device__ __forceinline__ int table_block(const Args& a, int b, int p) {
  const int blk = a.tables[(long long)b * a.M + p / a.bs];
  return blk < 0 ? 0 : (blk >= a.nb ? a.nb - 1 : blk);
}

// K7's decode route (C = 1). One launch: the key ranges of a (slot,
// head) are cut from the window's capacity, not from its length, so a
// block knows its keys before the length arrives; each block loads its
// slice of the block table into shared memory beside the length and q,
// so the key loop reads no table entry from device memory; a lane keeps
// U = 4 keys' payload rows (16 bytes each of K and V) and scales in
// flight per step, and a range is two steps of keys (the wrapper's
// decode_split_count: on the card two steps of 4 ranges ran faster than
// one step of 8). With nsplit > 1 each block writes a partial (acc, m, l)
// record; the last block of a (slot, head) to arrive (an arrival counter
// after __threadfence, as K8's split-K) merges them, writes the row and
// leaves the records and the counter zero, so the caller keeps one
// zeroed workspace and issues no memset per call.
constexpr int kDecodeTable = 256;  // table entries a block holds at a time
constexpr int kDecodeSplits = 16;  // key ranges a (slot, head) may have

// entries [w0, w0 + kDecodeTable) of slot b's table (those whose keys
// start below k_end), clamped into [0, NB)
__device__ __forceinline__ void load_table_window(const Args& a, int b, int w0, int k_end,
                                                  int* blk_s) {
  for (int i = threadIdx.x; i < kDecodeTable; i += kThreads) {
    const int e = w0 + i;
    int blk = 0;
    if (e * a.bs < k_end) {
      blk = a.tables[(long long)b * a.M + e];
      blk = blk < 0 ? 0 : (blk >= a.nb ? a.nb - 1 : blk);
    }
    blk_s[i] = blk;
  }
}

// grid: (nsplit, 1, B * N); block: kThreads; a group of G = D / E lanes
// per key, U keys per group per step.
// __launch_bounds__: four blocks an SM (<= 128 registers), so the 4 key
// ranges x 96 (slot, head) of the main path's tick run in one wave
template <int D, bool FP8>
__global__ void __launch_bounds__(kThreads, 4) qattn_decode_kernel(Args a) {
  constexpr int E = 16;             // payload bytes per lane
  constexpr int U = 4;              // keys per group per step
  constexpr int G = D / E;          // lanes per key group
  constexpr int NG = kThreads / G;  // key groups per block
  __shared__ int blk_s[kDecodeTable];
  __shared__ float sm_m[NG], sm_l[NG];
  __shared__ float sm_acc[NG][D];
  __shared__ int last;
  const int split = blockIdx.x;
  const int b = blockIdx.z / a.N;
  const int n = blockIdx.z % a.N;
  const int tid = threadIdx.x;
  const int grp = tid / G;
  const int lane = tid % G;
  const unsigned gmask =
      (G == 32) ? 0xffffffffu : (((1u << G) - 1u) << ((tid % 32) / G * G));

  int kps = (a.cap + a.nsplit - 1) / a.nsplit;
  kps = (kps + U - 1) / U * U;
  const int k_lo = split * kps;
  const int k_end = min(k_lo + kps, a.cap);
  const int len = max(a.lengths[b], 0);
  load_table_window(a, b, k_lo / a.bs, k_end, blk_s);
  float qv[E];
#pragma unroll
  for (int j = 0; j < E / 4; ++j) {
    const float4 t =
        load4(a.q + (long long)b * a.q_sb + (long long)n * a.q_sn + lane * E + 4 * j);
    qv[4 * j] = t.x;
    qv[4 * j + 1] = t.y;
    qv[4 * j + 2] = t.z;
    qv[4 * j + 3] = t.w;
  }
  const int k_hi = min(k_end, min(len + 1, a.cap));  // the row sees len + 1 keys
  float m = kNegInf, l = 0.f, acc[E];
#pragma unroll
  for (int i = 0; i < E; ++i) acc[i] = 0.f;
  __syncthreads();

  for (int w0 = k_lo / a.bs;;) {
    const int w_lo = max(k_lo, w0 * a.bs);
    const int w_hi = min(k_hi, (w0 + kDecodeTable) * a.bs);
    for (int base = w_lo + grp * U; base < w_hi; base += NG * U) {
      uint4 kw[U], vw[U];
      float ks[U], vs[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int p = base + u;
        kw[u] = vw[u] = make_uint4(0u, 0u, 0u, 0u);
        ks[u] = vs[u] = 0.f;
        if (p < w_hi) {
          const int e = p / a.bs;
          const long long blk = blk_s[e - w0];
          const long long off = p - e * a.bs;
          kw[u] = __ldg(reinterpret_cast<const uint4*>(a.kq + blk * a.k_sb + off * a.k_ss +
                                                       (long long)n * a.k_sn + lane * E));
          vw[u] = __ldg(reinterpret_cast<const uint4*>(a.vq + blk * a.v_sb + off * a.v_ss +
                                                       (long long)n * a.v_sn + lane * E));
          ks[u] = __ldg(a.k_scale + blk * a.ks_sb + off);
          vs[u] = __ldg(a.v_scale + blk * a.vs_sb + off);
        }
      }
      float s[U];
      float mnew = m;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        float dot = 0.f;
#pragma unroll
        for (int j = 0; j < E / 2; ++j) {
          const float2 k2 = payload_pair<FP8>(kw[u], j);
          dot += qv[2 * j] * k2.x;
          dot += qv[2 * j + 1] * k2.y;
        }
        s[u] = group_sum<G>(dot, gmask) * ks[u] * a.scale;
        if (base + u < w_hi) mnew = fmaxf(mnew, s[u]);
      }
      const float corr = expf(m - mnew);
      float psum = 0.f;
#pragma unroll
      for (int i = 0; i < E; ++i) acc[i] *= corr;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const float pr = base + u < w_hi ? expf(s[u] - mnew) : 0.f;
        psum += pr;
        const float pv = pr * vs[u];
#pragma unroll
        for (int j = 0; j < E / 2; ++j) {
          const float2 v2 = payload_pair<FP8>(vw[u], j);
          acc[2 * j] += pv * v2.x;
          acc[2 * j + 1] += pv * v2.y;
        }
      }
      l = l * corr + psum;
      m = mnew;
    }
    w0 += kDecodeTable;
    if (w0 * a.bs >= k_hi) break;  // uniform over the block
    __syncthreads();
    load_table_window(a, b, w0, k_end, blk_s);
    __syncthreads();
  }

  // merge the NG key groups of this block; thread c < D owns column c
  if (lane == 0) {
    sm_m[grp] = m;
    sm_l[grp] = l;
  }
#pragma unroll
  for (int i = 0; i < E; ++i) sm_acc[grp][lane * E + i] = acc[i];
  __syncthreads();
  const int c = tid;
  const long long row = (long long)b * a.N + n;  // out [B, 1, N, D]
  float mx = kNegInf, lsum = 0.f, as = 0.f;
  if (c < D) {
#pragma unroll
    for (int g = 0; g < NG; ++g) mx = fmaxf(mx, sm_m[g]);
#pragma unroll
    for (int g = 0; g < NG; ++g) {
      const float w = expf(sm_m[g] - mx);
      lsum += sm_l[g] * w;
      as += sm_acc[g][c] * w;
    }
  }
  if (a.nsplit == 1) {
    if (c < D) a.out[row * D + c] = lsum > 0.f ? as * (1.f / lsum) : 0.f;
    return;
  }
  // records [B * N][nsplit][D + 4]: acc[D], m, l
  constexpr int R = D + 4;
  float* rec = a.records + row * a.nsplit * R;
  if (c < D) {
    rec[split * R + c] = as;
    if (c == 0) {
      rec[split * R + D] = mx;
      rec[split * R + D + 1] = lsum;
    }
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) last = atomicAdd(a.counters + row, 1) == a.nsplit - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  // every record in one round of loads: (m, l) of each range into shared
  // memory, column c of each range's acc into registers
  float xs[kDecodeSplits];
  if (tid < a.nsplit) {
    sm_m[tid] = __ldcg(rec + tid * R + D);
    sm_l[tid] = __ldcg(rec + tid * R + D + 1);
  }
#pragma unroll
  for (int s = 0; s < kDecodeSplits; ++s)
    xs[s] = s < a.nsplit && c < D ? __ldcg(rec + s * R + c) : 0.f;
  __syncthreads();
  if (c < D) {
    mx = kNegInf;
    for (int s = 0; s < a.nsplit; ++s) mx = fmaxf(mx, sm_m[s]);
    lsum = as = 0.f;
#pragma unroll
    for (int s = 0; s < kDecodeSplits; ++s) {
      if (s >= a.nsplit) break;
      const float w = expf(sm_m[s] - mx);
      lsum += sm_l[s] * w;
      as += xs[s] * w;
    }
    a.out[row * D + c] = lsum > 0.f ? as * (1.f / lsum) : 0.f;
  }
  __syncthreads();  // every m and l is read: leave the records and the counter zero
  if (c < D)
    for (int s = 0; s < a.nsplit; ++s) __stcg(rec + s * R + c, 0.f);
  if (tid < a.nsplit) {
    __stcg(rec + tid * R + D, 0.f);
    __stcg(rec + tid * R + D + 1, 0.f);
  }
  if (tid == 0) a.counters[row] = 0;
}

template <bool FP8>
cudaError_t launch_decode_fp8(const Args& a, int d, cudaStream_t stream) {
  const dim3 grid(a.nsplit, 1, a.B * a.N);
  switch (d) {
    case 32: qattn_decode_kernel<32, FP8><<<grid, kThreads, 0, stream>>>(a); break;
    case 64: qattn_decode_kernel<64, FP8><<<grid, kThreads, 0, stream>>>(a); break;
    case 128: qattn_decode_kernel<128, FP8><<<grid, kThreads, 0, stream>>>(a); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

// The decode kernel takes one query row; chunks go to launch_prefill.
// Split keys need the workspace (counters and records).
cudaError_t launch_quantized(const Args& a, int d, bool fp8, cudaStream_t stream) {
  if (bad_grid(a) || a.tables == nullptr || a.C != 1 || a.nsplit > kDecodeSplits ||
      (a.nsplit > 1 && a.counters == nullptr))
    return cudaErrorInvalidValue;
  return fp8 ? launch_decode_fp8<true>(a, d, stream) : launch_decode_fp8<false>(a, d, stream);
}

// ---------------------------------------------------------------------------
// K7 prefill (C > 1): the chunk on the bf16 tensor cores
// ---------------------------------------------------------------------------
//
// The decode kernel above gives each (row, key) logit a shuffle reduction
// in f32 on the CUDA cores, which suits one row. A chunk reuses every key
// across its rows, so this kernel gives one warpgroup 64 rows and runs
// both products as wgmma at the f32 kernel's accuracy:
//  * Every int8 code and every finite e4m3 value is exact in bf16, so a
//    key tile's codes convert exactly into a bf16 tile.
//  * q, and p * s_v, are split into three bf16 pieces h = bf16(x),
//    m = bf16(x - h), l = bf16(x - h - m), which carry all 24 bits of an
//    f32; each product of a piece and a code is exact in f32, so the sum
//    of the three wgmma products is as accurate as f32 FMA (two pieces
//    are not: tests/test_torch_tc_split.py emulates both on the CPU).
//  * S = sum over pieces of Q_piece . K_codes^T (K-major, both from
//    shared memory), then s = S * s_k[key] * scale and the mask key <
//    lengths[b] + row + 1 on the accumulator fragment, the online softmax
//    in f32 there, and O_tile = sum over pieces of (p * s_v)_piece .
//    V_codes with the pieces as register A operands and V read through
//    the descriptor's transpose flag, 64 columns at a time. O_tile starts
//    from zero each key tile and is added to O (rescaled by corr) by f32
//    FMAs, so no sum of the tensor core's accumulator runs across key
//    tiles.
//  * Key rows are gathered through the block table (one lookup per key,
//    clamped into [0, NB) as the decode kernel does), 16 payload bytes a
//    lane, converted in registers and stored into the 128-byte swizzled
//    tile the descriptors read. For D <= 64 the next tile's bytes are
//    loaded into registers before this tile's products start.
//  * Flash-decoding split-K as above: a block owns (key range, 64 rows,
//    slot * head) and writes partials (m, l, acc) in the decode kernels'
//    format, which attn_combine_kernel combines.
constexpr int kTcRows = 64;     // query rows per block (one warpgroup)
constexpr int kTcKeys = 64;     // keys per tile
constexpr int kTcThreads = 128;

template <int D>
struct PrefillSmem {
  static constexpr int DP = Cols<D>::P;
  static constexpr int QB = kTcRows * DP * 2;  // one bf16 piece of the q tile
  static constexpr int KB = kTcKeys * DP * 2;  // the K or V code tile
  // D = 128 keeps the pieces of p * s_v in shared memory (PB bytes each):
  // as register operands, beside O (64 registers) they spill
  static constexpr bool P_SMEM = DP == 128;
  static constexpr int PB = P_SMEM ? kTcRows * kTcKeys * 2 : 0;
  static constexpr int BYTES = 1024 + 3 * QB + 2 * KB + 3 * PB + 2 * kTcKeys * 4;
};

// 16 payload bytes as 16 bf16 values, exactly: two 16-byte chunks
template <bool FP8>
__device__ __forceinline__ void codes_to_bf16(uint4 in, uint4 (&out)[2]) {
  unsigned o[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const float2 f = payload_pair<FP8>(in, i);
    o[i] = pack_bf16(f.x, f.y);
  }
  out[0] = make_uint4(o[0], o[1], o[2], o[3]);
  out[1] = make_uint4(o[4], o[5], o[6], o[7]);
}

template <int D>
struct KeyTileRegs {
  static constexpr int CH = D / 32;   // 16-byte chunks a thread owns per tensor
  uint4 k[CH], v[CH];
  float ks, vs;
};

// the payload bytes and scales of keys [k0, k0 + 64) into registers;
// keys at or beyond k_hi read as zero codes with zero scales
template <int D>
__device__ __forceinline__ void load_key_tile(const Args& a, int b, int n, int k0, int k_hi,
                                              KeyTileRegs<D>& t) {
  constexpr int CPK = D / 16;  // chunks per key row
  const int tid = threadIdx.x;
#pragma unroll
  for (int j = 0; j < KeyTileRegs<D>::CH; ++j) {
    const int i = j * kTcThreads + tid, key = i / CPK, part = i % CPK;
    const int p = k0 + key;
    t.k[j] = t.v[j] = make_uint4(0u, 0u, 0u, 0u);
    if (p < k_hi) {
      const int blk = table_block(a, b, p);
      const long long off = p % a.bs;
      t.k[j] = __ldg(reinterpret_cast<const uint4*>(a.kq + (long long)blk * a.k_sb +
                                                    off * a.k_ss + (long long)n * a.k_sn) + part);
      t.v[j] = __ldg(reinterpret_cast<const uint4*>(a.vq + (long long)blk * a.v_sb +
                                                    off * a.v_ss + (long long)n * a.v_sn) + part);
    }
  }
  t.ks = t.vs = 0.f;
  if (tid < kTcKeys && k0 + tid < k_hi) {
    const int p = k0 + tid;
    const int blk = table_block(a, b, p);
    t.ks = __ldg(a.k_scale + (long long)blk * a.ks_sb + p % a.bs);
    t.vs = __ldg(a.v_scale + (long long)blk * a.vs_sb + p % a.bs);
  }
}

template <int D, bool FP8>
__device__ __forceinline__ void store_key_tile(const KeyTileRegs<D>& t, uint8_t* sK, uint8_t* sV,
                                               float* ks_s, float* vs_s) {
  constexpr int CPK = D / 16;
  const int tid = threadIdx.x;
#pragma unroll
  for (int j = 0; j < KeyTileRegs<D>::CH; ++j) {
    const int i = j * kTcThreads + tid, key = i / CPK, part = i % CPK;
    uint4 o[2];
    codes_to_bf16<FP8>(t.k[j], o);
    *reinterpret_cast<uint4*>(sK + swz_offset<kTcKeys>(key, 2 * part)) = o[0];
    *reinterpret_cast<uint4*>(sK + swz_offset<kTcKeys>(key, 2 * part + 1)) = o[1];
    codes_to_bf16<FP8>(t.v[j], o);
    *reinterpret_cast<uint4*>(sV + swz_offset<kTcKeys>(key, 2 * part)) = o[0];
    *reinterpret_cast<uint4*>(sV + swz_offset<kTcKeys>(key, 2 * part + 1)) = o[1];
  }
  if (tid < kTcKeys) {
    ks_s[tid] = t.ks;
    vs_s[tid] = t.vs;
  }
}

// grid: (nsplit, ceil(C / 64), B * N); block: 128 threads (one warpgroup).
template <int D, bool FP8>
__global__ void __launch_bounds__(kTcThreads) qattn_prefill_tc_kernel(const Args a) {
  using S = PrefillSmem<D>;
  constexpr int DP = S::DP;
  constexpr bool PREFETCH = D <= 64;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  uint8_t* sQ = smem;                 // pieces h, m, l
  uint8_t* sK = sQ + 3 * S::QB;
  uint8_t* sV = sK + S::KB;
  uint8_t* sP = sV + S::KB;           // pieces of p * s_v (D = 128)
  float* ks_s = reinterpret_cast<float*>(sP + 3 * S::PB);
  float* vs_s = ks_s + kTcKeys;
  const uint32_t uQ0 = smem_u32(sQ), uK0 = smem_u32(sK), uV0 = smem_u32(sV);
  const uint32_t uP = smem_u32(sP);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int split = blockIdx.x;
  const int r0 = blockIdx.y * kTcRows;
  const int b = blockIdx.z / a.N, n = blockIdx.z % a.N;
  const int len = max(a.lengths[b], 0);
  const int last_row = min(r0 + kTcRows, a.C) - 1;
  const int maxlim = min(len + last_row + 1, a.cap);
  int kps = (maxlim + a.nsplit - 1) / a.nsplit;
  kps = (kps + kTcKeys - 1) / kTcKeys * kTcKeys;
  const int k_lo = split * kps;
  const int k_hi = min(k_lo + kps, maxlim);
  const int n_tiles = k_lo < k_hi ? (k_hi - k_lo + kTcKeys - 1) / kTcKeys : 0;

  // q rows r0.. into three bf16 pieces; rows past C and columns past D
  // (and the code tiles' columns past D) are zeros
  constexpr int QCH = DP / 8;  // 8-element chunks per row
  for (int i = tid; i < kTcRows * QCH; i += kTcThreads) {
    const int r = i / QCH, c = i % QCH, row = r0 + r;
    float x[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if (row < a.C && c * 8 < D) {
      const float* src = a.q + (long long)b * a.q_sb + (long long)row * a.q_sc +
                         (long long)n * a.q_sn + c * 8;
      const float4 lo = load4(src), hi = load4(src + 4);
      x[0] = lo.x; x[1] = lo.y; x[2] = lo.z; x[3] = lo.w;
      x[4] = hi.x; x[5] = hi.y; x[6] = hi.z; x[7] = hi.w;
    }
    store_pieces(x, sQ, S::QB, swz_offset<kTcRows>(r, c));
    if (c * 8 >= D) {  // padding columns of the code tiles (D = 32)
      *reinterpret_cast<uint4*>(sK + swz_offset<kTcKeys>(r, c)) = make_uint4(0u, 0u, 0u, 0u);
      *reinterpret_cast<uint4*>(sV + swz_offset<kTcKeys>(r, c)) = make_uint4(0u, 0u, 0u, 0u);
    }
  }

  // this thread's two rows (h = 0, 1) and the keys each may see
  int row[2], lim[2];
  float m[2], l[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    row[h] = r0 + frag_row(warp, lane, 2 * h);
    lim[h] = row[h] < a.C ? min(len + row[h] + 1, min(a.cap, k_hi)) : 0;
    m[h] = kNegInf;
    l[h] = 0.f;
  }
  float o[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) o[i] = 0.f;

  KeyTileRegs<D> regs;
  if (n_tiles > 0) {
    load_key_tile<D>(a, b, n, k_lo, k_hi, regs);
    store_key_tile<D, FP8>(regs, sK, sV, ks_s, vs_s);
  }
  fence_async_smem();
  __syncthreads();

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = k_lo + t * kTcKeys;
    if (PREFETCH && t + 1 < n_tiles) load_key_tile<D>(a, b, n, k0 + kTcKeys, k_hi, regs);
    // the tile addresses, opaque to the compiler each tile: otherwise it
    // keeps all 40-odd loop-invariant descriptors in registers across
    // the loop, which spills at D = 128
    uint32_t uQ = uQ0, uK = uK0;
    asm volatile("" : "+r"(uQ), "+r"(uK));

    // S = Q . K^T over the three pieces of q: 64 rows x 64 keys
    float s[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int piece = 2; piece >= 0; --piece)
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk)
        wgmma_ss_n64<0, 0>(s, desc_kmajor(uQ + piece * S::QB, kTcRows, kk),
                           desc_kmajor(uK, kTcKeys, kk), piece == 2 && kk == 0 ? 0 : 1);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);

    // s = S * s_k * scale, masked, then the online softmax on the fragment
    float mt[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int h = (i >> 1) & 1, c = frag_col(lane, i);
      const float x = s[i] * ks_s[c] * a.scale;
      s[i] = k0 + c < lim[h] ? x : kNegInf;
      mt[h] = fmaxf(mt[h], s[i]);
    }
    float corr[2], mu[2], ps[2] = {0.f, 0.f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float m_new = fmaxf(m[h], quad_max(mt[h]));
      corr[h] = expf(m[h] - m_new);
      m[h] = m_new;
      mu[h] = m_new == kNegInf ? 0.f : m_new;  // no key seen yet: every p is 0
    }
    // (p * s_v) in pieces h, m, l: register A operands, or (D = 128)
    // 64 x 64 swizzled bf16 tiles in shared memory
    uint32_t pa[3][16];
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const int h = (i >> 1) & 1, c = frag_col(lane, i);
      const float p0 = expf(s[i] - mu[h]), p1 = expf(s[i + 1] - mu[h]);
      ps[h] += p0 + p1;
      uint32_t ph, pm, pl;
      split3_pair(p0 * vs_s[c], p1 * vs_s[c + 1], ph, pm, pl);
      if constexpr (S::P_SMEM) {
        const uint32_t off =
            uP + swz_offset<kTcRows>(frag_row(warp, lane, i), c >> 3) + (c & 7) * 2;
        st_shared_u32(off, ph);
        st_shared_u32(off + S::PB, pm);
        st_shared_u32(off + 2 * S::PB, pl);
      } else {
        pa[0][i >> 1] = ph;
        pa[1][i >> 1] = pm;
        pa[2][i >> 1] = pl;
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) l[h] = l[h] * corr[h] + ps[h];
    if constexpr (S::P_SMEM) {
      fence_async_smem();
      __syncthreads();  // the whole 64-row tile is written
    }

    // O_tile = (p * s_v) . V_codes over the three pieces, V transposed,
    // 64 columns at a time (a 64 x 128 f32 tile would not fit beside O
    // and the pieces at D = 128)
    uint32_t uV = uV0;
    asm volatile("" : "+r"(uV));
#pragma unroll
    for (int half = 0; half < DP / 64; ++half) {
      float ot[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) ot[i] = 0.f;
      wgmma_fence();
#pragma unroll
      for (int piece = 2; piece >= 0; --piece)
#pragma unroll
        for (int kk = 0; kk < kTcKeys / 16; ++kk) {
          const uint64_t dv = desc_mnmajor(uV + half * kTcKeys * 128, kTcKeys, kk);
          const int first = piece == 2 && kk == 0 ? 0 : 1;
          if constexpr (S::P_SMEM)
            wgmma_ss_n64<0, 1>(ot, desc_kmajor(uP + piece * S::PB, kTcRows, kk), dv, first);
          else
            wgmma_rs_n64<1>(ot, pa[piece] + 4 * kk, dv, first);
        }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(ot);
      if constexpr (!S::P_SMEM) {
        fence_regs(pa[0]);
        fence_regs(pa[1]);
        fence_regs(pa[2]);
      }
#pragma unroll
      for (int i = 0; i < 32; ++i)
        o[32 * half + i] = fmaf(o[32 * half + i], corr[(i >> 1) & 1], ot[i]);
    }

    if (t + 1 < n_tiles) {
      __syncthreads();  // every warp is done with this tile
      if (!PREFETCH) load_key_tile<D>(a, b, n, k0 + kTcKeys, k_hi, regs);
      store_key_tile<D, FP8>(regs, sK, sV, ks_s, vs_s);
      fence_async_smem();
      __syncthreads();
    }
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float lsum = quad_sum(l[h]);
    if (row[h] >= a.C) continue;
    const long long orow = ((long long)b * a.C + row[h]) * a.N + n;
    const long long prow = orow * a.nsplit + split;
    float* dst = a.nsplit == 1 ? a.out + orow * D : a.part_acc + prow * D;
    const float inv = a.nsplit > 1 ? 1.f : (lsum > 0.f ? 1.f / lsum : 0.f);
#pragma unroll
    for (int i = 2 * h; i < DP / 2; i += 4) {
      const int c = frag_col(lane, i);
      if (c < D) *reinterpret_cast<float2*>(dst + c) = make_float2(o[i] * inv, o[i + 1] * inv);
    }
    if (a.nsplit > 1 && (lane & 3) == 0) {
      a.part_m[prow] = m[h];
      a.part_l[prow] = lsum;
    }
  }
}

template <int D, bool FP8>
cudaError_t launch_prefill_d(const Args& a, cudaStream_t stream) {
  const int bytes = PrefillSmem<D>::BYTES;
  void (*kernel)(Args) = qattn_prefill_tc_kernel<D, FP8>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  dim3 grid(a.nsplit, (a.C + kTcRows - 1) / kTcRows, a.B * a.N);
  kernel<<<grid, kTcThreads, bytes, stream>>>(a);
  return combine<D>(a, stream);
}

template <bool FP8>
cudaError_t launch_prefill_fp8(const Args& a, int d, cudaStream_t stream) {
  switch (d) {
    case 32: return launch_prefill_d<32, FP8>(a, stream);
    case 64: return launch_prefill_d<64, FP8>(a, stream);
    case 128: return launch_prefill_d<128, FP8>(a, stream);
    default: return cudaErrorInvalidValue;
  }
}

cudaError_t launch_prefill(const Args& a, int d, bool fp8, cudaStream_t stream) {
  if (bad_grid(a) || a.tables == nullptr) return cudaErrorInvalidValue;
  return fp8 ? launch_prefill_fp8<true>(a, d, stream) : launch_prefill_fp8<false>(a, d, stream);
}

// ---------------------------------------------------------------------------
// K6 chunks (C > 1): f32 pools on the bf16 tensor cores
// ---------------------------------------------------------------------------
//
// The structure of qattn_prefill_tc_kernel (64 query rows a warpgroup,
// 64-key tiles, the online softmax in f32 on the accumulator fragment,
// flash-decoding split-K over key ranges cut from the slot's length, a
// fresh f32 accumulator per key tile for P . V), with both operands of
// both products in float32:
//  * q, k, v and p are each split into three bf16 pieces h + m + l (the
//    pieces of x carry all 24 bits of its float32; split3_pair). K and V
//    are split on their way from the pool into shared memory: a register
//    pass over the raw tile, which cp.async has copied into a staging
//    area while the previous tile's products ran (D <= 64; at D = 128
//    the staging area does not fit beside the pieces, so the tile is
//    loaded and split after the products).
//  * S = sum of Q_i . K_j^T and O_tile = sum of P_i . V_j over the six
//    piece pairs with i + j <= 2 (h = 0, m = 1, l = 2), smallest first.
//    The pairs left out (m.l, l.m, l.l) are below 2^-24 of the
//    products; any five pairs, or three, miss the float32 kernel's
//    tolerance (tests/test_torch_tc_split.py models every set on the
//    CPU).
//  * The block table is read one tile ahead of the copies that need it
//    (one entry per key, clamped into [0, NB)) and kept in shared
//    memory, so no copy waits on a table load.
// Bound: at C = 512 the six bf16 products per f32 product put it on the
// operation side (6 x 4 x pairs x N x D at 989 TFLOP/s), against bytes
// for short chunks.

template <int D>
struct PagedTcSmem {
  static constexpr int DP = Cols<D>::P;
  static constexpr int TB = kTcRows * DP * 2;  // one bf16 piece of a Q, K or V tile
  static constexpr bool P_SMEM = DP == 128;    // p's pieces in shared memory, as K7's
  static constexpr int PB = P_SMEM ? kTcRows * kTcKeys * 2 : 0;
  static constexpr bool STAGE = D <= 64;       // raw f32 K and V of the next tile
  static constexpr int SB = STAGE ? kTcKeys * D * 4 : 0;
  static constexpr int BYTES = 1024 + 3 * kPieces * TB + kPieces * PB + 2 * SB + 4 * kTcKeys * 4;
};

// thread tid < 64's table entry for key tid of the tile at k0 (raw: the
// clamp and the range test come with tile_entry_store)
__device__ __forceinline__ int tile_entry_load(const Args& a, int b, int k0, int k_hi) {
  const int p = k0 + threadIdx.x;
  return p < k_hi ? __ldg(a.tables + (long long)b * a.M + p / a.bs) : 0;
}
// (block, offset) of key tid into slot `par`: block -1 past k_hi
__device__ __forceinline__ void tile_entry_store(const Args& a, int k0, int k_hi, int raw,
                                                 int* ent, int par) {
  const int p = k0 + threadIdx.x;
  const int blk = raw < 0 ? 0 : (raw >= a.nb ? a.nb - 1 : raw);
  ent[par * 2 * kTcKeys + threadIdx.x] = p < k_hi ? blk : -1;
  ent[par * 2 * kTcKeys + kTcKeys + threadIdx.x] = p % a.bs;
}

// the raw f32 rows of tile `par`'s keys into the staging area by
// cp.async (zeros past k_hi)
template <int D>
__device__ __forceinline__ void stage_tile(const Args& a, int n, const int* ent, int par,
                                           uint32_t stK, uint32_t stV) {
  constexpr int CPR = D / 4;  // 16-byte chunks per key row
#pragma unroll
  for (int it = 0; it < kTcKeys * CPR / kTcThreads; ++it) {
    const int i = it * kTcThreads + threadIdx.x, key = i / CPR, part = i % CPR;
    const int blk = ent[par * 2 * kTcKeys + key];
    const long long off = ent[par * 2 * kTcKeys + kTcKeys + key];
    const bool ok = blk >= 0;
    const long long ko = blk * a.k_sb + off * a.k_ss + (long long)n * a.k_sn + part * 4;
    const long long vo = blk * a.v_sb + off * a.v_ss + (long long)n * a.v_sn + part * 4;
    const float* gk = ok ? a.k + ko : a.k;
    const float* gv = ok ? a.v + vo : a.v;
    cp_async16(stK + i * 16, gk, ok);
    cp_async16(stV + i * 16, gv, ok);
  }
  cp_async_commit();
}

// the key tile split into the pieces of sK and sV: from the staging
// area (STAGE) or straight from the pool through tile `par`'s entries
template <int D, bool STAGE>
__device__ __forceinline__ void split_tile(const Args& a, int n, const int* ent, int par,
                                           const float* stK, const float* stV, uint8_t* sK,
                                           uint8_t* sV) {
  constexpr int CPK = D / 8;  // 8-float chunks per key row
  constexpr int TB = PagedTcSmem<D>::TB;
#pragma unroll 4
  for (int it = 0; it < kTcKeys * CPK / kTcThreads; ++it) {
    const int i = it * kTcThreads + threadIdx.x, key = i / CPK, c = i % CPK;
    float xk[8], xv[8];
    float4 k0, k1, v0, v1;
    if constexpr (STAGE) {
      k0 = *reinterpret_cast<const float4*>(stK + i * 8);
      k1 = *reinterpret_cast<const float4*>(stK + i * 8 + 4);
      v0 = *reinterpret_cast<const float4*>(stV + i * 8);
      v1 = *reinterpret_cast<const float4*>(stV + i * 8 + 4);
    } else {
      const int blk = ent[par * 2 * kTcKeys + key];
      const long long off = ent[par * 2 * kTcKeys + kTcKeys + key];
      k0 = k1 = v0 = v1 = make_float4(0.f, 0.f, 0.f, 0.f);
      if (blk >= 0) {
        const float* gk = a.k + blk * a.k_sb + off * a.k_ss + (long long)n * a.k_sn + c * 8;
        const float* gv = a.v + blk * a.v_sb + off * a.v_ss + (long long)n * a.v_sn + c * 8;
        k0 = load4(gk);
        k1 = load4(gk + 4);
        v0 = load4(gv);
        v1 = load4(gv + 4);
      }
    }
    xk[0] = k0.x; xk[1] = k0.y; xk[2] = k0.z; xk[3] = k0.w;
    xk[4] = k1.x; xk[5] = k1.y; xk[6] = k1.z; xk[7] = k1.w;
    xv[0] = v0.x; xv[1] = v0.y; xv[2] = v0.z; xv[3] = v0.w;
    xv[4] = v1.x; xv[5] = v1.y; xv[6] = v1.z; xv[7] = v1.w;
    const uint32_t off = swz_offset<kTcKeys>(key, c);
    store_pieces(xk, sK, TB, off);
    store_pieces(xv, sV, TB, off);
  }
}

// grid: (nsplit, ceil(C / 64), B * N); block: 128 threads (one warpgroup).
template <int D>
__global__ void __launch_bounds__(kTcThreads, PagedTcSmem<D>::STAGE ? 2 : 1)
    paged_prefill_tc_kernel(const Args a) {
  using S = PagedTcSmem<D>;
  constexpr int DP = S::DP;
  constexpr bool STAGE = S::STAGE;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  uint8_t* sQ = smem;                     // pieces h, m, l of each
  uint8_t* sK = sQ + kPieces * S::TB;
  uint8_t* sV = sK + kPieces * S::TB;
  uint8_t* sP = sV + kPieces * S::TB;     // pieces of p (D = 128)
  float* stK = reinterpret_cast<float*>(sP + kPieces * S::PB);  // staging (D <= 64)
  float* stV = reinterpret_cast<float*>(reinterpret_cast<uint8_t*>(stK) + S::SB);
  int* ent = reinterpret_cast<int*>(reinterpret_cast<uint8_t*>(stV) + S::SB);  // [2][blk, off][64]
  const uint32_t uQ0 = smem_u32(sQ), uK0 = smem_u32(sK), uV0 = smem_u32(sV);
  const uint32_t uP = smem_u32(sP);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int split = blockIdx.x;
  const int r0 = blockIdx.y * kTcRows;
  const int b = blockIdx.z / a.N, n = blockIdx.z % a.N;
  const int len = max(a.lengths[b], 0);
  const int last_row = min(r0 + kTcRows, a.C) - 1;
  const int maxlim = min(len + last_row + 1, a.cap);
  int kps = (maxlim + a.nsplit - 1) / a.nsplit;
  kps = (kps + kTcKeys - 1) / kTcKeys * kTcKeys;
  const int k_lo = split * kps;
  const int k_hi = min(k_lo + kps, maxlim);
  const int n_tiles = k_lo < k_hi ? (k_hi - k_lo + kTcKeys - 1) / kTcKeys : 0;

  // the first two tiles' table entries, in flight while q is split
  int raw0 = 0, raw1 = 0;
  if (tid < kTcKeys) {
    raw0 = tile_entry_load(a, b, k_lo, k_hi);
    raw1 = tile_entry_load(a, b, k_lo + kTcKeys, k_hi);
  }
  // q rows r0.. into three bf16 pieces; rows past C and columns past D
  // (and the K and V pieces' columns past D) are zeros
  constexpr int QCH = DP / 8;  // 8-element chunks per row
  for (int i = tid; i < kTcRows * QCH; i += kTcThreads) {
    const int r = i / QCH, c = i % QCH, row = r0 + r;
    float x[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if (row < a.C && c * 8 < D) {
      const float* src = a.q + (long long)b * a.q_sb + (long long)row * a.q_sc +
                         (long long)n * a.q_sn + c * 8;
      const float4 lo = load4(src), hi = load4(src + 4);
      x[0] = lo.x; x[1] = lo.y; x[2] = lo.z; x[3] = lo.w;
      x[4] = hi.x; x[5] = hi.y; x[6] = hi.z; x[7] = hi.w;
    }
    const uint32_t off = swz_offset<kTcRows>(r, c);
    store_pieces(x, sQ, S::TB, off);
    if (c * 8 >= D) {  // padding columns of the key tiles (D = 32)
      const float zero[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      store_pieces(zero, sK, S::TB, off);
      store_pieces(zero, sV, S::TB, off);
    }
  }
  if (tid < kTcKeys) {
    tile_entry_store(a, k_lo, k_hi, raw0, ent, 0);
    tile_entry_store(a, k_lo + kTcKeys, k_hi, raw1, ent, 1);
  }
  __syncthreads();
  if (n_tiles > 0) {
    if constexpr (STAGE) {
      stage_tile<D>(a, n, ent, 0, smem_u32(stK), smem_u32(stV));
      cp_async_wait<0>();
      __syncthreads();
    }
    split_tile<D, STAGE>(a, n, ent, 0, stK, stV, sK, sV);
  }
  fence_async_smem();
  __syncthreads();

  // this thread's two rows (h = 0, 1) and the keys each may see
  int row[2], lim[2];
  float m[2], l[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    row[h] = r0 + frag_row(warp, lane, 2 * h);
    lim[h] = row[h] < a.C ? min(len + row[h] + 1, min(a.cap, k_hi)) : 0;
    m[h] = kNegInf;
    l[h] = 0.f;
  }
  float o[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) o[i] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = k_lo + t * kTcKeys;
    const bool more = t + 1 < n_tiles;
    // the next tile's rows into the staging area, the one after's table
    // entries into a register, both while this tile's products run
    if constexpr (STAGE) {
      if (more) stage_tile<D>(a, n, ent, (t + 1) & 1, smem_u32(stK), smem_u32(stV));
    }
    int raw = 0;
    if (t + 2 < n_tiles && tid < kTcKeys) raw = tile_entry_load(a, b, k0 + 2 * kTcKeys, k_hi);
    // the tile addresses, opaque to the compiler each tile (as in K7's
    // kernel: it would otherwise keep every descriptor in registers)
    uint32_t uQ = uQ0, uK = uK0;
    asm volatile("" : "+r"(uQ), "+r"(uK));

    // S = Q . K^T over the six piece pairs: 64 rows x 64 keys
    float s[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int pr = 0; pr < kPairs; ++pr)
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk)
        wgmma_ss_n64<0, 0>(s, desc_kmajor(uQ + pair_a(pr) * S::TB, kTcRows, kk),
                           desc_kmajor(uK + pair_b(pr) * S::TB, kTcKeys, kk),
                           pr == 0 && kk == 0 ? 0 : 1);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);

    // s = S * scale, masked, then the online softmax on the fragment
    float mt[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int h = (i >> 1) & 1, c = frag_col(lane, i);
      const float x = s[i] * a.scale;
      s[i] = k0 + c < lim[h] ? x : kNegInf;
      mt[h] = fmaxf(mt[h], s[i]);
    }
    float corr[2], mu[2], ps[2] = {0.f, 0.f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float m_new = fmaxf(m[h], quad_max(mt[h]));
      corr[h] = expf(m[h] - m_new);
      m[h] = m_new;
      mu[h] = m_new == kNegInf ? 0.f : m_new;  // no key seen yet: every p is 0
    }
    // p in pieces h, m, l: register A operands, or (D = 128) 64 x 64
    // swizzled bf16 tiles in shared memory
    uint32_t pa[kPieces][16];
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const int h = (i >> 1) & 1, c = frag_col(lane, i);
      const float p0 = expf(s[i] - mu[h]), p1 = expf(s[i + 1] - mu[h]);
      ps[h] += p0 + p1;
      uint32_t ph, pm, pl;
      split3_pair(p0, p1, ph, pm, pl);
      if constexpr (S::P_SMEM) {
        const uint32_t off =
            uP + swz_offset<kTcRows>(frag_row(warp, lane, i), c >> 3) + (c & 7) * 2;
        st_shared_u32(off, ph);
        st_shared_u32(off + S::PB, pm);
        st_shared_u32(off + 2 * S::PB, pl);
      } else {
        pa[0][i >> 1] = ph;
        pa[1][i >> 1] = pm;
        pa[2][i >> 1] = pl;
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) l[h] = l[h] * corr[h] + ps[h];
    if constexpr (S::P_SMEM) {
      fence_async_smem();
      __syncthreads();  // the whole 64-row tile is written
    }

    // O_tile = P . V over the six piece pairs, V transposed, 64 columns
    // at a time, from a fresh f32 accumulator
    uint32_t uV = uV0;
    asm volatile("" : "+r"(uV));
#pragma unroll
    for (int half = 0; half < DP / 64; ++half) {
      float ot[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) ot[i] = 0.f;
      wgmma_fence();
#pragma unroll
      for (int pr = 0; pr < kPairs; ++pr)
#pragma unroll
        for (int kk = 0; kk < kTcKeys / 16; ++kk) {
          const uint64_t dv =
              desc_mnmajor(uV + pair_b(pr) * S::TB + half * kTcKeys * 128, kTcKeys, kk);
          const int first = pr == 0 && kk == 0 ? 0 : 1;
          if constexpr (S::P_SMEM)
            wgmma_ss_n64<0, 1>(ot, desc_kmajor(uP + pair_a(pr) * S::PB, kTcRows, kk), dv, first);
          else
            wgmma_rs_n64<1>(ot, pa[pair_a(pr)] + 4 * kk, dv, first);
        }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(ot);
      if constexpr (!S::P_SMEM) {
        fence_regs(pa[0]);
        fence_regs(pa[1]);
        fence_regs(pa[2]);
      }
#pragma unroll
      for (int i = 0; i < 32; ++i)
        o[32 * half + i] = fmaf(o[32 * half + i], corr[(i >> 1) & 1], ot[i]);
    }

    if (more) {
      if (t + 2 < n_tiles && tid < kTcKeys)
        tile_entry_store(a, k0 + 2 * kTcKeys, k_hi, raw, ent, t & 1);
      if constexpr (STAGE) cp_async_wait<0>();
      __syncthreads();  // every warp is done with this tile; the next one's rows are in
      split_tile<D, STAGE>(a, n, ent, (t + 1) & 1, stK, stV, sK, sV);
      fence_async_smem();
      __syncthreads();
    }
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float lsum = quad_sum(l[h]);
    if (row[h] >= a.C) continue;
    const long long orow = ((long long)b * a.C + row[h]) * a.N + n;
    const long long prow = orow * a.nsplit + split;
    float* dst = a.nsplit == 1 ? a.out + orow * D : a.part_acc + prow * D;
    const float inv = a.nsplit > 1 ? 1.f : (lsum > 0.f ? 1.f / lsum : 0.f);
#pragma unroll
    for (int i = 2 * h; i < DP / 2; i += 4) {
      const int c = frag_col(lane, i);
      if (c < D) *reinterpret_cast<float2*>(dst + c) = make_float2(o[i] * inv, o[i + 1] * inv);
    }
    if (a.nsplit > 1 && (lane & 3) == 0) {
      a.part_m[prow] = m[h];
      a.part_l[prow] = lsum;
    }
  }
}

template <int D>
cudaError_t launch_paged_tc_d(const Args& a, cudaStream_t stream) {
  const int bytes = PagedTcSmem<D>::BYTES;
  void (*kernel)(Args) = paged_prefill_tc_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  dim3 grid(a.nsplit, (a.C + kTcRows - 1) / kTcRows, a.B * a.N);
  kernel<<<grid, kTcThreads, bytes, stream>>>(a);
  return combine<D>(a, stream);
}

cudaError_t launch_paged_tc(const Args& a, int d, cudaStream_t stream) {
  if (bad_grid(a) || a.tables == nullptr) return cudaErrorInvalidValue;
  switch (d) {
    case 32: return launch_paged_tc_d<32>(a, stream);
    case 64: return launch_paged_tc_d<64>(a, stream);
    case 128: return launch_paged_tc_d<128>(a, stream);
    default: return cudaErrorInvalidValue;
  }
}

Args quantized_args(const void* q, const void* k_pool, const void* v_pool, const void* k_scale,
                    const void* v_scale, const void* tables, const void* lengths, void* out,
                    void* part_m, void* part_l, void* part_acc, int B, int C, int N, int NB,
                    int bs, int M, long long q_sb, long long q_sc, long long q_sn,
                    long long k_sb, long long k_ss, long long k_sn, long long v_sb,
                    long long v_ss, long long v_sn, long long ks_sb, long long vs_sb,
                    int nsplit, float scale) {
  Args a{};
  a.q = static_cast<const float*>(q);
  a.kq = static_cast<const unsigned char*>(k_pool);
  a.vq = static_cast<const unsigned char*>(v_pool);
  a.k_scale = static_cast<const float*>(k_scale);
  a.v_scale = static_cast<const float*>(v_scale);
  a.tables = static_cast<const int*>(tables);
  a.lengths = static_cast<const int*>(lengths);
  a.out = static_cast<float*>(out);
  a.part_m = static_cast<float*>(part_m);
  a.part_l = static_cast<float*>(part_l);
  a.part_acc = static_cast<float*>(part_acc);
  a.B = B;
  a.C = C;
  a.N = N;
  a.M = M;
  a.bs = bs;
  a.nb = NB;
  a.cap = M * bs;
  a.causal = 1;
  a.q_sb = q_sb;
  a.q_sc = q_sc;
  a.q_sn = q_sn;
  a.k_sb = k_sb;
  a.k_ss = k_ss;
  a.k_sn = k_sn;
  a.v_sb = v_sb;
  a.v_ss = v_ss;
  a.v_sn = v_sn;
  a.ks_sb = ks_sb;
  a.vs_sb = vs_sb;
  a.nsplit = nsplit;
  a.scale = scale;
  return a;
}

Args paged_args(const void* q, const void* k_pool, const void* v_pool, const void* tables,
                const void* lengths, void* out, void* part_m, void* part_l, void* part_acc, int B,
                int C, int N, int NB, int bs, int M, long long q_sb, long long q_sc,
                long long q_sn, long long k_sb, long long k_ss, long long k_sn, long long v_sb,
                long long v_ss, long long v_sn, int nsplit, float scale) {
  Args a{};
  a.q = static_cast<const float*>(q);
  a.k = static_cast<const float*>(k_pool);
  a.v = static_cast<const float*>(v_pool);
  a.tables = static_cast<const int*>(tables);
  a.lengths = static_cast<const int*>(lengths);
  a.out = static_cast<float*>(out);
  a.part_m = static_cast<float*>(part_m);
  a.part_l = static_cast<float*>(part_l);
  a.part_acc = static_cast<float*>(part_acc);
  a.B = B;
  a.C = C;
  a.N = N;
  a.M = M;
  a.bs = bs;
  a.nb = NB;
  a.cap = M * bs;
  a.causal = 1;
  a.q_sb = q_sb;
  a.q_sc = q_sc;
  a.q_sn = q_sn;
  a.k_sb = k_sb;
  a.k_ss = k_ss;
  a.k_sn = k_sn;
  a.v_sb = v_sb;
  a.v_ss = v_ss;
  a.v_sn = v_sn;
  a.nsplit = nsplit;
  a.scale = scale;
  return a;
}

}  // namespace

extern "C" {

// K5. q [B, N, D] (strides q_sb, q_sn); k/v [B, S, N, D] read through
// their strides (last dim contiguous); lengths [B] int32; out [B, N, D].
// One launch (f32_decode_kernel): nsplit blocks a (slot, head), one
// cluster.
int ptt_decode_attention_f32(const void* q, const void* k, const void* v,
                             const void* lengths, void* out, int B, int S, int N, int D,
                             long long q_sb, long long q_sn, long long k_sb, long long k_ss,
                             long long k_sn, long long v_sb, long long v_ss, long long v_sn,
                             int nsplit, float scale, void* stream) {
  Args a{};
  a.q = static_cast<const float*>(q);
  a.k = static_cast<const float*>(k);
  a.v = static_cast<const float*>(v);
  a.tables = nullptr;
  a.lengths = static_cast<const int*>(lengths);
  a.out = static_cast<float*>(out);
  a.B = B;
  a.C = 1;
  a.N = N;
  a.M = 1;
  a.bs = S;
  a.nb = 1;
  a.cap = S;
  a.causal = 0;
  a.q_sb = q_sb;
  a.q_sc = 0;
  a.q_sn = q_sn;
  a.k_sb = k_sb;
  a.k_ss = k_ss;
  a.k_sn = k_sn;
  a.v_sb = v_sb;
  a.v_ss = v_ss;
  a.v_sn = v_sn;
  a.nsplit = nsplit;
  a.scale = scale;
  return static_cast<int>(launch_f32_decode(a, D, static_cast<cudaStream_t>(stream)));
}

// K6's decode route. q [B, C, N, D] (strides q_sb, q_sc, q_sn); pools
// [NB, bs, N, D] read through their strides (last dim contiguous);
// tables [B, M] int32 contiguous; lengths [B] int32; out [B, C, N, D].
// The CUDA-core kernel (f32_decode_kernel), one launch: any C, in tiles
// of f32_tile_rows(C) rows, nsplit blocks a tile, one cluster.
int ptt_paged_decode_attention_f32(const void* q, const void* k_pool, const void* v_pool,
                                   const void* tables, const void* lengths, void* out, int B,
                                   int C, int N, int D, int NB, int bs, int M, long long q_sb,
                                   long long q_sc, long long q_sn, long long k_sb,
                                   long long k_ss, long long k_sn, long long v_sb,
                                   long long v_ss, long long v_sn, int nsplit, float scale,
                                   void* stream) {
  const Args a = paged_args(q, k_pool, v_pool, tables, lengths, out, nullptr, nullptr, nullptr,
                            B, C, N, NB, bs, M, q_sb, q_sc, q_sn, k_sb, k_ss, k_sn, v_sb, v_ss,
                            v_sn, nsplit, scale);
  if (a.tables == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch_f32_decode(a, D, static_cast<cudaStream_t>(stream)));
}

// K6's chunk route: the same arguments and function on the bf16 tensor
// cores (paged_prefill_tc_kernel; 64 rows a block, so nsplit counts key
// ranges per (64-row tile, slot, head)).
int ptt_paged_prefill_attention_f32(const void* q, const void* k_pool, const void* v_pool,
                                    const void* tables, const void* lengths, void* out,
                                    void* part_m, void* part_l, void* part_acc, int B, int C,
                                    int N, int D, int NB, int bs, int M, long long q_sb,
                                    long long q_sc, long long q_sn, long long k_sb,
                                    long long k_ss, long long k_sn, long long v_sb,
                                    long long v_ss, long long v_sn, int nsplit, float scale,
                                    void* stream) {
  const Args a = paged_args(q, k_pool, v_pool, tables, lengths, out, part_m, part_l, part_acc,
                            B, C, N, NB, bs, M, q_sb, q_sc, q_sn, k_sb, k_ss, k_sn, v_sb, v_ss,
                            v_sn, nsplit, scale);
  return static_cast<int>(launch_paged_tc(a, D, static_cast<cudaStream_t>(stream)));
}

// K7. q [B, C, N, D] float32 (strides q_sb, q_sc, q_sn); payload pools
// [NB, bs, N, D] of 1-byte elements (int8, or float8 e4m3 when fp8 != 0)
// read through their strides (last dim contiguous, rows 16-byte
// aligned); scales [NB, bs] float32 with row strides ks_sb / vs_sb;
// tables [B, M] int32 contiguous; lengths [B] int32; out [B, C, N, D].
// The decode route: CUDA cores, C = 1 only (any other C is refused), one
// launch. `work` (int32, zero, left zero) holds round_up(B * N, 4)
// arrival counters, then B * N * nsplit records of D + 4 floats; null
// when nsplit == 1.
int ptt_quantized_paged_decode_attention(
    const void* q, const void* k_pool, const void* v_pool, const void* k_scale,
    const void* v_scale, const void* tables, const void* lengths, void* out, void* work,
    int B, int C, int N, int D, int NB, int bs, int M, long long q_sb, long long q_sc,
    long long q_sn, long long k_sb, long long k_ss, long long k_sn, long long v_sb,
    long long v_ss, long long v_sn, long long ks_sb, long long vs_sb, int nsplit, float scale,
    int fp8, void* stream) {
  Args a = quantized_args(q, k_pool, v_pool, k_scale, v_scale, tables, lengths, out, nullptr,
                          nullptr, nullptr, B, C, N, NB, bs, M, q_sb, q_sc, q_sn, k_sb, k_ss,
                          k_sn, v_sb, v_ss, v_sn, ks_sb, vs_sb, nsplit, scale);
  if (work != nullptr) {
    a.counters = static_cast<int*>(work);
    a.records = reinterpret_cast<float*>(a.counters + ((B * N + 3) & ~3));
  }
  return static_cast<int>(launch_quantized(a, D, fp8 != 0, static_cast<cudaStream_t>(stream)));
}

// K7's prefill route: the same arguments and function on the bf16
// tensor cores (qattn_prefill_tc_kernel; 64 rows a block, so nsplit
// counts key ranges per (64-row tile, slot, head)).
int ptt_quantized_paged_prefill_attention(
    const void* q, const void* k_pool, const void* v_pool, const void* k_scale,
    const void* v_scale, const void* tables, const void* lengths, void* out, void* part_m,
    void* part_l, void* part_acc, int B, int C, int N, int D, int NB, int bs, int M,
    long long q_sb, long long q_sc, long long q_sn, long long k_sb, long long k_ss,
    long long k_sn, long long v_sb, long long v_ss, long long v_sn, long long ks_sb,
    long long vs_sb, int nsplit, float scale, int fp8, void* stream) {
  const Args a = quantized_args(q, k_pool, v_pool, k_scale, v_scale, tables, lengths, out,
                                part_m, part_l, part_acc, B, C, N, NB, bs, M, q_sb, q_sc, q_sn,
                                k_sb, k_ss, k_sn, v_sb, v_ss, v_sn, ks_sb, vs_sb, nsplit, scale);
  return static_cast<int>(launch_prefill(a, D, fp8 != 0, static_cast<cudaStream_t>(stream)));
}

}  // extern "C"
