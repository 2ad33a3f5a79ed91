// Decode attention for Hopper (sm_90a): kernels K5 and K6 of the port.
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
//     covered (the TPU kernel stopped at C <= 8).
//
// What bounds them on this card: bytes. A decode row does 2 flops per
// key element it reads (q.k and p.v), far below the ~20 flops/byte where
// the H100's float32 CUDA-core rate (67 TFLOP/s) would take over from
// its 3.35 TB/s of HBM. Large prefill chunks (C in the hundreds) reuse
// each key across C rows and move toward the operation bound.
//
// What the design does about it:
//  * Every K/V byte of a slot's window is read once per (slot, head,
//    row tile): a group of D/4 lanes owns one key at a time and reads
//    its D floats as one float4 per lane (a coalesced 256-byte row at
//    D=64), and that key serves all CR query rows the block holds.
//  * Loops stop at the slot's length: nothing beyond lengths[b] (+c+1)
//    is read, and no [B, N, S] logits ever reach device memory; the
//    online softmax state (m, l, acc) lives in registers in float32.
//  * Flash-decoding split-K: when (slot, head, row tile) blocks alone
//    cannot fill 132 SMs, the wrapper asks for nsplit key ranges per
//    block; each range writes a partial (m, l, acc) and a second small
//    kernel combines them. Ranges are cut from the slot's own length on
//    the device, so short slots do not leave empty blocks behind.
//  * The paged kernel looks up its own table entry per key (the TPU
//    kernel's scalar prefetch has no counterpart here); entries are
//    clamped into [0, NB) as XLA's gather clamps.
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

#include <cuda_runtime.h>

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

template <bool PAGED>
__device__ __forceinline__ long long key_offset(const Args& a, int b, int n, int p,
                                                long long sb, long long ss, long long sn) {
  if (PAGED) {
    int blk = a.tables[(long long)b * a.M + p / a.bs];
    blk = blk < 0 ? 0 : (blk >= a.nb ? a.nb - 1 : blk);
    return (long long)blk * sb + (long long)(p % a.bs) * ss + (long long)n * sn;
  }
  return (long long)b * sb + (long long)p * ss + (long long)n * sn;
}

// grid: (nsplit, ceil(C / CR), B * N); block: kThreads.
// Each block owns rows [r0, r0 + CR) of one (slot, head) and one key range.
template <int D, int CR, int U, bool PAGED>
__global__ void __launch_bounds__(kThreads) attn_partial_kernel(Args a) {
  constexpr int G = D / 4;          // lanes per key group
  constexpr int NG = kThreads / G;  // key groups per block
  const int split = blockIdx.x;
  const int r0 = blockIdx.y * CR;
  const int b = blockIdx.z / a.N;
  const int n = blockIdx.z % a.N;
  const int tid = threadIdx.x;
  const int grp = tid / G;
  const int lane = tid % G;
  const unsigned gmask =
      (G == 32) ? 0xffffffffu : (((1u << G) - 1u) << ((tid % 32) / G * G));

  int len = a.lengths[b];
  len = len < 0 ? 0 : len;
  int lim[CR];
  int maxlim = 0;
#pragma unroll
  for (int r = 0; r < CR; ++r) {
    int l = 0;
    if (r0 + r < a.C) {
      l = len + (a.causal ? r0 + r + 1 : 0);
      l = l < a.cap ? l : a.cap;
    }
    lim[r] = l;
    maxlim = l > maxlim ? l : maxlim;
  }
  // this block's key range, cut from the window the tile actually sees
  int kps = (maxlim + a.nsplit - 1) / a.nsplit;
  kps = (kps + U - 1) / U * U;
  const int k_lo = split * kps;
  const int k_hi = min(k_lo + kps, maxlim);

  float4 qv[CR];
#pragma unroll
  for (int r = 0; r < CR; ++r) {
    if (r0 + r < a.C)
      qv[r] = load4(a.q + (long long)b * a.q_sb + (long long)(r0 + r) * a.q_sc +
                    (long long)n * a.q_sn + lane * 4);
    else
      qv[r] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  float m[CR], l[CR];
  float4 acc[CR];
#pragma unroll
  for (int r = 0; r < CR; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
    acc[r] = make_float4(0.f, 0.f, 0.f, 0.f);
  }

  for (int base = k_lo + grp * U; base < k_hi; base += NG * U) {
    float4 kk[U], vv[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int p = base + u;
      if (p < k_hi) {
        kk[u] = load4(a.k + key_offset<PAGED>(a, b, n, p, a.k_sb, a.k_ss, a.k_sn) + lane * 4);
        vv[u] = load4(a.v + key_offset<PAGED>(a, b, n, p, a.v_sb, a.v_ss, a.v_sn) + lane * 4);
      } else {
        kk[u] = make_float4(0.f, 0.f, 0.f, 0.f);
        vv[u] = kk[u];
      }
    }
#pragma unroll
    for (int r = 0; r < CR; ++r) {
      if (base >= lim[r]) continue;  // uniform within the group
      float s[U];
      float mnew = m[r];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        s[u] = group_sum<G>(dot4(qv[r], kk[u]), gmask) * a.scale;
        const int p = base + u;
        if (p < k_hi && p < lim[r]) mnew = fmaxf(mnew, s[u]);
      }
      const float corr = expf(m[r] - mnew);
      float psum = 0.f;
      float4 av = make_float4(acc[r].x * corr, acc[r].y * corr, acc[r].z * corr,
                              acc[r].w * corr);
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int p = base + u;
        const float pr = (p < k_hi && p < lim[r]) ? expf(s[u] - mnew) : 0.f;
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
  }

  // merge the NG key groups of this block
  __shared__ float sm_m[NG][CR];
  __shared__ float sm_l[NG][CR];
  __shared__ float4 sm_acc[NG][CR][G];
#pragma unroll
  for (int r = 0; r < CR; ++r) {
    if (lane == 0) {
      sm_m[grp][r] = m[r];
      sm_l[grp][r] = l[r];
    }
    sm_acc[grp][r][lane] = acc[r];
  }
  __syncthreads();
  for (int idx = tid; idx < CR * G; idx += kThreads) {
    const int r = idx / G;
    const int ln = idx % G;
    const int row = r0 + r;
    if (row >= a.C) continue;
    float mx = kNegInf;
#pragma unroll
    for (int g = 0; g < NG; ++g) mx = fmaxf(mx, sm_m[g][r]);
    float lsum = 0.f;
    float4 as = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int g = 0; g < NG; ++g) {
      const float w = expf(sm_m[g][r] - mx);
      const float4 x = sm_acc[g][r][ln];
      lsum += sm_l[g][r] * w;
      as.x += x.x * w;
      as.y += x.y * w;
      as.z += x.z * w;
      as.w += x.w * w;
    }
    const long long orow = ((long long)b * a.C + row) * a.N + n;
    if (a.nsplit == 1) {
      const float inv = lsum > 0.f ? 1.f / lsum : 0.f;
      reinterpret_cast<float4*>(a.out + orow * D)[ln] =
          make_float4(as.x * inv, as.y * inv, as.z * inv, as.w * inv);
    } else {
      const long long prow = orow * a.nsplit + split;
      reinterpret_cast<float4*>(a.part_acc + prow * D)[ln] = as;
      if (ln == 0) {
        a.part_m[prow] = mx;
        a.part_l[prow] = lsum;
      }
    }
  }
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

template <int D, int CR, bool PAGED>
cudaError_t launch_d(const Args& a, cudaStream_t stream) {
  constexpr int U = CR == 1 ? 4 : 2;
  dim3 grid(a.nsplit, (a.C + CR - 1) / CR, a.B * a.N);
  attn_partial_kernel<D, CR, U, PAGED><<<grid, kThreads, 0, stream>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || a.nsplit == 1) return err;
  const long long rows = (long long)a.B * a.C * a.N;
  const long long per_block = kThreads / (D / 4);
  attn_combine_kernel<D><<<(unsigned)((rows + per_block - 1) / per_block), kThreads, 0,
                           stream>>>(a, rows);
  return cudaGetLastError();
}

template <int CR, bool PAGED>
cudaError_t launch_cr(const Args& a, int d, cudaStream_t stream) {
  switch (d) {
    case 32: return launch_d<32, CR, PAGED>(a, stream);
    case 64: return launch_d<64, CR, PAGED>(a, stream);
    case 128: return launch_d<128, CR, PAGED>(a, stream);
    default: return cudaErrorInvalidValue;
  }
}

cudaError_t launch(const Args& a, int d, cudaStream_t stream) {
  if (a.B <= 0 || a.C <= 0 || a.N <= 0 || a.nsplit <= 0 || a.B * a.N > 65535 ||
      (a.C + 7) / 8 > 65535)
    return cudaErrorInvalidValue;
  const bool paged = a.tables != nullptr;
  if (a.C == 1)
    return paged ? launch_cr<1, true>(a, d, stream) : launch_cr<1, false>(a, d, stream);
  return paged ? launch_cr<8, true>(a, d, stream) : launch_cr<8, false>(a, d, stream);
}

}  // namespace

extern "C" {

// K5. q [B, N, D] (strides q_sb, q_sn); k/v [B, S, N, D] read through
// their strides (last dim contiguous); lengths [B] int32; out [B, N, D].
int ptt_decode_attention_f32(const void* q, const void* k, const void* v,
                             const void* lengths, void* out, void* part_m, void* part_l,
                             void* part_acc, int B, int S, int N, int D, long long q_sb,
                             long long q_sn, long long k_sb, long long k_ss, long long k_sn,
                             long long v_sb, long long v_ss, long long v_sn, int nsplit,
                             float scale, void* stream) {
  Args a;
  a.q = static_cast<const float*>(q);
  a.k = static_cast<const float*>(k);
  a.v = static_cast<const float*>(v);
  a.tables = nullptr;
  a.lengths = static_cast<const int*>(lengths);
  a.out = static_cast<float*>(out);
  a.part_m = static_cast<float*>(part_m);
  a.part_l = static_cast<float*>(part_l);
  a.part_acc = static_cast<float*>(part_acc);
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
  return static_cast<int>(launch(a, D, static_cast<cudaStream_t>(stream)));
}

// K6. q [B, C, N, D] (strides q_sb, q_sc, q_sn); pools [NB, bs, N, D]
// read through their strides (last dim contiguous); tables [B, M] int32
// contiguous; lengths [B] int32; out [B, C, N, D].
int ptt_paged_decode_attention_f32(const void* q, const void* k_pool, const void* v_pool,
                                   const void* tables, const void* lengths, void* out,
                                   void* part_m, void* part_l, void* part_acc, int B, int C,
                                   int N, int D, int NB, int bs, int M, long long q_sb,
                                   long long q_sc, long long q_sn, long long k_sb,
                                   long long k_ss, long long k_sn, long long v_sb,
                                   long long v_ss, long long v_sn, int nsplit, float scale,
                                   void* stream) {
  Args a;
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
  if (a.tables == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch(a, D, static_cast<cudaStream_t>(stream)));
}

}  // extern "C"
