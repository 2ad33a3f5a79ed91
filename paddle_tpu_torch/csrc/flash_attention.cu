// FlashAttention-2 forward and backward for Hopper (sm_90a): kernels
// K1-K4 of the port, one family of three CUDA kernels.
//
// ptt_flash_fwd      replaces paddle_tpu/ops/pallas/flash_attention.py
//                    ::_fwd_kernel (K1, via _fwd) and ::_fwd1_kernel
//                    (K4f, via _fwd1).
// ptt_flash_bwd_dkv  replaces ::_bwd_dkv_kernel (K2, via _bwd) and the
//                    dK/dV/dbias half of ::_bwd1_kernel (K4b, via _bwd1).
// ptt_flash_bwd_dq   replaces ::_bwd_dq_kernel (K3, via _bwd) and the dQ
//                    half of ::_bwd1_kernel (K4b).
//
// The single-tile Pallas pair exists because a 512 x 512 f32 score tile
// fits in a TPU core's VMEM. A Hopper block has at most 227 KB of shared
// memory, so every T here streams key (or query) tiles of 64 with an
// online softmax, and one kernel family covers both Pallas paths.
//
// What bounds them on this card: operations. At BERT-base shapes
// (T=512, D=64) the forward does 4*T*T*D flops for 4*T*D elements read
// and written per (batch, head), ~T/2 flops per byte in bf16, far above
// the H100's ~20 flops/byte CUDA-core ridge. This first version runs on
// the CUDA cores in float32 (67 TFLOP/s peak), not on the tensor cores
// (989 TFLOP/s bf16): simple and right first; mma/wgmma tiles come
// later.
//
// What the design does about it:
//  * 256 threads own a 64 x 64 score tile, 4 x 4 per thread; operand
//    tiles sit in shared memory as f32 rows padded to D + 4, read as
//    float4 (16 FMAs per pair of 128-bit loads, no bank conflicts), and
//    the score tile is staged transposed so the following product reads
//    it as float4 broadcasts.
//  * Nothing of size T x T reaches device memory: s, p and ds live in
//    registers and one 64 x 64 shared tile; m, l and the accumulators
//    stay in registers in f32.
//  * Causal tiles wholly above the diagonal are skipped; the ragged edge
//    of T is masked in the kernel (no padding copies).
//  * q, k and v are read through their strides, so views of the fused
//    QKV projection [B, T, 3, N, D] need no transpose copy.
//  * dK/dV own a key tile and loop over query tiles; dQ owns a query tile
//    and loops over key tiles, so neither needs atomics for its output.
//    dbias (mask_grad) sums across heads with one atomicAdd per key per
//    block, so its summation order varies from run to run.
//
// Semantics follow the Pallas kernels: s = (q.k) * scale + bias[key]
// (f32), causal keeps col <= row, l sums the undropped p, the keep mask
// multiplies p before p.v and p is rounded to v's dtype first, l = 0
// gives safe_l = 1, lse = m + log(safe_l); the backward recomputes
// p = exp(s - lse), ds = p * (dp * keep - delta) * scale and rounds p*keep
// and ds to the operand dtype before their products. Dropout is the
// counter hash of _keep_mask, bit for bit: stream = fmix32(seed +
// (b*N + n) * 0x9E3779B9), x = fmix32(((row << 16) ^ col) + stream), keep
// iff x >= thresh, kept values scaled by keep_scale, with global rows and
// columns, so every tiling regenerates the same mask.
//
// Plain C interface, loaded with ctypes: every function returns the
// cudaError_t of its launch (0 on success). Nothing here allocates or
// synchronises; the caller owns every buffer and the stream.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 64;          // query rows and key columns per tile
constexpr int kLT = kTile + 4;     // row stride of the staged score tiles
constexpr float kNegInf = -1e30f;

// slots of FlashArgs::s: (batch, time, head) strides per tensor
enum { kQ = 0, kK = 3, kV = 6, kDO = 9, kO = 12, kDK = 15, kDV = 18 };

struct FlashArgs {
  const void* q;
  const void* k;
  const void* v;
  const float* bias;   // [B, Tk] additive key bias, or null
  const void* dout;
  const float* lse;    // [B*N, Tq]
  const float* delta;  // [B*N, Tq]
  void* out;           // o (forward) or dq
  void* dk;
  void* dv;
  float* lse_out;      // [B*N, Tq]
  float* dbias;        // [B, Tk], zeroed by the caller, or null
  int B, N, Tq, Tk;
  long long s[21];
  float scale;
  int causal;
  int dropout;
  unsigned seed;
  unsigned thresh;
  float keep_scale;
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// x rounded to T's precision (the Pallas kernels' astype before a matmul)
template <typename T>
__device__ __forceinline__ float round_to(float x) { return to_f(from_f<T>(x)); }

__device__ __forceinline__ uint32_t fmix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x;
}

__device__ __forceinline__ float keep_factor(const FlashArgs& a, uint32_t stream, int row,
                                             int col) {
  const uint32_t x = fmix32((((uint32_t)row << 16) ^ (uint32_t)col) + stream);
  return x >= a.thresh ? a.keep_scale : 0.f;
}

__device__ __forceinline__ bool valid_at(const FlashArgs& a, int row, int col) {
  return row < a.Tq && col < a.Tk && (!a.causal || col <= row);
}

// s = (q.k) * scale + bias, rounded as two f32 operations (no FMA), as
// the Pallas kernels compute it
__device__ __forceinline__ float score(float dot, float scale, float bias) {
  return __fadd_rn(__fmul_rn(dot, scale), bias);
}

// rows [r0, r0 + 64) of one (batch, head) slice into a [64][D + 4] f32
// tile; rows at or beyond `limit` are zeros
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* src, long long st, int r0,
                                          int limit) {
  constexpr int LD = D + 4;
  for (int idx = threadIdx.x; idx < kTile * D; idx += kThreads) {
    const int r = idx / D, d = idx % D;
    const int row = r0 + r;
    dst[r * LD + d] = row < limit ? to_f(src[(long long)row * st + d]) : 0.f;
  }
}

// 64 per-row values (lse, delta) of rows [r0, r0 + 64); zeros beyond limit
__device__ __forceinline__ void load_rows(float* dst, const float* src, int r0, int limit) {
  if (threadIdx.x < kTile) {
    const int row = r0 + threadIdx.x;
    dst[threadIdx.x] = row < limit ? src[row] : 0.f;
  }
}

// s[i][j] = A[ty*4 + i] . B[tx + 16*j] over D, for rows of two
// [64][D + 4] tiles (ty = thread / 16, tx = thread % 16)
template <int D>
__device__ __forceinline__ void tile_dot(const float* A, const float* Bm, float s[4][4]) {
  constexpr int LD = D + 4;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; d += 4) {
    float4 x[4], y[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) x[i] = *reinterpret_cast<const float4*>(A + (ty * 4 + i) * LD + d);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      y[j] = *reinterpret_cast<const float4*>(Bm + (tx + 16 * j) * LD + d);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float t = s[i][j];
        t = fmaf(x[i].x, y[j].x, t);
        t = fmaf(x[i].y, y[j].y, t);
        t = fmaf(x[i].z, y[j].z, t);
        t = fmaf(x[i].w, y[j].w, t);
        s[i][j] = t;
      }
  }
}

// St[tx + 16*j][ty*4 + i] = s[i][j]: the tile staged transposed
__device__ __forceinline__ void store_t(float* St, const float s[4][4]) {
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
#pragma unroll
  for (int j = 0; j < 4; ++j)
    *reinterpret_cast<float4*>(St + (tx + 16 * j) * kLT + ty * 4) =
        make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
}

// acc[i][c] += sum over k < 64 of St[k][ty*4 + i] * M[k][tx*CW + c],
// CW = D / 16 columns per thread
template <int D>
__device__ __forceinline__ void acc_mm(const float* St, const float* M, float acc[4][D / 16]) {
  constexpr int LD = D + 4, CW = D / 16;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
#pragma unroll 4
  for (int k = 0; k < kTile; ++k) {
    const float4 t = *reinterpret_cast<const float4*>(St + k * kLT + ty * 4);
    float m[CW];
    const float* row = M + k * LD + tx * CW;
    if constexpr (CW % 4 == 0) {
#pragma unroll
      for (int c = 0; c < CW; c += 4) {
        const float4 x = *reinterpret_cast<const float4*>(row + c);
        m[c] = x.x;
        m[c + 1] = x.y;
        m[c + 2] = x.z;
        m[c + 3] = x.w;
      }
    } else {
#pragma unroll
      for (int c = 0; c < CW; c += 2) {
        const float2 x = *reinterpret_cast<const float2*>(row + c);
        m[c] = x.x;
        m[c + 1] = x.y;
      }
    }
#pragma unroll
    for (int c = 0; c < CW; ++c) {
      acc[0][c] = fmaf(t.x, m[c], acc[0][c]);
      acc[1][c] = fmaf(t.y, m[c], acc[1][c]);
      acc[2][c] = fmaf(t.z, m[c], acc[2][c]);
      acc[3][c] = fmaf(t.w, m[c], acc[3][c]);
    }
  }
}

template <typename T>
__device__ __forceinline__ const T* slice(const void* base, const long long* s, int b, int n) {
  return static_cast<const T*>(base) + (long long)b * s[0] + (long long)n * s[2];
}

template <typename T>
__device__ __forceinline__ T* slice_out(void* base, const long long* s, int b, int n) {
  return static_cast<T*>(base) + (long long)b * s[0] + (long long)n * s[2];
}

// rows ty*4 + i of a [64][D] result tile, columns tx*CW + c, to memory
template <typename T, int D>
__device__ __forceinline__ void write_rows(T* dst, long long st, int r0, int limit,
                                           const float acc[4][D / 16], const float* mul) {
  constexpr int CW = D / 16;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = r0 + ty * 4 + i;
    if (row >= limit) continue;
#pragma unroll
    for (int c = 0; c < CW; ++c)
      dst[(long long)row * st + tx * CW + c] =
          from_f<T>(mul ? acc[i][c] / mul[i] : acc[i][c]);
  }
}

// ---------------------------------------------------------------------------
// forward: one block per (query tile, batch * head)
// ---------------------------------------------------------------------------
template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(FlashArgs a) {
  constexpr int LD = D + 4, CW = D / 16;
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* Ks = Qs + kTile * LD;
  float* Vs = Ks + kTile * LD;
  float* Pt = Vs + kTile * LD;        // [key][row]
  float* bias_s = Pt + kTile * kLT;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int q0 = blockIdx.x * kTile;
  const int bh = blockIdx.y;
  const int b = bh / a.N, n = bh % a.N;
  const T* q = slice<T>(a.q, a.s + kQ, b, n);
  const T* k = slice<T>(a.k, a.s + kK, b, n);
  const T* v = slice<T>(a.v, a.s + kV, b, n);
  const uint32_t stream = fmix32(a.seed + (uint32_t)bh * 0x9E3779B9u);

  load_tile<T, D>(Qs, q, a.s[kQ + 1], q0, a.Tq);
  float m[4], l[4], acc[4][CW];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < CW; ++c) acc[i][c] = 0.f;
  }
  const int k_end = a.causal ? min(a.Tk, q0 + kTile) : a.Tk;
  for (int k0 = 0; k0 < k_end; k0 += kTile) {
    __syncthreads();  // the previous tile's readers are done
    load_tile<T, D>(Ks, k, a.s[kK + 1], k0, a.Tk);
    load_tile<T, D>(Vs, v, a.s[kV + 1], k0, a.Tk);
    if (threadIdx.x < kTile)
      bias_s[threadIdx.x] = (a.bias != nullptr && k0 + (int)threadIdx.x < a.Tk)
                                ? a.bias[(long long)b * a.Tk + k0 + threadIdx.x]
                                : 0.f;
    __syncthreads();
    float s[4][4];
    tile_dot<D>(Qs, Ks, s);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty * 4 + i;
      float mt = kNegInf;
      unsigned ok = 0;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tx + 16 * j;
        s[i][j] = score(s[i][j], a.scale, bias_s[tx + 16 * j]);
        if (valid_at(a, row, col)) {
          ok |= 1u << j;
          mt = fmaxf(mt, s[i][j]);
        }
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, off));
      const float m_new = fmaxf(m[i], mt);
      const float corr = expf(m[i] - m_new);
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = (ok >> j) & 1u ? expf(s[i][j] - m_new) : 0.f;
        psum += p;
        s[i][j] = p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) psum += __shfl_xor_sync(0xffffffffu, psum, off);
      l[i] = l[i] * corr + psum;  // l sums the undropped p
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < CW; ++c) acc[i][c] *= corr;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float p = s[i][j];
        if (a.dropout) p *= keep_factor(a, stream, row, k0 + tx + 16 * j);
        s[i][j] = round_to<T>(p);
      }
    }
    store_t(Pt, s);
    __syncthreads();
    acc_mm<D>(Pt, Vs, acc);
  }

  float safe_l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) safe_l[i] = l[i] == 0.f ? 1.f : l[i];
  write_rows<T, D>(slice_out<T>(a.out, a.s + kO, b, n), a.s[kO + 1], q0, a.Tq, acc, safe_l);
  if (tx == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty * 4 + i;
      if (row < a.Tq) a.lse_out[(long long)bh * a.Tq + row] = m[i] + logf(safe_l[i]);
    }
  }
}

// ---------------------------------------------------------------------------
// backward dK / dV (+ dbias): one block per (key tile, batch * head)
// ---------------------------------------------------------------------------
template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkv_kernel(FlashArgs a) {
  constexpr int LD = D + 4, CW = D / 16;
  extern __shared__ float4 smem4[];
  float* Ks = reinterpret_cast<float*>(smem4);
  float* Vs = Ks + kTile * LD;
  float* Qs = Vs + kTile * LD;
  float* dOs = Qs + kTile * LD;
  float* Ps = dOs + kTile * LD;       // [row][key]: p * keep in dO's dtype
  float* Ds = Ps + kTile * kLT;       // [row][key]: ds in q's dtype
  float* lse_s = Ds + kTile * kLT;
  float* delta_s = lse_s + kTile;
  float* bias_s = delta_s + kTile;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int k0 = blockIdx.x * kTile;
  const int bh = blockIdx.y;
  const int b = bh / a.N, n = bh % a.N;
  const T* q = slice<T>(a.q, a.s + kQ, b, n);
  const T* k = slice<T>(a.k, a.s + kK, b, n);
  const T* v = slice<T>(a.v, a.s + kV, b, n);
  const T* dout = slice<T>(a.dout, a.s + kDO, b, n);
  const float* lse = a.lse + (long long)bh * a.Tq;
  const float* delta = a.delta + (long long)bh * a.Tq;
  const uint32_t stream = fmix32(a.seed + (uint32_t)bh * 0x9E3779B9u);

  load_tile<T, D>(Ks, k, a.s[kK + 1], k0, a.Tk);
  load_tile<T, D>(Vs, v, a.s[kV + 1], k0, a.Tk);
  if (threadIdx.x < kTile)
    bias_s[threadIdx.x] = (a.bias != nullptr && k0 + (int)threadIdx.x < a.Tk)
                              ? a.bias[(long long)b * a.Tk + k0 + threadIdx.x]
                              : 0.f;
  float dk[4][CW], dv[4][CW], dbias[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    dbias[i] = 0.f;
#pragma unroll
    for (int c = 0; c < CW; ++c) dk[i][c] = dv[i][c] = 0.f;
  }
  // causal: query tiles wholly above this key tile see none of its keys
  for (int q0 = a.causal ? k0 : 0; q0 < a.Tq; q0 += kTile) {
    __syncthreads();
    load_tile<T, D>(Qs, q, a.s[kQ + 1], q0, a.Tq);
    load_tile<T, D>(dOs, dout, a.s[kDO + 1], q0, a.Tq);
    load_rows(lse_s, lse, q0, a.Tq);
    load_rows(delta_s, delta, q0, a.Tq);
    __syncthreads();
    float st[4][4], dpt[4][4];
    tile_dot<D>(Ks, Qs, st);    // st[i][j] = k[key i] . q[row j]
    tile_dot<D>(Vs, dOs, dpt);  // dpt[i][j] = v[key i] . dO[row j]
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int col = k0 + ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int row = q0 + tx + 16 * j;
        const float s = score(st[i][j], a.scale, bias_s[ty * 4 + i]);
        const float p = valid_at(a, row, col) ? expf(s - lse_s[tx + 16 * j]) : 0.f;
        const float keep = a.dropout ? keep_factor(a, stream, row, col) : 1.f;
        const float ds = p * (dpt[i][j] * keep - delta_s[tx + 16 * j]) * a.scale;
        dbias[i] += ds / a.scale;
        st[i][j] = round_to<T>(p * keep);
        dpt[i][j] = round_to<T>(ds);
      }
    }
    store_t(Ps, st);
    store_t(Ds, dpt);
    __syncthreads();
    acc_mm<D>(Ps, dOs, dv);  // dV += (p * keep)^T dO
    acc_mm<D>(Ds, Qs, dk);   // dK += ds^T q
  }

  write_rows<T, D>(slice_out<T>(a.dk, a.s + kDK, b, n), a.s[kDK + 1], k0, a.Tk, dk, nullptr);
  write_rows<T, D>(slice_out<T>(a.dv, a.s + kDV, b, n), a.s[kDV + 1], k0, a.Tk, dv, nullptr);
  if (a.dbias != nullptr) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float x = dbias[i];
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
      const int col = k0 + ty * 4 + i;
      if (tx == 0 && col < a.Tk) atomicAdd(a.dbias + (long long)b * a.Tk + col, x);
    }
  }
}

// ---------------------------------------------------------------------------
// backward dQ: one block per (query tile, batch * head)
// ---------------------------------------------------------------------------
template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_kernel(FlashArgs a) {
  constexpr int LD = D + 4, CW = D / 16;
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* dOs = Qs + kTile * LD;
  float* Ks = dOs + kTile * LD;
  float* Vs = Ks + kTile * LD;
  float* Dt = Vs + kTile * LD;        // [key][row]: ds in k's dtype
  float* lse_s = Dt + kTile * kLT;
  float* delta_s = lse_s + kTile;
  float* bias_s = delta_s + kTile;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int q0 = blockIdx.x * kTile;
  const int bh = blockIdx.y;
  const int b = bh / a.N, n = bh % a.N;
  const T* q = slice<T>(a.q, a.s + kQ, b, n);
  const T* k = slice<T>(a.k, a.s + kK, b, n);
  const T* v = slice<T>(a.v, a.s + kV, b, n);
  const T* dout = slice<T>(a.dout, a.s + kDO, b, n);
  const uint32_t stream = fmix32(a.seed + (uint32_t)bh * 0x9E3779B9u);

  load_tile<T, D>(Qs, q, a.s[kQ + 1], q0, a.Tq);
  load_tile<T, D>(dOs, dout, a.s[kDO + 1], q0, a.Tq);
  load_rows(lse_s, a.lse + (long long)bh * a.Tq, q0, a.Tq);
  load_rows(delta_s, a.delta + (long long)bh * a.Tq, q0, a.Tq);
  float dq[4][CW];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < CW; ++c) dq[i][c] = 0.f;
  const int k_end = a.causal ? min(a.Tk, q0 + kTile) : a.Tk;
  for (int k0 = 0; k0 < k_end; k0 += kTile) {
    __syncthreads();
    load_tile<T, D>(Ks, k, a.s[kK + 1], k0, a.Tk);
    load_tile<T, D>(Vs, v, a.s[kV + 1], k0, a.Tk);
    if (threadIdx.x < kTile)
      bias_s[threadIdx.x] = (a.bias != nullptr && k0 + (int)threadIdx.x < a.Tk)
                                ? a.bias[(long long)b * a.Tk + k0 + threadIdx.x]
                                : 0.f;
    __syncthreads();
    float s[4][4], dp[4][4];
    tile_dot<D>(Qs, Ks, s);
    tile_dot<D>(dOs, Vs, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tx + 16 * j;
        const float sc = score(s[i][j], a.scale, bias_s[tx + 16 * j]);
        const float p = valid_at(a, row, col) ? expf(sc - lse_s[ty * 4 + i]) : 0.f;
        const float keep = a.dropout ? keep_factor(a, stream, row, col) : 1.f;
        dp[i][j] = round_to<T>(p * (dp[i][j] * keep - delta_s[ty * 4 + i]) * a.scale);
      }
    }
    store_t(Dt, dp);
    __syncthreads();
    acc_mm<D>(Dt, Ks, dq);  // dQ += ds k
  }
  write_rows<T, D>(slice_out<T>(a.out, a.s + kO, b, n), a.s[kO + 1], q0, a.Tq, dq, nullptr);
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------
enum Which { kFwd, kDkv, kDq };

template <int D>
constexpr size_t smem_bytes(Which w) {
  return sizeof(float) * (w == kFwd   ? 3 * kTile * (D + 4) + kTile * kLT + kTile
                          : w == kDkv ? 4 * kTile * (D + 4) + 2 * kTile * kLT + 3 * kTile
                                      : 4 * kTile * (D + 4) + kTile * kLT + 3 * kTile);
}

template <typename T, int D>
cudaError_t launch_td(Which w, const FlashArgs& a, cudaStream_t stream) {
  const size_t bytes = smem_bytes<D>(w);
  void (*kernel)(FlashArgs) = w == kFwd   ? flash_fwd_kernel<T, D>
                              : w == kDkv ? flash_bwd_dkv_kernel<T, D>
                                          : flash_bwd_dq_kernel<T, D>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  const int tiles = ((w == kDkv ? a.Tk : a.Tq) + kTile - 1) / kTile;
  kernel<<<dim3(tiles, a.B * a.N), kThreads, bytes, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_t(Which w, const FlashArgs& a, int d, cudaStream_t stream) {
  switch (d) {
    case 32: return launch_td<T, 32>(w, a, stream);
    case 64: return launch_td<T, 64>(w, a, stream);
    case 128: return launch_td<T, 128>(w, a, stream);
    default: return cudaErrorInvalidValue;
  }
}

// dtype: 0 float32, 1 bfloat16
int launch(Which w, FlashArgs& a, int dtype, int d, const long long* strides, float scale,
           int causal, int dropout, unsigned seed, unsigned thresh, float keep_scale,
           void* stream) {
  if (a.B <= 0 || a.N <= 0 || a.Tq <= 0 || a.Tk <= 0 || a.Tq > 65535 || a.Tk > 65535 ||
      (long long)a.B * a.N > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  for (int i = 0; i < 21; ++i) a.s[i] = strides[i];
  a.scale = scale;
  a.causal = causal;
  a.dropout = dropout;
  a.seed = seed;
  a.thresh = thresh;
  a.keep_scale = keep_scale;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0)
    err = launch_t<float>(w, a, d, st);
  else if (dtype == 1)
    err = launch_t<__nv_bfloat16>(w, a, d, st);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

FlashArgs make_args(const void* q, const void* k, const void* v, const void* bias, int B,
                    int N, int Tq, int Tk) {
  FlashArgs a = {};
  a.q = q;
  a.k = k;
  a.v = v;
  a.bias = static_cast<const float*>(bias);
  a.B = B;
  a.N = N;
  a.Tq = Tq;
  a.Tk = Tk;
  return a;
}

}  // namespace

extern "C" {

// Forward. q [B, Tq, N, D], k/v [B, Tk, N, D] and o [B, Tq, N, D] through
// their (batch, time, head) strides in slots 0, 3, 6 and 12 of
// `strides` (21 values, host memory); bias [B, Tk] f32 or null; lse
// [B*N, Tq] f32.
int ptt_flash_fwd(const void* q, const void* k, const void* v, const void* bias, void* o,
                  void* lse, int dtype, int B, int N, int Tq, int Tk, int D,
                  const long long* strides, float scale, int causal, int dropout,
                  unsigned seed, unsigned thresh, float keep_scale, void* stream) {
  FlashArgs a = make_args(q, k, v, bias, B, N, Tq, Tk);
  a.out = o;
  a.lse_out = static_cast<float*>(lse);
  return launch(kFwd, a, dtype, D, strides, scale, causal, dropout, seed, thresh, keep_scale,
                stream);
}

// dK, dV and (dbias != null) dbias. dout in slot 9, dk in 15, dv in 18;
// lse and delta [B*N, Tq] f32; dbias [B, Tk] f32, zeroed by the caller.
int ptt_flash_bwd_dkv(const void* q, const void* k, const void* v, const void* bias,
                      const void* dout, const void* lse, const void* delta, void* dk, void* dv,
                      void* dbias, int dtype, int B, int N, int Tq, int Tk, int D,
                      const long long* strides, float scale, int causal, int dropout,
                      unsigned seed, unsigned thresh, float keep_scale, void* stream) {
  FlashArgs a = make_args(q, k, v, bias, B, N, Tq, Tk);
  a.dout = dout;
  a.lse = static_cast<const float*>(lse);
  a.delta = static_cast<const float*>(delta);
  a.dk = dk;
  a.dv = dv;
  a.dbias = static_cast<float*>(dbias);
  return launch(kDkv, a, dtype, D, strides, scale, causal, dropout, seed, thresh, keep_scale,
                stream);
}

// dQ, in slot 12.
int ptt_flash_bwd_dq(const void* q, const void* k, const void* v, const void* bias,
                     const void* dout, const void* lse, const void* delta, void* dq, int dtype,
                     int B, int N, int Tq, int Tk, int D, const long long* strides, float scale,
                     int causal, int dropout, unsigned seed, unsigned thresh, float keep_scale,
                     void* stream) {
  FlashArgs a = make_args(q, k, v, bias, B, N, Tq, Tk);
  a.dout = dout;
  a.lse = static_cast<const float*>(lse);
  a.delta = static_cast<const float*>(delta);
  a.out = dq;
  return launch(kDq, a, dtype, D, strides, scale, causal, dropout, seed, thresh, keep_scale,
                stream);
}

}  // extern "C"
