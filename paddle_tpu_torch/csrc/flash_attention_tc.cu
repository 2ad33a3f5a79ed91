// FlashAttention forward and backward for Hopper's tensor cores (sm_90a),
// bfloat16 in, float32 accumulate: the bf16 half of kernels K1-K4 of the
// port. (float32 has its own tensor-core pair, in three bf16 pieces:
// flash_fwd_f32_tc.cu and flash_bwd_f32_tc.cu.)
//
// ptt_flash_fwd  replaces paddle_tpu/ops/pallas/flash_attention.py
//                ::_fwd_kernel (K1, :160, via _fwd) and ::_fwd1_kernel
//                (K4f, :280, via _fwd1).
// ptt_flash_bwd  replaces ::_bwd_dkv_kernel (K2, :468) and ::_bwd_dq_kernel
//                (K3, :543), both via _bwd, and ::_bwd1_kernel (K4b, :311,
//                via _bwd1): dQ, dK, dV and dbias from one kernel, as the
//                single-tile _bwd1_kernel emits them.
//
// What bounds them on this card: operations. At BERT-base shapes (T=512,
// D=64) the forward does 4*T*T*D flops per (batch, head) against 4*T*D
// bf16 elements read and written, ~T/2 = 256 flops per byte, near the
// H100's bf16 tensor-core ridge (989 TFLOP/s over 3.35 TB/s = 295); the
// backward does 10*T*T*D flops against ~7*T*D elements, above it. On the
// CUDA cores (67 TFLOP/s f32) both would sit ~15x above that bound.
//
// What the design does about it:
//  * Every product is a warpgroup MMA (wgmma.mma_async m64nNk16, bf16 x
//    bf16 -> f32) on the tensor cores. Operand tiles stay bf16 in shared
//    memory in the 128-byte swizzled layout the wgmma descriptors read
//    (16-byte chunk c of a 128-byte row r sits at chunk c ^ (r % 8));
//    head dim 128 is two such 64-column sub-tiles, head dim 32 is held as
//    64 with zero columns.
//  * Tiles arrive by cp.async.cg 16-byte copies into a 2-stage ring, so
//    the next tile's copy overlaps this tile's products; rows past T and
//    padding columns are zero-filled through the copy's src-size operand.
//  * Forward: one CTA per (128 query rows, batch * head), two warpgroups
//    of 64 rows; S = Q.K^T over 128-key tiles from shared memory, the
//    online softmax (exp2f, log2 e folded into the scale) on the
//    accumulator fragment in registers, and P x keep, rounded to bf16,
//    fed back as the register A operand of O += P.V (V read through the
//    descriptor's transpose flag, so no transposed copy).
//  * Backward (FA2/FA3 structure): one CTA per (128 keys, batch * head),
//    each warpgroup owning 64 keys, looping over 64-row query tiles
//    (causal: from the diagonal). S^T = K.Q^T and dP^T = V.dO^T put p
//    and dp in registers with keys as rows; the recompute of s and dp is
//    counted once (10*T*T*D flops where the split dK/dV + dQ pair spent
//    14). P^T x keep and dS^T, rounded to bf16, go to shared memory
//    ([128 keys][64 rows] each), where dV += (P^T x keep).dO and dK +=
//    dS^T.Q read them as A and dQ = dS.K reads dS^T through the
//    transpose flag, the two warpgroups splitting dQ's columns. (As
//    register A operands they would hold 32 more registers a thread,
//    which head dim 128, with two 64 x 128 f32 accumulators, cannot
//    spare.) dQ is added into a float32 workspace [B, Tq, N, D] with
//    atomics, so its summation order, like dbias's, varies from run to
//    run; the wrapper zeroes the workspace and casts it to bf16.
//  * Nothing of size T x T reaches device memory; m, l and the
//    accumulators stay in registers in f32.
//
// Semantics are those of the Pallas kernels:
// s = (q.k) * scale + bias[key] (f32), causal keeps col <= row, the ragged
// edge of T masked, l sums the undropped p, p x keep rounded to bf16
// before P.V, l = 0 gives safe_l = 1, lse = m + log(safe_l) as [B*N, Tq]
// f32; the backward recomputes p = exp(s - lse), ds = p * (dp * keep -
// delta) * scale (delta = rowsum(dO * O) - dlse, computed by the caller)
// and rounds p * keep and ds to bf16 before their products. Dropout is
// the counter hash of _keep_mask, bit for bit: stream = fmix32(seed +
// (b*N + n) * 0x9E3779B9), x = fmix32(((row << 16) ^ col) + stream), keep
// iff x >= thresh, with global rows and columns taken from the wgmma
// accumulator layout. q, k, v, dO are read through their (batch, time,
// head) strides (16-byte aligned rows), so views of the fused QKV [B, T,
// 3, N, D] need no copy.
//
// Plain C interface, loaded with ctypes: every function returns the
// cudaError_t of its launch (0 on success). Nothing here allocates or
// synchronises; the caller owns every buffer and the stream.

#include "tc_common.cuh"

namespace {

constexpr int kThreads = 256;      // two warpgroups
constexpr int kFwdRows = 128;      // query rows per forward CTA
constexpr int kFwdKeys = 128;      // keys per forward tile
constexpr int kBwdKeys = 128;      // keys per backward CTA
constexpr int kBwdRows = 64;       // query rows per backward tile
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// slots of TcArgs::s: (batch, time, head) strides per tensor
enum { kQ = 0, kK = 3, kV = 6, kDO = 9, kO = 12, kDK = 15, kDV = 18 };

struct TcArgs {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  const float* bias;   // [B, Tk] additive key bias, or null
  const bf16* dout;
  const float* lse;    // [B*N, Tq]
  const float* delta;  // [B*N, Tq]
  bf16* o;
  float* dq;           // f32 workspace, zeroed by the caller (slot kO)
  bf16* dk;
  bf16* dv;
  float* lse_out;      // [B*N, Tq]
  float* dbias;        // [B, Tk], zeroed by the caller, or null
  int B, N, Tq, Tk;
  long long s[21];
  float scale;         // softmax scale
  float scale_log2;    // scale * log2(e)
  int causal;
  int dropout;
  unsigned seed;
  unsigned thresh;
  float keep_scale;
};

// ---------------------------------------------------------------------------
// helpers of the flash kernels (the tensor-core ones are in tc_common.cuh)
// ---------------------------------------------------------------------------
__device__ __forceinline__ float keep_factor(const TcArgs& a, uint32_t stream, int row, int col) {
  const uint32_t x = fmix32((((uint32_t)row << 16) ^ (uint32_t)col) + stream);
  return x >= a.thresh ? a.keep_scale : 0.f;
}

template <typename T>
__device__ __forceinline__ T* slice(T* base, const long long* s, int b, int n) {
  return base + (long long)b * s[0] + (long long)n * s[2];
}


// ---------------------------------------------------------------------------
// forward: one CTA per (128 query rows, batch * head)
// ---------------------------------------------------------------------------
template <int D>
__global__ void __launch_bounds__(kThreads, 1) flash_fwd_tc_kernel(const TcArgs a) {
  constexpr int DP = Cols<D>::P;
  constexpr int QB = kFwdRows * DP * 2;  // bytes of the Q tile
  constexpr int KB = kFwdKeys * DP * 2;  // bytes of one K or V tile
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  const uint32_t sQ = smem_u32(smem);
  const uint32_t sK = sQ + QB;       // two stages
  const uint32_t sV = sK + 2 * KB;   // two stages
  float* bias_s = reinterpret_cast<float*>(smem + QB + 4 * KB);  // [2][kFwdKeys], log2 units

  const int tid = threadIdx.x, wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int q0 = blockIdx.x * kFwdRows;
  const int bh = blockIdx.y, b = bh / a.N, n = bh % a.N;
  const bf16* q = slice(a.q, a.s + kQ, b, n);
  const bf16* k = slice(a.k, a.s + kK, b, n);
  const bf16* v = slice(a.v, a.s + kV, b, n);
  const uint32_t stream = fmix32(a.seed + (uint32_t)bh * 0x9E3779B9u);
  const int k_end = a.causal ? min(a.Tk, q0 + kFwdRows) : a.Tk;
  const int n_tiles = (k_end + kFwdKeys - 1) / kFwdKeys;

  auto load_kv = [&](int t) {
    const int st = t & 1, k0 = t * kFwdKeys;
    load_tile<kFwdKeys, D, kThreads>(sK + st * KB, k, a.s[kK + 1], k0, a.Tk);
    load_tile<kFwdKeys, D, kThreads>(sV + st * KB, v, a.s[kV + 1], k0, a.Tk);
    if (tid < kFwdKeys)
      bias_s[st * kFwdKeys + tid] = (a.bias != nullptr && k0 + tid < a.Tk)
                                        ? a.bias[(long long)b * a.Tk + k0 + tid] * kLog2e
                                        : 0.f;
  };
  load_tile<kFwdRows, D, kThreads>(sQ, q, a.s[kQ + 1], q0, a.Tq);
  load_kv(0);
  cp_async_commit();

  // this thread's two rows (h = 0, 1) and the keys each may see
  int row[2], lim[2];
  float m[2], l[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    row[h] = q0 + 64 * wg + 16 * warp + (lane >> 2) + 8 * h;
    lim[h] = a.causal ? min(a.Tk, row[h] + 1) : a.Tk;
    m[h] = kNegInf;
    l[h] = 0.f;
  }
  const int cq = 2 * (lane & 3);
  float o[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) o[i] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    if (t + 1 < n_tiles) load_kv(t + 1);
    cp_async_commit();
    cp_async_wait<1>();
    fence_async_smem();
    __syncthreads();
    const int st = t & 1, k0 = t * kFwdKeys;
    const uint32_t tK = sK + st * KB, tV = sV + st * KB;
    const float* bias_t = bias_s + st * kFwdKeys;

    // S = Q . K^T: 64 rows of this warpgroup x 128 keys
    float s[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) s[i] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk)
      wgmma_ss_n128<0, 0>(s, desc_kmajor(sQ + wg * 64 * 128, kFwdRows, kk),
                          desc_kmajor(tK, kFwdKeys, kk), 1);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);

    // online softmax on the fragment, in log2 units
    float mt[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      const int h = (i >> 1) & 1, c = 8 * (i >> 2) + cq + (i & 1);
      const float x = fmaf(s[i], a.scale_log2, bias_t[c]);
      s[i] = k0 + c < lim[h] ? x : kNegInf;
      mt[h] = fmaxf(mt[h], s[i]);
    }
    float corr[2], mu[2], ps[2] = {0.f, 0.f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float m_new = fmaxf(m[h], quad_max(mt[h]));
      corr[h] = exp2f(m[h] - m_new);
      m[h] = m_new;
      mu[h] = m_new == kNegInf ? 0.f : m_new;  // no key seen yet: every p is 0
    }
    uint32_t pa[32];
#pragma unroll
    for (int i = 0; i < 64; i += 2) {
      const int h = (i >> 1) & 1, c = k0 + 8 * (i >> 2) + cq;
      float p0 = exp2f(s[i] - mu[h]), p1 = exp2f(s[i + 1] - mu[h]);
      ps[h] += p0 + p1;  // l sums the undropped p
      if (a.dropout) {
        p0 *= keep_factor(a, stream, row[h], c);
        p1 *= keep_factor(a, stream, row[h], c + 1);
      }
      pa[i >> 1] = pack_bf16(p0, p1);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) l[h] = l[h] * corr[h] + ps[h];
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) o[i] *= corr[(i >> 1) & 1];

    // O += (P x keep) . V, P as the register A operand, V transposed
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kFwdKeys / 16; ++kk) {
      if constexpr (DP == 64)
        wgmma_rs_n64<1>(o, pa + 4 * kk, desc_mnmajor(tV, kFwdKeys, kk), 1);
      else
        wgmma_rs_n128<1>(o, pa + 4 * kk, desc_mnmajor(tV, kFwdKeys, kk), 1);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(o);
    fence_regs(pa);
    __syncthreads();  // stage st is free for tile t + 2
  }

  bf16* out = slice(a.o, a.s + kO, b, n);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float lsum = quad_sum(l[h]);
    const float safe_l = lsum == 0.f ? 1.f : lsum;
    const float inv = 1.f / safe_l;
    if (row[h] < a.Tq) {
#pragma unroll
      for (int i = 2 * h; i < DP / 2; i += 4) {
        const int c = 8 * (i >> 2) + cq;
        if (c < D)
          *reinterpret_cast<uint32_t*>(out + (long long)row[h] * a.s[kO + 1] + c) =
              pack_bf16(o[i] * inv, o[i + 1] * inv);
      }
      if ((lane & 3) == 0)
        a.lse_out[(long long)bh * a.Tq + row[h]] =
            m[h] == kNegInf ? kNegInf : (m[h] + log2f(safe_l)) * kLn2;
    }
  }
}

// ---------------------------------------------------------------------------
// backward: one CTA per (128 keys, batch * head) -> dK, dV, dbias; dQ by
// atomics into the f32 workspace
// ---------------------------------------------------------------------------
template <int D>
__global__ void __launch_bounds__(kThreads, 1) flash_bwd_tc_kernel(const TcArgs a) {
  constexpr int DP = Cols<D>::P;
  constexpr int KB = kBwdKeys * DP * 2;  // bytes of the K or V tile
  constexpr int RB = kBwdRows * DP * 2;  // bytes of one Q or dO tile
  constexpr int SB = kBwdKeys * 128;     // P^T or dS^T: [128 keys][64 rows] bf16
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  const uint32_t sK = smem_u32(smem);
  const uint32_t sV = sK + KB;
  const uint32_t sQ = sV + KB;       // two stages
  const uint32_t sO = sQ + 2 * RB;   // dO, two stages
  const uint32_t sP = sO + 2 * RB;   // P^T x keep
  const uint32_t sS = sP + SB;       // dS^T
  float* lse_s = reinterpret_cast<float*>(smem + 2 * KB + 4 * RB + 2 * SB);  // [2][64], log2 units
  float* delta_s = lse_s + 2 * kBwdRows;                                // [2][64]

  const int tid = threadIdx.x, wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int k0 = blockIdx.x * kBwdKeys;
  const int bh = blockIdx.y, b = bh / a.N, n = bh % a.N;
  const bf16* q = slice(a.q, a.s + kQ, b, n);
  const bf16* k = slice(a.k, a.s + kK, b, n);
  const bf16* v = slice(a.v, a.s + kV, b, n);
  const bf16* dout = slice(a.dout, a.s + kDO, b, n);
  const float* lse = a.lse + (long long)bh * a.Tq;
  const float* delta = a.delta + (long long)bh * a.Tq;
  const uint32_t stream = fmix32(a.seed + (uint32_t)bh * 0x9E3779B9u);
  // causal: query tiles wholly above this key tile see none of its keys
  const int q_begin = a.causal ? k0 : 0;
  const int n_tiles = q_begin < a.Tq ? (a.Tq - q_begin + kBwdRows - 1) / kBwdRows : 0;

  auto load_q = [&](int j) {
    const int st = j & 1, r0 = q_begin + j * kBwdRows;
    load_tile<kBwdRows, D, kThreads>(sQ + st * RB, q, a.s[kQ + 1], r0, a.Tq);
    load_tile<kBwdRows, D, kThreads>(sO + st * RB, dout, a.s[kDO + 1], r0, a.Tq);
    if (tid < kBwdRows) {
      const bool ok = r0 + tid < a.Tq;
      lse_s[st * kBwdRows + tid] = ok ? lse[r0 + tid] * kLog2e : 0.f;
      delta_s[st * kBwdRows + tid] = ok ? delta[r0 + tid] : 0.f;
    }
  };
  load_tile<kBwdKeys, D, kThreads>(sK, k, a.s[kK + 1], k0, a.Tk);
  load_tile<kBwdKeys, D, kThreads>(sV, v, a.s[kV + 1], k0, a.Tk);
  if (n_tiles > 0) load_q(0);
  cp_async_commit();

  // this thread's two keys, rows krow + 8h (h = 0, 1) of S^T, dK and dV
  const int krow = 64 * wg + 16 * warp + (lane >> 2);
  float bias_r[2], dbias_acc[2] = {0.f, 0.f};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int key = k0 + krow + 8 * h;
    bias_r[h] = (a.bias != nullptr && key < a.Tk) ? a.bias[(long long)b * a.Tk + key] * kLog2e
                                                  : 0.f;
  }
  const int cq = 2 * (lane & 3);
  float dk[DP / 2], dv[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) dk[i] = dv[i] = 0.f;

  for (int j = 0; j < n_tiles; ++j) {
    if (j + 1 < n_tiles) load_q(j + 1);
    cp_async_commit();
    cp_async_wait<1>();
    fence_async_smem();
    __syncthreads();
    const int st = j & 1, r0 = q_begin + j * kBwdRows;
    const uint32_t tQ = sQ + st * RB, tO = sO + st * RB;
    const float* lse_t = lse_s + st * kBwdRows;
    const float* delta_t = delta_s + st * kBwdRows;

    // S^T = K . Q^T and dP^T = V . dO^T: 64 keys of this warpgroup x 64 rows
    float sT[32], dpT[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) sT[i] = dpT[i] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk)
      wgmma_ss_n64<0, 0>(sT, desc_kmajor(sK + wg * 64 * 128, kBwdKeys, kk),
                         desc_kmajor(tQ, kBwdRows, kk), 1);
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk)
      wgmma_ss_n64<0, 0>(dpT, desc_kmajor(sV + wg * 64 * 128, kBwdKeys, kk),
                         desc_kmajor(tO, kBwdRows, kk), 1);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(sT);
    fence_regs(dpT);

    // p, keep and ds per element; P^T x keep and dS^T go to shared memory
    // as bf16 (row = key, 128 bytes of 64 query rows, swizzled), where
    // the dV, dK and dQ products read them
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const int h = (i >> 1) & 1, kl = krow + 8 * h, key = k0 + kl;
      float pk[2], ds[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = 8 * (i >> 2) + cq + e, r = r0 + c;
        const bool ok = key < a.Tk && r >= (a.causal ? key : 0) && r < a.Tq;
        const float p = ok ? exp2f(fmaf(sT[i + e], a.scale_log2, bias_r[h]) - lse_t[c]) : 0.f;
        const float keep = a.dropout ? keep_factor(a, stream, r, key) : 1.f;
        const float g = p * (dpT[i + e] * keep - delta_t[c]);
        dbias_acc[h] += g;
        pk[e] = p * keep;
        ds[e] = g * a.scale;
      }
      const uint32_t off = kl * 128 + (((i >> 2) ^ (kl & 7)) << 4) + cq * 2;
      st_shared_u32(sP + off, pack_bf16(pk[0], pk[1]));
      st_shared_u32(sS + off, pack_bf16(ds[0], ds[1]));
    }
    fence_async_smem();
    __syncthreads();  // both warpgroups' rows of P^T and dS^T are written

    // dV += (P^T x keep) . dO and dK += dS^T . Q: this warpgroup's 64 rows
    // of P^T and dS^T as A, the B operands transposed
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBwdRows / 16; ++kk) {
      const uint64_t p_kk = desc_kmajor(sP + wg * 64 * 128, kBwdKeys, kk);
      const uint64_t ds_kk = desc_kmajor(sS + wg * 64 * 128, kBwdKeys, kk);
      if constexpr (DP == 64) {
        wgmma_ss_n64<0, 1>(dv, p_kk, desc_mnmajor(tO, kBwdRows, kk), 1);
        wgmma_ss_n64<0, 1>(dk, ds_kk, desc_mnmajor(tQ, kBwdRows, kk), 1);
      } else {
        wgmma_ss_n128<0, 1>(dv, p_kk, desc_mnmajor(tO, kBwdRows, kk), 1);
        wgmma_ss_n128<0, 1>(dk, ds_kk, desc_mnmajor(tQ, kBwdRows, kk), 1);
      }
    }
    wgmma_commit();

    // dQ[64 rows x DP] = dS . K: warpgroup wg takes columns [wg * DP/2,
    // (wg + 1) * DP/2); both operands through the transpose flag
    if (D >= 64 || wg == 0) {
      float dq[DP / 4];
#pragma unroll
      for (int i = 0; i < DP / 4; ++i) dq[i] = 0.f;
      const uint32_t tKc = DP == 64 ? sK + wg * 64 : sK + wg * kBwdKeys * 128;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBwdKeys / 16; ++kk) {
        if constexpr (DP == 64)
          wgmma_ss_n32<1, 1>(dq, desc_mnmajor(sS, kBwdKeys, kk), desc_mnmajor(tKc, kBwdKeys, kk),
                             1);
        else
          wgmma_ss_n64<1, 1>(dq, desc_mnmajor(sS, kBwdKeys, kk), desc_mnmajor(tKc, kBwdKeys, kk),
                             1);
      }
      wgmma_commit();
      wgmma_wait_all();  // dV and dK too
      fence_regs(dq);
      float* dqp = slice(a.dq, a.s + kO, b, n);
#pragma unroll
      for (int i = 0; i < DP / 4; ++i) {
        const int r = r0 + 16 * warp + (lane >> 2) + 8 * ((i >> 1) & 1);
        const int c = wg * (DP / 2) + 8 * (i >> 2) + cq + (i & 1);
        if (r < a.Tq && c < D) atomicAdd(dqp + (long long)r * a.s[kO + 1] + c, dq[i]);
      }
    }
    wgmma_wait_all();
    fence_regs(dv);
    fence_regs(dk);
    __syncthreads();  // stage st, P^T and dS^T are free
  }

  bf16* dkp = slice(a.dk, a.s + kDK, b, n);
  bf16* dvp = slice(a.dv, a.s + kDV, b, n);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int key = k0 + krow + 8 * h;
    if (key < a.Tk) {
#pragma unroll
      for (int i = 2 * h; i < DP / 2; i += 4) {
        const int c = 8 * (i >> 2) + cq;
        if (c < D) {
          *reinterpret_cast<uint32_t*>(dkp + (long long)key * a.s[kDK + 1] + c) =
              pack_bf16(dk[i], dk[i + 1]);
          *reinterpret_cast<uint32_t*>(dvp + (long long)key * a.s[kDV + 1] + c) =
              pack_bf16(dv[i], dv[i + 1]);
        }
      }
    }
    const float x = quad_sum(dbias_acc[h]);
    if (a.dbias != nullptr && key < a.Tk && (lane & 3) == 0)
      atomicAdd(a.dbias + (long long)b * a.Tk + key, x);
  }
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------
template <int D>
constexpr size_t fwd_smem() {
  return 1024 + (size_t)Cols<D>::P * 2 * (kFwdRows + 4 * kFwdKeys) + 2 * kFwdKeys * 4;
}
template <int D>
constexpr size_t bwd_smem() {
  return 1024 + (size_t)Cols<D>::P * 2 * (2 * kBwdKeys + 4 * kBwdRows) + 2 * kBwdKeys * 128 +
         4 * kBwdRows * 4;
}

template <int D>
cudaError_t launch_d(bool fwd, const TcArgs& a, cudaStream_t stream) {
  const size_t bytes = fwd ? fwd_smem<D>() : bwd_smem<D>();
  void (*kernel)(TcArgs) = fwd ? flash_fwd_tc_kernel<D> : flash_bwd_tc_kernel<D>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  const int tiles = fwd ? (a.Tq + kFwdRows - 1) / kFwdRows : (a.Tk + kBwdKeys - 1) / kBwdKeys;
  kernel<<<dim3(tiles, a.B * a.N), kThreads, bytes, stream>>>(a);
  return cudaGetLastError();
}

int launch(bool fwd, TcArgs& a, int d, const long long* strides, float scale, int causal,
           int dropout, unsigned seed, unsigned thresh, float keep_scale, void* stream) {
  if (a.B <= 0 || a.N <= 0 || a.Tq <= 0 || a.Tk <= 0 || a.Tq > 65535 || a.Tk > 65535 ||
      (long long)a.B * a.N > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  for (int i = 0; i < 21; ++i) a.s[i] = strides[i];
  a.scale = scale;
  a.scale_log2 = scale * kLog2e;
  a.causal = causal;
  a.dropout = dropout;
  a.seed = seed;
  a.thresh = thresh;
  a.keep_scale = keep_scale;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 32: return static_cast<int>(launch_d<32>(fwd, a, st));
    case 64: return static_cast<int>(launch_d<64>(fwd, a, st));
    case 128: return static_cast<int>(launch_d<128>(fwd, a, st));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

TcArgs make_args(const void* q, const void* k, const void* v, const void* bias, int B, int N,
                 int Tq, int Tk) {
  TcArgs a = {};
  a.q = static_cast<const bf16*>(q);
  a.k = static_cast<const bf16*>(k);
  a.v = static_cast<const bf16*>(v);
  a.bias = static_cast<const float*>(bias);
  a.B = B;
  a.N = N;
  a.Tq = Tq;
  a.Tk = Tk;
  return a;
}

}  // namespace

extern "C" {

// Forward, bfloat16. q [B, Tq, N, D], k/v [B, Tk, N, D] and o [B, Tq, N,
// D] through their (batch, time, head) strides in slots 0, 3, 6 and 12 of
// `strides` (21 values, host memory; rows 16-byte aligned); bias [B, Tk]
// f32 or null; lse [B*N, Tq] f32.
int ptt_flash_fwd(const void* q, const void* k, const void* v, const void* bias, void* o,
                  void* lse, int B, int N, int Tq, int Tk, int D, const long long* strides,
                  float scale, int causal, int dropout, unsigned seed, unsigned thresh,
                  float keep_scale, void* stream) {
  TcArgs a = make_args(q, k, v, bias, B, N, Tq, Tk);
  a.o = static_cast<bf16*>(o);
  a.lse_out = static_cast<float*>(lse);
  return launch(true, a, D, strides, scale, causal, dropout, seed, thresh, keep_scale, stream);
}

// Backward, bfloat16, one kernel. dout in slot 9; dq_acc, the f32
// workspace zeroed by the caller, in slot 12 (dQ is added into it); dk in
// 15, dv in 18; lse and delta [B*N, Tq] f32; dbias [B, Tk] f32, zeroed by
// the caller, or null.
int ptt_flash_bwd(const void* q, const void* k, const void* v, const void* bias,
                  const void* dout, const void* lse, const void* delta, void* dq_acc, void* dk,
                  void* dv, void* dbias, int B, int N, int Tq, int Tk, int D,
                  const long long* strides, float scale, int causal, int dropout, unsigned seed,
                  unsigned thresh, float keep_scale, void* stream) {
  TcArgs a = make_args(q, k, v, bias, B, N, Tq, Tk);
  a.dout = static_cast<const bf16*>(dout);
  a.lse = static_cast<const float*>(lse);
  a.delta = static_cast<const float*>(delta);
  a.dq = static_cast<float*>(dq_acc);
  a.dk = static_cast<bf16*>(dk);
  a.dv = static_cast<bf16*>(dv);
  a.dbias = static_cast<float*>(dbias);
  return launch(false, a, D, strides, scale, causal, dropout, seed, thresh, keep_scale, stream);
}

}  // extern "C"
