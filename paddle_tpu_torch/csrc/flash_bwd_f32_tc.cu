// The float32 flash-attention backward on Hopper's bf16 tensor cores
// (sm_90a): the f32 half of kernels K2, K3 and K4b of the port, one
// kernel for dQ, dK, dV and dbias.
//
// ptt_flash_bwd_f32  replaces paddle_tpu/ops/pallas/flash_attention.py
//                    ::_bwd_dkv_kernel (K2, :468) and ::_bwd_dq_kernel
//                    (K3, :543), both via _bwd, and ::_bwd1_kernel (K4b,
//                    :311, via _bwd1) for float32 q, k, v. (bfloat16
//                    takes flash_bwd_tc_kernel in flash_attention_tc.cu;
//                    the f32 forward, whose lse this kernel reads, is
//                    flash_fwd_f32_tc.cu.)
//
// What bounds it on this card: operations. The backward does 10*T*T*D
// flops per (batch, head) (s and dp recomputed once, dV, dK, dQ) against
// ~7*T*D float32 elements read and written; each f32 product here is six
// bf16 products (see below), so the bound is 6 x 10*B*N*Tq*Tk*D at 989
// TFLOP/s (at B=4, T=512, N=12, D=64: 0.0489 ms; as f32 FMAs on the CUDA
// cores, 67 TFLOP/s: 0.120 ms).
//
// What the design does about it (flash_bwd_tc_kernel's FA2/FA3 structure
// with the f32 forward's pieces):
//  * f32 products on the bf16 tensor cores at f32 accuracy: q, k, v and
//    dO are split into three bf16 pieces h + m + l on their way into
//    shared memory (split3_pair / store_pieces), p x keep and ds in
//    registers, after the subtraction dp - delta, in f32. Each of the
//    five products, S^T = K.Q^T, dP^T = V.dO^T, dV += (P^T x keep).dO,
//    dK += dS^T.Q and dQ += dS.K, is the sum of the six piece pairs with
//    i + j <= 2, smallest first, into a fresh f32 accumulator per tile;
//    the running dK and dV sums are f32 adds in registers.
//    tests/test_torch_tc_split.py models the arithmetic on the CPU.
//  * A CTA owns 64 keys of one (batch, head) and loops over 64-row query
//    tiles (causal: from the diagonal). Its two warpgroups split the
//    work by role: warpgroup 0 computes S^T (keys as rows, so the causal
//    mask and the dropout hash come from the fragment's index map), p =
//    exp(s - lse), and dV with P^T x keep as its register A operand;
//    warpgroup 1 computes dP^T, takes p from warpgroup 0 through shared
//    memory, forms ds and dbias's term, and computes dK with dS^T as its
//    register A operand. dS^T's pieces also go to shared memory, where
//    both warpgroups read them through wgmma's transpose flag for dQ =
//    dS.K, each taking half of dQ's columns. dK and dV stay in f32
//    registers (one running sum a warpgroup); dbias sums in registers
//    and adds one atomic per key per CTA; dQ is added into the zeroed
//    f32 workspace [B, Tq, N, D] (the f32 output itself) with float2
//    atomics, so its summation order, like dbias's, varies from run to
//    run.
//  * Shared memory holds the pieces of K, V, Q and dO (3 x 64 x DP bf16
//    each) and of dS^T (3 x 64 x 64), p's exchange in dS^T's place: 216
//    KB at D = 128, so one block an SM. At D <= 64 the Q and dO pieces
//    have two stages and cp.async copies raw f32 rows a tile ahead into
//    a staging area: warpgroup 1 splits tile j + 1 into the other stage
//    and starts the copy of tile j + 2 while its dP^T runs and while
//    warpgroup 0 computes p, the step both wait on. At D = 128 there is
//    no room for either, so the next tile is loaded and split after the
//    products.
//  * q, k, v and dO are read through their (batch, time, head) strides,
//    so views of the fused QKV projection [B, T, 3, N, D] need no copy;
//    rows that are not 16-byte aligned take 4-byte loads.
//  * Nothing of size T x T reaches device memory.
//
// Semantics are those of the Pallas kernels: s = (q.k) * scale +
// bias[key], causal keeps col <= row, p = exp(s - lse) from the
// forward's lse (computed as exp2((fma(S, scale, bias) - lse) * log2 e),
// a few ulps from two rounded steps and exp), g = p * (dp * keep - delta)
// (delta = rowsum(dO * O) - dlse, computed by the caller), ds = g *
// scale, dbias[key] = sum over heads and queries of g. Dropout is the
// counter hash of _keep_mask, bit for bit: stream = fmix32(seed + (b*N +
// n) * 0x9E3779B9), x = fmix32(((row << 16) ^ col) + stream), keep iff x
// >= thresh, with global rows and columns.
//
// Plain C interface, loaded with ctypes: returns the cudaError_t of the
// launch (0 on success). Nothing here allocates or synchronises.

#include "tc_common.cuh"

namespace {

constexpr int kKeys = 64;      // keys per CTA (a warpgroup's accumulator rows)
constexpr int kRows = 64;      // query rows per tile
constexpr int kThreads = 256;  // two warpgroups
constexpr int kWg = 128;       // threads of one warpgroup
constexpr float kLog2e = 1.4426950408889634f;

// slots of BwdArgs::s: (batch, time, head) strides per tensor
enum { kQ = 0, kK = 3, kV = 6, kDO = 9, kDQ = 12, kDK = 15, kDV = 18 };

// named barriers (0 is __syncthreads): p is written (warpgroup 0 arrives,
// warpgroup 1 waits); warpgroup 1 has read p
enum { kBarP = 1, kBarRead = 2 };

struct BwdArgs {
  const float* q;
  const float* k;
  const float* v;
  const float* bias;   // [B, Tk] additive key bias, or null
  const float* dout;
  const float* lse;    // [B*N, Tq]
  const float* delta;  // [B*N, Tq]
  float* dq;           // f32, zeroed by the caller (slot kDQ)
  float* dk;
  float* dv;
  float* dbias;        // [B, Tk], zeroed by the caller, or null
  int B, N, Tq, Tk;
  long long s[21];
  float scale;
  int causal;
  int dropout;
  unsigned seed;
  unsigned thresh;
  float keep_scale;
  int vec;             // every q, k, v, dO row starts 16-byte aligned
};

template <int D>
struct BwdSmem {
  static constexpr int DP = Cols<D>::P;
  static constexpr int TB = 64 * DP * 2;        // one bf16 piece of a K, V, Q or dO tile
  static constexpr int SB = kKeys * kRows * 2;  // one piece of dS^T [64 keys][64 rows]
  static constexpr bool STAGE = D <= 64;        // raw f32 Q and dO of a tile ahead
  static constexpr int QS = STAGE ? 2 : 1;      // stages of the Q and dO pieces
  static constexpr int RB = STAGE ? kRows * D * 4 : 0;
  static constexpr int BYTES =
      1024 + (2 + 2 * QS) * kPieces * TB + kPieces * SB + 2 * RB + 2 * QS * kRows * 4;
  static_assert(kRows * kKeys * 4 <= kPieces * SB, "p's exchange fits in dS^T's place");
  static_assert(BYTES <= 232448, "shared memory of one block");
};

__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

__device__ __forceinline__ float keep_factor(const BwdArgs& a, uint32_t stream, int row, int col) {
  const uint32_t x = fmix32((((uint32_t)row << 16) ^ (uint32_t)col) + stream);
  return x >= a.thresh ? a.keep_scale : 0.f;
}

// eight floats of a row: two 16-byte loads, or eight 4-byte ones where
// the rows are not 16-byte aligned
__device__ __forceinline__ void load8(const float* src, bool vec, float (&x)[8]) {
  if (vec) {
    const float4 lo = __ldg(reinterpret_cast<const float4*>(src));
    const float4 hi = __ldg(reinterpret_cast<const float4*>(src + 4));
    x[0] = lo.x; x[1] = lo.y; x[2] = lo.z; x[3] = lo.w;
    x[4] = hi.x; x[5] = hi.y; x[6] = hi.z; x[7] = hi.w;
  } else {
#pragma unroll
    for (int j = 0; j < 8; ++j) x[j] = __ldg(src + j);
  }
}

// the raw f32 rows [r0, r0 + 64) of Q and dO into the staging area by
// cp.async (zeros past Tq), in split_rows' chunks of 8 floats: each
// thread copies the chunks it will split, so only its own cp.async wait
// stands between the two
template <int D, int THREADS>
__device__ __forceinline__ void stage_rows(const BwdArgs& a, int t, const float* q,
                                           const float* dout, int r0, uint32_t stQ,
                                           uint32_t stO) {
  constexpr int CPR = D / 8;  // 8-float chunks per row
#pragma unroll
  for (int it = 0; it < kRows * CPR / THREADS; ++it) {
    const int i = it * THREADS + t, r = i / CPR, c = i % CPR;
    const int row = r0 + r;
    const bool ok = row < a.Tq;
    const float* gq = ok ? q + row * a.s[kQ + 1] + c * 8 : q;
    const float* go = ok ? dout + row * a.s[kDO + 1] + c * 8 : dout;
    if (a.vec) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        cp_async16(stQ + i * 32 + 16 * j, ok ? gq + 4 * j : q, ok);
        cp_async16(stO + i * 32 + 16 * j, ok ? go + 4 * j : dout, ok);
      }
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        cp_async_ca<4>(stQ + i * 32 + 4 * j, ok ? gq + j : q, ok);
        cp_async_ca<4>(stO + i * 32 + 4 * j, ok ? go + j : dout, ok);
      }
    }
  }
  cp_async_commit();
}

// the query tile at r0 split into the pieces of sQ and sO by THREADS
// threads (this one the t-th): from the staging area (STAGE) or straight
// from device memory; its lse and delta into lse_s and delta_s
template <int D, bool STAGE, int THREADS>
__device__ __forceinline__ void split_rows(const BwdArgs& a, int t, const float* q,
                                           const float* dout, const float* lse,
                                           const float* delta, int r0, const float* stQ,
                                           const float* stO, uint8_t* sQ, uint8_t* sO,
                                           float* lse_s, float* delta_s) {
  constexpr int CPR = D / 8;  // 8-float chunks per row
  constexpr int TB = BwdSmem<D>::TB;
#pragma unroll
  for (int it = 0; it < kRows * CPR / THREADS; ++it) {
    const int i = it * THREADS + t, r = i / CPR, c = i % CPR;
    float xq[8], xo[8];
    if constexpr (STAGE) {
      const float4 q0 = *reinterpret_cast<const float4*>(stQ + i * 8);
      const float4 q1 = *reinterpret_cast<const float4*>(stQ + i * 8 + 4);
      const float4 o0 = *reinterpret_cast<const float4*>(stO + i * 8);
      const float4 o1 = *reinterpret_cast<const float4*>(stO + i * 8 + 4);
      xq[0] = q0.x; xq[1] = q0.y; xq[2] = q0.z; xq[3] = q0.w;
      xq[4] = q1.x; xq[5] = q1.y; xq[6] = q1.z; xq[7] = q1.w;
      xo[0] = o0.x; xo[1] = o0.y; xo[2] = o0.z; xo[3] = o0.w;
      xo[4] = o1.x; xo[5] = o1.y; xo[6] = o1.z; xo[7] = o1.w;
    } else {
      const int row = r0 + r;
#pragma unroll
      for (int j = 0; j < 8; ++j) xq[j] = xo[j] = 0.f;
      if (row < a.Tq) {
        load8(q + row * a.s[kQ + 1] + c * 8, a.vec, xq);
        load8(dout + row * a.s[kDO + 1] + c * 8, a.vec, xo);
      }
    }
    const uint32_t off = swz_offset<kRows>(r, c);
    store_pieces(xq, sQ, TB, off);
    store_pieces(xo, sO, TB, off);
  }
  if (t < kRows) {
    const int row = r0 + t;
    const bool ok = row < a.Tq;
    lse_s[t] = ok ? lse[row] : 0.f;
    delta_s[t] = ok ? delta[row] : 0.f;
  }
}

// grid: (ceil(Tk / 64), B * N); block: 256 threads (two warpgroups).
template <int D>
__global__ void __launch_bounds__(kThreads, 1) flash_bwd_f32_tc_kernel(const BwdArgs a) {
  using S = BwdSmem<D>;
  constexpr int DP = S::DP;
  constexpr int TB = S::TB;
  constexpr int SB = S::SB;
  constexpr bool STAGE = S::STAGE;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  uint8_t* sK = smem;                  // pieces h, m, l of each
  uint8_t* sV = sK + kPieces * TB;
  uint8_t* sQ = sV + kPieces * TB;     // QS stages of the Q pieces
  uint8_t* sO = sQ + S::QS * kPieces * TB;  // and of the dO pieces
  uint8_t* sS = sO + S::QS * kPieces * TB;  // dS^T; p's exchange before it
  float* stQ = reinterpret_cast<float*>(sS + kPieces * SB);  // staging (D <= 64)
  float* stO = reinterpret_cast<float*>(reinterpret_cast<uint8_t*>(stQ) + S::RB);
  float* lse_s = reinterpret_cast<float*>(reinterpret_cast<uint8_t*>(stO) + S::RB);  // [QS][64]
  float* delta_s = lse_s + S::QS * kRows;                                              // [QS][64]
  float* xch = reinterpret_cast<float*>(sS);  // [32][128]: p in fragment order
  const uint32_t uK0 = smem_u32(sK), uV0 = smem_u32(sV), uQ0 = smem_u32(sQ);
  const uint32_t uO0 = smem_u32(sO), uS0 = smem_u32(sS);
  constexpr int QSB = kPieces * TB;  // bytes of one Q or dO stage

  const int tid = threadIdx.x, wg = tid >> 7, wtid = tid & (kWg - 1);
  const int warp = wtid >> 5, lane = tid & 31;
  const int k0 = blockIdx.x * kKeys;
  const int bh = blockIdx.y, b = bh / a.N, n = bh % a.N;
  const float* q = a.q + (long long)b * a.s[kQ] + (long long)n * a.s[kQ + 2];
  const float* k = a.k + (long long)b * a.s[kK] + (long long)n * a.s[kK + 2];
  const float* v = a.v + (long long)b * a.s[kV] + (long long)n * a.s[kV + 2];
  const float* dout = a.dout + (long long)b * a.s[kDO] + (long long)n * a.s[kDO + 2];
  const float* lse = a.lse + (long long)bh * a.Tq;
  const float* delta = a.delta + (long long)bh * a.Tq;
  const uint32_t stream = fmix32(a.seed + (uint32_t)bh * 0x9E3779B9u);
  // causal: query tiles wholly above this key tile see none of its keys
  const int q_begin = a.causal ? k0 : 0;
  const int n_tiles = q_begin < a.Tq ? (a.Tq - q_begin + kRows - 1) / kRows : 0;

  // K and V rows k0.. into three bf16 pieces (rows past Tk are zeros);
  // the padding columns of every tile (D = 32) are zeros once for all
  constexpr int CH = DP / 8;  // 8-element chunks per row
  for (int i = tid; i < kKeys * CH; i += kThreads) {
    const int r = i / CH, c = i % CH, row = k0 + r;
    float xk[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    float xv[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if (row < a.Tk && c * 8 < D) {
      load8(k + row * a.s[kK + 1] + c * 8, a.vec, xk);
      load8(v + row * a.s[kV + 1] + c * 8, a.vec, xv);
    }
    const uint32_t off = swz_offset<kKeys>(r, c);
    store_pieces(xk, sK, TB, off);
    store_pieces(xv, sV, TB, off);
    if (c * 8 >= D) {
#pragma unroll
      for (int st = 0; st < S::QS; ++st) {
        store_pieces(xk, sQ + st * QSB, TB, off);
        store_pieces(xk, sO + st * QSB, TB, off);
      }
    }
  }
  if (n_tiles > 0) {
    if constexpr (STAGE) {
      stage_rows<D, kThreads>(a, tid, q, dout, q_begin, smem_u32(stQ), smem_u32(stO));
      cp_async_wait<0>();
    }
    split_rows<D, STAGE, kThreads>(a, tid, q, dout, lse, delta, q_begin, stQ, stO, sQ, sO, lse_s,
                                   delta_s);
  }
  fence_async_smem();
  __syncthreads();
  // from here on warpgroup 1 stages and splits the tiles after the first
  if constexpr (STAGE) {
    if (n_tiles > 1 && wg == 1)
      stage_rows<D, kWg>(a, wtid, q, dout, q_begin + kRows, smem_u32(stQ), smem_u32(stO));
  }

  // this thread's two keys (h = 0, 1): rows of S^T, dP^T, dV and dK
  int key[2];
  float bias_r[2], dbias_acc[2] = {0.f, 0.f};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    key[h] = k0 + frag_row(warp, lane, 2 * h);
    bias_r[h] = (a.bias != nullptr && key[h] < a.Tk)
                    ? __ldg(a.bias + (long long)b * a.Tk + key[h])
                    : 0.f;
  }
  // the running dV (warpgroup 0) or dK (warpgroup 1): 64 keys x DP
  float acc[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) acc[i] = 0.f;

  for (int j = 0; j < n_tiles; ++j) {
    const int r0 = q_begin + j * kRows;
    const bool more = j + 1 < n_tiles;
    const int st = STAGE ? (j & 1) : 0;  // this tile's Q and dO stage
    const float* lse_t = lse_s + st * kRows;
    const float* delta_t = delta_s + st * kRows;
    // S^T = K . Q^T (warpgroup 0) or dP^T = V . dO^T (warpgroup 1) over
    // the six piece pairs: 64 keys x 64 rows. The tile addresses are
    // opaque to the compiler each tile (it would otherwise keep every
    // descriptor in registers).
    uint32_t uA = wg ? uV0 : uK0, uB = (wg ? uO0 : uQ0) + st * QSB;
    asm volatile("" : "+r"(uA), "+r"(uB));
    float x[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) x[i] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int pr = 0; pr < kPairs; ++pr)
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss_n64<0, 0>(x, desc_kmajor(uA + pair_a(pr) * TB, kKeys, kk),
                           desc_kmajor(uB + pair_b(pr) * TB, kRows, kk),
                           pr == 0 && kk == 0 ? 0 : 1);
    wgmma_commit();
    // warpgroup 1, while its products run and then while warpgroup 0
    // computes p: the next tile (staged a tile ahead, each thread
    // splitting the chunks it copied) into the other stage, and the tile
    // after it into the staging area
    if constexpr (STAGE) {
      if (more && wg == 1) {
        cp_async_wait<0>();
        split_rows<D, STAGE, kWg>(a, wtid, q, dout, lse, delta, r0 + kRows, stQ, stO,
                                  sQ + (st ^ 1) * QSB, sO + (st ^ 1) * QSB,
                                  lse_s + (st ^ 1) * kRows, delta_s + (st ^ 1) * kRows);
        if (j + 2 < n_tiles)
          stage_rows<D, kWg>(a, wtid, q, dout, r0 + 2 * kRows, smem_u32(stQ), smem_u32(stO));
      }
    }
    wgmma_wait_all();
    fence_regs(x);

    // p x keep (warpgroup 0) or ds (warpgroup 1) in pieces h, m, l as
    // register A operands; ds's pieces also to shared memory as dS^T
    // ([64 keys][64 rows] bf16, swizzled) for dQ
    uint32_t pa[kPieces][16];
    if (wg == 0) {
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int h = (i >> 1) & 1, c = frag_col(lane, i), r = r0 + c;
        const bool ok = key[h] < a.Tk && r < a.Tq && (!a.causal || key[h] <= r);
        // exp2 of a scaled argument: fewer instructions than expf on the
        // step warpgroup 1 waits for (folding log2 e into the bias and
        // lse instead costs D = 128 the registers it does not have)
        x[i] = ok ? exp2f((fmaf(x[i], a.scale, bias_r[h]) - lse_t[c]) * kLog2e) : 0.f;
        xch[i * kWg + wtid] = x[i];
      }
      bar_arrive(kBarP, kThreads);
#pragma unroll
      for (int i = 0; i < 32; i += 2) {
        const int h = (i >> 1) & 1, r = r0 + frag_col(lane, i);
        float p0 = x[i], p1 = x[i + 1];
        if (a.dropout) {
          p0 *= keep_factor(a, stream, r, key[h]);
          p1 *= keep_factor(a, stream, r + 1, key[h]);
        }
        split3_pair(p0, p1, pa[0][i >> 1], pa[1][i >> 1], pa[2][i >> 1]);
      }
    } else {
      bar_sync(kBarP, kThreads);
      float p[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) p[i] = xch[i * kWg + wtid];
      bar_sync(kBarRead, kWg);  // every p is read: dS^T may take its place
#pragma unroll
      for (int i = 0; i < 32; i += 2) {
        const int h = (i >> 1) & 1, c = frag_col(lane, i);
        float ds[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float keep = a.dropout ? keep_factor(a, stream, r0 + c + e, key[h]) : 1.f;
          const float g = p[i + e] * (x[i + e] * keep - delta_t[c + e]);
          dbias_acc[h] += g;
          ds[e] = g * a.scale;
        }
        uint32_t ph, pm, pl;
        split3_pair(ds[0], ds[1], ph, pm, pl);
        pa[0][i >> 1] = ph;
        pa[1][i >> 1] = pm;
        pa[2][i >> 1] = pl;
        const uint32_t off =
            uS0 + swz_offset<kKeys>(frag_row(warp, lane, i), c >> 3) + (c & 7) * 2;
        st_shared_u32(off, ph);
        st_shared_u32(off + SB, pm);
        st_shared_u32(off + 2 * SB, pl);
      }
      fence_async_smem();
    }

    // dV += (P^T x keep) . dO (warpgroup 0) or dK += dS^T . Q (warpgroup
    // 1) over the six piece pairs, the B operand transposed, 64 columns
    // at a time, each from a fresh f32 accumulator
    uint32_t uB2 = (wg ? uQ0 : uO0) + st * QSB;
    asm volatile("" : "+r"(uB2));
#pragma unroll
    for (int half = 0; half < DP / 64; ++half) {
      float t[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) t[i] = 0.f;
      wgmma_fence();
#pragma unroll
      for (int pr = 0; pr < kPairs; ++pr)
#pragma unroll
        for (int kk = 0; kk < kRows / 16; ++kk)
          wgmma_rs_n64<1>(t, pa[pair_a(pr)] + 4 * kk,
                          desc_mnmajor(uB2 + pair_b(pr) * TB + half * kRows * 128, kRows, kk),
                          pr == 0 && kk == 0 ? 0 : 1);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(t);
      fence_regs(pa[0]);
      fence_regs(pa[1]);
      fence_regs(pa[2]);
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[32 * half + i] += t[i];
    }
    __syncthreads();  // dS^T's pieces are written

    // dQ[64 rows x DP] = dS . K over the six piece pairs, both operands
    // through the transpose flag: warpgroup wg takes columns [wg * DP/2,
    // (wg + 1) * DP/2) (at D = 32 warpgroup 0 alone: the rest is padding)
    if (D >= 64 || wg == 0) {
      float dq[DP / 4];
#pragma unroll
      for (int i = 0; i < DP / 4; ++i) dq[i] = 0.f;
      uint32_t uKc = DP == 64 ? uK0 + wg * 64 : uK0 + wg * kKeys * 128, uS = uS0;
      asm volatile("" : "+r"(uKc), "+r"(uS));
      wgmma_fence();
#pragma unroll
      for (int pr = 0; pr < kPairs; ++pr)
#pragma unroll
        for (int kk = 0; kk < kKeys / 16; ++kk) {
          const uint64_t da = desc_mnmajor(uS + pair_a(pr) * SB, kKeys, kk);
          const uint64_t db = desc_mnmajor(uKc + pair_b(pr) * TB, kKeys, kk);
          const int first = pr == 0 && kk == 0 ? 0 : 1;
          if constexpr (DP == 64)
            wgmma_ss_n32<1, 1>(dq, da, db, first);
          else
            wgmma_ss_n64<1, 1>(dq, da, db, first);
        }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(dq);
      float* dqp = a.dq + (long long)b * a.s[kDQ] + (long long)n * a.s[kDQ + 2];
#pragma unroll
      for (int i = 0; i < DP / 4; i += 2) {
        const int r = r0 + frag_row(warp, lane, i);
        const int c = wg * (DP / 2) + frag_col(lane, i);
        if (r < a.Tq && c < D)
          atomicAdd(reinterpret_cast<float2*>(dqp + (long long)r * a.s[kDQ + 1] + c),
                    make_float2(dq[i], dq[i + 1]));
      }
    }

    if (more) {
      if constexpr (!STAGE) {
        __syncthreads();  // every warpgroup is done with this tile's Q and dO
        split_rows<D, STAGE, kThreads>(a, tid, q, dout, lse, delta, r0 + kRows, stQ, stO, sQ,
                                       sO, lse_s, delta_s);
      }
      fence_async_smem();
      __syncthreads();  // the next tile's pieces are in; dS^T is free
    }
  }

  // dV (warpgroup 0) or dK (warpgroup 1); dbias's terms (warpgroup 1)
  float* out = wg ? a.dk + (long long)b * a.s[kDK] + (long long)n * a.s[kDK + 2]
                  : a.dv + (long long)b * a.s[kDV] + (long long)n * a.s[kDV + 2];
  const long long st = wg ? a.s[kDK + 1] : a.s[kDV + 1];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (key[h] < a.Tk) {
#pragma unroll
      for (int i = 2 * h; i < DP / 2; i += 4) {
        const int c = 64 * (i >> 5) + frag_col(lane, i & 31);
        if (c < D) {
          out[key[h] * st + c] = acc[i];
          out[key[h] * st + c + 1] = acc[i + 1];
        }
      }
    }
    if (wg == 1) {
      const float x = quad_sum(dbias_acc[h]);
      if (a.dbias != nullptr && key[h] < a.Tk && (lane & 3) == 0)
        atomicAdd(a.dbias + (long long)b * a.Tk + key[h], x);
    }
  }
}

template <int D>
cudaError_t launch_d(const BwdArgs& a, cudaStream_t stream) {
  const int bytes = BwdSmem<D>::BYTES;
  void (*kernel)(BwdArgs) = flash_bwd_f32_tc_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  kernel<<<dim3((a.Tk + kKeys - 1) / kKeys, a.B * a.N), kThreads, bytes, stream>>>(a);
  return cudaGetLastError();
}

bool aligned16(const void* p, const long long* s) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && s[0] % 4 == 0 && s[1] % 4 == 0 &&
         s[2] % 4 == 0;
}

}  // namespace

extern "C" {

// Backward, float32, one kernel. q [B, Tq, N, D], k/v [B, Tk, N, D] and
// dout [B, Tq, N, D] through their (batch, time, head) strides in slots
// 0, 3, 6 and 9 of `strides` (21 values, host memory; last dim
// contiguous, rows of any alignment); dq, the f32 output zeroed by the
// caller (dQ is added into it two floats at a time: rows 8-byte
// aligned), in slot 12; dk in 15, dv in 18; lse and
// delta [B*N, Tq] f32; dbias [B, Tk] f32, zeroed by the caller, or null.
// D in {32, 64, 128}.
int ptt_flash_bwd_f32(const void* q, const void* k, const void* v, const void* bias,
                      const void* dout, const void* lse, const void* delta, void* dq, void* dk,
                      void* dv, void* dbias, int B, int N, int Tq, int Tk, int D,
                      const long long* strides, float scale, int causal, int dropout,
                      unsigned seed, unsigned thresh, float keep_scale, void* stream) {
  if (B <= 0 || N <= 0 || Tq <= 0 || Tk <= 0 || Tq > 65535 || Tk > 65535 ||
      (long long)B * N > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  BwdArgs a = {};
  a.q = static_cast<const float*>(q);
  a.k = static_cast<const float*>(k);
  a.v = static_cast<const float*>(v);
  a.bias = static_cast<const float*>(bias);
  a.dout = static_cast<const float*>(dout);
  a.lse = static_cast<const float*>(lse);
  a.delta = static_cast<const float*>(delta);
  a.dq = static_cast<float*>(dq);
  a.dk = static_cast<float*>(dk);
  a.dv = static_cast<float*>(dv);
  a.dbias = static_cast<float*>(dbias);
  a.B = B;
  a.N = N;
  a.Tq = Tq;
  a.Tk = Tk;
  for (int i = 0; i < 21; ++i) a.s[i] = strides[i];
  a.scale = scale;
  a.causal = causal;
  a.dropout = dropout;
  a.seed = seed;
  a.thresh = thresh;
  a.keep_scale = keep_scale;
  a.vec = aligned16(q, strides + kQ) && aligned16(k, strides + kK) &&
          aligned16(v, strides + kV) && aligned16(dout, strides + kDO);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32: return static_cast<int>(launch_d<32>(a, st));
    case 64: return static_cast<int>(launch_d<64>(a, st));
    case 128: return static_cast<int>(launch_d<128>(a, st));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
