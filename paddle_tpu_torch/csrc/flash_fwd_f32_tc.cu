// The float32 flash-attention forward on Hopper's bf16 tensor cores
// (sm_90a): the f32 half of kernels K1 and K4f of the port.
//
// ptt_flash_fwd_f32  replaces paddle_tpu/ops/pallas/flash_attention.py
//                    ::_fwd_kernel (K1, :160, via _fwd) and ::_fwd1_kernel
//                    (K4f, :280, via _fwd1) for float32 q, k, v.
//                    (bfloat16 takes flash_fwd_tc_kernel in
//                    flash_attention_tc.cu; the f32 backward, which
//                    reads this kernel's lse, is flash_bwd_f32_tc.cu.)
//
// What bounds it on this card: operations. At BERT-base shapes (T = 512,
// D = 64) the forward does 4*T*T*D flops per (batch, head) against 4*T*D
// float32 elements read and written, ~T/4 flops per byte; on the CUDA
// cores (67 TFLOP/s f32) it sits far above their ridge. Here each f32
// product is six bf16 products (see below), so the bound is 6 x 4*B*N*
// Tq*Tk*D at 989 TFLOP/s.
//
// What the design does about it (the structure of K6's chunk kernel,
// paged_prefill_tc_kernel in decode_attention.cu, over strided views
// instead of a block table):
//  * f32 products on the bf16 tensor cores at f32 accuracy: q, k, v and
//    p are each split into three bf16 pieces h + m + l (split3_pair),
//    which carry all 24 bits of a float32, and S = sum of Q_i . K_j^T,
//    O_tile = sum of P_i . V_j over the six piece pairs with i + j <= 2,
//    smallest first; a product of two pieces is exact in f32 (TF32 would
//    keep ~3 decimal digits). tests/test_torch_tc_split.py models the
//    arithmetic on the CPU.
//  * One warpgroup owns 64 query rows of one (batch, head); keys stream
//    in tiles of 64 with the online softmax in f32 on the accumulator
//    fragment. O_tile starts from a fresh f32 accumulator each key tile
//    and is added to O (rescaled by corr) by f32 FMAs.
//  * K and V are split on their way into shared memory by a register
//    pass; at D <= 64 cp.async copies the next tile's raw f32 rows into a
//    staging area while this tile's products run (two blocks an SM); at
//    D = 128 the pieces of Q, K, V (144 KB) and of p (24 KB) leave no
//    room for it, so the next tile is loaded and split after the
//    products (one block an SM).
//  * q, k, v are read through their (batch, time, head) strides, so views
//    of the fused QKV projection [B, T, 3, N, D] need no copy; rows that
//    are not 16-byte aligned take 4-byte loads (the CUDA-core kernel took
//    any stride, and so does this one).
//  * Causal tiles wholly above the diagonal are skipped; the ragged edge
//    of T is masked in the kernel.
//
// Semantics are those of the Pallas kernels:
// s = (q.k) * scale + bias[key] as two rounded f32 operations (the scale
// applied after the piece sum, as the plain version multiplies the f32
// logits), causal keeps col <= row, l sums the undropped p, the keep mask
// multiplies p before P.V, l = 0 gives safe_l = 1, o = O / safe_l, lse =
// m + log(safe_l) as [B*N, Tq] f32 (the backward recomputes p = exp(s -
// lse) from it). Dropout is the counter hash of _keep_mask, bit
// for bit: stream = fmix32(seed + (b*N + n) * 0x9E3779B9), x =
// fmix32(((row << 16) ^ col) + stream), keep iff x >= thresh, with global
// rows and columns from the accumulator fragment's index map.
//
// Plain C interface, loaded with ctypes: returns the cudaError_t of the
// launch (0 on success). Nothing here allocates or synchronises.

#include "tc_common.cuh"

namespace {

constexpr int kRows = 64;      // query rows per block (one warpgroup)
constexpr int kKeys = 64;      // keys per tile
constexpr int kThreads = 128;
constexpr float kNegInf = -1e30f;

// slots of F32Args::s: (batch, time, head) strides per tensor
enum { kQ = 0, kK = 3, kV = 6, kO = 12 };

struct F32Args {
  const float* q;
  const float* k;
  const float* v;
  const float* bias;   // [B, Tk] additive key bias, or null
  float* o;
  float* lse;          // [B*N, Tq]
  int B, N, Tq, Tk;
  long long s[21];
  float scale;
  int causal;
  int dropout;
  unsigned seed;
  unsigned thresh;
  float keep_scale;
  int vec;             // every q, k, v row starts 16-byte aligned
};

template <int D>
struct FwdSmem {
  static constexpr int DP = Cols<D>::P;
  static constexpr int TB = kRows * DP * 2;    // one bf16 piece of a Q, K or V tile
  static constexpr bool P_SMEM = DP == 128;    // p's pieces in shared memory, as K6's
  static constexpr int PB = P_SMEM ? kRows * kKeys * 2 : 0;
  static constexpr bool STAGE = D <= 64;       // raw f32 K and V of the next tile
  static constexpr int SB = STAGE ? kKeys * D * 4 : 0;
  static constexpr int BYTES = 1024 + 3 * kPieces * TB + kPieces * PB + 2 * SB + 2 * kKeys * 4;
  static_assert(kRows == kKeys, "the Q and K/V piece tiles share one layout");
};

__device__ __forceinline__ float keep_factor(const F32Args& a, uint32_t stream, int row, int col) {
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

// the raw f32 rows [k0, k0 + 64) of K and V into the staging area by
// cp.async (zeros past Tk)
template <int D>
__device__ __forceinline__ void stage_kv(const F32Args& a, const float* k, const float* v, int k0,
                                         uint32_t stK, uint32_t stV) {
  constexpr int CPR = D / 4;  // 16-byte chunks per row
#pragma unroll
  for (int it = 0; it < kKeys * CPR / kThreads; ++it) {
    const int i = it * kThreads + threadIdx.x, key = i / CPR, part = i % CPR;
    const int row = k0 + key;
    const bool ok = row < a.Tk;
    const float* gk = ok ? k + row * a.s[kK + 1] + part * 4 : k;
    const float* gv = ok ? v + row * a.s[kV + 1] + part * 4 : v;
    if (a.vec) {
      cp_async16(stK + i * 16, gk, ok);
      cp_async16(stV + i * 16, gv, ok);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        cp_async_ca<4>(stK + i * 16 + 4 * j, ok ? gk + j : k, ok);
        cp_async_ca<4>(stV + i * 16 + 4 * j, ok ? gv + j : v, ok);
      }
    }
  }
  cp_async_commit();
}

// the key tile at k0 split into the pieces of sK and sV: from the staging
// area (STAGE) or straight from device memory
template <int D, bool STAGE>
__device__ __forceinline__ void split_kv(const F32Args& a, const float* k, const float* v, int k0,
                                         const float* stK, const float* stV, uint8_t* sK,
                                         uint8_t* sV) {
  constexpr int CPK = D / 8;  // 8-float chunks per key row
  constexpr int TB = FwdSmem<D>::TB;
#pragma unroll 4
  for (int it = 0; it < kKeys * CPK / kThreads; ++it) {
    const int i = it * kThreads + threadIdx.x, key = i / CPK, c = i % CPK;
    float xk[8], xv[8];
    if constexpr (STAGE) {
      const float4 k0v = *reinterpret_cast<const float4*>(stK + i * 8);
      const float4 k1v = *reinterpret_cast<const float4*>(stK + i * 8 + 4);
      const float4 v0v = *reinterpret_cast<const float4*>(stV + i * 8);
      const float4 v1v = *reinterpret_cast<const float4*>(stV + i * 8 + 4);
      xk[0] = k0v.x; xk[1] = k0v.y; xk[2] = k0v.z; xk[3] = k0v.w;
      xk[4] = k1v.x; xk[5] = k1v.y; xk[6] = k1v.z; xk[7] = k1v.w;
      xv[0] = v0v.x; xv[1] = v0v.y; xv[2] = v0v.z; xv[3] = v0v.w;
      xv[4] = v1v.x; xv[5] = v1v.y; xv[6] = v1v.z; xv[7] = v1v.w;
    } else {
      const int row = k0 + key;
#pragma unroll
      for (int j = 0; j < 8; ++j) xk[j] = xv[j] = 0.f;
      if (row < a.Tk) {
        load8(k + row * a.s[kK + 1] + c * 8, a.vec, xk);
        load8(v + row * a.s[kV + 1] + c * 8, a.vec, xv);
      }
    }
    const uint32_t off = swz_offset<kKeys>(key, c);
    store_pieces(xk, sK, TB, off);
    store_pieces(xv, sV, TB, off);
  }
}

// the key bias of tile k0 (zeros without a bias or past Tk)
__device__ __forceinline__ void load_bias(const F32Args& a, int b, int k0, float* dst) {
  if (threadIdx.x < kKeys) {
    const int col = k0 + threadIdx.x;
    dst[threadIdx.x] =
        (a.bias != nullptr && col < a.Tk) ? __ldg(a.bias + (long long)b * a.Tk + col) : 0.f;
  }
}

// grid: (ceil(Tq / 64), B * N); block: 128 threads (one warpgroup).
template <int D>
__global__ void __launch_bounds__(kThreads, FwdSmem<D>::STAGE ? 2 : 1)
    flash_fwd_f32_tc_kernel(const F32Args a) {
  using S = FwdSmem<D>;
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
  float* bias_s = reinterpret_cast<float*>(reinterpret_cast<uint8_t*>(stV) + S::SB);  // [2][64]
  const uint32_t uQ0 = smem_u32(sQ), uK0 = smem_u32(sK), uV0 = smem_u32(sV);
  const uint32_t uP = smem_u32(sP);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int q0 = blockIdx.x * kRows;
  const int bh = blockIdx.y, b = bh / a.N, n = bh % a.N;
  const float* q = a.q + (long long)b * a.s[kQ] + (long long)n * a.s[kQ + 2];
  const float* k = a.k + (long long)b * a.s[kK] + (long long)n * a.s[kK + 2];
  const float* v = a.v + (long long)b * a.s[kV] + (long long)n * a.s[kV + 2];
  const uint32_t stream = fmix32(a.seed + (uint32_t)bh * 0x9E3779B9u);
  const int k_end = a.causal ? min(a.Tk, q0 + kRows) : a.Tk;
  const int n_tiles = (k_end + kKeys - 1) / kKeys;

  // q rows q0.. into three bf16 pieces; rows past Tq and columns past D
  // (and the K and V pieces' columns past D) are zeros
  constexpr int QCH = DP / 8;  // 8-element chunks per row
  for (int i = tid; i < kRows * QCH; i += kThreads) {
    const int r = i / QCH, c = i % QCH, row = q0 + r;
    float x[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if (row < a.Tq && c * 8 < D) load8(q + row * a.s[kQ + 1] + c * 8, a.vec, x);
    const uint32_t off = swz_offset<kRows>(r, c);
    store_pieces(x, sQ, S::TB, off);
    if (c * 8 >= D) {  // padding columns of the key tiles (D = 32)
      const float zero[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      store_pieces(zero, sK, S::TB, off);
      store_pieces(zero, sV, S::TB, off);
    }
  }
  load_bias(a, b, 0, bias_s);
  if constexpr (STAGE) {
    stage_kv<D>(a, k, v, 0, smem_u32(stK), smem_u32(stV));
    cp_async_wait<0>();
    __syncthreads();
  }
  split_kv<D, STAGE>(a, k, v, 0, stK, stV, sK, sV);
  fence_async_smem();
  __syncthreads();

  // this thread's two rows (h = 0, 1)
  int row[2];
  float m[2], l[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    row[h] = q0 + frag_row(warp, lane, 2 * h);
    m[h] = kNegInf;
    l[h] = 0.f;
  }
  float o[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) o[i] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kKeys;
    const bool more = t + 1 < n_tiles;
    // the next tile's rows into the staging area while this tile's
    // products run
    if constexpr (STAGE) {
      if (more) stage_kv<D>(a, k, v, k0 + kKeys, smem_u32(stK), smem_u32(stV));
    }
    // the tile addresses, opaque to the compiler each tile (as in K6's
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
        wgmma_ss_n64<0, 0>(s, desc_kmajor(uQ + pair_a(pr) * S::TB, kRows, kk),
                           desc_kmajor(uK + pair_b(pr) * S::TB, kKeys, kk),
                           pr == 0 && kk == 0 ? 0 : 1);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);

    // s = S * scale + bias, masked, then the online softmax on the fragment
    const float* bias_t = bias_s + (t & 1) * kKeys;
    float mt[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int h = (i >> 1) & 1, c = frag_col(lane, i), col = k0 + c;
      const float x = __fadd_rn(__fmul_rn(s[i], a.scale), bias_t[c]);
      const bool ok = col < a.Tk && (!a.causal || col <= row[h]);
      s[i] = ok ? x : kNegInf;
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
    // p x keep in pieces h, m, l: register A operands, or (D = 128) 64 x 64
    // swizzled bf16 tiles in shared memory
    uint32_t pa[kPieces][16];
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const int h = (i >> 1) & 1, c = frag_col(lane, i);
      float p0 = expf(s[i] - mu[h]), p1 = expf(s[i + 1] - mu[h]);
      ps[h] += p0 + p1;  // l sums the undropped p
      if (a.dropout) {
        p0 *= keep_factor(a, stream, row[h], k0 + c);
        p1 *= keep_factor(a, stream, row[h], k0 + c + 1);
      }
      uint32_t ph, pm, pl;
      split3_pair(p0, p1, ph, pm, pl);
      if constexpr (S::P_SMEM) {
        const uint32_t off =
            uP + swz_offset<kRows>(frag_row(warp, lane, i), c >> 3) + (c & 7) * 2;
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
        for (int kk = 0; kk < kKeys / 16; ++kk) {
          const uint64_t dv =
              desc_mnmajor(uV + pair_b(pr) * S::TB + half * kKeys * 128, kKeys, kk);
          const int first = pr == 0 && kk == 0 ? 0 : 1;
          if constexpr (S::P_SMEM)
            wgmma_ss_n64<0, 1>(ot, desc_kmajor(uP + pair_a(pr) * S::PB, kRows, kk), dv, first);
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
      // bias half (t + 1) & 1 was last read at tile t - 1
      load_bias(a, b, k0 + kKeys, bias_s + ((t + 1) & 1) * kKeys);
      if constexpr (STAGE) cp_async_wait<0>();
      __syncthreads();  // every warp is done with this tile; the next one's rows are in
      split_kv<D, STAGE>(a, k, v, k0 + kKeys, stK, stV, sK, sV);
      fence_async_smem();
      __syncthreads();
    }
  }

  float* out = a.o + (long long)b * a.s[kO] + (long long)n * a.s[kO + 2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float lsum = quad_sum(l[h]);
    if (row[h] >= a.Tq) continue;
    const float safe_l = lsum == 0.f ? 1.f : lsum;
    float* dst = out + row[h] * a.s[kO + 1];
#pragma unroll
    for (int i = 2 * h; i < DP / 2; i += 4) {
      const int c = frag_col(lane, i);
      if (c < D) {
        dst[c] = o[i] / safe_l;
        dst[c + 1] = o[i + 1] / safe_l;
      }
    }
    if ((lane & 3) == 0) a.lse[(long long)bh * a.Tq + row[h]] = m[h] + logf(safe_l);
  }
}

template <int D>
cudaError_t launch_d(const F32Args& a, cudaStream_t stream) {
  const int bytes = FwdSmem<D>::BYTES;
  void (*kernel)(F32Args) = flash_fwd_f32_tc_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  kernel<<<dim3((a.Tq + kRows - 1) / kRows, a.B * a.N), kThreads, bytes, stream>>>(a);
  return cudaGetLastError();
}

bool aligned16(const void* p, const long long* s) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && s[0] % 4 == 0 && s[1] % 4 == 0 &&
         s[2] % 4 == 0;
}

}  // namespace

extern "C" {

// Forward, float32. q [B, Tq, N, D], k/v [B, Tk, N, D] and o [B, Tq, N, D]
// through their (batch, time, head) strides in slots 0, 3, 6 and 12 of
// `strides` (21 values, host memory; last dim contiguous); bias [B, Tk]
// f32 or null; lse [B*N, Tq] f32. D in {32, 64, 128}.
int ptt_flash_fwd_f32(const void* q, const void* k, const void* v, const void* bias, void* o,
                      void* lse, int B, int N, int Tq, int Tk, int D, const long long* strides,
                      float scale, int causal, int dropout, unsigned seed, unsigned thresh,
                      float keep_scale, void* stream) {
  if (B <= 0 || N <= 0 || Tq <= 0 || Tk <= 0 || Tq > 65535 || Tk > 65535 ||
      (long long)B * N > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  F32Args a = {};
  a.q = static_cast<const float*>(q);
  a.k = static_cast<const float*>(k);
  a.v = static_cast<const float*>(v);
  a.bias = static_cast<const float*>(bias);
  a.o = static_cast<float*>(o);
  a.lse = static_cast<float*>(lse);
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
  a.vec = aligned16(q, strides + kQ) && aligned16(k, strides + kK) && aligned16(v, strides + kV);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32: return static_cast<int>(launch_d<32>(a, st));
    case 64: return static_cast<int>(launch_d<64>(a, st));
    case 128: return static_cast<int>(launch_d<128>(a, st));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
