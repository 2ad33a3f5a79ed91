// K8: fused dequant matmul for Hopper (sm_90a).
//
// Replaces paddle_tpu/ops/pallas/quantized_matmul.py::_kernel (launched
// by fused_dequant_matmul): out [M, N] f32 = x [M, K] f32 @ w_q [K, N]
// int8 with per-output-channel scales w_scale [N].
//
//   int8-activation mode: codes = clip(rint(x / s * qm), -qm, qm), an
//     exact int32 accumulate of codes x w_q on the s8 tensor cores, then
//     out = (float(acc) * xs_over_qm) * (w_scale[n] / qm).
//   weight-only mode: acc = sum_k x * float(w_q) in f32 (FMA), then
//     out = acc * (w_scale[n] / qm).
//
// Every quotient and product of the quantization and the rescale is an
// explicitly rounded IEEE operation (__fdiv_rn / __fmul_rn), in the JAX
// package's order, so codes, accumulators and int8-mode outputs equal
// the plain PyTorch version (ops/kernels/quantized_matmul.py) bit for
// bit; the build uses no fast-math flag.
//
// What bounds it on the H100: bytes. At the ResNet-50 fc (M = batch in
// {1, 8, 32}, K = 2048, N = 1000) the call must read 2 MB of int8
// weights, under a microsecond at 3.35 TB/s; at a 4096 x 768 x 3072 GEMM
// it must move 63 MB (x in, out f32), about twice its time at the 1979
// TOP/s int8 rate.
//
// What the int8 design does about it:
//  * Products on the tensor cores: mma.sync m16n8k32 s8 x s8 -> s32,
//    exact in int32 as dp4a is. mma.sync rather than wgmma, because the
//    main path's M is 1, 8 or 32 and a 64-row wgmma tile would be mostly
//    empty at each of them.
//  * Two tile shapes: 32 x 64 outputs per 128-thread block for M <= 32,
//    64 x 256 per 512-thread block above (the wide tile quantizes each
//    row of x for a quarter as many column tiles as 64 x 64 would); each
//    warp owns 16 or 32 rows by 32 columns, in at most 128 registers.
//  * Operands arrive through a 4-stage cp.async ring of raw tiles (x as
//    f32 [rows][64 k], w_q as bytes [64 k][columns], rows padded to
//    8 mod 32 words). The block quantizes each x tile once into one of
//    two s8 code tiles (rows padded to 80 bytes: ldmatrix reads them
//    without bank conflicts), and the A fragments come from them by
//    ldmatrix.x4. K tile t runs the products of code tile t while it
//    quantizes tile t + 1 into the other, so the quantization's ALU work
//    overlaps the tensor cores' and one barrier a tile suffices.
//  * 8-bit tensor-core operands are K-major on both sides, and w_q is
//    N-major. No transposed copy of the weight is kept: each lane reads
//    four 4-byte words (4 k rows x 4 columns) of the raw weight tile and
//    turns the 4 x 4 byte block with __byte_perm into the B fragments of
//    four n8 tiles. For that, column c of n8 tile j is weight column
//    4c + j of the warp's 32: a lane then holds 8 adjacent output
//    columns, written as two 16-byte stores.
//  * Split-K fills 132 SMs at small M: the wrapper picks `splits` from
//    the number of output tiles (8 at the fc: 16 tiles x 8 = 128
//    blocks), each block sums its k range and adds it into an int32
//    workspace [M, N] by atomicAdd (integer addition is associative, so
//    the sum is exact and independent of order), then counts itself in
//    on the tile's arrival counter; the last block to arrive applies the
//    rescale and writes out (and the accumulator), and zeroes the sums it
//    read and the tile's counter again. With no split, the block writes
//    straight from registers. The wrapper owns the workspace and the
//    counters: it zeroes them once when it allocates them, and the
//    kernel leaves them zero, so later calls on the stream reuse them.
//  * Edge tiles are zero-filled (rows past M, k past K, columns past N),
//    which is exact. Rows of x whose length is not a multiple of 4
//    floats come by 4-byte copies, weight rows that are not a multiple
//    of 8 bytes by byte loads.
//
// Weight-only mode keeps its CUDA-core kernel: one 64 x 64 output tile
// per 256-thread block, 4 x 4 outputs per thread, f32 FMA.
#include <cuda_runtime.h>
#include <stdint.h>

#include "tc_common.cuh"

namespace {

__device__ __forceinline__ int quant_code(float x, float s, float qm) {
  float q = rintf(__fmul_rn(__fdiv_rn(x, s), qm));
  q = fminf(fmaxf(q, -qm), qm);
  return static_cast<int>(q);
}

// ---------------------------------------------------------------------------
// int8-activation mode: s8 tensor cores, split-K
// ---------------------------------------------------------------------------
constexpr int kKTile = 64;               // k values per pipeline stage
constexpr int kStages = 4;               // cp.async ring depth
constexpr int kAPitch = kKTile + 16;     // bytes per row of the code tile

template <int TBM, int TBN, int MT>
struct I8Tile {
  static constexpr int WARPS_M = TBM / (16 * MT);
  static constexpr int WARPS_N = TBN / 32;
  static constexpr int THREADS = 32 * WARPS_M * WARPS_N;
  // blocks an SM must hold at once: caps registers at 128 a thread
  static constexpr int MIN_BLOCKS = THREADS <= 256 ? 2 : 1;
  static constexpr int WPITCH = TBN + 8;           // bytes per raw weight row
  static constexpr int XBYTES = TBM * kKTile * 4;  // raw x tile
  static constexpr int WBYTES = kKTile * WPITCH;   // raw weight tile
  static constexpr int STAGE = XBYTES + WBYTES;
  static constexpr int SMEM = kStages * STAGE + 2 * TBM * kAPitch + 16;
  static_assert(WPITCH % 32 == 8, "raw weight rows must be 8 mod 32 words");
  static_assert(STAGE % 16 == 0, "stages must stay 16-byte aligned");
  static_assert(kStages >= 3, "stage t + 1 must be in flight while tile t computes");
};

struct I8Args {
  const float* x;
  const int8_t* w;
  const float* w_scale;
  float* out;
  int* acc_out;    // [M, N] int32, or null
  int* work;       // [M, N] int32, zeroed; split-K only
  int* counters;   // [tiles] int32, zeroed; split-K only
  int M, K, N;
  int splits;
  float s, qm, xs_over_qm;
  int xvec;        // x rows 16-byte aligned (K % 4 == 0)
  int wvec;        // w_q rows 8-byte aligned (N % 8 == 0)
};

template <int BYTES>
__device__ __forceinline__ void cp_async_ca(uint32_t dst, const void* src, bool full) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(dst), "l"(src),
               "n"(BYTES), "r"(full ? BYTES : 0)
               : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// d += a . b on the s8 tensor cores (m16n8k32, int32 accumulate)
__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The 4 x 4 byte block r[i] = (row k+i: columns n..n+3) turned into
// t[j] = (column n+j: rows k..k+3), byte 0 holding row k.
__device__ __forceinline__ void transpose4x4(const uint32_t (&r)[4], uint32_t (&t)[4]) {
  const uint32_t lo01 = __byte_perm(r[0], r[1], 0x5140);
  const uint32_t hi01 = __byte_perm(r[0], r[1], 0x7362);
  const uint32_t lo23 = __byte_perm(r[2], r[3], 0x5140);
  const uint32_t hi23 = __byte_perm(r[2], r[3], 0x7362);
  t[0] = __byte_perm(lo01, lo23, 0x5410);
  t[1] = __byte_perm(lo01, lo23, 0x7632);
  t[2] = __byte_perm(hi01, hi23, 0x5410);
  t[3] = __byte_perm(hi01, hi23, 0x7632);
}

// k tile `kt` of this block's rows and columns into ring slot `slot`
template <int TBM, int TBN, int MT>
__device__ __forceinline__ void load_stage(const I8Args& a, uint8_t* ring, int slot, int kt,
                                            int m0, int n0) {
  using T = I8Tile<TBM, TBN, MT>;
  const int tid = threadIdx.x, k0 = kt * kKTile;
  uint8_t* xs = ring + slot * T::STAGE;
  uint8_t* ws = xs + T::XBYTES;
  if (a.xvec) {  // 16 four-float chunks per row
#pragma unroll
    for (int it = 0; it < TBM * 16 / T::THREADS; ++it) {
      const int i = it * T::THREADS + tid, r = i / 16, c = i % 16;
      const int m = m0 + r, k = k0 + 4 * c;
      const bool ok = m < a.M && k < a.K;
      cp_async16(smem_u32(xs + r * kKTile * 4 + c * 16),
                 ok ? a.x + (long long)m * a.K + k : a.x, ok);
    }
  } else {
    for (int i = tid; i < TBM * kKTile; i += T::THREADS) {
      const int r = i / kKTile, c = i % kKTile;
      const int m = m0 + r, k = k0 + c;
      const bool ok = m < a.M && k < a.K;
      cp_async_ca<4>(smem_u32(xs + (r * kKTile + c) * 4),
                     ok ? a.x + (long long)m * a.K + k : a.x, ok);
    }
  }
  if (a.wvec) {  // 8-byte chunks of weight rows
#pragma unroll
    for (int it = 0; it < kKTile * (TBN / 8) / T::THREADS; ++it) {
      const int i = it * T::THREADS + tid, r = i / (TBN / 8), c = i % (TBN / 8);
      const int k = k0 + r, n = n0 + 8 * c;
      const bool ok = k < a.K && n < a.N;
      cp_async_ca<8>(smem_u32(ws + r * T::WPITCH + 8 * c),
                     ok ? a.w + (long long)k * a.N + n : a.w, ok);
    }
  } else {
    for (int i = tid; i < kKTile * TBN; i += T::THREADS) {
      const int r = i / TBN, c = i % TBN;
      const int k = k0 + r, n = n0 + c;
      ws[r * T::WPITCH + c] =
          (k < a.K && n < a.N) ? static_cast<uint8_t>(a.w[(long long)k * a.N + n]) : 0;
    }
  }
}

// grid: (ceil(N / TBN), ceil(M / TBM), splits); block: T::THREADS.
template <int TBM, int TBN, int MT>
__global__ void __launch_bounds__(I8Tile<TBM, TBN, MT>::THREADS,
                                  I8Tile<TBM, TBN, MT>::MIN_BLOCKS)
qmm_int8_tc_kernel(const I8Args a) {
  using T = I8Tile<TBM, TBN, MT>;
  extern __shared__ __align__(16) uint8_t smem[];
  uint8_t* ring = smem;
  uint8_t* codes = smem + kStages * T::STAGE;
  int* last_flag = reinterpret_cast<int*>(codes + 2 * TBM * kAPitch);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm0 = (warp / T::WARPS_N) * 16 * MT;   // warp's first row in the tile
  const int wn0 = (warp % T::WARPS_N) * 32;        // warp's first column in the tile
  const int m0 = blockIdx.y * TBM, n0 = blockIdx.x * TBN;
  const int nkt = (a.K + kKTile - 1) / kKTile;
  const int kps = (nkt + a.splits - 1) / a.splits;
  const int kt0 = blockIdx.z * kps;
  const int nt = max(0, min(nkt, kt0 + kps) - kt0);

  int acc[MT][4][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][j][e] = 0;

  // quantize the x tile of ring slot `slot` once into code tile `buf`
  auto quantize = [&](int slot, int buf) {
    const uint8_t* xs = ring + slot * T::STAGE;
    uint8_t* ct = codes + buf * TBM * kAPitch;
#pragma unroll
    for (int it = 0; it < TBM * 16 / T::THREADS; ++it) {
      const int i = it * T::THREADS + tid, r = i / 16, c = i % 16;
      const float4 v = *reinterpret_cast<const float4*>(xs + r * kKTile * 4 + c * 16);
      const uint32_t word = (static_cast<uint32_t>(quant_code(v.x, a.s, a.qm)) & 0xffu) |
                            ((static_cast<uint32_t>(quant_code(v.y, a.s, a.qm)) & 0xffu) << 8) |
                            ((static_cast<uint32_t>(quant_code(v.z, a.s, a.qm)) & 0xffu) << 16) |
                            (static_cast<uint32_t>(quant_code(v.w, a.s, a.qm)) << 24);
      *reinterpret_cast<uint32_t*>(ct + r * kAPitch + 4 * c) = word;
    }
  };

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nt) load_stage<TBM, TBN, MT>(a, ring, s, kt0 + s, m0, n0);
    cp_async_commit();
  }
  cp_async_wait<kStages - 2>();
  __syncthreads();  // stage 0 landed
  if (nt > 0) quantize(0, 0);

  // k tile t: the products of code tile t & 1 with the raw weights of
  // stage t, then the quantization of stage t + 1 into the other code
  // tile, so the ALU work of one overlaps the tensor-core work of the
  // other; one barrier a tile
  for (int t = 0; t < nt; ++t) {
    cp_async_wait<kStages - 3>();
    // code tile t & 1 is complete, stage t + 1 has landed, and every
    // warp is done with tile t - 1 (its stage's slot is free again)
    __syncthreads();
    if (t + kStages - 1 < nt)
      load_stage<TBM, TBN, MT>(a, ring, (t + kStages - 1) % kStages, kt0 + t + kStages - 1,
                                m0, n0);
    cp_async_commit();
    const uint8_t* ct = codes + (t & 1) * TBM * kAPitch;
    const uint32_t* wsw =
        reinterpret_cast<const uint32_t*>(ring + (t % kStages) * T::STAGE + T::XBYTES);

#pragma unroll
    for (int ks = 0; ks < kKTile / 32; ++ks) {
      uint32_t af[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const int row = wm0 + 16 * mt + (lane & 7) + 8 * ((lane >> 3) & 1);
        ldmatrix_x4(af[mt], smem_u32(ct + row * kAPitch + 32 * ks + 16 * (lane >> 4)));
      }
      // B fragments: rows 32ks + 4(lane%4) + i (b0) and + 16 (b1), weight
      // columns wn0 + 4(lane/4) .. + 3, one per n8 tile
      uint32_t r0[4], r1[4], b0[4], b1[4];
      const int col_w = (wn0 >> 2) + (lane >> 2);
      const int krow = 32 * ks + 4 * (lane & 3);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        r0[i] = wsw[(krow + i) * (T::WPITCH / 4) + col_w];
        r1[i] = wsw[(krow + 16 + i) * (T::WPITCH / 4) + col_w];
      }
      transpose4x4(r0, b0);
      transpose4x4(r1, b1);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_s8(acc[mt][j], af[mt], b0[j], b1[j]);
    }
    if (t + 1 < nt) quantize((t + 1) % kStages, (t + 1) & 1);
  }
  cp_async_wait<0>();

  // lane's outputs: rows wm0 + 16mt + lane/4 + 8h, columns
  // wn0 + 8(lane%4) + e, e = 0..7 (e = j from c[2h], e = 4 + j from c[2h+1])
  const int nb = n0 + wn0 + 8 * (lane & 3);
  if (a.splits > 1) {
    if (nt > 0) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int m = m0 + wm0 + 16 * mt + (lane >> 2) + 8 * h;
          if (m >= a.M) continue;
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            const int n = nb + e;
            if (n < a.N) atomicAdd(a.work + (long long)m * a.N + n, acc[mt][e & 3][2 * h + (e >> 2)]);
          }
        }
    }
    __threadfence();
    __syncthreads();
    if (tid == 0) {
      const int tile = blockIdx.y * gridDim.x + blockIdx.x;
      *last_flag = atomicAdd(a.counters + tile, 1) == a.splits - 1;
    }
    __syncthreads();
    if (!*last_flag) return;
    __threadfence();
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + wm0 + 16 * mt + (lane >> 2) + 8 * h;
        if (m >= a.M) continue;
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const int n = nb + e;
          int v = 0;
          if (n < a.N) {   // read the sum, and leave the workspace zero
            int* p = a.work + (long long)m * a.N + n;
            v = __ldcg(p);
            __stcg(p, 0);
          }
          acc[mt][e & 3][2 * h + (e >> 2)] = v;
        }
      }
    if (tid == 0) a.counters[blockIdx.y * gridDim.x + blockIdx.x] = 0;
  }

  float wsc[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) wsc[e] = nb + e < a.N ? __fdiv_rn(a.w_scale[nb + e], a.qm) : 0.f;
  const bool vec = (a.N % 4 == 0) && nb + 8 <= a.N;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + wm0 + 16 * mt + (lane >> 2) + 8 * h;
      if (m >= a.M) continue;
      int v[8];
      float o[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        v[e] = acc[mt][e & 3][2 * h + (e >> 2)];
        o[e] = __fmul_rn(__fmul_rn(__int2float_rn(v[e]), a.xs_over_qm), wsc[e]);
      }
      const long long row = (long long)m * a.N;
      if (vec) {
        float4* op = reinterpret_cast<float4*>(a.out + row + nb);
        op[0] = make_float4(o[0], o[1], o[2], o[3]);
        op[1] = make_float4(o[4], o[5], o[6], o[7]);
        if (a.acc_out != nullptr) {
          int4* ap = reinterpret_cast<int4*>(a.acc_out + row + nb);
          ap[0] = make_int4(v[0], v[1], v[2], v[3]);
          ap[1] = make_int4(v[4], v[5], v[6], v[7]);
        }
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          if (nb + e >= a.N) continue;
          a.out[row + nb + e] = o[e];
          if (a.acc_out != nullptr) a.acc_out[row + nb + e] = v[e];
        }
      }
    }
}

template <int TBM, int TBN, int MT>
cudaError_t launch_int8(const I8Args& a, cudaStream_t stream) {
  using T = I8Tile<TBM, TBN, MT>;
  void (*kernel)(const I8Args) = qmm_int8_tc_kernel<TBM, TBN, MT>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.N + TBN - 1) / TBN, (a.M + TBM - 1) / TBM, a.splits);
  kernel<<<grid, T::THREADS, T::SMEM, stream>>>(a);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// weight-only mode: f32 FMA on the CUDA cores
// ---------------------------------------------------------------------------
constexpr int BM = 64;
constexpr int BN = 64;
constexpr int BK = 32;           // k values per tile
constexpr int THREADS = 256;     // 16 x 16 threads, 4 x 4 outputs each

__global__ void __launch_bounds__(THREADS)
qmm_weight_only_kernel(const float* __restrict__ x,
                       const int8_t* __restrict__ w,
                       const float* __restrict__ w_scale,
                       float* __restrict__ out, int M, int K, int N,
                       float qm) {
  __shared__ float As[BK][BM + 4];   // x tile, transposed: k-major
  __shared__ float Bs[BK][BN + 4];   // w tile as f32
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < K; k0 += BK) {
    for (int e = tid; e < BM * BK; e += THREADS) {
      const int r = e / BK, kk = e % BK;
      const int m = m0 + r, k = k0 + kk;
      As[kk][r] = (m < M && k < K) ? x[(long long)m * K + k] : 0.0f;
    }
    for (int e = tid; e < BN * BK; e += THREADS) {
      const int c = e % BN, kk = e / BN;
      const int n = n0 + c, k = k0 + kk;
      Bs[kk][c] = (n < N && k < K)
                      ? static_cast<float>(w[(long long)k * N + n]) : 0.0f;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < BK; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[kk][ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[kk][tx * 4 + j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int n = n0 + tx * 4 + j;
    if (n >= N) continue;
    const float ws = __fdiv_rn(w_scale[n], qm);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int m = m0 + ty * 4 + i;
      if (m < M) out[(long long)m * N + n] = __fmul_rn(acc[i][j], ws);
    }
  }
}

}  // namespace

// int8 mode (int8_mode != 0): `splits` k ranges per output tile (the
// wrapper's k8_split_count); with splits > 1, `workspace` holds M * N
// int32 sums and then one int32 arrival counter per output tile, all
// zero, and the kernel leaves them zero. Tiles: 32 x 64 for M <= 32, else 64 x 256. Weight-only mode
// ignores acc_out, workspace and splits.
extern "C" int ptt_quantized_matmul(const void* x, const void* w_q, const void* w_scale,
                                    void* out, void* acc_out, void* workspace, int M, int K,
                                    int N, int int8_mode, int splits, float s, float qm,
                                    float xs_over_qm, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (M <= 0 || N <= 0 || K < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (!int8_mode) {
    const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
    qmm_weight_only_kernel<<<grid, THREADS, 0, st>>>(
        static_cast<const float*>(x), static_cast<const int8_t*>(w_q),
        static_cast<const float*>(w_scale), static_cast<float*>(out), M, K, N, qm);
    return static_cast<int>(cudaGetLastError());
  }
  if (splits < 1 || splits > 65535 || (splits > 1 && workspace == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  I8Args a = {};
  a.x = static_cast<const float*>(x);
  a.w = static_cast<const int8_t*>(w_q);
  a.w_scale = static_cast<const float*>(w_scale);
  a.out = static_cast<float*>(out);
  a.acc_out = static_cast<int*>(acc_out);
  a.work = static_cast<int*>(workspace);
  a.counters = a.work == nullptr ? nullptr : a.work + (long long)M * N;
  a.M = M;
  a.K = K;
  a.N = N;
  a.splits = splits;
  a.s = s;
  a.qm = qm;
  a.xs_over_qm = xs_over_qm;
  a.xvec = K % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  a.wvec = N % 8 == 0 && reinterpret_cast<uintptr_t>(w_q) % 8 == 0;
  if (M <= 32) return static_cast<int>(launch_int8<32, 64, 1>(a, st));
  return static_cast<int>(launch_int8<64, 256, 2>(a, st));
}
