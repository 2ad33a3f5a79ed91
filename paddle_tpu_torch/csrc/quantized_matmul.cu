// K8: fused dequant matmul for Hopper (sm_90a).
//
// Replaces paddle_tpu/ops/pallas/quantized_matmul.py::_kernel (launched
// by fused_dequant_matmul): out [M, N] f32 = x [M, K] f32 @ w_q [K, N]
// int8 with per-output-channel scales w_scale [N].
//
//   int8-activation mode: codes = clip(rint(x / s * qm), -qm, qm), an
//     exact int32 accumulate of codes x w_q on the s8 tensor cores, then
//     out = (float(acc) * xs_over_qm) * (w_scale[n] / qm).
//   weight-only mode: acc = sum_k x * float(w_q) in f32, then
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
//  * Split-K fills 132 SMs at small M: the plan picks `splits` from
//    the number of output tiles (8 at the fc: 16 tiles x 8 = 128
//    blocks), each block sums its k range and adds it into an int32
//    workspace [M, N] by atomicAdd (integer addition is associative, so
//    the sum is exact and independent of order), then counts itself in
//    on the tile's arrival counter; the last block to arrive applies the
//    rescale and writes out (and the accumulator), and zeroes the sums it
//    read and the tile's counter again. With no split, the block writes
//    straight from registers. The caller owns the workspace and the
//    counters: it zeroes them once when it allocates them, and the
//    kernel leaves them zero, so later calls on the stream reuse them.
//  * Edge tiles are zero-filled (rows past M, k past K, columns past N),
//    which is exact. Rows of x whose length is not a multiple of 4
//    floats come by 4-byte copies, weight rows that are not a multiple
//    of 8 bytes by byte loads.
//
// What the weight-only design does (qmm_weight_only_tc_kernel):
//  * Products on the bf16 tensor cores at float32 accuracy: every int8
//    code is exact in bf16, and x is split into three bf16 pieces h, m, l
//    (split3_pair, tc_common.cuh) that carry all 24 bits of its float32;
//    a product of a piece and a code is exact in f32, so the three
//    piece products, summed in f32 (l first), give the f32 product up to
//    summation order. The accumulator starts fresh for every 64-k tile
//    and is added into a running f32 sum in registers: no tensor-core
//    sum runs across k tiles (the int8 kernel's finding that keeps
//    long-K sums inside an f32 gate). tests/test_torch_tc_split.py models
//    it on the CPU.
//  * Operands swapped: out^T = W^T . x^T, so the weight's columns fill
//    wgmma's 64-row side (one warpgroup per 64 columns) and the rows of x
//    its n side; the main path's small M wastes no tensor-core row. The
//    three pieces of x are stacked along n (3 BM rows: n = 24 at M <= 8,
//    96 at the fc's batch 32), so one wgmma per k16 slice takes all three
//    and reads each weight slice from shared memory once. x at large M
//    takes tiles of 128 rows x 128 weight columns (two warpgroups, the
//    pieces one wgmma each) where those tiles fill the card.
//  * One register pass fills shared memory in the layouts wgmma reads:
//    x's pieces as one K-major 128-byte swizzled tile, the codes converted
//    int8 -> bf16 into an MN-major swizzled [64 k][columns] tile (the
//    weight is N-major in device memory, and wgmma's transpose flag
//    reads it as W^T). The raw tiles arrive by cp.async, STAGES tiles
//    ahead (16-byte copies where N % 16 == 0 and the pointer allows, else
//    8-byte where N % 8 == 0 (the fc's N = 1000), else byte loads; x by
//    16-byte copies, or 4-byte where its rows are not 16-byte aligned).
//    Two converted buffers: the products of tile t run while tile t + 1
//    is converted.
//  * Split-K as in int8 mode (the same plan, 8 at the fc), but
//    deterministic: each split writes its partial tile (fragment order,
//    coalesced) to the workspace, and the last block to arrive on the
//    tile's counter sums every split's partial in split order, so two
//    calls on the same inputs give the same bits; it leaves the counter
//    zero. Bytes: at the fc the call must read 2 MB of codes (0.6 us at
//    3.35 TB/s); at a 4096 x 768 x 3072 GEMM three bf16 products per
//    f32 product put the bound on operations (3 x 2MKN at 989 TFLOP/s).
#include <cuda_runtime.h>
#include <stdint.h>

#include "quantized_matmul_plan.cuh"
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
// weight-only mode: x in three bf16 pieces against the codes on wgmma
// ---------------------------------------------------------------------------
constexpr int kWoK = 64;           // k values per tile

// Tiles of the weight-only kernel at BM rows of x (the plan's,
// quantized_matmul_plan.cu): BN = 64 weight columns per warpgroup;
// STAGES raw tiles in flight; two converted buffers (the products of one while the other is
// filled). x's three pieces are stacked as one K-major [3 BM][64] tile,
// so up to BM = 64 one wgmma of n = 3 BM (the STACK) takes all three
// pieces per k16 slice and reads each weight slice once; BM = 128 (n =
// 384 is past wgmma's 256) runs the pieces one wgmma each.
template <int BM>
struct WoTile {
  static constexpr int WGS = BM <= 64 ? 1 : 2;
  static constexpr int BN = 64 * WGS;
  static constexpr int THREADS = 128 * WGS;
  static constexpr int STAGES = BM <= 64 ? 4 : 2;
  static constexpr bool STACK = BM <= 64;
  static constexpr int ACC = BM / 2;            // running-sum registers a thread
  static constexpr int TACC = STACK ? kPieces * ACC : ACC;  // a k tile's accumulator
  static constexpr int XP = BM * 128;           // one bf16 piece of x: [BM][64], K-major
  static constexpr int WB = kWoK * BN * 2;      // the codes as bf16: [64][BN], MN-major
  static constexpr int CONV = kPieces * XP + WB;
  static constexpr int XRAW = BM * kWoK * 4;    // raw f32 x tile
  static constexpr int WRAW = kWoK * BN;        // raw int8 weight tile
  static constexpr int STAGE = XRAW + WRAW;
  static constexpr int SMEM = 1024 + 2 * CONV + STAGES * STAGE + 16;
  static_assert(CONV % 1024 == 0, "converted tiles must stay 1024-byte aligned");
  static_assert(SMEM <= 232448, "shared memory");
};

struct WoArgs {
  const float* x;
  const int8_t* w;
  const float* w_scale;
  float* out;
  int* counters;   // [kK8WoCounters] int32, zero, left zero; split-K only
  float* part;     // [splits][tiles][THREADS][ACC] partial sums; split-K only
  int M, K, N;
  int splits;
  float qm;
  int xvec;        // x rows 16-byte aligned (K % 4 == 0)
  int wvec;        // bytes per weight copy: 16, 8 or 1
};

// D[64 weight columns x N rows of x's pieces] (+)= W^T . x^T over one
// k16 slice; N = 3 BM (stacked pieces) or 128 (one piece of BM = 128)
template <int N>
__device__ __forceinline__ void wgmma_wo(float (&d)[N / 2], uint64_t dw, uint64_t dx,
                                         int scale_d) {
  if constexpr (N == 24) wgmma_ss_n24<1, 0>(d, dw, dx, scale_d);
  else if constexpr (N == 48) wgmma_ss_n48<1, 0>(d, dw, dx, scale_d);
  else if constexpr (N == 96) wgmma_ss_n96<1, 0>(d, dw, dx, scale_d);
  else if constexpr (N == 192) wgmma_ss_n192<1, 0>(d, dw, dx, scale_d);
  else wgmma_ss_n128<1, 0>(d, dw, dx, scale_d);
}

// k tile `kt` of this block's rows of x and columns of w into raw slot
// `raw` (zeros past M, K and N)
template <int BM>
__device__ __forceinline__ void wo_load(const WoArgs& a, uint8_t* raw, int kt, int m0, int n0) {
  using T = WoTile<BM>;
  const int tid = threadIdx.x, k0 = kt * kWoK;
  uint8_t* xs = raw;
  uint8_t* ws = raw + T::XRAW;
  // (loops of compile-time trip counts, unrolled: every copy of a thread
  // issued back to back)
  static_assert(BM * 16 % T::THREADS == 0, "x chunks do not split over the block");
#pragma unroll
  for (int it = 0; it < BM * 16 / T::THREADS; ++it) {  // 16 four-float chunks a row
    const int i = it * T::THREADS + tid, r = i >> 4, c = i & 15, m = m0 + r, k = k0 + 4 * c;
    const uint32_t dst = smem_u32(xs + r * kWoK * 4 + c * 16);
    const float* src = a.x + (long long)m * a.K + k;
    if (a.xvec) {
      const bool ok = m < a.M && k < a.K;
      cp_async16(dst, ok ? src : a.x, ok);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool ok = m < a.M && k + j < a.K;
        cp_async_ca<4>(dst + 4 * j, ok ? src + j : a.x, ok);
      }
    }
  }
  if (a.wvec == 16) {
#pragma unroll
    for (int it = 0; it < kWoK * T::BN / 16 / T::THREADS; ++it) {
      const int i = it * T::THREADS + tid;
      const int r = i / (T::BN / 16), c = i % (T::BN / 16), k = k0 + r, n = n0 + 16 * c;
      const bool ok = k < a.K && n < a.N;
      cp_async16(smem_u32(ws + r * T::BN + 16 * c), ok ? a.w + (long long)k * a.N + n : a.w, ok);
    }
  } else if (a.wvec == 8) {
#pragma unroll
    for (int it = 0; it < kWoK * T::BN / 8 / T::THREADS; ++it) {
      const int i = it * T::THREADS + tid;
      const int r = i / (T::BN / 8), c = i % (T::BN / 8), k = k0 + r, n = n0 + 8 * c;
      const bool ok = k < a.K && n < a.N;
      cp_async_ca<8>(smem_u32(ws + r * T::BN + 8 * c), ok ? a.w + (long long)k * a.N + n : a.w,
                     ok);
    }
  } else {  // masked byte loads (odd N or an unaligned weight): every
             // load of the tile in flight before the first store
    constexpr int WORDS = kWoK * T::BN / 4 / T::THREADS;  // 4-column words a thread
    uint32_t word[WORDS];
#pragma unroll
    for (int j = 0; j < WORDS; ++j) {
      const int i = j * T::THREADS + tid, r = i / (T::BN / 4), c = 4 * (i % (T::BN / 4));
      const int k = k0 + r;
      word[j] = 0;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int n = n0 + c + e;
        const uint32_t byte =
            (k < a.K && n < a.N) ? static_cast<uint8_t>(__ldg(a.w + (long long)k * a.N + n)) : 0;
        word[j] |= byte << (8 * e);
      }
    }
#pragma unroll
    for (int j = 0; j < WORDS; ++j) {
      const int i = j * T::THREADS + tid, r = i / (T::BN / 4), c = 4 * (i % (T::BN / 4));
      *reinterpret_cast<uint32_t*>(ws + r * T::BN + c) = word[j];
    }
  }
}

// raw slot -> converted buffer: x into its three bf16 pieces (rows BM
// apart in one K-major swizzled tile of 3 BM rows), the codes into bf16,
// exactly (the MN-major swizzled [64][BN] tile wgmma reads through its
// transpose flag)
template <int BM>
__device__ __forceinline__ void wo_convert(const uint8_t* raw, uint8_t* conv) {
  using T = WoTile<BM>;
  constexpr int XCH = BM * 8;                   // 8-float chunks of the x tile
  constexpr int WCH = kWoK * T::BN / 8;         // 8-code chunks of the weight tile
  static_assert(WCH % T::THREADS == 0, "weight chunks do not split over the block");
  const int tid = threadIdx.x;
  const float* xs = reinterpret_cast<const float*>(raw);
  // (compile-time trip counts, unrolled: a thread's chunks are
  // independent, so their conversions overlap)
#pragma unroll
  for (int it = 0; it < (XCH + T::THREADS - 1) / T::THREADS; ++it) {
    const int i = it * T::THREADS + tid, r = i >> 3, c = i & 7;
    if (XCH % T::THREADS != 0 && i >= XCH) break;
    const float4 lo = *reinterpret_cast<const float4*>(xs + r * kWoK + 8 * c);
    const float4 hi = *reinterpret_cast<const float4*>(xs + r * kWoK + 8 * c + 4);
    const float x[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
    store_pieces(x, conv, T::XP, swz_offset<kPieces * BM>(r, c));
  }
  const uint8_t* ws = raw + T::XRAW;
  uint8_t* wt = conv + kPieces * T::XP;
#pragma unroll
  for (int it = 0; it < WCH / T::THREADS; ++it) {  // 8 columns a chunk
    const int i = it * T::THREADS + tid, r = i / (T::BN / 8), c = i % (T::BN / 8);
    const uint2 v = *reinterpret_cast<const uint2*>(ws + r * T::BN + 8 * c);
    // code c as float: the bits 0x4B0000xx, xx = c + 128 (the byte with
    // its sign bit flipped), are 2^23 + c + 128, and one exact subtraction
    // leaves c (a byte permute and an add where a conversion instruction
    // runs at a quarter of their rate)
    uint32_t o[4];
    const uint32_t u[2] = {v.x ^ 0x80808080u, v.y ^ 0x80808080u};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const uint32_t word = u[j >> 1];
      const int e = 2 * (j & 1);
      const float f0 = __uint_as_float(__byte_perm(word, 0x4B000000u, 0x7540 | e)) - 8388736.f;
      const float f1 = __uint_as_float(__byte_perm(word, 0x4B000000u, 0x7541 | e)) - 8388736.f;
      o[j] = pack_bf16(f0, f1);
    }
    *reinterpret_cast<uint4*>(wt + swz_offset<kWoK>(r, c)) = make_uint4(o[0], o[1], o[2], o[3]);
  }
}

// grid: (ceil(N / BN), ceil(M / BM), splits); block: T::THREADS.
// out^T [N, M] = W^T [N, K] . x^T [K, M]: the weight's columns fill
// wgmma's 64-row side and the rows of x its n side (8 at M = 1).
template <int BM>
__global__ void __launch_bounds__(WoTile<BM>::THREADS, 1) qmm_weight_only_tc_kernel(const WoArgs a) {
  using T = WoTile<BM>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  uint8_t* conv = smem;                            // two converted buffers
  uint8_t* ring = smem + 2 * T::CONV;              // STAGES raw tiles
  int* last_flag = reinterpret_cast<int*>(ring + T::STAGES * T::STAGE);

  const int tid = threadIdx.x, wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * T::BN;
  const int nkt = (a.K + kWoK - 1) / kWoK;
  const int kps = (nkt + a.splits - 1) / a.splits;
  const int kt0 = blockIdx.z * kps;
  const int nt = max(0, min(nkt, kt0 + kps) - kt0);

  float run[T::ACC];
#pragma unroll
  for (int i = 0; i < T::ACC; ++i) run[i] = 0.f;
  // this thread's two weight columns and their scales, loaded now so the
  // epilogue waits on no load
  int col[2];
  float wsc[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    col[h] = n0 + 64 * wg + frag_row(warp, lane, 2 * h);
    wsc[h] = col[h] < a.N ? __fdiv_rn(__ldg(a.w_scale + col[h]), a.qm) : 0.f;
  }

  // raw tiles 0..STAGES-1 in flight, tile 0 converted
#pragma unroll
  for (int s = 0; s < T::STAGES; ++s) {
    if (s < nt) wo_load<BM>(a, ring + s * T::STAGE, kt0 + s, m0, n0);
    cp_async_commit();
  }
  if (nt > 0) {
    cp_async_wait<T::STAGES - 1>();
    __syncthreads();
    wo_convert<BM>(ring, conv);
  }
  fence_async_smem();
  __syncthreads();
  if (T::STAGES < nt) wo_load<BM>(a, ring, kt0 + T::STAGES, m0, n0);
  cp_async_commit();

  // tile t: the products of converted buffer t & 1 run while raw tile
  // t + 1 is converted into the other; a fresh f32 accumulator per tile,
  // added into `run` (no tensor-core sum runs across k tiles); the raw
  // slot freed is refilled STAGES tiles ahead
  for (int t = 0; t < nt; ++t) {
    const uint32_t uc = smem_u32(conv + (t & 1) * T::CONV);
    const uint32_t uw = uc + kPieces * T::XP + wg * kWoK * 128;
    float acc[T::TACC];
#pragma unroll
    for (int i = 0; i < T::TACC; ++i) acc[i] = 0.f;
    wgmma_fence();
    if constexpr (T::STACK) {
#pragma unroll
      for (int kk = 0; kk < kWoK / 16; ++kk)
        wgmma_wo<kPieces * BM>(acc, desc_mnmajor(uw, kWoK, kk),
                               desc_kmajor(uc, kPieces * BM, kk), kk == 0 ? 0 : 1);
    } else {
#pragma unroll
      for (int piece = kPieces - 1; piece >= 0; --piece)
#pragma unroll
        for (int kk = 0; kk < kWoK / 16; ++kk)
          wgmma_wo<BM>(acc, desc_mnmajor(uw, kWoK, kk),
                       desc_kmajor(uc + piece * T::XP, kPieces * BM, kk),
                       piece == kPieces - 1 && kk == 0 ? 0 : 1);
    }
    wgmma_commit();
    if (t + 1 < nt) {
      cp_async_wait<T::STAGES - 1>();
      __syncthreads();  // raw tile t + 1 landed in every thread's copies
      wo_convert<BM>(ring + ((t + 1) % T::STAGES) * T::STAGE, conv + ((t + 1) & 1) * T::CONV);
    }
    wgmma_wait_all();
    fence_regs(acc);
    if constexpr (T::STACK) {
      // registers p * ACC + i hold piece p's product at run[i]'s place;
      // the pieces are summed smallest first
#pragma unroll
      for (int i = 0; i < T::ACC; ++i)
        run[i] += (acc[2 * T::ACC + i] + acc[T::ACC + i]) + acc[i];
    } else {
#pragma unroll
      for (int i = 0; i < T::ACC; ++i) run[i] += acc[i];
    }
    fence_async_smem();
    __syncthreads();  // buffer (t + 1) & 1 complete; every warpgroup done with t & 1
    if (t + 1 + T::STAGES < nt)
      wo_load<BM>(a, ring + ((t + 1) % T::STAGES) * T::STAGE, kt0 + t + 1 + T::STAGES, m0, n0);
    cp_async_commit();
  }
  cp_async_wait<0>();

  if (a.splits > 1) {
    // this split's partial tile, in fragment order; the last block of the
    // tile to arrive sums every split's in split order (deterministic)
    const int tiles = gridDim.x * gridDim.y;
    const int tile = blockIdx.y * gridDim.x + blockIdx.x;
    float* mine = a.part + ((long long)(blockIdx.z * tiles + tile) * T::THREADS + tid) * T::ACC;
#pragma unroll
    for (int i = 0; i < T::ACC; i += 4)
      __stcg(reinterpret_cast<float4*>(mine + i), make_float4(run[i], run[i + 1], run[i + 2], run[i + 3]));
    __threadfence();
    __syncthreads();
    if (tid == 0) *last_flag = atomicAdd(a.counters + tile, 1) == a.splits - 1;
    __syncthreads();
    if (!*last_flag) return;
    __threadfence();
    // the partials of kMergeBatch splits in flight at a time (64
    // registers of them), added in split order
    constexpr int kMergeBatch = T::ACC >= 4 ? 64 / T::ACC : 16;
    for (int s0 = 0; s0 < a.splits; s0 += kMergeBatch) {
      float4 v[kMergeBatch][T::ACC / 4];
#pragma unroll
      for (int j = 0; j < kMergeBatch; ++j) {
        if (s0 + j >= a.splits) break;
        const float* p =
            a.part + ((long long)((s0 + j) * tiles + tile) * T::THREADS + tid) * T::ACC;
#pragma unroll
        for (int i = 0; i < T::ACC / 4; ++i) v[j][i] = __ldcg(reinterpret_cast<const float4*>(p) + i);
      }
#pragma unroll
      for (int j = 0; j < kMergeBatch; ++j) {
        if (s0 + j >= a.splits) break;
        const bool first = s0 + j == 0;
#pragma unroll
        for (int i = 0; i < T::ACC / 4; ++i) {
          run[4 * i] = first ? v[j][i].x : run[4 * i] + v[j][i].x;
          run[4 * i + 1] = first ? v[j][i].y : run[4 * i + 1] + v[j][i].y;
          run[4 * i + 2] = first ? v[j][i].z : run[4 * i + 2] + v[j][i].z;
          run[4 * i + 3] = first ? v[j][i].w : run[4 * i + 3] + v[j][i].w;
        }
      }
    }
    if (tid == 0) a.counters[tile] = 0;
  }

  // register i: weight column col[(i >> 1) & 1], row of x m0 +
  // frag_col(lane, i)
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (col[h] >= a.N) continue;
#pragma unroll
    for (int i = 2 * h; i < T::ACC; i += 4) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int m = m0 + frag_col(lane, i + e);
        if (m < a.M) a.out[(long long)m * a.N + col[h]] = __fmul_rn(run[i + e], wsc[h]);
      }
    }
  }
}

template <int BM>
cudaError_t launch_wo(const WoArgs& a, cudaStream_t stream) {
  using T = WoTile<BM>;
  void (*kernel)(const WoArgs) = qmm_weight_only_tc_kernel<BM>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.N + T::BN - 1) / T::BN, (a.M + BM - 1) / BM, a.splits);
  kernel<<<grid, T::THREADS, T::SMEM, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// The tile and `splits`, the k ranges per output tile, are
// ptt_quantized_matmul_plan's (quantized_matmul_plan.cu). With splits >
// 1, `workspace` (int32, `workspace_words` of them, at least the plan's)
// holds, in int8 mode, M * N int32 sums and then one arrival counter per
// output tile, all zero; in weight-only mode kK8WoCounters (256) arrival
// counters, zero, then splits x tiles x THREADS x BM / 2 float32 partial
// sums (any content): calls of any shape can share the buffer, the
// counters never moving. The kernel leaves the zeros zero. A workspace
// smaller than the plan's is refused. Weight-only mode ignores acc_out.
extern "C" int ptt_quantized_matmul(const void* x, const void* w_q, const void* w_scale,
                                    void* out, void* acc_out, void* workspace,
                                    long long workspace_words, int M, int K, int N, int int8_mode,
                                    float s, float qm, float xs_over_qm, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int plan[3];
  long long words = 0;
  if (ptt_quantized_matmul_plan(M, K, N, int8_mode, plan, &words) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int bm = plan[0], splits = plan[2];
  if (splits > 1 && (workspace == nullptr || workspace_words < words))
    return static_cast<int>(cudaErrorInvalidValue);
  if (!int8_mode) {
    WoArgs a = {};
    a.x = static_cast<const float*>(x);
    a.w = static_cast<const int8_t*>(w_q);
    a.w_scale = static_cast<const float*>(w_scale);
    a.out = static_cast<float*>(out);
    a.M = M;
    a.K = K;
    a.N = N;
    a.splits = splits;
    a.qm = qm;
    a.xvec = K % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
    const uintptr_t wp = reinterpret_cast<uintptr_t>(w_q);
    a.wvec = N % 16 == 0 && wp % 16 == 0 ? 16 : (N % 8 == 0 && wp % 8 == 0 ? 8 : 1);
    if (splits > 1) {
      a.counters = static_cast<int*>(workspace);
      a.part = reinterpret_cast<float*>(a.counters + kK8WoCounters);
    }
    switch (bm) {
      case 8: return static_cast<int>(launch_wo<8>(a, st));
      case 16: return static_cast<int>(launch_wo<16>(a, st));
      case 32: return static_cast<int>(launch_wo<32>(a, st));
      case 64: return static_cast<int>(launch_wo<64>(a, st));
      default: return static_cast<int>(launch_wo<128>(a, st));
    }
  }
  I8Args a = {};
  a.x = static_cast<const float*>(x);
  a.w = static_cast<const int8_t*>(w_q);
  a.w_scale = static_cast<const float*>(w_scale);
  a.out = static_cast<float*>(out);
  a.acc_out = static_cast<int*>(acc_out);
  a.work = splits > 1 ? static_cast<int*>(workspace) : nullptr;
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
  if (bm == 32) return static_cast<int>(launch_int8<32, 64, 1>(a, st));
  return static_cast<int>(launch_int8<64, 256, 2>(a, st));
}
