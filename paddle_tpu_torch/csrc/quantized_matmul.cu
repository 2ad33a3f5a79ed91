// K8: fused dequant matmul for Hopper (sm_90a).
//
// Replaces paddle_tpu/ops/pallas/quantized_matmul.py::_kernel (launched
// by fused_dequant_matmul): out [M, N] f32 = x [M, K] f32 @ w_q [K, N]
// int8 with per-output-channel scales w_scale [N].
//
//   int8-activation mode: codes = clip(rint(x / s * qm), -qm, qm), an
//     exact int32 accumulate of codes x w_q (dp4a), then
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
// What bounds it on the H100: at the ResNet-50 fc (M = batch, K = 2048,
// N = 1000) it reads 2 MB of int8 weights once per call, a few us at
// 3.35 TB/s, and launches only 16 * ceil(M / 64) blocks; at large M
// (a 4096 x 768 x 3072 GEMM) it is bound by operations. The TPU kernel's
// 128^3 MXU tiles become 64 x 64 output tiles per 256-thread block, each
// thread owning a 4 x 4 register tile; a K tile of 32 is loaded into
// shared memory as codes packed four k per int32 (the activation is
// quantized in registers on the way in), and dp4a does four multiply-adds
// per instruction on the CUDA cores. Edge tiles are zero-filled, which
// is exact in both modes. Tensor-core s8 tiles (mma.sync / wgmma) and
// TMA are left for a later change.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;
constexpr int BN = 64;
constexpr int BK = 32;           // k values per tile
constexpr int KW = BK / 4;       // packed int32 words per tile row
constexpr int THREADS = 256;     // 16 x 16 threads, 4 x 4 outputs each

__device__ __forceinline__ int quant_code(float x, float s, float qm) {
  float q = rintf(__fmul_rn(__fdiv_rn(x, s), qm));
  q = fminf(fmaxf(q, -qm), qm);
  return static_cast<int>(q);
}

__global__ void __launch_bounds__(THREADS)
qmm_int8_kernel(const float* __restrict__ x, const int8_t* __restrict__ w,
                const float* __restrict__ w_scale, float* __restrict__ out,
                int* __restrict__ acc_out, int M, int K, int N, float s,
                float qm, float xs_over_qm) {
  __shared__ int As[BM][KW + 1];   // x codes, row m, k packed by 4
  __shared__ int Bs[BN][KW + 1];   // w codes, column n, k packed by 4
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  int acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0;

  for (int k0 = 0; k0 < K; k0 += BK) {
    for (int e = tid; e < BM * KW; e += THREADS) {
      const int r = e / KW, wd = e % KW;
      const int m = m0 + r, k = k0 + wd * 4;
      uint32_t packed = 0;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        int code = 0;
        if (m < M && k + b < K)
          code = quant_code(x[(long long)m * K + k + b], s, qm);
        packed |= (static_cast<uint32_t>(code) & 0xffu) << (8 * b);
      }
      As[r][wd] = static_cast<int>(packed);
    }
    for (int e = tid; e < BN * KW; e += THREADS) {
      const int c = e % BN, wd = e / BN;
      const int n = n0 + c, k = k0 + wd * 4;
      uint32_t packed = 0;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        int v = 0;
        if (n < N && k + b < K) v = w[(long long)(k + b) * N + n];
        packed |= (static_cast<uint32_t>(v) & 0xffu) << (8 * b);
      }
      Bs[c][wd] = static_cast<int>(packed);
    }
    __syncthreads();
#pragma unroll
    for (int wd = 0; wd < KW; ++wd) {
      int a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[ty * 4 + i][wd];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[tx * 4 + j][wd];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = __dp4a(a[i], b[j], acc[i][j]);
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
      if (m >= M) continue;
      const long long o = (long long)m * N + n;
      out[o] = __fmul_rn(__fmul_rn(__int2float_rn(acc[i][j]), xs_over_qm),
                         ws);
      if (acc_out != nullptr) acc_out[o] = acc[i][j];
    }
  }
}

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

extern "C" int ptt_quantized_matmul(const void* x, const void* w_q,
                                    const void* w_scale, void* out,
                                    void* acc_out, int M, int K, int N,
                                    int int8_mode, float s, float qm,
                                    float xs_over_qm, void* stream) {
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (int8_mode) {
    qmm_int8_kernel<<<grid, THREADS, 0, st>>>(
        static_cast<const float*>(x), static_cast<const int8_t*>(w_q),
        static_cast<const float*>(w_scale), static_cast<float*>(out),
        static_cast<int*>(acc_out), M, K, N, s, qm, xs_over_qm);
  } else {
    qmm_weight_only_kernel<<<grid, THREADS, 0, st>>>(
        static_cast<const float*>(x), static_cast<const int8_t*>(w_q),
        static_cast<const float*>(w_scale), static_cast<float*>(out), M, K,
        N, qm);
  }
  return static_cast<int>(cudaGetLastError());
}
