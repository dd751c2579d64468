// Prefill GEMM against 2-bit (ternary) / 1-bit (binary) packed weights,
// for sm_90a.
//
// Replaces: src/repro/kernels/packed_matmul.py:packed_matmul (_matmul_kernel).
// Computes: out (M, N) = x (M, K) . unpack(codes (K/G, N)) in fp32, for the
//           M > 8 prefill shapes.  K is a multiple of G; callers zero-pad x
//           past the true K, so pad codes add nothing.
// Bound on this card: operations.  At the prefill shape of this slice
//           (M = 16, true K = 1000, N = 4000) the codes are 1 MB (0.3 us at
//           3.35 TB/s).  The weights are -1/0/+1, so the function needs one
//           fp32 add per row and nonzero weight: 32 M for a ternary weight
//           with half its codes zero, 0.96 us at the 33.5 T/s of the CUDA
//           cores; 64 M and 1.9 us for a binary one.  The tensor cores
//           would be byte bound, but only in TF32 or bf16, which would round
//           x; the reference is an exact fp32 dot, so x stays fp32.  The
//           products below are exact (weights are -1/0/+1).  Measured at
//           that shape: 73.7 us of device time a launch, against 12.5 us for
//           torch.matmul on the dequantized weight (NVIDIA H100 80GB HBM3,
//           700 W power limit; chip_smoke.py): the 64-row tile computes 48
//           rows of padding at M = 16 and fills 63 of the 132 SMs.
// Design:   a plain shared-memory tiled GEMM.  Each 64x64 output tile is one
//           block of 256 threads, 4x4 outputs a thread.  Per 32-deep k step
//           the block stages a 64x32 tile of x and decodes the matching
//           (32/G, 64) code words into a 32x64 tile of -1/0/+1 floats in
//           shared memory, then accumulates in fp32 registers.  wgmma, TMA
//           and a deeper pipeline are later work.
#include <cuda_runtime.h>
#include <stdint.h>

#include "packed_codes.cuh"

namespace {

constexpr int BM = 64, BN = 64, BK = 32, TM = 4, TN = 4;
constexpr int kThreads = (BM / TM) * (BN / TN);  // 256

template <int MODE>
__global__ void __launch_bounds__(kThreads)
packed_matmul_kernel(const float* __restrict__ x,
                     const uint32_t* __restrict__ codes,
                     float* __restrict__ out, int M, int K, int N) {
  constexpr int G = MODE == 0 ? 16 : 32;
  constexpr int WPT = BK / G;  // code words per column per k step
  __shared__ float xs[BK][BM + 4];
  __shared__ float ws[BK][BN];

  const int tx = threadIdx.x % (BN / TN);
  const int ty = threadIdx.x / (BN / TN);
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int KW = K / G;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += BK) {
    for (int i = threadIdx.x; i < BM * BK; i += kThreads) {
      const int m = i / BK, k = i % BK;
      const int gm = m0 + m, gk = k0 + k;
      xs[k][m] = (gm < M && gk < K) ? x[(size_t)gm * K + gk] : 0.f;
    }
    for (int i = threadIdx.x; i < WPT * BN; i += kThreads) {
      const int wr = i / BN, n = i % BN;
      const int gw = k0 / G + wr, gn = n0 + n;
      const uint32_t word =
          (gw < KW && gn < N) ? codes[(size_t)gw * N + gn] : 0u;
#pragma unroll
      for (int j = 0; j < G; ++j)
        ws[wr * G + j][n] = packed_codes::value<MODE>(word, j);
    }
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < BK; ++k) {
      float a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = xs[k][ty * TM + i];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = ws[k][tx * TN + j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] += a[i] * b[j];
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gm = m0 + ty * TM + i;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gn = n0 + tx * TN + j;
      if (gn < N) out[(size_t)gm * N + gn] = acc[i][j];
    }
  }
}

}  // namespace

// mode: 0 ternary, 1 binary.  Returns the cudaError_t of the launch.
extern "C" int packed_matmul_launch(const void* x, const void* codes,
                                    void* out, int M, int K, int N, int mode,
                                    void* stream) {
  if (M < 1 || N < 1 || K < 1) return (int)cudaErrorInvalidValue;
  const int G = mode == 0 ? 16 : 32;
  if (K % G) return (int)cudaErrorInvalidValue;
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM), block(kThreads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  const uint32_t* cw = static_cast<const uint32_t*>(codes);
  float* of = static_cast<float*>(out);
  if (mode == 0)
    packed_matmul_kernel<0><<<grid, block, 0, s>>>(xf, cw, of, M, K, N);
  else
    packed_matmul_kernel<1><<<grid, block, 0, s>>>(xf, cw, of, M, K, N);
  return (int)cudaGetLastError();
}
