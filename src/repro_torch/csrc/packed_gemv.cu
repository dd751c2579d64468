// Multiply-free decode GEMV against 2-bit (ternary) / 1-bit (binary) packed
// weights, for sm_90a.
//
// Replaces: src/repro/kernels/packed_matmul.py:packed_gemv
//           (_gemv_kernel -> accumulate_gemv -> code_masks).
// Computes: out (bp, N) = x (bp, K) . unpack(codes (K/G, N)), bp <= 8,
//           G = 16 (ternary) or 32 (binary).  Ternary code 1 is +1, code 3
//           is -1, any other code is 0; binary bit 1 is +1, bit 0 is -1.
//           Callers zero-pad x past the true K, so pad codes add nothing.
// Bound on this card: the codes are 1/16 (1/32) of the fp32 weight and
//           are read once, so the bytes are small (1.09 MB at the prefill
//           shape bp = 4, true K = 1000, N = 4000: 0.32 us at 3.35 TB/s).
//           The function needs one fp32 add per row and nonzero weight on
//           the CUDA cores (33.5 T/s, half the 67 TFLOP/s that counts an FMA
//           as two): at most bp*K*N, 0.48 us there, and half that with the
//           zeros of a ternary weight.  So bytes bound the ternary GEMV at
//           bp = 4 and adds bound the binary one at bp = 8; either way the
//           inner loop is kept to one LOP3 and one FADD per (row, k, n).
//           Measured at that shape: 8.2 us of device time a launch
//           (NVIDIA H100 80GB HBM3, 700 W power limit; chip_smoke.py).
// Design:   the weight is never a float.  Each 2-bit code becomes a keep
//           mask and a sign bit; the activation's bits are ANDed with the
//           mask and XORed with the sign (one LOP3), then added.  No float
//           multiply anywhere on this path (chip_smoke.py checks the SASS).
//           One thread per output column n for each k-slice: the 32 lanes
//           of a warp read 32 consecutive code words (one 128-byte line),
//           and the 8 warps of a block split K into 8 interleaved slices,
//           reduced through shared memory at the end.  x is staged in
//           shared memory in chunks of 1024 k, zero-filled past bp rows.
#include <cuda_runtime.h>
#include <stdint.h>

#include "packed_codes.cuh"

namespace {

constexpr int kCols = 32;    // output columns per block: one warp's lanes
constexpr int kSlices = 8;   // k-slices per block: one warp each
constexpr int kChunk = 1024; // k values of x staged in shared memory at once

template <int MODE, int ROWS>
__global__ void __launch_bounds__(kCols * kSlices)
packed_gemv_kernel(const float* __restrict__ x,
                   const uint32_t* __restrict__ codes,
                   float* __restrict__ out, int bp, int K, int N) {
  constexpr int G = MODE == 0 ? 16 : 32;
  __shared__ float xs[ROWS][kChunk];
  __shared__ float red[kSlices][ROWS][kCols];

  const int lane = threadIdx.x & 31;
  const int slice = threadIdx.x >> 5;
  const int n = blockIdx.x * kCols + lane;

  float acc[ROWS];
#pragma unroll
  for (int b = 0; b < ROWS; ++b) acc[b] = 0.f;

  for (int k0 = 0; k0 < K; k0 += kChunk) {
    const int kc = min(kChunk, K - k0);
    __syncthreads();
    for (int i = threadIdx.x; i < ROWS * kChunk; i += blockDim.x) {
      const int b = i / kChunk, k = i % kChunk;
      xs[b][k] = (b < bp && k < kc) ? x[(size_t)b * K + k0 + k] : 0.f;
    }
    __syncthreads();
    if (n < N) {
      const int w0 = k0 / G;
      const int nw = kc / G;
      for (int w = slice; w < nw; w += kSlices) {
        const uint32_t word = codes[(size_t)(w0 + w) * N + n];
#pragma unroll
        for (int j = 0; j < G; ++j) {
          uint32_t keep, flip;
          packed_codes::decode<MODE>(word, j, keep, flip);
#pragma unroll
          for (int b = 0; b < ROWS; ++b)
            acc[b] += packed_codes::apply(xs[b][w * G + j], keep, flip);
        }
      }
    }
  }

#pragma unroll
  for (int b = 0; b < ROWS; ++b) red[slice][b][lane] = acc[b];
  __syncthreads();
  const int b = slice;  // after the reduction, warp b writes output row b
  if (b < ROWS && b < bp && n < N) {
    float s = 0.f;
#pragma unroll
    for (int sl = 0; sl < kSlices; ++sl) s += red[sl][b][lane];
    out[(size_t)b * N + n] = s;
  }
}

template <int MODE>
void launch_rows(int rows, dim3 grid, dim3 block, cudaStream_t s,
                 const float* x, const uint32_t* codes, float* out, int bp,
                 int K, int N) {
  switch (rows) {
    case 1: packed_gemv_kernel<MODE, 1><<<grid, block, 0, s>>>(x, codes, out, bp, K, N); break;
    case 2: packed_gemv_kernel<MODE, 2><<<grid, block, 0, s>>>(x, codes, out, bp, K, N); break;
    case 4: packed_gemv_kernel<MODE, 4><<<grid, block, 0, s>>>(x, codes, out, bp, K, N); break;
    default: packed_gemv_kernel<MODE, 8><<<grid, block, 0, s>>>(x, codes, out, bp, K, N); break;
  }
}

}  // namespace

// mode: 0 ternary, 1 binary.  Returns the cudaError_t of the launch.
extern "C" int packed_gemv_launch(const void* x, const void* codes, void* out,
                                  int bp, int K, int N, int mode,
                                  void* stream) {
  if (bp < 1 || bp > 8 || N < 1 || K < 1) return (int)cudaErrorInvalidValue;
  const int G = mode == 0 ? 16 : 32;
  if (K % G) return (int)cudaErrorInvalidValue;
  const int rows = bp <= 1 ? 1 : bp <= 2 ? 2 : bp <= 4 ? 4 : 8;
  const dim3 grid((N + kCols - 1) / kCols), block(kCols * kSlices);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  const uint32_t* cw = static_cast<const uint32_t*>(codes);
  float* of = static_cast<float*>(out);
  if (mode == 0)
    launch_rows<0>(rows, grid, block, s, xf, cw, of, bp, K, N);
  else
    launch_rows<1>(rows, grid, block, s, xf, cw, of, bp, K, N);
  return (int)cudaGetLastError();
}
