// Fused stochastic quantize + bit-pack (paper Eqs. 4-6), for sm_90a.
//
// Replaces: src/repro/kernels/packed_matmul.py:quantize_pack (_qpack_kernel).
// Computes: out (K/G, N) words from w, u (K, N) fp32 and a scalar alpha:
//           code k of column n samples w[k, n] with the uniform noise
//           u[k, n] (packed_codes::encode) and goes to bits [b*j, b*j + b)
//           of word k / G, j = k % G; G = 16, b = 2 (ternary) or G = 32,
//           b = 1 (binary).  alpha arrives as a kernel argument, where the
//           TPU kernel read it from SMEM.  Bit-exact: IEEE division, no
//           fast math, the comparisons of the JAX kernel.
// Bound on this card: bytes.  Each weight needs one fp32 division and a
//           few compares, and reads 8 bytes (w and u) to write 1/8 (1/4)
//           of a byte: at the training path's (1008, 4000) it reads 32.3 MB
//           and writes 1.0 MB (ternary), 9.9 us at 3.35 TB/s, against
//           about 0.3 us of arithmetic on the CUDA cores.
// Design:   one thread per output word: thread (n, r) reads the G weights
//           and noise values of column n in rows r*G .. r*G + G-1, ORs
//           their codes into a register and writes the word once.  The 32
//           lanes of a warp take 32 consecutive columns, so each of the G
//           reads down a column is one coalesced 128-byte line; the G
//           loads of a thread are independent and unrolled, so many are in
//           flight.  Grid: (ceil(N / 128), K / G) blocks of 128 threads.
#include <cuda_runtime.h>
#include <stdint.h>

#include "packed_codes.cuh"

namespace {

constexpr int kThreads = 128;  // columns per block

template <int MODE>
__global__ void __launch_bounds__(kThreads)
quantize_pack_kernel(const float* __restrict__ w, const float* __restrict__ u,
                     uint32_t* __restrict__ out, float alpha, int N) {
  constexpr int G = MODE == 0 ? 16 : 32;
  const int n = blockIdx.x * kThreads + threadIdx.x;
  if (n >= N) return;
  const size_t r = blockIdx.y;
  const size_t base = r * G * (size_t)N + n;
  uint32_t word = 0u;
#pragma unroll
  for (int j = 0; j < G; ++j) {
    const size_t i = base + (size_t)j * N;
    word |= packed_codes::encode<MODE>(w[i], u[i], alpha, j);
  }
  out[r * N + n] = word;
}

}  // namespace

// mode: 0 ternary, 1 binary.  Returns the cudaError_t of the launch.
extern "C" int quantize_pack_launch(const void* w, const void* u, void* out,
                                    float alpha, int K, int N, int mode,
                                    void* stream) {
  const int G = mode == 0 ? 16 : 32;
  if (K < G || N < 1 || K % G || K / G > 65535)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((N + kThreads - 1) / kThreads, K / G), block(kThreads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* wf = static_cast<const float*>(w);
  const float* uf = static_cast<const float*>(u);
  uint32_t* o = static_cast<uint32_t*>(out);
  if (mode == 0)
    quantize_pack_kernel<0><<<grid, block, 0, s>>>(wf, uf, o, alpha, N);
  else
    quantize_pack_kernel<1><<<grid, block, 0, s>>>(wf, uf, o, alpha, N);
  return (int)cudaGetLastError();
}
