// Batched fp32 matrix product whose every output element sums its K terms
// in one fixed order, for sm_90a: attention's two products, the SSD step's
// readout and the norms' row sums in serving.
//
// Replaces: no TPU kernel.  JAX's attention (src/repro/models/layers.py:
//           _sdpa) is two einsums that XLA lowers; the port computed them
//           with cuBLAS, whose algorithm, and with it a row's summation
//           order, follows the batch count and the row count.  So a
//           request's attention scores differed in their last bits
//           between a decode at B = 1 and the same row in a batch of 8, and
//           between a prompt whole and in chunks (PERF.md section 6,
//           bisect_invariance.py), and its stream could follow its
//           neighbours.  This kernel makes each output a function of its
//           own row of A and column of B alone.
// Computes: c[n] = a[n] . b[n] for a (N, M, K), b (N, K, P), c (N, M, P),
//           all fp32 and contiguous: c[n, i, j] = fma(a[n,i,K-1],
//           b[n,K-1,j], ... fma(a[n,i,1], b[n,1,j], fma(a[n,i,0], b[n,0,j],
//           0))), one fused multiply-add a term in increasing k.  Nothing
//           of that depends on N, M, P or the tile an element falls in.
// Bound on this card: the products, 2 * N * M * K * P flops at the fp32
//           rate of the CUDA cores (67 TFLOP/s), or the bytes of a, b and c
//           once (3.35 TB/s), whichever is larger.
// Design:   a block computes a 64 x 64 tile of c with 256 threads, 4 x 4
//           outputs a thread; K advances 16 at a time through shared
//           memory (a's tile stored k-major, so a thread's 4 rows of one
//           k are one 16-byte read); each output keeps one accumulator and
//           takes its terms in order.  Outside the matrices the tiles hold
//           zeros, which add nothing.  At P = 1 (the norms' row sums
//           against a column of ones) a tile would leave 63 of its 64
//           columns idle and stage K / 16 times for one dot a row, so
//           `ordered_dot_kernel` gives each output a thread of its own
//           that takes the same terms in the same order from global
//           memory, a stage of loads ahead: the same bits, without the
//           tiles.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;     // outputs a block owns along M and along P
constexpr int kDepth = 16;    // k a shared-memory stage holds
constexpr int kThreads = 256;

__device__ __forceinline__ float lane(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

__global__ void __launch_bounds__(kThreads)
ordered_bmm_kernel(const float* __restrict__ a, const float* __restrict__ b,
                   float* __restrict__ c, int M, int K, int P) {
  __shared__ __align__(16) float as[kDepth][kTile];  // a's tile, k-major
  __shared__ __align__(16) float bs[kDepth][kTile];
  const int n = blockIdx.z;
  const int i0 = blockIdx.y * kTile, j0 = blockIdx.x * kTile;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  a += (size_t)n * M * K;
  b += (size_t)n * K * P;
  c += (size_t)n * M * P;

  float4 acc[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) acc[r] = make_float4(0.f, 0.f, 0.f, 0.f);

  for (int k0 = 0; k0 < K; k0 += kDepth) {
    // each thread stages 4 values of each tile (zero outside the matrices)
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const int e = threadIdx.x + t * kThreads;   // 0 .. 1023
      const int ar = e / kDepth, ak = e % kDepth;  // a: row, k
      const int gi = i0 + ar, gk = k0 + ak;
      as[ak][ar] = (gi < M && gk < K) ? a[gi * K + gk] : 0.f;
      const int bk = e / kTile, bc = e % kTile;    // b: k, column
      const int hk = k0 + bk, gj = j0 + bc;
      bs[bk][bc] = (hk < K && gj < P) ? b[hk * P + gj] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kDepth; ++kk) {
      const float4 av = *reinterpret_cast<const float4*>(&as[kk][4 * ty]);
      const float4 bv = *reinterpret_cast<const float4*>(&bs[kk][4 * tx]);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float a_r = lane(av, r);
        acc[r].x = __fmaf_rn(a_r, bv.x, acc[r].x);
        acc[r].y = __fmaf_rn(a_r, bv.y, acc[r].y);
        acc[r].z = __fmaf_rn(a_r, bv.z, acc[r].z);
        acc[r].w = __fmaf_rn(a_r, bv.w, acc[r].w);
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int gi = i0 + 4 * ty + r;
    if (gi >= M) continue;
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const int gj = j0 + 4 * tx + s;
      if (gj < P) c[gi * P + gj] = lane(acc[r], s);
    }
  }
}

// P = 1: c[o] = a[o, :] . b[n, :] for output o = n * M + i, one thread an
// output, one fused multiply-add a term in increasing k.  A row of a
// multiple of 4 floats on 16-byte boundaries streams in stages of
// 4 * kDot floats, the next stage's loads issued before this stage's
// adds, so the chain of adds, not the loads' latency, sets the pace.
constexpr int kDot = 8;  // float4s of a row a stage

__device__ __forceinline__ void dot_load(const float4* r, const float4* q,
                                         int s, int n4, float4 (&va)[kDot],
                                         float4 (&vb)[kDot]) {
#pragma unroll
  for (int i = 0; i < kDot; ++i) {
    if (s + i < n4) {
      va[i] = __ldg(r + s + i);
      vb[i] = __ldg(q + s + i);
    }
  }
}

__global__ void __launch_bounds__(128)
ordered_dot_kernel(const float* __restrict__ a, const float* __restrict__ b,
                   float* __restrict__ c, int N, int M, int K) {
  const long long o = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (o >= (long long)N * M) return;
  const float* row = a + (size_t)o * K;
  const float* col = b + (size_t)(o / M) * K;
  float acc = 0.f;
  const uintptr_t at = reinterpret_cast<uintptr_t>(row) |
                       reinterpret_cast<uintptr_t>(col);
  if ((K & 3) == 0 && (at & 15) == 0) {
    const float4* r = reinterpret_cast<const float4*>(row);
    const float4* q = reinterpret_cast<const float4*>(col);
    const int n4 = K / 4;
    const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
    float4 va[kDot], vb[kDot], na[kDot], nb[kDot];
#pragma unroll
    for (int i = 0; i < kDot; ++i) va[i] = vb[i] = na[i] = nb[i] = zero;
    dot_load(r, q, 0, n4, va, vb);
    for (int s = 0; s < n4; s += kDot) {
      dot_load(r, q, s + kDot, n4, na, nb);
#pragma unroll
      for (int i = 0; i < kDot; ++i) {
        if (s + i < n4) {
          acc = __fmaf_rn(va[i].x, vb[i].x, acc);
          acc = __fmaf_rn(va[i].y, vb[i].y, acc);
          acc = __fmaf_rn(va[i].z, vb[i].z, acc);
          acc = __fmaf_rn(va[i].w, vb[i].w, acc);
        }
        va[i] = na[i];
        vb[i] = nb[i];
      }
    }
  } else {
    for (int k = 0; k < K; ++k)
      acc = __fmaf_rn(__ldg(row + k), __ldg(col + k), acc);
  }
  c[o] = acc;
}

}  // namespace

// a (N, M, K), b (N, K, P) -> c (N, M, P), fp32, contiguous.  Returns the
// cudaError_t of the launch.
extern "C" int ordered_bmm_launch(const void* a, const void* b, void* c,
                                  int N, int M, int K, int P, void* stream) {
  // a matrix's offsets are 32-bit ints (64-bit ones cost registers, and
  // with them spills, at this block size)
  const long long most = 1ll << 31;
  if (N < 1 || M < 1 || K < 1 || P < 1 || N > 65535 ||
      (M + kTile - 1) / kTile > 65535 || (long long)M * K >= most ||
      (long long)K * P >= most || (long long)M * P >= most)
    return (int)cudaErrorInvalidValue;
  if (P == 1) {
    const long long outs = (long long)N * M;
    ordered_dot_kernel<<<(unsigned)((outs + 127) / 128), 128, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(a), static_cast<const float*>(b),
        static_cast<float*>(c), N, M, K);
    return (int)cudaGetLastError();
  }
  const dim3 grid((P + kTile - 1) / kTile, (M + kTile - 1) / kTile, N);
  ordered_bmm_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<float*>(c), M, K, P);
  return (int)cudaGetLastError();
}
