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
//           fp32, a and b read through their strides, c contiguous.
// The order, the same on every route and a function of k alone: the K
//           terms of an output fall into blocks of 32 consecutive k
//           (block q holds k = 32q .. 32q + 31).  Each block is one chain
//           of fused multiply-adds in increasing k from +0,
//               p_q = fma(a[32q+31] b[32q+31], ... fma(a[32q] b[32q], 0)),
//           and the output is the blocks' partials added in increasing q
//           from +0:  c = (((0 + p_0) + p_1) + ...) + p_last.
//           Every step is an explicit __fmaf_rn / __fadd_rn, so nvcc can
//           neither contract nor reassociate it.  Nothing of that depends on
//           N, M, P, the strides, the tile or the route.  Terms past K are
//           zeros: fma(0, 0, p) is p (a partial -0 turns +0, and the total,
//           which starts at +0 and never becomes -0, does not see the
//           difference), so zero columns of a with zero rows of b appended
//           to K leave every bit as it was.
// Bound on this card: the products, 2 * N * M * K * P flops at the fp32
//           rate of the CUDA cores (67 TFLOP/s), or the bytes of a, b and c
//           once (3.35 TB/s), whichever is larger.
// Routes, picked by the wrapper from (N, M, K, P) alone
//           (kernels/ordered_bmm.py `route`):
//   row     P = 1, the norms' means of squares: a row to 1-8 warps (by
//           its block count), a lane a block, staged through shared
//           memory by coalesced float4 loads; the block partials meet in
//           shared memory and one lane adds them in block order.
//   small   M <= 16, decode's scores and values, the SSD readout: a CTA
//           owns a batch's M rows (a power of two >= M) and 32-256
//           columns, a lane a column; its warps split the blocks of k
//           (1-8 a round), each stages its block of a in shared memory and
//           chains the block's 32 terms for every row; owners add the
//           round's partials in block order.
//   tile    prefill and encoder products: 64 x 64 or 128 x 64 tiles
//           (4 x 4 or 8 x 4 outputs a thread, two CTAs an SM), 256
//           threads (warps of 8 x 4 threads), a stage one block of
//           k, two stages in flight by cp.async (16-byte copies where the
//           layout allows, else 4-byte ones, zero-filled past the edges);
//           a thread keeps a partial and a total an output.  b is staged
//           as it lies: by rows of k (values: P contiguous) or, for the
//           keys' permuted view (K contiguous), by columns.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 32;   // k a block of the order holds
constexpr int kPitch = 36;   // floats a k-contiguous row of a stage holds
constexpr int kThreads = 256;

// an operand's strides in elements: two batch dims, then its rows and
// columns ((M, K) of a, (K, P) of b)
struct Strides {
  long long s1, s2, sr, sc;
};

__device__ __forceinline__ void cp16(void* dst, const void* src, int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp4(void* dst, const void* src, int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// ---------------------------------------------------------------- row
// One block's partial by the strides: the terms k0 .. min(k0 + 32, K) - 1
// of a row and a column, one chain in increasing k.
__device__ __forceinline__ float block_chain(const float* row, long long sa,
                                             const float* col, long long sb,
                                             int k0, int K) {
  float p = 0.f;
  const int n = min(kBlock, K - k0);
  for (int kk = 0; kk < n; ++kk)
    p = __fmaf_rn(__ldg(row + (k0 + kk) * sa), __ldg(col + (k0 + kk) * sb), p);
  return p;
}

// a warp's staging of its 32 blocks of a row and of the column, a block to
// a row of kPitch floats
constexpr int kRowStage = 2 * 32 * kPitch;
constexpr size_t kRowSmem = sizeof(float) * kThreads / 32 * kRowStage;

// P = 1: CTA o (W warps) takes output o = n * M + i, row i of a[n] against
// the column b[n]; a round gives each of its 32 W lanes one block.  `vec`
// (the row and the column contiguous, 16-byte aligned, K % 4 == 0): a warp
// brings its 32 blocks of both in coalesced float4 loads (512 bytes an
// instruction) into shared memory, then a lane chains its own block from
// there (rows of kPitch floats: no bank conflicts either way); else a lane
// reads its block by the strides.  Past K the staged terms are zeros,
// which move no bit (header).
__global__ void __launch_bounds__(kThreads)
row_kernel(const float* __restrict__ a, const float* __restrict__ b,
           float* __restrict__ c, int N2, int M, int K, Strides A, Strides B,
           int vec) {
  extern __shared__ __align__(16) float stage[];
  __shared__ __align__(16) float part[kThreads / 32][32];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int W = blockDim.x >> 5;
  const long long o = blockIdx.x, n = o / M;
  const float* row = a + (n / N2) * A.s1 + (n % N2) * A.s2 + (o % M) * A.sr;
  const float* col = b + (n / N2) * B.s1 + (n % N2) * B.s2;
  const int nb = (K + kBlock - 1) / kBlock;
  float* sa = stage + warp * kRowStage;
  float* sb = sa + 32 * kPitch;
  float total = 0.f;
  for (int r0 = 0; r0 < nb; r0 += 32 * W) {
    const int q0 = r0 + warp * 32;  // the warp's first block
    float p = 0.f;
    if (vec) {
      const float4* r4 = reinterpret_cast<const float4*>(row);
      const float4* c4 = reinterpret_cast<const float4*>(col);
      const int n4 = K / 4;
      const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
      float4 va[8], vb[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int g = q0 * 8 + 32 * i + lane;
        va[i] = g < n4 ? __ldg(r4 + g) : zero;
        vb[i] = g < n4 ? __ldg(c4 + g) : zero;
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int f = 32 * i + lane;  // block f / 8, float4 f % 8
        *reinterpret_cast<float4*>(sa + (f >> 3) * kPitch + (f & 7) * 4) = va[i];
        *reinterpret_cast<float4*>(sb + (f >> 3) * kPitch + (f & 7) * 4) = vb[i];
      }
      __syncwarp();
#pragma unroll
      for (int t = 0; t < kBlock; t += 4) {
        const float4 x = *reinterpret_cast<const float4*>(sa + lane * kPitch + t);
        const float4 y = *reinterpret_cast<const float4*>(sb + lane * kPitch + t);
        p = __fmaf_rn(x.x, y.x, p);
        p = __fmaf_rn(x.y, y.y, p);
        p = __fmaf_rn(x.z, y.z, p);
        p = __fmaf_rn(x.w, y.w, p);
      }
    } else if (q0 + lane < nb) {
      p = block_chain(row, A.sc, col, B.sr, (q0 + lane) * kBlock, K);
    }
    part[warp][lane] = p;
    __syncthreads();
    if (threadIdx.x == 0) {
      // the W warps' partials in block order; those past the last block
      // are +0, which moves no bit
      const float4* pp = reinterpret_cast<const float4*>(&part[0][0]);
#pragma unroll 4
      for (int t = 0; t < 8 * W; ++t) {
        const float4 v = pp[t];
        total = __fadd_rn(total, v.x);
        total = __fadd_rn(total, v.y);
        total = __fadd_rn(total, v.z);
        total = __fadd_rn(total, v.w);
      }
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) c[o] = total;
}

// ---------------------------------------------------------------- small
// M <= BM rows of one batch against 32 * (8 / KS) columns; warp (kw, cw)
// takes block r0 + kw of each round of KS blocks for column cw * 32 + lane.
// `kvec`: b is k-contiguous (the keys' view), 16-byte aligned, K % 4 == 0:
// a lane reads its column's block as 8 float4; else 32 loads by the
// strides (coalesced across lanes where P is contiguous).
template <int BM>
__global__ void __launch_bounds__(kThreads)
small_kernel(const float* __restrict__ a, const float* __restrict__ b,
             float* __restrict__ c, int N2, int M, int K, int P, int KS,
             Strides A, Strides B, int kvec) {
  __shared__ __align__(16) float as[kThreads / 32][BM][kBlock];
  __shared__ float part[kThreads / 32][BM][32];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int kw = warp % KS, cw = warp / KS;
  const int j = (blockIdx.x * (8 / KS) + cw) * 32 + lane;
  const int n = blockIdx.y;
  const float* an = a + (n / N2) * A.s1 + (n % N2) * A.s2;
  const float* bj = b + (n / N2) * B.s1 + (n % N2) * B.s2 +
                    min(j, P - 1) * B.sc;
  const int nb = (K + kBlock - 1) / kBlock;
  float total[BM];
#pragma unroll
  for (int q = 0; q < BM; ++q) total[q] = 0.f;

  for (int r0 = 0; r0 < nb; r0 += KS) {
    const int blk = r0 + kw;
    float p[BM];
#pragma unroll
    for (int i = 0; i < BM; ++i) p[i] = 0.f;
    if (blk < nb) {
      const int k0 = blk * kBlock, k = k0 + lane;
#pragma unroll
      for (int i = 0; i < BM; ++i)
        as[warp][i][lane] = (i < M && k < K) ? __ldg(an + i * A.sr + k * A.sc)
                                             : 0.f;
      float bv[kBlock];
      if (kvec) {
        const float4* q4 = reinterpret_cast<const float4*>(bj + k0);
#pragma unroll
        for (int t = 0; t < 8; ++t) {
          const float4 v = k0 + 4 * t < K ? __ldg(q4 + t)
                                          : make_float4(0.f, 0.f, 0.f, 0.f);
          bv[4 * t] = v.x;
          bv[4 * t + 1] = v.y;
          bv[4 * t + 2] = v.z;
          bv[4 * t + 3] = v.w;
        }
      } else {
#pragma unroll
        for (int t = 0; t < kBlock; ++t)
          bv[t] = k0 + t < K ? __ldg(bj + (k0 + t) * B.sr) : 0.f;
      }
      __syncwarp();
#pragma unroll
      for (int t = 0; t < kBlock; t += 4) {
#pragma unroll
        for (int i = 0; i < BM; ++i) {
          const float4 av = *reinterpret_cast<const float4*>(&as[warp][i][t]);
          p[i] = __fmaf_rn(av.x, bv[t], p[i]);
          p[i] = __fmaf_rn(av.y, bv[t + 1], p[i]);
          p[i] = __fmaf_rn(av.z, bv[t + 2], p[i]);
          p[i] = __fmaf_rn(av.w, bv[t + 3], p[i]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < BM; ++i) part[warp][i][lane] = p[i];
    __syncthreads();
    // warp (kw, cw) owns rows kw, kw + KS, ... of its column
#pragma unroll
    for (int q = 0; q < BM; ++q) {
      const int i = kw + KS * q;
      if (i < BM)
        for (int s = 0; s < KS && r0 + s < nb; ++s)
          total[q] = __fadd_rn(total[q], part[cw * KS + s][i][lane]);
    }
    __syncthreads();
  }
  if (j < P) {
    float* cj = c + (long long)n * M * P + j;
#pragma unroll
    for (int q = 0; q < BM; ++q) {
      const int i = kw + KS * q;
      if (i < M) cj[(long long)i * P] = total[q];
    }
  }
}

// ---------------------------------------------------------------- tile
// A (16 TM) x (16 TN) tile of c, 256 threads as 16 x 16, thread (tx, ty)
// owning rows ty + 16 i.  A stage holds one block of k: a as [row][k]
// (pitch kPitch, read two k at a time), b as [k][column] when P is
// contiguous (thread columns 64 q + 4 tx + 0..3, float4 reads) or as
// [column][k] when K is (KMAJ: thread columns tx + 16 c, one float a
// column).  A warp's 4 rows and 8 columns of threads read either layout
// without bank conflicts.
template <int TM, int TN, bool KMAJ>
struct Tile {
  static constexpr int BM = 16 * TM, BN = 16 * TN;
  static constexpr int AS = BM * kPitch;
  static constexpr int BS = KMAJ ? BN * kPitch : kBlock * BN;
  static constexpr size_t smem = sizeof(float) * 2 * (AS + BS);
};

template <int TM, int TN, bool KMAJ>
__global__ void __launch_bounds__(kThreads, 2)
tile_kernel(const float* __restrict__ a, const float* __restrict__ b,
            float* __restrict__ c, int N2, int M, int K, int P, Strides A,
            Strides B, int vec_a, int vec_b, int vec_c) {
  using T = Tile<TM, TN, KMAJ>;
  constexpr int BM = T::BM, BN = T::BN;
  extern __shared__ __align__(16) float smem[];
  // a warp is 8 columns of threads x 4 rows, the CTA 2 x 4 warps: a
  // fragment load reads 4 rows of a and 8 columns' float4 of b, 128 bytes
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int tx = (warp & 1) * 8 + (lane & 7), ty = (warp >> 1) * 4 + (lane >> 3);
  const int n = blockIdx.z;
  const int i0 = blockIdx.y * BM, j0 = blockIdx.x * BN;
  const float* an = a + (n / N2) * A.s1 + (n % N2) * A.s2;
  const float* bn = b + (n / N2) * B.s1 + (n % N2) * B.s2;

  auto load = [&](int stage, int k0) {
    float* as = smem + stage * T::AS;
    float* bs = smem + 2 * T::AS + stage * T::BS;
    if (vec_a) {
      for (int e = tid; e < BM * 8; e += kThreads) {
        const int r = e >> 3, kc = (e & 7) * 4, gi = i0 + r, gk = k0 + kc;
        const bool in = gi < M && gk < K;
        cp16(as + r * kPitch + kc, in ? an + gi * A.sr + gk : an,
             in ? 4 * min(4, K - gk) : 0);
      }
    } else {
      for (int e = tid; e < BM * kBlock; e += kThreads) {
        const int r = e >> 5, kk = e & 31, gi = i0 + r, gk = k0 + kk;
        const bool in = gi < M && gk < K;
        cp4(as + r * kPitch + kk, in ? an + gi * A.sr + gk * A.sc : an,
            in ? 4 : 0);
      }
    }
    if (KMAJ) {
      if (vec_b) {
        for (int e = tid; e < BN * 8; e += kThreads) {
          const int r = e >> 3, kc = (e & 7) * 4, gj = j0 + r, gk = k0 + kc;
          const bool in = gj < P && gk < K;
          cp16(bs + r * kPitch + kc, in ? bn + gj * B.sc + gk : bn,
               in ? 4 * min(4, K - gk) : 0);
        }
      } else {
        for (int e = tid; e < BN * kBlock; e += kThreads) {
          const int r = e >> 5, kk = e & 31, gj = j0 + r, gk = k0 + kk;
          const bool in = gj < P && gk < K;
          cp4(bs + r * kPitch + kk, in ? bn + gj * B.sc + gk * B.sr : bn,
              in ? 4 : 0);
        }
      }
    } else {
      if (vec_b) {
        for (int e = tid; e < kBlock * (BN / 4); e += kThreads) {
          const int kk = e / (BN / 4), jc = (e % (BN / 4)) * 4;
          const int gk = k0 + kk, gj = j0 + jc;
          const bool in = gk < K && gj < P;
          cp16(bs + kk * BN + jc, in ? bn + gk * B.sr + gj : bn,
               in ? 4 * min(4, P - gj) : 0);
        }
      } else {
        for (int e = tid; e < kBlock * BN; e += kThreads) {
          const int kk = e / BN, jj = e % BN, gk = k0 + kk, gj = j0 + jj;
          const bool in = gk < K && gj < P;
          cp4(bs + kk * BN + jj, in ? bn + gk * B.sr + gj * B.sc : bn,
              in ? 4 : 0);
        }
      }
    }
  };

  float tot[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int q = 0; q < TN; ++q) tot[i][q] = 0.f;

  const int nb = (K + kBlock - 1) / kBlock;
  load(0, 0);
  cp_commit();
  for (int blk = 0; blk < nb; ++blk) {
    if (blk + 1 < nb) {
      load((blk + 1) & 1, (blk + 1) * kBlock);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    const float* as = smem + (blk & 1) * T::AS;
    const float* bs = smem + 2 * T::AS + (blk & 1) * T::BS;
    float acc[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int q = 0; q < TN; ++q) acc[i][q] = 0.f;
#pragma unroll
    for (int t = 0; t < kBlock; t += 2) {
      // a's fragment two k at a time (float2), which keeps the 128 x 64
      // tile within two CTAs an SM
      float2 av[TM];
#pragma unroll
      for (int i = 0; i < TM; ++i)
        av[i] = *reinterpret_cast<const float2*>(as + (ty + 16 * i) * kPitch +
                                                 t);
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        float bv[TN];
        if constexpr (KMAJ) {
#pragma unroll
          for (int q = 0; q < TN; ++q)
            bv[q] = bs[(tx + 16 * q) * kPitch + t + s];
        } else {
#pragma unroll
          for (int q = 0; q < TN / 4; ++q) {
            const float4 v = *reinterpret_cast<const float4*>(
                bs + (t + s) * BN + 64 * q + 4 * tx);
            bv[4 * q] = v.x;
            bv[4 * q + 1] = v.y;
            bv[4 * q + 2] = v.z;
            bv[4 * q + 3] = v.w;
          }
        }
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int q = 0; q < TN; ++q)
            acc[i][q] = __fmaf_rn(s == 0 ? av[i].x : av[i].y, bv[q], acc[i][q]);
      }
    }
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int q = 0; q < TN; ++q) tot[i][q] = __fadd_rn(tot[i][q], acc[i][q]);
    __syncthreads();
  }

  float* cn = c + (long long)n * M * P;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gi = i0 + ty + 16 * i;
    if (gi >= M) continue;
    float* cr = cn + (long long)gi * P;
    if constexpr (KMAJ) {
#pragma unroll
      for (int q = 0; q < TN; ++q) {
        const int gj = j0 + tx + 16 * q;
        if (gj < P) cr[gj] = tot[i][q];
      }
    } else {
#pragma unroll
      for (int q = 0; q < TN / 4; ++q) {
        const int gj = j0 + 64 * q + 4 * tx;
        if (vec_c && gj < P) {
          *reinterpret_cast<float4*>(cr + gj) = make_float4(
              tot[i][4 * q], tot[i][4 * q + 1], tot[i][4 * q + 2],
              tot[i][4 * q + 3]);
        } else {
#pragma unroll
          for (int r = 0; r < 4; ++r)
            if (gj + r < P) cr[gj + r] = tot[i][4 * q + r];
        }
      }
    }
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

bool mult4(long long s) { return (s & 3) == 0; }

template <int TM, int TN, bool KMAJ>
cudaError_t launch_tile(const float* a, const float* b, float* c, int N,
                        int N2, int M, int K, int P, Strides A, Strides B,
                        cudaStream_t st) {
  using T = Tile<TM, TN, KMAJ>;
  static bool sized = false;  // the dynamic shared memory allowed, once
  if (!sized) {
    const cudaError_t e = cudaFuncSetAttribute(
        tile_kernel<TM, TN, KMAJ>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)T::smem);
    if (e != cudaSuccess) return e;
    sized = true;
  }
  const int vec_a = A.sc == 1 && aligned16(a) && mult4(A.s1) &&
                    mult4(A.s2) && mult4(A.sr);
  const int vec_b = KMAJ ? (B.sr == 1 && aligned16(b) && mult4(B.s1) &&
                            mult4(B.s2) && mult4(B.sc))
                         : (B.sc == 1 && aligned16(b) && mult4(B.s1) &&
                            mult4(B.s2) && mult4(B.sr));
  const int vec_c = (P & 3) == 0 && aligned16(c);
  const dim3 grid((P + T::BN - 1) / T::BN, (M + T::BM - 1) / T::BM, N);
  tile_kernel<TM, TN, KMAJ><<<grid, kThreads, T::smem, st>>>(
      a, b, c, N2, M, K, P, A, B, vec_a, vec_b, vec_c);
  return cudaGetLastError();
}

template <int BM>
cudaError_t launch_small(const float* a, const float* b, float* c, int N,
                         int N2, int M, int K, int P, Strides A, Strides B,
                         cudaStream_t st) {
  const int nb = (K + kBlock - 1) / kBlock;
  int KS = 1;  // warps along k: enough for one round where nb <= 8
  while (KS < 8 && KS < nb) KS *= 2;
  const int cols = 32 * (8 / KS);
  const int kvec = B.sr == 1 && B.sc != 1 && (K & 3) == 0 && aligned16(b) &&
                   mult4(B.s1) && mult4(B.s2) && mult4(B.sc);
  const dim3 grid((P + cols - 1) / cols, N);
  small_kernel<BM><<<grid, kThreads, 0, st>>>(a, b, c, N2, M, K, P, KS, A, B,
                                               kvec);
  return cudaGetLastError();
}

}  // namespace

// a (N1 * N2, M, K), b (N1 * N2, K, P) -> c (N1 * N2, M, P), fp32.  a and b
// are read through their strides (elements: batch dims 1 and 2, rows,
// columns; 0 for a broadcast dim), c is written contiguous.  `route`: 0
// row (P = 1), 1 small (M <= 16), then tiles of rows x columns: 2 64 x 64,
// 3 128 x 64.  Returns the cudaError_t of the launch.
extern "C" int ordered_bmm_launch(const void* a_, const void* b_, void* c_,
                                  int route, int N1, int N2, int M, int K,
                                  int P, long long sa1, long long sa2,
                                  long long sam, long long sak, long long sb1,
                                  long long sb2, long long sbk, long long sbp,
                                  void* stream) {
  const float* a = static_cast<const float*>(a_);
  const float* b = static_cast<const float*>(b_);
  float* c = static_cast<float*>(c_);
  const Strides A{sa1, sa2, sam, sak}, B{sb1, sb2, sbk, sbp};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long N = (long long)N1 * N2;
  if (N1 < 1 || N2 < 1 || M < 1 || K < 1 || P < 1)
    return (int)cudaErrorInvalidValue;
  if (route == 0) {
    if (P != 1 || N * M >= (1ll << 31)) return (int)cudaErrorInvalidValue;
    const int nb = (K + kBlock - 1) / kBlock;
    int W = 1;  // warps a row
    while (W < 8 && 32 * W < nb) W *= 2;
    const int vec = A.sc == 1 && B.sr == 1 && (K & 3) == 0 && aligned16(a) &&
                    aligned16(b) && mult4(A.s1) && mult4(A.s2) &&
                    mult4(A.sr) && mult4(B.s1) && mult4(B.s2);
    static bool sized = false;  // the dynamic shared memory allowed, once
    if (!sized) {
      const cudaError_t e = cudaFuncSetAttribute(
          row_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          (int)kRowSmem);
      if (e != cudaSuccess) return (int)e;
      sized = true;
    }
    row_kernel<<<(unsigned)(N * M), 32 * W,
                 vec ? W * kRowStage * sizeof(float) : 0, st>>>(
        a, b, c, N2, M, K, A, B, vec);
    return (int)cudaGetLastError();
  }
  if (N > 65535) return (int)cudaErrorInvalidValue;
  const int n = (int)N;
  if (route == 1) {
    if (M > 16) return (int)cudaErrorInvalidValue;
    if (M == 1) return (int)launch_small<1>(a, b, c, n, N2, M, K, P, A, B, st);
    if (M == 2) return (int)launch_small<2>(a, b, c, n, N2, M, K, P, A, B, st);
    if (M <= 4) return (int)launch_small<4>(a, b, c, n, N2, M, K, P, A, B, st);
    if (M <= 8) return (int)launch_small<8>(a, b, c, n, N2, M, K, P, A, B, st);
    return (int)launch_small<16>(a, b, c, n, N2, M, K, P, A, B, st);
  }
  if ((M + 63) / 64 > 65535) return (int)cudaErrorInvalidValue;
  // the keys' view: K contiguous, P not
  const bool kmaj = sbk == 1 && sbp != 1;
#define TILE(TM)                                                            \
  return (int)(kmaj ? launch_tile<TM, 4, true>(a, b, c, n, N2, M, K, P, A, B, \
                                               st)                           \
                    : launch_tile<TM, 4, false>(a, b, c, n, N2, M, K, P, A,  \
                                                B, st))
  if (route == 2) TILE(4);   // 64 x 64
  if (route == 3) TILE(8);   // 128 rows x 64 columns
#undef TILE
  return (int)cudaErrorInvalidValue;
}
