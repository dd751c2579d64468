// Prefill GEMM against 2-bit (ternary) / 1-bit (binary) packed weights,
// for sm_90a, on the bf16 tensor cores with an exact three-term split of x.
//
// Replaces: src/repro/kernels/packed_matmul.py:packed_matmul (_matmul_kernel).
// Computes: out (M, N) = x (M, K) . unpack(codes (K/G, N)) in fp32, for the
//           M > 8 prefill shapes.  K is a multiple of G; callers zero-pad x
//           past the true K, so pad codes add nothing.  N may be ragged.
// Bound on this card: bytes, barely.  At the prefill shape (M = 16, true
//           K = 1000, N = 4000) the codes are 1.0 MB and x and out 0.3 MB:
//           0.33 us at 3.35 TB/s.  The three bf16 products below are
//           3 * 2*M*K*N = 0.38 GFLOP, 0.39 us at the 989 TFLOP/s of the bf16
//           tensor cores, so at M = 16 the two bounds meet, and above M = 16
//           the products bound it.  (Counted as fp32 adds on the CUDA cores,
//           one per row and nonzero weight, the same work is 0.96 us.)
// Design:   fp32 x on bf16 tensor cores.  Each x splits exactly into
//           three bf16 terms, rounding to nearest at every step: hi =
//           bf16(x), mid = bf16(x - hi), lo = bf16(x - hi - mid); 8 + 8 + 8
//           significand bits and the signs cover fp32's 24 for every normal
//           x.  The weights are -1/0/+1, which bf16 holds exactly, so every
//           product is exact; mma.sync m16n8k16 accumulates them in fp32 on
//           the tensor cores, whose adds do not round as IEEE
//           round-to-nearest does, so the sum differs from a plain fp32 sum
//           by a few ulps (within rtol 1e-5, atol 1e-4 of the plain
//           version, chip_smoke.py).  Two accumulators per output: the hi
//           products in one, and lo then mid (the small terms first) in the
//           other, added at the end.
//           The codes decode straight into B-fragment registers
//           (packed_codes::bf16_fragment; for ternary one byte permute a
//           register): a ternary word is the 16 k of one column, one k16
//           step; a binary word two.  A warp owns 16-row tiles x 32 columns
//           as four n8 tiles whose columns interleave: thread (group g,
//           lane-in-group t) decodes columns 4g .. 4g+3 (one 16-byte load of
//           four code words) and ends holding the 8 consecutive outputs
//           8t .. 8t+7 of rows g and g + 8.
//           x is staged 128 k at a time in shared memory with cp.async,
//           double-buffered (the next stage and the next code words load
//           while the tensor cores work on this one).  Each staged value is
//           split once, into three bf16 planes whose 272-byte rows let
//           ldmatrix read each term's A fragment without bank conflicts.
//           Tiles: a block is 4 warps, 128 columns and one 16-row tile;
//           the grid covers N and M.  Where that leaves the card short of
//           blocks (M = 16, N = 4000: 32 blocks), a thread block cluster of
//           up to 8 blocks splits K (kernels/packed_matmul.py:
//           matmul_plan).  Each block pushes its partial tile, a slice to each
//           block of the cluster, into that block's shared memory
//           (distributed shared memory); after one cluster barrier each
//           block sums its slice in rank order and stores it.  No atomics:
//           two launches on the same inputs give the same bits.
//           Measured (NVIDIA H100 80GB HBM3, 700 W power limit;
//           chip_smoke.py): 7.2 us at M = 16 and 11.1 us at M = 32
//           (ternary; binary 6.9 and 9.7 us), against 12.9 and 15.5 us for
//           torch.matmul on the dequantized fp32 weight and 73.1 us for the
//           first design, a 64 x 64 fp32 tile on the CUDA cores.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "packed_codes.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int BM = 16;            // rows a block owns: one mma tile
constexpr int WN = 32;            // columns a warp owns: four n8 tiles
constexpr int BN = WN * kWarps;   // columns a block owns
constexpr int KC = 128;           // k values of x staged per pipeline stage
constexpr int XS = KC + 8;        // staged row stride in floats
constexpr int PS = KC + 8;        // bf16 plane row stride: 272 bytes, so the
                                  // 8 row addresses of an ldmatrix phase
                                  // fall on distinct banks
constexpr int kMaxCluster = 8;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  // src-size 0 fills the 16 bytes with zeros and reads nothing
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) {
  uint32_t u;
  memcpy(&u, &v, sizeof(u));
  return u;
}

// (a, b) = hi + mid + lo exactly, each a bf16 pair (a in the low half).
__device__ __forceinline__ void split3(float2 v, uint32_t& hi, uint32_t& mid,
                                       uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(v.x, v.y);
  float ra = __fsub_rn(v.x, __low2float(h));
  float rb = __fsub_rn(v.y, __high2float(h));
  const __nv_bfloat162 m = __floats2bfloat162_rn(ra, rb);
  ra = __fsub_rn(ra, __low2float(m));
  rb = __fsub_rn(rb, __high2float(m));
  hi = bits(h);
  mid = bits(m);
  lo = bits(__floats2bfloat162_rn(ra, rb));
}

// The A fragment of a 16 x 16 bf16 tile from shared memory: lane l gives
// the address of row l % 16, columns 8 (l / 16) ..
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&a)[4], const void* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
      : "r"(s)
      : "memory");
}

// d += a . b on the bf16 tensor cores, fp32 accumulate.
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Store 4 consecutive outputs of row gm from column gn, masking the edge.
__device__ __forceinline__ void store4(float* out, int gm, int gn, float4 v,
                                       int M, int N, bool vec) {
  if (gm >= M || gn >= N) return;
  float* p = out + (size_t)gm * N + gn;
  if (vec) {
    *reinterpret_cast<float4*>(p) = v;
    return;
  }
  const float e[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i)
    if (gn + i < N) p[i] = e[i];
}

// One 16-row tile a block; gridDim.x is the cluster size (the K split).
template <int MODE>
__global__ void __launch_bounds__(kThreads)
packed_matmul_kernel(const float* __restrict__ x,
                     const uint32_t* __restrict__ codes,
                     float* __restrict__ out, int M, int K, int N) {
  constexpr int G = MODE == 0 ? 16 : 32;
  constexpr int CW = KC / G;   // code words per column per stage
  constexpr int SPW = G / 16;  // k16 steps per code word
  constexpr int kQuads = BM * BN / 4;  // float4s of an output tile
  // two x stages; the current stage split into hi, mid and lo bf16 planes;
  // the partials the cluster's blocks push to this block (K split only):
  // a slot for each sender and quad this block owns, rounded up
  __shared__ __align__(16) float xs[2][BM][XS];
  __shared__ __align__(16) uint32_t planes[3][BM][PS / 2];
  __shared__ float4 inbox[kQuads + kMaxCluster];

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int cs = gridDim.x, rank = blockIdx.x;
  const int m0 = blockIdx.z * BM;
  const int nb = blockIdx.y * BN;
  const int n0 = nb + warp * WN;   // this warp's 32 columns
  const int ncol = n0 + 4 * gid;   // this thread's 4 code columns
  const bool vec = (N & 3) == 0;
  const int KW = K / G;
  const int w_begin = (int)((long long)rank * KW / cs);
  const int w_end = (int)((long long)(rank + 1) * KW / cs);
  // every block of the cluster has started before any writes to another's
  // shared memory: arrive now, wait before the first remote write
  if (cs > 1) asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::);

  float acc_hi[4][4], acc_sm[4][4];
#pragma unroll
  for (int t = 0; t < 4; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_hi[t][e] = acc_sm[t][e] = 0.f;

  // x rows [m0, m0 + BM), k of words [w0, w0 + CW) into stage `buf`
  auto stage = [&](int buf, int w0) {
    const int nseg = min(CW, w_end - w0) * (G / 4);  // 16-byte segments a row
    const float* src0 = x + (size_t)w0 * G;
    for (int i = threadIdx.x; i < BM * (KC / 4); i += kThreads) {
      const int r = i / (KC / 4), sg = i % (KC / 4);
      if (sg >= nseg) continue;
      const bool ok = m0 + r < M;
      cp_async16(&xs[buf][r][4 * sg],
                 ok ? src0 + (size_t)(m0 + r) * K + 4 * sg : x, ok);
    }
    cp_async_commit();
  };
  auto load_codes = [&](uint32_t (&cw)[CW][4], int w0) {
#pragma unroll
    for (int j = 0; j < CW; ++j) {
      const int w = w0 + j;
      const uint32_t* p = codes + (size_t)w * N + ncol;
      if (w < w_end && vec && ncol < N) {
        const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
        cw[j][0] = v.x;
        cw[j][1] = v.y;
        cw[j][2] = v.z;
        cw[j][3] = v.w;
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          cw[j][e] = (w < w_end && ncol + e < N) ? __ldg(p + e) : 0u;
      }
    }
  };

  uint32_t cur[CW][4], nxt[CW][4];
  if (w_begin < w_end) {
    stage(0, w_begin);
    load_codes(cur, w_begin);
  }
  int buf = 0;
  for (int w0 = w_begin; w0 < w_end; w0 += CW) {
    if (w0 + CW < w_end) {
      stage(buf ^ 1, w0 + CW);
      load_codes(nxt, w0 + CW);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int nw = min(CW, w_end - w0);
    // split each staged x once into its three bf16 planes
    for (int i = threadIdx.x; i < BM * (KC / 2); i += kThreads) {
      const int r = i / (KC / 2), c = i % (KC / 2);
      if (2 * c >= nw * G) continue;
      split3(*reinterpret_cast<const float2*>(&xs[buf][r][2 * c]),
             planes[0][r][c], planes[1][r][c], planes[2][r][c]);
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < CW; ++j) {
      if (j >= nw) continue;
#pragma unroll
      for (int s = 0; s < SPW; ++s) {
        uint32_t b[4][2];
#pragma unroll
        for (int t = 0; t < 4; ++t)
          packed_codes::bf16_fragment<MODE>(cur[j][t], 16 * s + 2 * tig,
                                            b[t][0], b[t][1]);
        // this lane's ldmatrix row and column (in bf16 pairs) of the planes
        const int row = lane & 15;
        const int kp = ((j * SPW + s) * 16 + 8 * (lane >> 4)) / 2;
        uint32_t hi[4], mid[4], lo[4];
        ldmatrix_x4(hi, &planes[0][row][kp]);
        ldmatrix_x4(mid, &planes[1][row][kp]);
        ldmatrix_x4(lo, &planes[2][row][kp]);
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          mma(acc_sm[t], lo, b[t][0], b[t][1]);
          mma(acc_sm[t], mid, b[t][0], b[t][1]);
          mma(acc_hi[t], hi, b[t][0], b[t][1]);
        }
      }
    }
    __syncthreads();  // the stage and planes are read before they are reused
#pragma unroll
    for (int j = 0; j < CW; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) cur[j][e] = nxt[j][e];
    buf ^= 1;
  }

  // tile t's column q is the warp's column 4q + t, so thread (gid, tig)
  // holds columns 8 tig + 4 (e & 1) + t of row gid + 8 (e >> 1) in v[e]
  float4 v[4];
#pragma unroll
  for (int e = 0; e < 4; ++e)
    v[e] = make_float4(
        acc_hi[0][e] + acc_sm[0][e], acc_hi[1][e] + acc_sm[1][e],
        acc_hi[2][e] + acc_sm[2][e], acc_hi[3][e] + acc_sm[3][e]);
  if (cs == 1) {
#pragma unroll
    for (int e = 0; e < 4; ++e)
      store4(out, m0 + gid + 8 * (e >> 1), n0 + 8 * tig + 4 * (e & 1), v[e],
             M, N, vec);
    return;
  }

  // K split across the cluster: each block pushes the float4s of its
  // partial tile to the block that owns them (block r owns quads
  // [r * per, (r + 1) * per)), into slot (sender, quad); after one cluster
  // barrier each owner sums its slots in rank order and stores.
  cg::cluster_group cluster = cg::this_cluster();
  const int per = (kQuads + cs - 1) / cs;
  asm volatile("barrier.cluster.wait.aligned;\n" ::);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int i = ((gid + 8 * (e >> 1)) * BN + warp * WN + 8 * tig +
                   4 * (e & 1)) / 4;
    const int owner = i / per;
    cluster.map_shared_rank(inbox, owner)[rank * per + i - owner * per] = v[e];
  }
  cluster.sync();  // every push has landed
  const int end = min(kQuads, (int)(rank + 1) * per);
  for (int i = rank * per + threadIdx.x; i < end; i += kThreads) {
    float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int r = 0; r < cs; ++r) {
      const float4 p = inbox[r * per + i - rank * per];
      s.x += p.x;
      s.y += p.y;
      s.z += p.z;
      s.w += p.w;
    }
    store4(out, m0 + (4 * i) / BN, nb + (4 * i) % BN, s, M, N, vec);
  }
}

template <int MODE>
cudaError_t launch(const float* x, const uint32_t* codes, float* out, int M,
                   int K, int N, int cluster, cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster, (N + BN - 1) / BN, (M + BM - 1) / BM);
  cfg.blockDim = dim3(kThreads);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = cluster > 1 ? 1 : 0;
  return cudaLaunchKernelEx(&cfg, packed_matmul_kernel<MODE>, x, codes, out,
                            M, K, N);
}

}  // namespace

// mode: 0 ternary, 1 binary; cluster: blocks that split K (1 .. 8).
// Returns the cudaError_t of the launch.
extern "C" int packed_matmul_launch(const void* x, const void* codes,
                                    void* out, int M, int K, int N, int mode,
                                    int cluster, void* stream) {
  if (M < 1 || N < 1 || K < 1) return (int)cudaErrorInvalidValue;
  const int G = mode == 0 ? 16 : 32;
  if (K % G || cluster < 1 || cluster > kMaxCluster)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  const uint32_t* cw = static_cast<const uint32_t*>(codes);
  float* of = static_cast<float*>(out);
  const cudaError_t err =
      mode == 0 ? launch<0>(xf, cw, of, M, K, N, cluster, s)
                : launch<1>(xf, cw, of, M, K, N, cluster, s);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
