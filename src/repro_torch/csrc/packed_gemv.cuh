// The multiply-free packed GEMV kernel of csrc/packed_gemv.cu: x of at
// most 8 rows in one row tile, or of any number of rows in 8-row tiles over
// gridDim.z, a row of x summed in the same order, to the same bits,
// whatever the row count, so a decode step's row does not depend on what
// shares its batch.  packed_gemv.cu says what it computes and how.
#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "packed_codes.cuh"

namespace packed_gemv {

namespace cg = cooperative_groups;

constexpr int kQuads = 8;             // column quads a block owns
constexpr int kCols = 4 * kQuads;     // output columns a block owns
constexpr int kThreads = 256;
constexpr int kSlices = kThreads / kQuads;  // k-slices of a block: 4 a warp
constexpr int kChunk = 16;            // k a slice takes at a time: a ternary
                                      // word, half a binary one
constexpr int kUnroll = 8;            // codes decoded a loop step
constexpr int kMaxCluster = 8;

// The ROWS staged values of one k: 128-bit broadcasts where ROWS >= 4.
template <int ROWS>
__device__ __forceinline__ void load_rows(const float* p, float (&v)[ROWS]) {
  if constexpr (ROWS >= 4) {
#pragma unroll
    for (int q = 0; q < ROWS / 4; ++q) {
      const float4 t = reinterpret_cast<const float4*>(p)[q];
      v[4 * q] = t.x;
      v[4 * q + 1] = t.y;
      v[4 * q + 2] = t.z;
      v[4 * q + 3] = t.w;
    }
  } else if constexpr (ROWS == 2) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    v[0] = t.x;
    v[1] = t.y;
  } else {
    v[0] = p[0];
  }
}

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

__device__ __forceinline__ float4 shfl_add4(float4 a, int lane_mask) {
  a.x += __shfl_xor_sync(0xffffffffu, a.x, lane_mask);
  a.y += __shfl_xor_sync(0xffffffffu, a.y, lane_mask);
  a.z += __shfl_xor_sync(0xffffffffu, a.z, lane_mask);
  a.w += __shfl_xor_sync(0xffffffffu, a.w, lane_mask);
  return a;
}

// Store 4 consecutive outputs of row r from column n, masking the edge.
__device__ __forceinline__ void store4(float* out, int r, int n, float4 v,
                                       int N) {
  if (n >= N) return;
  float* p = out + (size_t)r * N + n;
  if ((N & 3) == 0) {
    *reinterpret_cast<float4*>(p) = v;
    return;
  }
  const float e[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i)
    if (n + i < N) p[i] = e[i];
}

// One tile of kCols columns and ROWS rows a block; gridDim.x is the
// cluster size (the K split), gridDim.z the row tiles of x (M rows).  The
// tile's bp = min(ROWS, M - its first row) rows are real; rows [bp, ROWS)
// are staged as zeros and never stored.  VEC: codes read 16 bytes at a
// time.  Nothing a row adds, nor the order it adds in, depends on ROWS,
// bp, M or the row tile: a row's sums are a function of (K, N, MODE) and
// the cluster size alone.
template <int MODE, int ROWS, bool VEC>
__global__ void __launch_bounds__(kThreads)
packed_gemv_kernel(const float* __restrict__ x,
                   const uint32_t* __restrict__ codes,
                   float* __restrict__ out, int M, int K, int N) {
  constexpr int G = MODE == 0 ? 16 : 32;
  constexpr int B = 32 / G;  // bits a code
  // float4s of x a thread stages a pass: a pass is kSlices chunks
  constexpr int kStaged = (ROWS * kSlices * kChunk / 4 + kThreads - 1) / kThreads;
  // the pass's x, k-major: xs[k * ROWS + row] (16 KB at most); the warps'
  // partials (the slices of a warp summed by shuffles); the partials the
  // cluster's blocks push to this block: a slot for each sender and float4
  // output this block owns, rounded up
  __shared__ __align__(16) float xs[kSlices * kChunk * ROWS];
  __shared__ float4 red[kThreads / 32][ROWS * kQuads];
  __shared__ float4 inbox[ROWS * kQuads + kMaxCluster];

  const int m0 = blockIdx.z * ROWS, bp = min(ROWS, M - m0);
  x += (size_t)m0 * K;
  out += (size_t)m0 * N;
  const int q = threadIdx.x % kQuads, slice = threadIdx.x / kQuads;
  const int cs = gridDim.x, rank = blockIdx.x;
  const int n = blockIdx.y * kCols + 4 * q;   // this thread's 4 columns
  const int KC = K / kChunk;
  const int c_begin = rank * KC / cs, c_end = (rank + 1) * KC / cs;
  // every block of the cluster has started before any writes to another's
  // shared memory: arrive now, wait before the first remote write
  if (cs > 1) asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::);
  const bool xvec = (reinterpret_cast<uintptr_t>(x) & 15) == 0;

  float acc[ROWS][4];
#pragma unroll
  for (int r = 0; r < ROWS; ++r)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[r][e] = 0.f;

  // A pass takes kSlices chunks, one a slice; chunk c's word for this
  // thread's 4 columns (0 past c_end or N)
  auto load_word = [&](uint32_t (&cw)[4], int c) {
    const uint32_t* p = codes + (size_t)(c / (G / kChunk)) * N + n;
    if (c < c_end && n < N) {
      if (VEC) {
        const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
        cw[0] = v.x;
        cw[1] = v.y;
        cw[2] = v.z;
        cw[3] = v.w;
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) cw[e] = n + e < N ? __ldg(p + e) : 0u;
      }
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) cw[e] = 0u;
    }
  };

  // 1. this thread's first code word before anything else; each later one
  // loads while the pass before adds
  uint32_t cw[4], nxt[4];
  load_word(cw, c_begin + slice);
  for (int p0 = c_begin; p0 < c_end; p0 += kSlices) {
    const int pn = min(kSlices, c_end - p0);  // chunks of this pass
    // 2. x rows [0, bp) of the pass's k, k-major, while the codes arrive;
    // rows [bp, ROWS) zero
    if (p0 > c_begin) __syncthreads();  // the last pass has read the stage
    // (all of a thread's loads first, then its stores: one round trip)
    const int k0 = p0 * kChunk, items = ROWS * pn * kChunk / 4;
    float4 v[kStaged];
#pragma unroll
    for (int t = 0; t < kStaged; ++t) {
      const int i = threadIdx.x + t * kThreads, r = i % ROWS;
      const float* src = x + (size_t)r * K + k0 + 4 * (i / ROWS);
      v[t] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (i < items && r < bp)
        v[t] = xvec ? __ldg(reinterpret_cast<const float4*>(src))
                    : make_float4(src[0], src[1], src[2], src[3]);
    }
#pragma unroll
    for (int t = 0; t < kStaged; ++t) {
      const int i = threadIdx.x + t * kThreads;
      if (i < items) {
        float* d = xs + 4 * (i / ROWS) * ROWS + i % ROWS;
        d[0] = v[t].x;
        d[ROWS] = v[t].y;
        d[2 * ROWS] = v[t].z;
        d[3 * ROWS] = v[t].w;
      }
    }
    __syncthreads();
    load_word(nxt, p0 + kSlices + slice);
    // 3. each code decoded once per (k, column), applied to every row,
    // kUnroll codes a loop step
    if (slice < pn) {
      const int half = (p0 + slice) % (G / kChunk);  // binary: which half
      uint32_t w[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) w[e] = cw[e] >> (half * kChunk * B);
      const float* xk = xs + slice * kChunk * ROWS;
#pragma unroll 1
      for (int j0 = 0; j0 < kChunk; j0 += kUnroll) {
#pragma unroll
        for (int j = 0; j < kUnroll; ++j) {
          float xv[ROWS];
          load_rows<ROWS>(xk + j * ROWS, xv);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            uint32_t keep, flip;
            packed_codes::decode<MODE>(w[e], j, keep, flip);
#pragma unroll
            for (int r = 0; r < ROWS; ++r)
              acc[r][e] += packed_codes::apply(xv[r], keep, flip);
          }
        }
        xk += kUnroll * ROWS;
#pragma unroll
        for (int e = 0; e < 4; ++e) w[e] >>= kUnroll * B;
      }
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) cw[e] = nxt[e];
  }

  // 4. the slices' partials summed in the block, in a fixed order: the
  // warp's 4 slices by shuffles, then the warps in order (float4 output
  // i = row * kQuads + quad of this tile); 5. the K split: block i / per of
  // the cluster owns output i and gets each block's sum in its slot
  // (distributed shared memory); after one cluster barrier each owner sums
  // its slots in rank order and stores
  const int warp = threadIdx.x / 32;
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    float4 v = make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
#pragma unroll
    for (int m = kQuads; m < 32; m *= 2) v = shfl_add4(v, m);
    if (r < bp && (threadIdx.x & 31) < kQuads) red[warp][r * kQuads + q] = v;
  }
  __syncthreads();
  cg::cluster_group cluster = cg::this_cluster();
  const int outs = bp * kQuads, per = (outs + cs - 1) / cs;
  const int col = blockIdx.y * kCols;
  if (cs > 1) asm volatile("barrier.cluster.wait.aligned;\n" ::);
  for (int i = threadIdx.x; i < outs; i += kThreads) {
    float4 s = red[0][i];
#pragma unroll
    for (int wp = 1; wp < kThreads / 32; ++wp) s = add4(s, red[wp][i]);
    if (cs == 1) {
      store4(out, i / kQuads, col + 4 * (i % kQuads), s, N);
    } else {
      const int owner = i / per;
      cluster.map_shared_rank(inbox, owner)[rank * per + i - owner * per] = s;
    }
  }
  if (cs == 1) return;
  cluster.sync();  // every push has landed
  for (int i = threadIdx.x; i < per && rank * per + i < outs; i += kThreads) {
    float4 s = inbox[i];
#pragma unroll
    for (int r = 1; r < kMaxCluster; ++r)
      if (r < cs) s = add4(s, inbox[r * per + i]);
    const int o = rank * per + i;
    store4(out, o / kQuads, col + 4 * (o % kQuads), s, N);
  }
}

template <int MODE, int ROWS, bool VEC>
cudaError_t launch(const float* x, const uint32_t* codes, float* out, int M,
                   int K, int N, int cluster, int tiles, cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster, tiles, (M + ROWS - 1) / ROWS);
  cfg.blockDim = dim3(kThreads);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = cluster > 1 ? 1 : 0;
  return cudaLaunchKernelEx(&cfg, packed_gemv_kernel<MODE, ROWS, VEC>, x,
                            codes, out, M, K, N);
}

// The geometry's checks, shared by both entry points: the K split of
// gemv_plan (1 .. 8 blocks, at most K/G), the column tiles covering N, and
// 16-byte code loads only where N % 4 == 0 and the codes are aligned.
inline bool valid_geometry(const void* codes, int K, int N, int mode,
                           int cluster, int tiles, int vec) {
  const int G = mode == 0 ? 16 : 32;
  if (K < 1 || N < 1 || K % G || cluster < 1 || cluster > kMaxCluster ||
      cluster > K / G || (long long)tiles * kCols < N ||
      (tiles - 1) * kCols >= N)
    return false;
  return !(vec && ((N & 3) || (reinterpret_cast<uintptr_t>(codes) & 15)));
}

}  // namespace packed_gemv
