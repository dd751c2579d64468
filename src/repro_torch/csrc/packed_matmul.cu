// Prefill GEMM against 2-bit (ternary) / 1-bit (binary) packed weights, for
// sm_90a, on Hopper's tensor cores: wgmma on bf16 tiles that TMA brings in.
//
// Replaces: src/repro/kernels/packed_matmul.py:packed_matmul (_matmul_kernel:
//           codes decoded to bf16 in VMEM, then a dot into an fp32
//           accumulator over a K grid).
// Computes: out (M, N) = x (M, K) . unpack(codes (K/G, N)) in fp32, G = 16
//           (ternary) or 32 (binary), for the sequence route (kernels/ops.py):
//           every projection of a prompt chunk, at any M, 1 included.  K is a
//           multiple of G; callers zero-pad x past the true K, so pad codes
//           (binary: a zero word decodes to -1) add nothing.  M, N and K may
//           be ragged.
// The exact product: x = hi + mid + lo, three bf16 terms rounded to nearest
//           in turn (8 + 8 + 8 significand bits and the signs cover fp32's 24
//           for every normal x); the weights -1/0/+1 are exact in bf16, so
//           every product is exact, and wgmma accumulates hi, then mid, then
//           lo of each k16 step into one fp32 accumulator.  The tensor cores'
//           adds do not round as IEEE round-to-nearest does: the sum is held
//           to the fp64 product within 1e-5 of |x| @ |w| (chip_smoke.py).
// Bound on this card: the three products, 3 * 2 * M * K * N flops at the
//           989 TFLOP/s of the bf16 tensor cores, above a few rows; below,
//           the codes' bytes (1/16 or 1/32 of the fp32 weight) at 3.35 TB/s
//           (chip_smoke.py: gemm_bound).  A wgmma always computes 64 rows, so
//           at M << 64 the tensor cores spend a whole tile's time on a few
//           rows; the bound counts only the real ones.  What holds the
//           kernel back from it is not the tensor cores: the decode and
//           the split take issue slots on every k-tile, x (fp32) is read
//           from the L2 once for every 128 columns, and at small M a
//           block's chain of k-tiles and its prologue are latency.
// Batch invariance, and why the route is chosen by role: a request's
//           stream must not depend on how its prompt was chunked or what
//           shared its batch.  Here a row's sum depends on (K, N, mode)
//           alone: the instruction shape (m64n128k16), the tile (bk 64, bn
//           128), the k-tiles' order, the three terms' order and the K split
//           over a cluster are fixed by kernels/packed_matmul.py:matmul_plan,
//           which takes no M; only the number of 64-row tiles (gridDim.z)
//           follows M, rows past M are zero-filled and never stored, and the
//           tensor cores compute an output row from its own row of x alone.
//           No tensor-core product can sum in the GEMV's order, so the two
//           routes give a row different bits; JAX routes by row count (M <= 8
//           to the GEMV), which would send a prompt's last short chunk to the
//           GEMV and the same rows of the whole prompt here.  The port routes
//           each product by its role instead (sequence products here at every
//           M, step products to the GEMV at every M), so a row never changes
//           route between a stream and its one-request reference.
// Design:   a block owns a 64 x 128 output tile and is two warpgroups;
//           two blocks fit an SM (118-121 registers a thread, 105 KB of
//           shared memory a block).  The consumer warpgroup (warps 0-3)
//           splits x and issues wgmma m64n128k16; the producer warpgroup
//           (warps 4-7) decodes the codes.  A ring of 4 stages holds x
//           tiles (64 rows x 64 k fp32, two TMA boxes of 128 bytes a row,
//           128-byte swizzled) and code tiles (64/G rows x 128 words),
//           filled by TMA 3 tiles ahead (one consumer thread issues a stage
//           once the consumers have split it; an mbarrier a stage counts the
//           bytes).  The codes move, not the decoded tile: 16x (32x) fewer
//           bytes.  Each producer thread decodes one column's words into a B
//           tile in shared memory, K-major and 128-byte swizzled as wgmma
//           reads it (packed_codes::bf16_fragment: a byte permute a pair of
//           outputs, ternary; xors of the sign, binary), into one of two B
//           buffers, a tile ahead of the tensor cores (a full and an empty
//           mbarrier a buffer).  A comes from registers: a consumer thread
//           loads its fragment of one k16 step of x and splits it in place
//           while the tensor cores run the step before (two register sets
//           of 12; the swizzle keeps the loads free of bank conflicts).
//           Against the alternatives timed on the card: one warpgroup
//           doing both (no producer) is a little faster on the largest
//           shapes and slower on all others; a 64 x 256 tile a block, one
//           block an SM, and a producer that also writes x's three planes
//           for an all-shared-memory wgmma were slower everywhere: the
//           decode and the split, not the tensor cores, bound this kernel.  Where N % 4 != 0 (or the codes are not
//           16-byte aligned) TMA cannot describe the codes, and the wrapper
//           picks the cp.async variant of the same kernel (each producer
//           thread copies its column's words, 4 bytes at a time, zero past
//           N and K/G); x always goes by TMA (K % 16 == 0).
//           Where one 64-row tile of blocks would leave the card short
//           (matmul_plan, from N and K), a thread block cluster of up to 8
//           blocks splits the k-tiles; each block pushes its partial tile,
//           a slice of rows to each block of the cluster, into that block's
//           shared memory (distributed shared memory); after a cluster
//           barrier each block sums its rows in rank order and stores them.
//           No atomics: two launches give the same bits.  The kernel
//           allocates nothing and launches on the caller's stream.
#include <cooperative_groups.h>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "packed_codes.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int BM = 64;           // rows a block owns: one wgmma m64 tile
constexpr int BN = 128;          // columns a block owns: wgmma n128
constexpr int BK = 64;           // k a stage holds: 128 bytes of bf16 a column
constexpr int kThreads = 256;    // the consumer and the producer warpgroup
constexpr int kStages = 4;       // x and code stages
constexpr int kMaxCluster = 8;
constexpr int kXBox = 32;                      // fp32 k of a TMA box of x
constexpr int kXStage = BM * BK * 4;           // bytes of an x stage
constexpr int kBTile = BN * BK * 2;            // bytes of a decoded B tile
constexpr int kCodeStage = (BK / 16) * BN * 4;  // bytes of a code stage
// the barriers: a full barrier a stage (TMA bytes), a full and an empty
// barrier a B buffer
constexpr int kBars = kStages + 4;
constexpr int kSmem = 1024 + kStages * kXStage + 2 * kBTile +
                      kStages * kCodeStage + kBars * 8;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// A 2-D box of `map` at (c0 innermost, c1) into shared memory at `dst`; its
// bytes complete a transaction on `bar`.  Out-of-bounds elements are zeros.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         int c0, int c1, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}

// 4 bytes global -> shared; src-size 0 writes zeros and reads nothing.
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
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

// The wgmma descriptor of a K-major, 128-byte swizzled bf16 operand at
// shared address `addr` (a 1024-byte aligned tile, or 32 bytes a k16 step
// past one): 8-row groups 1024 bytes apart (SBO), the leading offset unused
// by the swizzled K-major layout (1), layout type 1 (128-byte swizzle).
__device__ __forceinline__ uint64_t b_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) |
         (static_cast<uint64_t>(1) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// The consumer warpgroup's own barrier (barrier 0 is __syncthreads).
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, 128;\n" ::: "memory");
}

// d (64 x 128 over the warpgroup) += a (64 x 16 bf16, registers) . b (16 x
// 128 bf16, K-major in shared memory): m64n128k16, fp32 accumulate.
__device__ __forceinline__ void wgmma(float (&d)[64], const uint32_t (&a)[4],
                                      uint64_t desc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
      "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "
      "%57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

// One 64 x 128 output tile a block: gridDim.x the cluster (the K split),
// gridDim.y the column tiles, gridDim.z the 64-row tiles of x.  TMA_CODES:
// the codes come by TMA, else by cp.async.  Nothing a row adds, nor the
// order it adds in, depends on M or on the row tile.
template <int MODE, bool TMA_CODES>
__global__ void __launch_bounds__(kThreads, 2)
packed_matmul_kernel(const __grid_constant__ CUtensorMap x_map,
                     const __grid_constant__ CUtensorMap code_map,
                     const uint32_t* __restrict__ codes,
                     float* __restrict__ out, int M, int K, int N) {
  constexpr int G = MODE == 0 ? 16 : 32;
  constexpr int KW = BK / G;  // code rows a stage: 4 ternary, 2 binary
  constexpr uint32_t kCodeBytes = KW * BN * 4;
  extern __shared__ uint8_t smem_raw[];
  // the swizzled tiles need 1024-byte aligned shared addresses
  uint8_t* base = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  uint8_t* xs = base;                          // kStages x tiles
  uint8_t* bs = xs + kStages * kXStage;        // 2 decoded B tiles
  uint32_t* cw = reinterpret_cast<uint32_t*>(bs + 2 * kBTile);
  uint64_t* bars = reinterpret_cast<uint64_t*>(
      reinterpret_cast<uint8_t*>(cw) + kStages * kCodeStage);
  // bars[s]: stage s landed; bars[kStages + b]: B buffer b decoded;
  // bars[kStages + 2 + b]: B buffer b read by the tensor cores
  auto full = [&](int s) { return smem_addr(&bars[s]); };
  auto b_full = [&](int b) { return smem_addr(&bars[kStages + b]); };
  auto b_empty = [&](int b) { return smem_addr(&bars[kStages + 2 + b]); };

  const int tid = threadIdx.x;
  const int cs = gridDim.x, rank = blockIdx.x;
  const int n0 = blockIdx.y * BN, m0 = blockIdx.z * BM;
  const int KT = (K + BK - 1) / BK;
  const int kb = (int)((long long)rank * KT / cs);
  const int nk = (int)((long long)(rank + 1) * KT / cs) - kb;

  if (tid == 0) {
    // fetch the TMA descriptors while the barriers are set up
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                     reinterpret_cast<uint64_t>(&x_map))
                 : "memory");
    if (TMA_CODES)
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                       reinterpret_cast<uint64_t>(&code_map))
                   : "memory");
    for (int s = 0; s < kStages; ++s) mbar_init(full(s), 1);
    for (int b = 0; b < 2; ++b) {
      mbar_init(b_full(b), 128);   // every producer thread
      mbar_init(b_empty(b), 1);    // one consumer thread
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // Tile i of this block's k range into stage i % kStages: x (and the
  // codes) by TMA, from consumer thread 0.
  auto issue = [&](int i) {
    const int s = i % kStages, kt = kb + i;
    mbar_expect_tx(full(s), kXStage + (TMA_CODES ? kCodeBytes : 0));
    const uint32_t xd = smem_addr(xs + s * kXStage);
    tma_load(xd, &x_map, kt * BK, m0, full(s));
    tma_load(xd + kXStage / 2, &x_map, kt * BK + kXBox, m0, full(s));
    if (TMA_CODES)
      tma_load(smem_addr(cw + s * (kCodeStage / 4)), &code_map, n0, kt * KW,
               full(s));
  };

  float acc[64];
#pragma unroll
  for (int j = 0; j < 64; ++j) acc[j] = 0.f;

  if (tid >= 128) {
    // ---- the producer warpgroup: decode the codes, a tile ahead ---------
    const int p = tid - 128;  // column p of the tile
    // cp.async variant: each thread copies its column's words, one group a
    // tile (empty past the range), kStages tiles ahead
    auto copy = [&](int i) {
      if (!TMA_CODES) {
        const int s = i % kStages, kt = kb + i, n = n0 + p;
        for (int w = 0; w < KW && i < nk; ++w) {
          const int row = kt * KW + w;
          const bool ok = n < N && row < K / G;
          cp_async4(cw + s * (kCodeStage / 4) + w * BN + p,
                    ok ? codes + (size_t)row * N + n : codes, ok);
        }
        cp_async_commit();
      }
    };
    for (int i = 0; i < kStages; ++i) copy(i);
    for (int i = 0; i < nk; ++i) {
      const int s = i % kStages, b = i & 1;
      if (TMA_CODES)
        mbar_wait(full(s), (i / kStages) & 1);
      else
        cp_async_wait<kStages - 1>();
      if (i >= 2) mbar_wait(b_empty(b), ((i >> 1) - 1) & 1);
      // column p's words into row p of the B tile (128 bytes), 16-byte
      // chunk c at c ^ (p % 8)
      const uint32_t* src = cw + s * (kCodeStage / 4);
      uint8_t* row = bs + b * kBTile + p * (BK * 2);
      const int sw = p & 7;
#pragma unroll
      for (int w = 0; w < KW; ++w) {
        const uint32_t word = src[w * BN + p];
#pragma unroll
        for (int h = 0; h < G / 16; ++h) {
          uint32_t lo[4], hi[4];
#pragma unroll
          for (int q = 0; q < 4; ++q)
            packed_codes::bf16_fragment<MODE>(word, 16 * h + 2 * q, lo[q],
                                              hi[q]);
          const int ch = (w * G + 16 * h) / 8;  // codes 16h .. 16h + 7
          *reinterpret_cast<uint4*>(row + ((ch ^ sw) << 4)) =
              make_uint4(lo[0], lo[1], lo[2], lo[3]);
          *reinterpret_cast<uint4*>(row + (((ch + 1) ^ sw) << 4)) =
              make_uint4(hi[0], hi[1], hi[2], hi[3]);
        }
      }
      // the generic stores, before wgmma (the async proxy) reads them
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      mbar_arrive(b_full(b));
      copy(i + kStages);  // this thread's words of stage s are decoded
    }
  } else {
    // ---- the consumer warpgroup: split x, issue wgmma --------------------
    // Thread (warp, gid, tig) holds A rows r0 and r0 + 8, k 2 tig (+1) and
    // 2 tig + 8 (+1) of each k16 step (register q: row + 8 (q & 1), k + 8
    // (q >> 1)).
    const int warp = tid >> 5, lane = tid & 31;
    const int gid = lane >> 2, tig = lane & 3;
    const int r0 = 16 * warp + gid;
    // tile i's k16 step t of x, split into its three bf16 terms:
    // a[term][register]
    auto split = [&](int i, int t, uint32_t (&a)[3][4]) {
      const uint8_t* xt = xs + (i % kStages) * kXStage;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int r = r0 + 8 * (q & 1);
        const int k = 16 * t + 2 * tig + 8 * (q >> 1);
        const int col = k & (kXBox - 1);  // (r & 7) == gid: the swizzle
        const float2 v = *reinterpret_cast<const float2*>(
            xt + (k / kXBox) * (kXStage / 2) + r * 128 +
            (((col >> 2) ^ gid) << 4) + (col & 3) * 4);
        split3(v, a[0][q], a[1][q], a[2][q]);
      }
    };
    // k16 step t of tile i: its three wgmma from `cur` go out; then, once
    // the step before is done, the next step is split into `nxt` while
    // this one runs.
    auto step = [&](int i, int t, uint32_t (&cur)[3][4],
                    uint32_t (&nxt)[3][4]) {
      wgmma_fence();
      const uint64_t desc =
          b_desc(smem_addr(bs + (i & 1) * kBTile) + 32 * t);
#pragma unroll
      for (int term = 0; term < 3; ++term) wgmma(acc, cur[term], desc);
      wgmma_commit();
      wgmma_wait<1>();  // the step before is done, its registers free
      if (t == 0 && i > 0 && tid == 0) mbar_arrive(b_empty((i - 1) & 1));
      if (t < 3) {
        split(i, t + 1, nxt);
      } else {
        // every consumer has split tile i: its stage takes tile i + kStages
        consumer_sync();
        if (tid == 0 && i + kStages < nk) issue(i + kStages);
        if (i + 1 < nk) {
          mbar_wait(full((i + 1) % kStages), ((i + 1) / kStages) & 1);
          split(i + 1, 0, nxt);
        }
      }
    };

    if (tid == 0)
      for (int i = 0; i < kStages && i < nk; ++i) issue(i);
    uint32_t a0[3][4], a1[3][4];
    mbar_wait(full(0), 0);
    split(0, 0, a0);
    for (int i = 0; i < nk; ++i) {
      mbar_wait(b_full(i & 1), (i >> 1) & 1);
      step(i, 0, a0, a1);
      step(i, 1, a1, a0);
      step(i, 2, a0, a1);
      step(i, 3, a1, a0);
    }
    wgmma_wait<0>();
#pragma unroll
    for (int j = 0; j < 64; ++j) asm volatile("" : "+f"(acc[j])::"memory");
  }

  // acc[4 j + 2 h + e] of a consumer thread: row r0 + 8 h, column 8 j +
  // 2 tig + e
  const int lane = tid & 31;
  const int r0 = 16 * (tid >> 5) + (lane >> 2), c0 = 2 * (lane & 3);
  const bool pairs = (N & 1) == 0;
  if (cs == 1) {
    if (tid >= 128) return;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = m0 + r0 + 8 * h;
      if (row >= M) continue;
      float* o = out + (size_t)row * N;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int col = n0 + 8 * j + c0;
        if (pairs && col < N) {
          *reinterpret_cast<float2*>(o + col) =
              make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
        } else {
          if (col < N) o[col] = acc[4 * j + 2 * h];
          if (col + 1 < N) o[col + 1] = acc[4 * j + 2 * h + 1];
        }
      }
    }
    return;
  }

  // The K split: block r of the cluster owns rows [r * per, (r + 1) * per)
  // of the tile and gets each block's partial rows in its slot (the stage
  // ring, free once every block of the cluster is past its loop); after a
  // cluster barrier each owner sums its slots in rank order and stores.
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  float* inbox = reinterpret_cast<float*>(xs);  // [cs][per][BN]
  const int per = BM / cs;
  if (tid < 128) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r0 + 8 * h, owner = r / per;
      float* dst = cluster.map_shared_rank(inbox, owner) +
                   (size_t)(rank * per + r - owner * per) * BN + c0;
#pragma unroll
      for (int j = 0; j < 16; ++j)
        *reinterpret_cast<float2*>(dst + 8 * j) =
            make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
    }
  }
  cluster.sync();
  for (int e = tid; e < per * BN; e += kThreads) {
    const int r = e / BN, c = e % BN;
    float sum = inbox[e];
    for (int q = 1; q < cs; ++q) sum += inbox[q * per * BN + e];
    const int row = m0 + rank * per + r, col = n0 + c;
    if (row < M && col < N) out[(size_t)row * N + col] = sum;
  }
}

// A row-major fp32 / int32 matrix (outer, inner) as a TMA map of boxes
// (box_outer, box_inner), zeros out of bounds.
bool tensor_map(CUtensorMap* map, CUtensorMapDataType type, const void* ptr,
                int inner, int outer, int box_inner, int box_outer,
                CUtensorMapSwizzle swizzle) {
  const cuuint64_t dims[2] = {(cuuint64_t)inner, (cuuint64_t)outer};
  const cuuint64_t strides[1] = {(cuuint64_t)inner * 4};
  const cuuint32_t box[2] = {(cuuint32_t)box_inner, (cuuint32_t)box_outer};
  const cuuint32_t elem[2] = {1, 1};
  return cuTensorMapEncodeTiled(
             map, type, 2, const_cast<void*>(ptr), dims, strides, box, elem,
             CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int MODE, bool TMA_CODES>
cudaError_t launch(const CUtensorMap& x_map, const CUtensorMap& code_map,
                   const uint32_t* codes, float* out, int M, int K, int N,
                   int cluster, cudaStream_t stream) {
  auto kernel = packed_matmul_kernel<MODE, TMA_CODES>;
  // the shared memory past 48 KB, set on the current device
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster, (N + BN - 1) / BN, (M + BM - 1) / BM);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = kSmem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = cluster > 1 ? 1 : 0;
  return cudaLaunchKernelEx(&cfg, kernel, x_map, code_map, codes, out, M, K,
                            N);
}

}  // namespace

// mode: 0 ternary, 1 binary; cluster (1, 2, 4 or 8, at most the k-tiles)
// from matmul_plan (K and N only); tma 1 for the codes by TMA (N % 4 == 0
// and 16-byte aligned codes), 0 for the cp.async variant.  x must be
// 16-byte aligned.  Returns the cudaError_t of the launch.
extern "C" int packed_matmul_launch(const void* x, const void* codes,
                                    void* out, int M, int K, int N, int mode,
                                    int cluster, int tma, void* stream) {
  const int G = mode == 0 ? 16 : 32;
  const int KT = (K + BK - 1) / BK;
  if (M < 1 || N < 1 || K < 1 || K % G || (M + BM - 1) / BM > 65535 ||
      (cluster != 1 && cluster != 2 && cluster != 4 && cluster != kMaxCluster) ||
      cluster > KT || (reinterpret_cast<uintptr_t>(x) & 15) ||
      (tma && ((N & 3) || (reinterpret_cast<uintptr_t>(codes) & 15))))
    return (int)cudaErrorInvalidValue;
  CUtensorMap x_map, code_map;
  if (!tensor_map(&x_map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, x, K, M, kXBox, BM,
                  CU_TENSOR_MAP_SWIZZLE_128B))
    return (int)cudaErrorInvalidValue;
  if (tma) {
    if (!tensor_map(&code_map, CU_TENSOR_MAP_DATA_TYPE_INT32, codes, N, K / G,
                    BN, BK / G, CU_TENSOR_MAP_SWIZZLE_NONE))
      return (int)cudaErrorInvalidValue;
  } else {
    code_map = x_map;  // unused
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint32_t* cw = static_cast<const uint32_t*>(codes);
  float* of = static_cast<float*>(out);
  cudaError_t err;
  if (mode == 0)
    err = tma ? launch<0, true>(x_map, code_map, cw, of, M, K, N, cluster, s)
              : launch<0, false>(x_map, code_map, cw, of, M, K, N, cluster, s);
  else
    err = tma ? launch<1, true>(x_map, code_map, cw, of, M, K, N, cluster, s)
              : launch<1, false>(x_map, code_map, cw, of, M, K, N, cluster, s);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
