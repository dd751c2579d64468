// One whole BN-LSTM / BN-GRU decode tick in one launch, for sm_90a.
//
// Replaces: src/repro/kernels/decode_step.py:fused_tick (_tick_kernel),
//           called through src/repro/kernels/ops.py:fused_decode_tick.
// Computes, for each layer l: the multiply-free h-side GEMV per gate
//           against gate-aligned packed codes, the frozen-BN affine (alpha
//           folded into the scale), the LSTM or GRU gate math with the
//           cell-norm affine, and the `live` row select (dead rows keep h/c
//           bit for bit); for l >= 1 the x-side GEMV of layer l-1's new h.
//           Then the fp head and a greedy argmax (ties to the minimum
//           index; a row holding a NaN gets vp, as jnp's max/== pair gives).
//           The head runs in the launch at every vp: it streams ws from
//           global memory, so the TPU kernel's 4 MiB VMEM budget for it has
//           no counterpart here.  Operands arrive padded: bp a multiple of 4
//           (of the row pass), hp and vp multiples of 8 (the wrapper pads
//           them to 128).
// Bound on this card: count the unpadded function at rnn-paper decode
//           (B = 4, H = 1000, V = 50, g = 4): it reads 1.01 MB of h-side
//           codes (ceil(H/16) words per column), the 0.2 MB head, and
//           0.14 MB of input preacts, state and affines, and writes 0.03 MB:
//           1.38 MB, 0.41 us at 3.35 TB/s.  Its adds are one per row and
//           nonzero weight: at most B * 4.0 M = 16 M, 0.48 us at 33.5 T/s,
//           about half that with the zeros of a ternary weight, so bytes
//           bound it, barely.  At word-PTB medium (H = 650, V = 10,000)
//           the head's 26 MB of ws sets the bound: 8.0 us at B = 4 and 8.2
//           us at B = 16 (chip_smoke.tick_bound).  What it waits on besides: the grid-wide
//           barrier (about 1 us across 128 blocks) and chains of L2
//           round trips (staging, the head's partials, the argmax).
// Design:   the TPU kernel is one program holding h and c in VMEM; a layer
//           needs all of the previous layer's h, and the argmax needs every
//           head column.  Here that is one COOPERATIVE launch
//           (cudaLaunchCooperativeKernel) whose grid is no larger than the
//           co-resident block count, with cg::this_grid().sync() between
//           layers and once after the top layer: L barriers a tick.  The
//           co-resident count and the shared-memory attribute are worked
//           out once per (device, shared-memory size) and cached, so a tick
//           costs the host one launch call.
//           GEMV: each block owns slices of 8 columns (all g gates); its 256
//           threads are 8 columns x 32 interleaved k-slices of code words.
//           A row pass covers R = 4 or 8 batch rows (the wrapper picks R
//           from the padded batch, so B = 4 does no padding work).  A
//           pass's activations are staged k-major, [k][R] with 16 bytes of
//           skew every 16 k, by 4-byte cp.async, so one 128-bit shared load
//           (a broadcast to the 8 lanes of a k-slice, conflict-free across
//           the 4 k-slices of a warp) serves 4 rows; the gate math's
//           operands (input preacts, affines, h, c, live) come with them.
//           Each thread issues its code-word loads, two words per gate,
//           once per slice and before the staging is waited for, so they
//           overlap the copy.  Every word is decoded once (a keep mask and
//           a sign bit a code, packed_codes.cuh) and applied to the R rows
//           from registers: one LOP3 and one FADD an add, no float
//           multiply.  Partial sums reduce by warp shuffles,
//           then across warps through shared memory.
//           Head, in one of two ways (the wrapper picks, by width):
//           - early, for a narrow head (rnn-paper's Vp 128): a block that
//             has just written the top layer's h for its 8 columns
//             multiplies them at once with the 8 matching rows of ws: a
//             partial product over its k-slice for every row and head
//             column, written in whole sectors, without waiting for the
//             other blocks.  After the single barrier the blocks share the
//             units of 8 head columns of a row: each sums a unit's nsl
//             partials (contiguous in memory) in a fixed order and adds
//             the bias.  The partials take bp/8 times the bytes of ws, so
//             only a narrow head takes this way;
//           - late, for a wide head (word-PTB's Vp 10,112): after the
//             barrier, 128-column units spread over the blocks; a row pass
//             stages R rows of the top layer's h k-major, and each lane
//             streams 4 columns of ws with 16-byte loads, kHeadAhead in
//             flight, so ws is read once a row pass.
//           Either leaves each 8-column unit's (max, min index, NaN)
//           partial.  The last block to arrive (an integer atomic ticket
//           after a __threadfence) reduces those into the greedy ids.  No
//           float atomics: two launches on the same inputs give the same
//           bits.
//           Measured (NVIDIA H100 80GB HBM3, 700 W power limit;
//           time_kernels.py): 11.1 us of device time at B = 4 and 23.2 us at
//           B = 16 (two passes of 8 rows), against 21.0 us and 35.8 us for
//           the first design, which staged [row][k] (a shared load per
//           add), padded B to 8, took three barriers and ran the head on
//           vp/8 blocks; at word-PTB medium (Hp 768, Vp 10,112) 26.3 and
//           65.7 us against 184.2 and 233.5 us.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <mutex>
#include <vector>

#include "packed_codes.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kCols = 8;       // columns a block slice owns
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSlices = kThreads / kCols;  // 32 k-slices per column
constexpr int kMaxGates = 4;
constexpr int kAhead = 2;      // code words per gate loaded before the adds

struct TickParams {
  const float* ax0;         // (bp, g, hp) layer-0 input preact, bias folded
  const float* h;           // (L, bp, hp)
  const float* c;           // (L, bp, hp)
  const float* live;        // (bp, hp) 0/1
  const uint32_t* codes_h;  // (L, g, hp/G, hp)
  const uint32_t* codes_x;  // (max(L-1, 1), g, hp/G, hp)
  const float* scale_h;     // (L, g, hp)
  const float* shift_h;
  const float* scale_x;     // (max(L-1, 1), g, hp)
  const float* shift_x;
  const float* scale_c;     // (L, 1, hp)
  const float* shift_c;
  const float* ws;          // (hp, vp)
  const float* bs;          // (1, vp)
  float* h_out;             // (L, bp, hp)
  float* c_out;             // (L, bp, hp)
  float* logits;            // (bp, vp)
  int* greedy;              // (bp,)
  float* head_part;         // (vp / 8, bp, hp / kCols, 8) slice partials
  float* part_val;          // (bp, vp / 8) maxima of 8-column units
  int* part_idx;            // (bp, vp / 8) their minimum column
  int* part_nan;            // (bp, vp / 8) 1 where the unit held a NaN
  unsigned* ticket;         // (1,) blocks done with their head units
  int L, bp, hp, vp;
  int late_head;            // 1: the head runs after the barrier (late_head)
};

// Staged activations are k-major, R rows a k, 4 floats of skew every 16 k.
template <int R>
__device__ __forceinline__ int kidx(int k) {
  return k * R + (k >> 4) * 4;
}

template <int R>
__host__ __device__ __forceinline__ int stage_floats(int hp) {
  return hp * R + (hp >> 4) * 4;
}

__device__ __forceinline__ float sigmoidf(float x) {
  return 1.f / (1.f + expf(-x));
}

__device__ __forceinline__ void cp_async4(float* smem, const float* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Start copying rows [0, R) of a (R, hp) row-major matrix into the k-major
// stage (cp.async; stage_pass commits the group).
template <int R>
__device__ __forceinline__ void stage_rows(float* dst, const float* src,
                                           int hp) {
#pragma unroll
  for (int b = 0; b < R; ++b)
    for (int k = threadIdx.x; k < hp; k += kThreads)
      cp_async4(dst + kidx<R>(k) + b, src + (size_t)b * hp + k);
}

// Words w0 + a * kSlices (a < kAhead) of column n for NG gates: codes
// (NG, KW, hp) words; 0 past KW.
template <int NG>
__device__ __forceinline__ void load_words(const uint32_t* codes, int KW,
                                           int hp, int n, int w0,
                                           uint32_t (&wd)[kAhead][kMaxGates]) {
#pragma unroll
  for (int a = 0; a < kAhead; ++a) {
    const int w = w0 + a * kSlices;
#pragma unroll
    for (int i = 0; i < NG; ++i)
      wd[a][i] = w < KW ? __ldg(codes + ((size_t)i * KW + w) * hp + n) : 0u;
  }
}

// Partial multiply-free GEMV of k-slice ks for column n of NG gates against
// R staged rows.  `first` holds the slice's first words (load_words at
// w0 = ks), loaded once for every row pass; later words load ahead of their
// adds.
template <int MODE, int NG, int R>
__device__ __forceinline__ void gemv_part(
    const float* xs, const uint32_t* codes, int KW, int hp, int n, int ks,
    const uint32_t (&first)[kAhead][kMaxGates], float (&acc)[kMaxGates][R]) {
  constexpr int G = MODE == 0 ? 16 : 32;
#pragma unroll
  for (int i = 0; i < NG; ++i)
#pragma unroll
    for (int b = 0; b < R; ++b) acc[i][b] = 0.f;
  uint32_t wd[kAhead][kMaxGates];
  for (int w0 = ks; w0 < KW; w0 += kAhead * kSlices) {
    if (w0 == ks) {
#pragma unroll
      for (int a = 0; a < kAhead; ++a)
#pragma unroll
        for (int i = 0; i < NG; ++i) wd[a][i] = first[a][i];
    } else {
      load_words<NG>(codes, KW, hp, n, w0, wd);
    }
#pragma unroll
    for (int a = 0; a < kAhead; ++a) {
      const int w = w0 + a * kSlices;
      if (w >= KW) break;
#pragma unroll
      for (int j = 0; j < G; ++j) {
        const float4* xv =
            reinterpret_cast<const float4*>(xs + kidx<R>(w * G + j));
        float x[R];
#pragma unroll
        for (int q = 0; q < R / 4; ++q) {
          const float4 v = xv[q];
          x[4 * q] = v.x;
          x[4 * q + 1] = v.y;
          x[4 * q + 2] = v.z;
          x[4 * q + 3] = v.w;
        }
#pragma unroll
        for (int i = 0; i < NG; ++i) {
          uint32_t keep, flip;
          packed_codes::decode<MODE>(wd[a][i], j, keep, flip);
#pragma unroll
          for (int b = 0; b < R; ++b)
            acc[i][b] += packed_codes::apply(x[b], keep, flip);
        }
      }
    }
  }
}

// Sum the 32 k-slices of each (gate, row, column) into out[(i*R+b)*kCols
// + col].  Ends with the block synchronised and `out` complete.
template <int NG, int R>
__device__ __forceinline__ void reduce_slices(float (&acc)[kMaxGates][R],
                                              float* red, float* out) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int i = 0; i < NG; ++i)
#pragma unroll
    for (int b = 0; b < R; ++b) {
      float v = acc[i][b];
      v += __shfl_xor_sync(0xffffffffu, v, 8);
      v += __shfl_xor_sync(0xffffffffu, v, 16);
      acc[i][b] = v;
    }
  if (lane < kCols) {
#pragma unroll
    for (int i = 0; i < NG; ++i)
#pragma unroll
      for (int b = 0; b < R; ++b)
        red[((warp * NG + i) * R + b) * kCols + lane] = acc[i][b];
  }
  __syncthreads();
  for (int o = threadIdx.x; o < NG * R * kCols; o += kThreads) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += red[w * NG * R * kCols + o];
    out[o] = s;
  }
  __syncthreads();
}

// Where slice s's head partial of row b, column v lies: (vp/8, bp, nsl, 8),
// so a slice writes whole 32-byte sectors and a unit (b, 8 columns) reads
// its nsl*8 partials contiguously.
__device__ __forceinline__ size_t head_at(int v, int b, int s, int bp,
                                          int nsl) {
  return (((size_t)(v >> 3) * bp + b) * nsl + s) * 8 + (v & 7);
}

// A row's running argmax: the largest value, its minimum column, and
// whether a NaN was seen (then the row gets vp).  `better` is commutative
// and associative, so any reduction order gives the same answer.
struct Best {
  float v;
  int i, nan;
};

__device__ __forceinline__ Best better(Best a, Best b) {
  const bool take = b.i >= 0 && (a.i < 0 || b.v > a.v ||
                                 (b.v == a.v && b.i < a.i));
  return {take ? b.v : a.v, take ? b.i : a.i, a.nan | b.nan};
}

__device__ __forceinline__ Best warp_best(Best x) {
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) {
    const Best o = {__shfl_xor_sync(0xffffffffu, x.v, m),
                    __shfl_xor_sync(0xffffffffu, x.i, m),
                    __shfl_xor_sync(0xffffffffu, x.nan, m)};
    x = better(x, o);
  }
  return x;
}

// The gate math's operands of one (row, column), staged by cp.async with
// the activations: kOps floats a thread of the gate math.
enum GateOp {
  kAx = 0,                  // NG layer-0 input preacts (l == 0)
  kScaleH = kMaxGates,      // NG h-side BN scales, then shifts
  kShiftH = 2 * kMaxGates,
  kScaleX = 3 * kMaxGates,  // NG x-side BN scales, then shifts (l > 0)
  kShiftX = 4 * kMaxGates,
  kHPrev = 5 * kMaxGates,
  kCPrev,
  kLive,
  kScaleC,
  kShiftC,
  kOps  // odd, so the R*kCols threads' operand rows spread over the banks
};

// Start copying row pass r0's operands into the stage: R rows of
// h_prev (and of the layer below's new h, l > 0), k-major, and the gate
// math's operands of its R*kCols (row, column) pairs.
template <int NG, int R>
__device__ __forceinline__ void stage_pass(const TickParams& p, int l, int s,
                                           int r0, float* hs, float* xs,
                                           float* gop) {
  const int hp = p.hp, bp = p.bp, t = threadIdx.x;
  stage_rows<R>(hs, p.h + ((size_t)l * bp + r0) * hp, hp);
  if (l > 0) stage_rows<R>(xs, p.h_out + ((size_t)(l - 1) * bp + r0) * hp, hp);
  if (t < R * kCols) {  // thread (b, cc) of the gate math
    const int row = r0 + t / kCols, nn = s * kCols + t % kCols;
    float* g = gop + t * kOps;
#pragma unroll
    for (int i = 0; i < NG; ++i) {
      const size_t a = ((size_t)l * NG + i) * hp + nn;
      cp_async4(g + kScaleH + i, p.scale_h + a);
      cp_async4(g + kShiftH + i, p.shift_h + a);
      if (l == 0) {
        cp_async4(g + kAx + i, p.ax0 + ((size_t)row * NG + i) * hp + nn);
      } else {
        const size_t ax = ((size_t)(l - 1) * NG + i) * hp + nn;
        cp_async4(g + kScaleX + i, p.scale_x + ax);
        cp_async4(g + kShiftX + i, p.shift_x + ax);
      }
    }
    const size_t st = ((size_t)l * bp + row) * hp + nn;
    cp_async4(g + kHPrev, p.h + st);
    cp_async4(g + kCPrev, p.c + st);
    cp_async4(g + kLive, p.live + (size_t)row * hp + nn);
    if (NG == 4) {
      cp_async4(g + kScaleC, p.scale_c + (size_t)l * hp + nn);
      cp_async4(g + kShiftC, p.shift_c + (size_t)l * hp + nn);
    }
  }
  cp_async_commit();
}

// The early head's second half, after the barrier: a unit is one row's 8
// head columns [8 vb, 8 vb + 8), and its logits are the sums of the
// slices' partials, read as nsl*8 contiguous floats.  A block takes
// per_block units at once where it can, in groups of 8*subs threads: 8
// columns times subs strided slice subsets, summed by a fixed shuffle tree
// (and across warps in warp order), plus the bias.  The unit's best column
// is its argmax partial.
__device__ __forceinline__ void sum_head_partials(const TickParams& p,
                                                  float* red) {
  const int bp = p.bp, vp = p.vp, nsl = p.hp / kCols;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int vbn = vp / 8, units = bp * vbn;
  const int per_block = (units + gridDim.x - 1) / gridDim.x;
  int subs = 32;
  while (subs > 1 && per_block * 8 * subs > kThreads) subs >>= 1;
  const int gsz = 8 * subs, gpr = kThreads / gsz;
  const int grp = t / gsz, r = t % gsz, vi = r & 7, sub = r >> 3;
  const int ub = min(units, (int)blockIdx.x * per_block);
  const int ue = min(units, ub + per_block);
  for (int u0 = ub; u0 < ue; u0 += gpr) {
    const int u = u0 + grp;
    const bool ok = u < ue;
    const int b = ok ? u / vbn : 0, v = ok ? (u % vbn) * 8 + vi : 0;
    float a = 0.f, bias = 0.f;
    if (ok) {
      if (sub == 0) bias = p.bs[v];
      const float* src = p.head_part + head_at(v, b, 0, bp, nsl);
#pragma unroll 4
      for (int s = sub; s < nsl; s += subs) a += __ldcg(src + (size_t)s * 8);
    }
    for (int m = 8; m < gsz && m < 32; m <<= 1)
      a += __shfl_xor_sync(0xffffffffu, a, m);
    if (gsz > 32) {  // the group's warps, in order
      if (lane < 8) red[warp * 8 + lane] = a;
      __syncthreads();
      if (r < 8) {
        a = 0.f;
        for (int w = 0; w < gsz / 32; ++w)
          a += red[(grp * gsz / 32 + w) * 8 + r];
      }
    }
    Best x = {-INFINITY, -1, 0};
    if (ok && r < 8) {
      const float y = a + bias;
      p.logits[(size_t)b * vp + v] = y;
      x = y != y ? Best{-INFINITY, -1, 1} : Best{y, v, 0};
    }
#pragma unroll
    for (int m = 4; m > 0; m >>= 1) {  // the 8 lanes r < 8 of each group
      const Best o = {__shfl_xor_sync(0xffffffffu, x.v, m),
                      __shfl_xor_sync(0xffffffffu, x.i, m),
                      __shfl_xor_sync(0xffffffffu, x.nan, m)};
      x = better(x, o);
    }
    if (ok && r == 0) {
      p.part_val[u] = x.v;
      p.part_idx[u] = x.i;
      p.part_nan[u] = x.nan;
    }
    if (gsz > 32) __syncthreads();  // red is read before the next round
  }
}

// The late head, for a wide head: after the barrier, a unit is 128 head
// columns, lane l reads columns 4l .. 4l+3 of a ws row with one 16-byte
// load, and the block's 8 warps split hp by k (k = warp + 8 j).  A row
// pass stages R rows of the top layer's h k-major, as the GEMV does, so one
// 128-bit broadcast serves 4 rows; each thread keeps kHeadAhead ws loads in
// flight (a warp 512 bytes each), so ws is read once a row pass and no
// partial goes through global memory.  The warps' sums are added in warp
// order, one column of the four at a time through `red`, plus the bias;
// each 8-column unit's best column is its argmax partial, as in
// sum_head_partials.
constexpr int kHeadCols = 128;
constexpr int kHeadAhead = 8;

template <int R>
__device__ __forceinline__ void late_head(const TickParams& p, float* hs,
                                          float* red) {
  const int hp = p.hp, bp = p.bp, vp = p.vp, units = vp / kHeadCols;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  if ((int)blockIdx.x >= units) return;
  for (int r0 = 0; r0 < bp; r0 += R) {
    __syncthreads();  // the stage is free
    stage_rows<R>(hs, p.h_out + ((size_t)(p.L - 1) * bp + r0) * hp, hp);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    for (int u = blockIdx.x; u < units; u += gridDim.x) {
      const int v0 = u * kHeadCols + 4 * lane;  // this lane's 4 columns
      const float4* wcol = reinterpret_cast<const float4*>(p.ws + v0);
      float acc[R][4];
#pragma unroll
      for (int b = 0; b < R; ++b)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[b][c] = 0.f;
      for (int k0 = warp; k0 < hp; k0 += kWarps * kHeadAhead) {
        float4 w[kHeadAhead];
#pragma unroll
        for (int j = 0; j < kHeadAhead; ++j) {
          const int k = k0 + j * kWarps;
          w[j] = k < hp ? __ldg(wcol + (size_t)k * (vp / 4))
                        : make_float4(0.f, 0.f, 0.f, 0.f);
        }
#pragma unroll
        for (int j = 0; j < kHeadAhead; ++j) {
          const int k = k0 + j * kWarps;
          if (k >= hp) break;
          const float4* xv =
              reinterpret_cast<const float4*>(hs + kidx<R>(k));
#pragma unroll
          for (int q = 0; q < R / 4; ++q) {
            const float4 x4 = xv[q];
            const float x[4] = {x4.x, x4.y, x4.z, x4.w};
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              float* a = acc[4 * q + i];
              a[0] = fmaf(x[i], w[j].x, a[0]);
              a[1] = fmaf(x[i], w[j].y, a[1]);
              a[2] = fmaf(x[i], w[j].z, a[2]);
              a[3] = fmaf(x[i], w[j].w, a[3]);
            }
          }
        }
      }
      // warp b < R finishes row r0 + b: its lane's 4 columns, one a round
      float y[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
#pragma unroll
        for (int b = 0; b < R; ++b)
          red[(warp * R + b) * 32 + lane] = acc[b][c];
        __syncthreads();
        if (warp < R) {
          float s = 0.f;
#pragma unroll
          for (int w = 0; w < kWarps; ++w)
            s += red[(w * R + warp) * 32 + lane];
          y[c] = s + p.bs[v0 + c];
        }
        __syncthreads();  // red is read before the next round
      }
      if (warp < R) {
        const int row = r0 + warp;
        *reinterpret_cast<float4*>(p.logits + (size_t)row * vp + v0) =
            make_float4(y[0], y[1], y[2], y[3]);
        Best x = {-INFINITY, -1, 0};
#pragma unroll
        for (int c = 0; c < 4; ++c)
          x = better(x, y[c] != y[c] ? Best{-INFINITY, -1, 1}
                                     : Best{y[c], v0 + c, 0});
        const Best o = {__shfl_xor_sync(0xffffffffu, x.v, 1),
                        __shfl_xor_sync(0xffffffffu, x.i, 1),
                        __shfl_xor_sync(0xffffffffu, x.nan, 1)};
        x = better(x, o);  // lanes 2m and 2m+1 hold one 8-column unit
        if ((lane & 1) == 0) {
          const size_t o8 = (size_t)row * (vp / 8) + v0 / 8;
          p.part_val[o8] = x.v;
          p.part_idx[o8] = x.i;
          p.part_nan[o8] = x.nan;
        }
      }
    }
  }
}

template <int MODE, int CELL, int R>
__global__ void __launch_bounds__(kThreads, 1)
fused_tick_kernel(TickParams p) {
  constexpr int G = MODE == 0 ? 16 : 32;
  constexpr int NG = CELL == 0 ? 4 : 3;
  extern __shared__ __align__(16) float smem[];
  __shared__ bool last;
  const int hp = p.hp, bp = p.bp, vp = p.vp;
  const int sf = stage_floats<R>(hp);
  float* hs = smem;                                 // staged h_prev rows
  float* xs = hs + sf;                              // layer-below new h (L > 1)
  float* red = xs + (p.L > 1 ? sf : 0);             // (kWarps, NG*R, kCols)
  float* gh = red + kWarps * kMaxGates * R * kCols;  // (NG, R, kCols)
  float* gx = gh + kMaxGates * R * kCols;
  float* gop = gx + kMaxGates * R * kCols;          // (R*kCols, kOps)
  float* hnew = gop + R * kCols * kOps;             // (bp, kCols) top layer

  cg::grid_group grid = cg::this_grid();
  const int t = threadIdx.x;
  const int lane = t & 31, warp = t >> 5;
  const int col = lane & (kCols - 1);
  const int ks = (lane >> 3) + 4 * warp;
  const int KW = hp / G;
  const int nsl = hp / kCols;
  float acc[kMaxGates][R];
  uint32_t wh[kAhead][kMaxGates], wx[kAhead][kMaxGates];
  if (blockIdx.x == 0 && t == 0) *p.ticket = 0u;  // ordered by the barriers

  for (int l = 0; l < p.L; ++l) {
    if (l > 0) grid.sync();  // layer l-1's h_out is complete
    const bool top = l == p.L - 1;
    const uint32_t* ch = p.codes_h + (size_t)l * NG * KW * hp;
    const uint32_t* cx = p.codes_x + (size_t)(l - 1) * NG * KW * hp;
    for (int s = blockIdx.x; s < nsl; s += gridDim.x) {
      const int n = s * kCols + col;
      const float* g = gop + t * kOps;  // the gate math's operands
      for (int r0 = 0; r0 < bp; r0 += R) {
        __syncthreads();  // the last pass is done reading the stage
        stage_pass<NG, R>(p, l, s, r0, hs, xs, gop);
        if (r0 == 0) {  // the code words load once for every row pass
          if (l > 0) load_words<NG>(cx, KW, hp, n, ks, wx);
          load_words<NG>(ch, KW, hp, n, ks, wh);
        }
        cp_async_wait<0>();
        __syncthreads();
        if (l > 0) {
          gemv_part<MODE, NG, R>(xs, cx, KW, hp, n, ks, wx, acc);
          reduce_slices<NG, R>(acc, red, gx);
        }
        gemv_part<MODE, NG, R>(hs, ch, KW, hp, n, ks, wh, acc);
        reduce_slices<NG, R>(acc, red, gh);
        if (t < R * kCols) {
          const int b = t / kCols, cc = t % kCols;
          const int row = r0 + b, nn = s * kCols + cc;
          float ax[kMaxGates], ah[kMaxGates];
#pragma unroll
          for (int i = 0; i < NG; ++i) {
            const int o = (i * R + b) * kCols + cc;
            ax[i] = l == 0 ? g[kAx + i]
                           : gx[o] * g[kScaleX + i] + g[kShiftX + i];
            ah[i] = gh[o] * g[kScaleH + i] + g[kShiftH + i];
          }
          const float h_prev = g[kHPrev], c_prev = g[kCPrev];
          const bool live = g[kLive] > 0.f;
          float h_new, c_sel;
          if (CELL == 0) {
            const float f = ah[0] + ax[0], ig = ah[1] + ax[1];
            const float o = ah[2] + ax[2], gg = ah[3] + ax[3];
            const float c_new =
                sigmoidf(f) * c_prev + sigmoidf(ig) * tanhf(gg);
            const float cn = c_new * g[kScaleC] + g[kShiftC];
            h_new = live ? sigmoidf(o) * tanhf(cn) : h_prev;
            c_sel = live ? c_new : c_prev;
          } else {
            // the h-side BN shift is not folded into ax: r gates the whole
            // normalized ah_g term
            const float r = sigmoidf(ax[0] + ah[0]);
            const float z = sigmoidf(ax[1] + ah[1]);
            const float gg = tanhf(ax[2] + r * ah[2]);
            h_new = live ? (1.f - z) * h_prev + z * gg : h_prev;
            c_sel = c_prev;
          }
          const size_t st = ((size_t)l * bp + row) * hp + nn;
          p.h_out[st] = h_new;
          p.c_out[st] = c_sel;
          if (top) hnew[row * kCols + cc] = h_new;
        }
      }
      if (!top || p.late_head) continue;
      // the head's partial product over this slice's 8 rows of ws, for
      // every batch row and head column; the fp multiplies consume the
      // tick's output activations against the fp head weight
      __syncthreads();  // hnew holds every row
      for (int v = t; v < vp; v += kThreads) {
        float w[kCols];
#pragma unroll
        for (int cc = 0; cc < kCols; ++cc)
          w[cc] = __ldg(p.ws + (size_t)(s * kCols + cc) * vp + v);
        for (int b = 0; b < bp; ++b) {
          float a = 0.f;
#pragma unroll
          for (int cc = 0; cc < kCols; ++cc)
            a = fmaf(hnew[b * kCols + cc], w[cc], a);
          p.head_part[head_at(v, b, s, bp, nsl)] = a;
        }
      }
    }
  }

  grid.sync();  // the top layer's h_out (and every head partial) is written
  if (p.late_head)
    late_head<R>(p, hs, red);
  else
    sum_head_partials(p, red);
  // the last block to finish its units reduces every unit's partial
  __threadfence();
  __syncthreads();
  if (t == 0) last = atomicAdd(p.ticket, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  const int vbn = vp / 8;
  for (int b = warp; b < bp; b += kWarps) {
    Best x = {-INFINITY, -1, 0};
#pragma unroll 4
    for (int vb = lane; vb < vbn; vb += 32) {
      const size_t o = (size_t)b * vbn + vb;
      x = better(x, Best{__ldcg(p.part_val + o), __ldcg(p.part_idx + o),
                         __ldcg(p.part_nan + o)});
    }
    x = warp_best(x);
    if (lane == 0) p.greedy[b] = (x.nan || x.i < 0) ? vp : x.i;
  }
}

template <int R>
size_t smem_bytes(int L, int hp, int bp) {
  return sizeof(float) *
         ((size_t)(L > 1 ? 2 : 1) * stage_floats<R>(hp) +
          (size_t)kWarps * kMaxGates * R * kCols +
          (size_t)2 * kMaxGates * R * kCols + (size_t)R * kCols * kOps +
          (size_t)bp * kCols);
}

// The most blocks of one instantiation that can be co-resident on the
// current device with `smem` bytes of shared memory, worked out on the
// first launch for each (device, smem) and cached: the shared-memory
// attribute and the occupancy query are host calls a decode tick should
// not pay again.
struct CoResident {
  int dev;
  size_t smem;
  int blocks;
};

template <int MODE, int CELL, int R>
cudaError_t co_resident_blocks(size_t smem, int* blocks) {
  static std::mutex mu;
  static std::vector<CoResident> seen;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> lock(mu);
  for (const CoResident& r : seen)
    if (r.dev == dev && r.smem == smem) {
      *blocks = r.blocks;
      return cudaSuccess;
    }
  auto kernel = fused_tick_kernel<MODE, CELL, R>;
  // the attribute is one per function and device: keep it at the largest
  // size seen there, so a smaller launch never lowers it under a larger one
  size_t most = smem;
  for (const CoResident& r : seen)
    if (r.dev == dev && r.smem > most) most = r.smem;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)most);
  if (err != cudaSuccess) return err;
  int n_sm = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kThreads, smem);
  if (err != cudaSuccess) return err;
  seen.push_back({dev, smem, per_sm * n_sm});
  *blocks = per_sm * n_sm;
  return cudaSuccess;
}

template <int MODE, int CELL, int R>
int launch(TickParams p, int grid_max, cudaStream_t stream) {
  const size_t smem = smem_bytes<R>(p.L, p.hp, p.bp);
  int grid = 0;
  cudaError_t err = co_resident_blocks<MODE, CELL, R>(smem, &grid);
  if (err != cudaSuccess) return (int)err;
  if (grid > grid_max) grid = grid_max;
  if (grid < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  void* args[] = {&p};
  err = cudaLaunchCooperativeKernel(
      (const void*)fused_tick_kernel<MODE, CELL, R>, dim3(grid),
      dim3(kThreads), args, smem, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <int MODE, int CELL>
int launch_rows(TickParams p, int rows, int grid_max, cudaStream_t s) {
  return rows == 8 ? launch<MODE, CELL, 8>(p, grid_max, s)
                   : launch<MODE, CELL, 4>(p, grid_max, s);
}

}  // namespace

// mode: 0 ternary, 1 binary; cell: 0 lstm (4 gates), 1 gru (3 gates); rows:
// batch rows a pass (4 or 8, dividing bp); late_head: 1 to run the head
// after the barrier (vp a multiple of 128, ws 16-byte aligned; head_part is
// then unused), 0 to sum the slices' early partials; grid_max: the most
// blocks to launch.  Returns the cudaError_t of the launch.
extern "C" int fused_tick_launch(
    const void* ax0, const void* h, const void* c, const void* live,
    const void* codes_h, const void* codes_x, const void* scale_h,
    const void* shift_h, const void* scale_x, const void* shift_x,
    const void* scale_c, const void* shift_c, const void* ws, const void* bs,
    void* h_out, void* c_out, void* logits, void* greedy, void* head_part,
    void* part_val, void* part_idx, void* part_nan, void* ticket, int L,
    int bp, int hp, int vp, int cell, int mode, int rows, int late_head,
    int grid_max, void* stream) {
  if (L < 1 || (rows != 4 && rows != 8) || bp < rows || bp % rows ||
      hp < kCols || hp % 32 || vp < kCols || vp % kCols || grid_max < 1 ||
      (late_head &&
       (vp % kHeadCols || reinterpret_cast<uintptr_t>(ws) % 16)))
    return (int)cudaErrorInvalidValue;
  TickParams p;
  p.ax0 = static_cast<const float*>(ax0);
  p.h = static_cast<const float*>(h);
  p.c = static_cast<const float*>(c);
  p.live = static_cast<const float*>(live);
  p.codes_h = static_cast<const uint32_t*>(codes_h);
  p.codes_x = static_cast<const uint32_t*>(codes_x);
  p.scale_h = static_cast<const float*>(scale_h);
  p.shift_h = static_cast<const float*>(shift_h);
  p.scale_x = static_cast<const float*>(scale_x);
  p.shift_x = static_cast<const float*>(shift_x);
  p.scale_c = static_cast<const float*>(scale_c);
  p.shift_c = static_cast<const float*>(shift_c);
  p.ws = static_cast<const float*>(ws);
  p.bs = static_cast<const float*>(bs);
  p.h_out = static_cast<float*>(h_out);
  p.c_out = static_cast<float*>(c_out);
  p.logits = static_cast<float*>(logits);
  p.greedy = static_cast<int*>(greedy);
  p.head_part = static_cast<float*>(head_part);
  p.part_val = static_cast<float*>(part_val);
  p.part_idx = static_cast<int*>(part_idx);
  p.part_nan = static_cast<int*>(part_nan);
  p.ticket = static_cast<unsigned*>(ticket);
  p.L = L;
  p.bp = bp;
  p.hp = hp;
  p.vp = vp;
  p.late_head = late_head;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mode == 0)
    return cell == 0 ? launch_rows<0, 0>(p, rows, grid_max, s)
                     : launch_rows<0, 1>(p, rows, grid_max, s);
  return cell == 0 ? launch_rows<1, 0>(p, rows, grid_max, s)
                   : launch_rows<1, 1>(p, rows, grid_max, s);
}
