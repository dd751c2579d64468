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
//           no counterpart here.  Operands arrive padded: bp a multiple of 8,
//           hp and vp multiples of 8 (the wrapper pads them to 128).
// Bound on this card: count the unpadded function at rnn-paper decode
//           (B = 4, H = 1000, V = 50, g = 4): it reads 1.01 MB of h-side
//           codes (ceil(H/16) words per column), the 0.2 MB head, and
//           0.14 MB of input preacts, state and affines, and writes 0.03 MB:
//           1.38 MB, 0.41 us at 3.35 TB/s.  Its adds are one per row and
//           nonzero weight: at most B * 4.0 M = 16 M, 0.48 us at 33.5 T/s,
//           about half that with the zeros of a ternary weight, so bytes
//           bound it, barely, and the small batch leaves most of the card's
//           132 SMs idle unless the GEMV is cut finely across blocks.
//           Measured there: 21.3 us of device time a launch (NVIDIA H100
//           80GB HBM3, 700 W power limit; chip_smoke.py): two grid-wide
//           barriers, a shared-memory load per add, and a head on 16 of the
//           blocks.
// Design:   the TPU kernel is one program holding h and c in VMEM; a layer
//           needs all of the previous layer's h, and the argmax needs every
//           head column.  Here that is one COOPERATIVE launch
//           (cudaLaunchCooperativeKernel) whose grid is no larger than the
//           co-resident block count, with cg::this_grid().sync() between
//           layers, before the head, and before the final argmax.  The
//           co-resident count and the shared-memory attribute are worked
//           out once per (device, hp) and cached, so a tick costs the host
//           one launch call.  A thread block cluster was the alternative;
//           its 16 blocks at most would leave the GEMV on 16 of 132 SMs, so
//           the grid-wide barrier wins.
//           Each block owns slices of 8 columns (all g gates).  It stages 8
//           rows of h_prev (and of the layer below's new h) in shared memory
//           with a padded stride against bank conflicts; its 256 threads
//           are 8 columns x 32 interleaved k-slices, the 8 lanes of a column
//           slice reading 8 consecutive code words (one 32-byte sector).
//           Partial sums are reduced with warp shuffles, then through
//           shared memory.  The code decode is the packed_gemv one
//           (packed_codes.cuh): a keep mask and a sign bit applied with
//           integer logic, then one FADD.
//           For the head, blocks own 8-column slices of vp, write logits,
//           and leave a (max, min index, NaN) partial per row; block 0
//           reduces the partials in slice order after the last sync.
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
constexpr int kRows = 8;       // batch rows staged per pass
constexpr int kMaxGates = 4;

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
  float* part_val;          // (vp / kCols, bp) per-slice row maxima
  int* part_idx;            // (vp / kCols, bp) their minimum column
  int* part_nan;            // (vp / kCols, bp) 1 where the slice held a NaN
  int L, bp, hp, vp;
};

__device__ __forceinline__ int padk(int k) { return k + (k >> 5); }

__device__ __forceinline__ float sigmoidf(float x) {
  return 1.f / (1.f + expf(-x));
}

// Copy rows [r0, r0 + kRows) of a (bp, hp) matrix into shared memory with
// the padded stride.
__device__ void stage_rows(float* dst, const float* src, int hp, int hpp) {
  for (int i = threadIdx.x; i < kRows * hp; i += kThreads) {
    const int b = i / hp, k = i % hp;
    dst[b * hpp + padk(k)] = src[(size_t)b * hp + k];
  }
}

// Partial multiply-free GEMV of this thread's k-slice for column n of NG
// gates: codes (NG, KW, hp) words, x staged (kRows, hpp).
template <int MODE, int NG>
__device__ void gemv_part(const float* xs, const uint32_t* codes, int KW,
                          int hp, int hpp, int n, int ks,
                          float (&acc)[kMaxGates][kRows]) {
  constexpr int G = MODE == 0 ? 16 : 32;
#pragma unroll
  for (int i = 0; i < NG; ++i)
#pragma unroll
    for (int b = 0; b < kRows; ++b) acc[i][b] = 0.f;
  for (int w = ks; w < KW; w += kSlices) {
#pragma unroll
    for (int i = 0; i < NG; ++i) {
      const uint32_t word = codes[((size_t)i * KW + w) * hp + n];
#pragma unroll
      for (int j = 0; j < G; ++j) {
        uint32_t keep, flip;
        packed_codes::decode<MODE>(word, j, keep, flip);
        const int kk = padk(w * G + j);
#pragma unroll
        for (int b = 0; b < kRows; ++b)
          acc[i][b] += packed_codes::apply(xs[b * hpp + kk], keep, flip);
      }
    }
  }
}

// Sum the 32 k-slices of each (gate, row, column) into out[(i*kRows+b)*kCols
// + col].  Ends with the block synchronised and `out` complete.
template <int NG>
__device__ void reduce_slices(float (&acc)[kMaxGates][kRows], float* red,
                              float* out) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int i = 0; i < NG; ++i)
#pragma unroll
    for (int b = 0; b < kRows; ++b) {
      float v = acc[i][b];
      v += __shfl_xor_sync(0xffffffffu, v, 8);
      v += __shfl_xor_sync(0xffffffffu, v, 16);
      acc[i][b] = v;
    }
  if (lane < kCols) {
#pragma unroll
    for (int i = 0; i < NG; ++i)
#pragma unroll
      for (int b = 0; b < kRows; ++b)
        red[(warp * NG * kRows + i * kRows + b) * kCols + lane] = acc[i][b];
  }
  __syncthreads();
  for (int o = threadIdx.x; o < NG * kRows * kCols; o += kThreads) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += red[w * NG * kRows * kCols + o];
    out[o] = s;
  }
  __syncthreads();
}

template <int MODE, int CELL>
__global__ void __launch_bounds__(kThreads)
fused_tick_kernel(TickParams p) {
  constexpr int G = MODE == 0 ? 16 : 32;
  constexpr int NG = CELL == 0 ? 4 : 3;
  extern __shared__ float smem[];
  const int hp = p.hp, bp = p.bp;
  const int hpp = hp + (hp >> 5);
  float* hs = smem;                      // (kRows, hpp) h_prev rows
  float* xs = hs + kRows * hpp;          // (kRows, hpp) layer-below new h
  float* red = xs + kRows * hpp;         // (kWarps, NG*kRows, kCols)
  float* gh = red + kWarps * kMaxGates * kRows * kCols;  // (NG, kRows, kCols)
  float* gx = gh + kMaxGates * kRows * kCols;

  cg::grid_group grid = cg::this_grid();
  const int t = threadIdx.x;
  const int lane = t & 31, warp = t >> 5;
  const int col = lane & (kCols - 1);
  const int ks = (lane >> 3) + 4 * warp;
  const int KW = hp / G;
  const int nsl = hp / kCols;
  float acc[kMaxGates][kRows];

  for (int l = 0; l < p.L; ++l) {
    if (l > 0) grid.sync();  // layer l-1's h_out is complete
    const float* hin = p.h + (size_t)l * bp * hp;
    const float* xin = p.h_out + (size_t)(l - 1) * bp * hp;
    for (int r0 = 0; r0 < bp; r0 += kRows) {
      __syncthreads();
      stage_rows(hs, hin + (size_t)r0 * hp, hp, hpp);
      if (l > 0) stage_rows(xs, xin + (size_t)r0 * hp, hp, hpp);
      __syncthreads();
      for (int s = blockIdx.x; s < nsl; s += gridDim.x) {
        const int n = s * kCols + col;
        if (l > 0) {
          gemv_part<MODE, NG>(xs, p.codes_x + (size_t)(l - 1) * NG * KW * hp,
                              KW, hp, hpp, n, ks, acc);
          reduce_slices<NG>(acc, red, gx);
        }
        gemv_part<MODE, NG>(hs, p.codes_h + (size_t)l * NG * KW * hp, KW, hp,
                            hpp, n, ks, acc);
        reduce_slices<NG>(acc, red, gh);
        if (t < kRows * kCols) {
          const int b = t / kCols, cc = t % kCols;
          const int row = r0 + b, nn = s * kCols + cc;
          float ax[kMaxGates], ah[kMaxGates];
#pragma unroll
          for (int i = 0; i < NG; ++i) {
            const int o = (i * kRows + b) * kCols + cc;
            if (l == 0) {
              ax[i] = p.ax0[((size_t)row * NG + i) * hp + nn];
            } else {
              const size_t a = ((size_t)(l - 1) * NG + i) * hp + nn;
              ax[i] = gx[o] * p.scale_x[a] + p.shift_x[a];
            }
            const size_t a = ((size_t)l * NG + i) * hp + nn;
            ah[i] = gh[o] * p.scale_h[a] + p.shift_h[a];
          }
          const size_t st = ((size_t)l * bp + row) * hp + nn;
          const float h_prev = p.h[st], c_prev = p.c[st];
          const bool live = p.live[(size_t)row * hp + nn] > 0.f;
          float h_new, c_sel;
          if (CELL == 0) {
            const float f = ah[0] + ax[0], ig = ah[1] + ax[1];
            const float o = ah[2] + ax[2], g = ah[3] + ax[3];
            const float c_new = sigmoidf(f) * c_prev + sigmoidf(ig) * tanhf(g);
            const float cn = c_new * p.scale_c[(size_t)l * hp + nn] +
                             p.shift_c[(size_t)l * hp + nn];
            h_new = live ? sigmoidf(o) * tanhf(cn) : h_prev;
            c_sel = live ? c_new : c_prev;
          } else {
            // the h-side BN shift is not folded into ax: r gates the whole
            // normalized ah_g term
            const float r = sigmoidf(ax[0] + ah[0]);
            const float z = sigmoidf(ax[1] + ah[1]);
            const float g = tanhf(ax[2] + r * ah[2]);
            h_new = live ? (1.f - z) * h_prev + z * g : h_prev;
            c_sel = c_prev;
          }
          p.h_out[st] = h_new;
          p.c_out[st] = c_sel;
        }
      }
    }
  }

  grid.sync();  // the top layer's h_out is complete
  const int vp = p.vp;
  const int nsv = vp / kCols;
  const float* hl = p.h_out + (size_t)(p.L - 1) * bp * hp;
  for (int r0 = 0; r0 < bp; r0 += kRows) {
    __syncthreads();
    stage_rows(hs, hl + (size_t)r0 * hp, hp, hpp);
    __syncthreads();
    for (int s = blockIdx.x; s < nsv; s += gridDim.x) {
      const int n = s * kCols + col;
#pragma unroll
      for (int b = 0; b < kRows; ++b) acc[0][b] = 0.f;
      // fp head: these multiplies consume the tick's output activations
      // against the fp head weight; the packed weight path ended above
      for (int k = ks; k < hp; k += kSlices) {
        const float w = p.ws[(size_t)k * vp + n];
        const int kk = padk(k);
#pragma unroll
        for (int b = 0; b < kRows; ++b) acc[0][b] += hs[b * hpp + kk] * w;
      }
      reduce_slices<1>(acc, red, gh);
      if (t < kRows * kCols) {
        const int b = t / kCols, cc = t % kCols;
        const float v = gh[t] + p.bs[s * kCols + cc];
        p.logits[(size_t)(r0 + b) * vp + s * kCols + cc] = v;
        gx[t] = v;
      }
      __syncthreads();
      if (t < kRows) {
        float best = -INFINITY;
        int idx = -1, nan = 0;
        for (int cc = 0; cc < kCols; ++cc) {
          const float v = gx[t * kCols + cc];
          if (v != v) {
            nan = 1;
          } else if (idx < 0 || v > best) {
            best = v;
            idx = s * kCols + cc;
          }
        }
        const size_t o = (size_t)s * bp + r0 + t;
        p.part_val[o] = best;
        p.part_idx[o] = idx;
        p.part_nan[o] = nan;
      }
    }
  }
  grid.sync();  // every slice's partial argmax is written
  if (blockIdx.x != 0) return;
  for (int row = t; row < bp; row += kThreads) {
    float best = -INFINITY;
    int idx = -1, nan = 0;
    for (int s = 0; s < nsv; ++s) {
      const size_t o = (size_t)s * bp + row;
      nan |= p.part_nan[o];
      const int i = p.part_idx[o];
      if (i >= 0 && (idx < 0 || p.part_val[o] > best)) {
        best = p.part_val[o];
        idx = i;
      }
    }
    p.greedy[row] = (nan || idx < 0) ? vp : idx;
  }
}

size_t smem_bytes(int hp) {
  const int hpp = hp + (hp >> 5);
  return sizeof(float) * ((size_t)2 * kRows * hpp +
                          (size_t)kWarps * kMaxGates * kRows * kCols +
                          (size_t)2 * kMaxGates * kRows * kCols);
}

// The most blocks of one instantiation that can be co-resident on the
// current device at hp, worked out on the first launch for each (device, hp)
// and cached: the shared-memory attribute and the occupancy query are host
// calls a decode tick should not pay again.
struct CoResident {
  int dev, hp, blocks;
};

template <int MODE, int CELL>
cudaError_t co_resident_blocks(int hp, size_t smem, int* blocks) {
  static std::mutex mu;
  static std::vector<CoResident> seen;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> lock(mu);
  for (const CoResident& r : seen)
    if (r.dev == dev && r.hp == hp) {
      *blocks = r.blocks;
      return cudaSuccess;
    }
  auto kernel = fused_tick_kernel<MODE, CELL>;
  // the attribute is one per function and device: keep it at the largest
  // hp seen there, so a smaller hp never lowers it under a larger one
  size_t most = smem;
  for (const CoResident& r : seen)
    if (r.dev == dev && smem_bytes(r.hp) > most) most = smem_bytes(r.hp);
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)most);
  if (err != cudaSuccess) return err;
  int n_sm = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kThreads, smem);
  if (err != cudaSuccess) return err;
  seen.push_back({dev, hp, per_sm * n_sm});
  *blocks = per_sm * n_sm;
  return cudaSuccess;
}

template <int MODE, int CELL>
int launch(TickParams p, cudaStream_t stream) {
  const size_t smem = smem_bytes(p.hp);
  int grid = 0;
  cudaError_t err = co_resident_blocks<MODE, CELL>(p.hp, smem, &grid);
  if (err != cudaSuccess) return (int)err;
  const int want = (p.hp > p.vp ? p.hp : p.vp) / kCols;
  if (grid > want) grid = want;
  if (grid < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  void* args[] = {&p};
  err = cudaLaunchCooperativeKernel((const void*)fused_tick_kernel<MODE, CELL>,
                                    dim3(grid), dim3(kThreads), args, smem,
                                    stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

// mode: 0 ternary, 1 binary; cell: 0 lstm (4 gates), 1 gru (3 gates).
// Returns the cudaError_t of the launch.
extern "C" int fused_tick_launch(
    const void* ax0, const void* h, const void* c, const void* live,
    const void* codes_h, const void* codes_x, const void* scale_h,
    const void* shift_h, const void* scale_x, const void* shift_x,
    const void* scale_c, const void* shift_c, const void* ws, const void* bs,
    void* h_out, void* c_out, void* logits, void* greedy, void* part_val,
    void* part_idx, void* part_nan, int L, int bp, int hp, int vp, int cell,
    int mode, void* stream) {
  if (L < 1 || bp < kRows || bp % kRows || hp < kCols || hp % 32 ||
      vp < kCols || vp % kCols)
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
  p.part_val = static_cast<float*>(part_val);
  p.part_idx = static_cast<int*>(part_idx);
  p.part_nan = static_cast<int*>(part_nan);
  p.L = L;
  p.bp = bp;
  p.hp = hp;
  p.vp = vp;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mode == 0) return cell == 0 ? launch<0, 0>(p, s) : launch<0, 1>(p, s);
  return cell == 0 ? launch<1, 0>(p, s) : launch<1, 1>(p, s);
}
