// Multiply-free GEMV against 2-bit (ternary) / 1-bit (binary) packed
// weights, for sm_90a: the step route (kernels/ops.py), which takes every
// decode tick, speculative verify and recurrent h-side product at any row
// count.  The kernel lives in packed_gemv.cuh.
//
// Replaces: src/repro/kernels/packed_matmul.py:packed_gemv
//           (_gemv_kernel -> accumulate_gemv -> code_masks).
// Computes: out (M, N) = x (M, K) . unpack(codes (K/G, N)), G = 16
//           (ternary) or 32 (binary): one launch of the 1-, 2-, 4- or 8-row
//           instance up to 8 rows, and the 8-row instance over ceil(M / 8)
//           row tiles (gridDim.z) above that.  A row is summed in the same
//           order at any M and in any instance, so a row's bits are a
//           function of (K, N, mode) alone.  Ternary code 1 is +1, code 3
//           is -1, any other code is 0; binary bit 1 is +1, bit 0 is -1.
//           Callers zero-pad x past the true K, so pad codes add nothing.
// Bound on this card: the codes are 1/16 (1/32) of the fp32 weight and
//           are read once, so the bytes are small (1.09 MB at the prefill
//           shape bp = 4, true K = 1000, N = 4000: 0.32 us at 3.35 TB/s).
//           The function needs one fp32 add per row and nonzero weight on
//           the CUDA cores (33.5 T/s): 0.96 us for the binary GEMV at
//           bp = 8.  The multiply-free loop issues one LOP3 and one FADD
//           per (row, k, column), and decoding a code takes four more
//           integer instructions per (k, column), shared by the rows: 49
//           instructions a thread per k at bp = 4 (4 columns), 1.5 us of
//           issue over the 528 schedulers of 132 SMs at 1.98 GHz (the
//           issue floor; LOP3 alone, at 64 a clock an SM, is 0.96 us).
//           The codes sit in the L2 (the prefill loop re-reads them every
//           step), so the rest is latency: the launch, one L2 round trip,
//           a cluster barrier.
// Design:   the weight is never a float.  Each code becomes a keep mask and
//           a sign bit (packed_codes::decode); the activation's bits are
//           ANDed with the mask and XORed with the sign (one LOP3), then
//           added.  No float multiply anywhere on this path (chip_smoke.py
//           checks the SASS).
//           A thread owns 4 adjacent columns (one 16-byte load of 4 code
//           words where N % 4 == 0 and the codes are 16-byte aligned, 4
//           scalar loads otherwise) and a chunk of 16 k (a ternary word,
//           half a binary one) a pass.  It issues its code loads before
//           anything else; then the block stages its K range of x, real
//           rows only, k-major (xs[k][row]) with 16-byte loads, so the two
//           L2 round trips overlap, and loads the next pass's codes while
//           this one adds.  Each code is decoded once per (k, column) and
//           applied to every row: one 128-bit broadcast of xs serves 4
//           rows, and rows x 4 columns independent accumulators keep the
//           FADDs from waiting on each other.  The loop decodes 8 codes a
//           step rather than unrolling whole words.
//           A block is 8 warps: 32 columns and 32 k-slices (4 a warp).  A
//           thread block cluster of up to 8 blocks splits K further, so the
//           grid fills the card (kernels/packed_matmul.py: gemv_plan;
//           N = 4000: 125 column tiles, clusters of 2, 250 blocks).  The
//           slices' partials are summed in a fixed order (shuffles in the
//           warp, then the warps through shared memory); each block pushes
//           its sums to the block of the cluster that owns those outputs
//           (distributed shared memory); after one cluster barrier each
//           owner sums its slots in rank order and stores.  No atomics: two
//           launches give the same bits.
//           Measured (NVIDIA H100 80GB HBM3, 700 W power limit;
//           time_kernels.py): 5.4 us of device time at the main path's
//           ternary x (4, 1008) . codes (63, 4000), against 7.8 us for the
//           first design (one thread a column, 8 warps splitting K in a
//           block, one word in flight at a time) and 10.9 us for
//           torch.matmul on the dequantized weight; 7.5 us binary at 8
//           rows (first design 11.8 us).  What holds it back from the
//           issue floor: staging x, which every column tile reads again,
//           and the in-block and cluster sums (PERF.md section 6).
#include "packed_gemv.cuh"

namespace {

using namespace packed_gemv;

template <int MODE, bool VEC>
cudaError_t launch_rows(int rows, const float* x, const uint32_t* codes,
                        float* out, int bp, int K, int N, int cluster,
                        int tiles, cudaStream_t s) {
  switch (rows) {
    case 1: return launch<MODE, 1, VEC>(x, codes, out, bp, K, N, cluster, tiles, s);
    case 2: return launch<MODE, 2, VEC>(x, codes, out, bp, K, N, cluster, tiles, s);
    case 4: return launch<MODE, 4, VEC>(x, codes, out, bp, K, N, cluster, tiles, s);
    default: return launch<MODE, 8, VEC>(x, codes, out, bp, K, N, cluster, tiles, s);
  }
}

}  // namespace

// mode: 0 ternary, 1 binary.  The geometry comes from gemv_plan: rows is
// the instance (1, 2, 4 or 8, >= bp; 8 above 8 rows, one row tile of x a
// gridDim.z), cluster the blocks that split K
// (1 .. 8, at most K/G), tiles the kCols-column tiles (covering N), vec 1 for
// 16-byte code loads (N % 4 == 0 and 16-byte aligned codes).  Returns the
// cudaError_t of the launch.
extern "C" int packed_gemv_launch(const void* x, const void* codes, void* out,
                                  int bp, int K, int N, int mode, int rows,
                                  int cluster, int tiles, int vec,
                                  void* stream) {
  if (bp < 1 || (bp + 7) / 8 > 65535 ||
      (rows != 1 && rows != 2 && rows != 4 && rows != 8) ||
      (rows < bp && rows != 8) ||
      !valid_geometry(codes, K, N, mode, cluster, tiles, vec))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  const uint32_t* cw = static_cast<const uint32_t*>(codes);
  float* of = static_cast<float*>(out);
  cudaError_t err;
  if (mode == 0)
    err = vec ? launch_rows<0, true>(rows, xf, cw, of, bp, K, N, cluster, tiles, s)
              : launch_rows<0, false>(rows, xf, cw, of, bp, K, N, cluster, tiles, s);
  else
    err = vec ? launch_rows<1, true>(rows, xf, cw, of, bp, K, N, cluster, tiles, s)
              : launch_rows<1, false>(rows, xf, cw, of, bp, K, N, cluster, tiles, s);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
