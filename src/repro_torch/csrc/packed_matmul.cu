// Prefill GEMM against 2-bit (ternary) / 1-bit (binary) packed weights, for
// sm_90a: the multiply-free GEMV kernel (packed_gemv.cuh) over 8-row tiles.
//
// Replaces: src/repro/kernels/packed_matmul.py:packed_matmul (_matmul_kernel).
// Computes: out (M, N) = x (M, K) . unpack(codes (K/G, N)) in fp32, for the
//           M > 8 prefill shapes.  K is a multiple of G; callers zero-pad x
//           past the true K, so pad codes add nothing.  N may be ragged.
// Why this design: batch invariance.  A request's stream must not depend
//           on how its prompt was chunked or what shared its batch
//           (src/repro/serve/engine.py's promise).  A prompt run whole and
//           the same prompt in chunks reach this kernel at other row counts,
//           and its last short chunk (at most 8 rows) reaches the GEMV.  So
//           a row's fp32 sum must be a function of (K, N, mode) alone: the
//           same adds in the same order at any M, and the GEMV's own.  This
//           kernel is therefore the GEMV's, launched over ceil(M/8) row
//           tiles (gridDim.z) with the GEMV's K split (kernels/
//           packed_matmul.py: gemv_plan, which reads K and N only): every
//           row is summed exactly as packed_gemv sums it, to the same bits.
//           The earlier design, an exact three-term bf16 split of x on the
//           tensor cores, summed in the mma unit's own order and split K by
//           a cluster chosen from M as well, so a row's bits followed the
//           row count (PERF.md section 6).
// Bound on this card: one fp32 add per row and nonzero weight on the CUDA
//           cores (the weights are -1/0/+1), at 33.5 T adds/s; above a few
//           rows that is more than the bytes (codes, x and out once) take
//           at 3.35 TB/s (chip_smoke.py counts both from the weights).
// Design:   see packed_gemv.cu.  Each 8-row tile re-decodes the codes, which
//           stay in the L2 across the tiles; each column tile re-stages x.
//           The loop issues a LOP3 and an FADD per (row, k, column) and
//           decodes a code once per (k, column) for the tile's 8 rows.
#include "packed_gemv.cuh"

namespace {

using namespace packed_gemv;

template <int MODE, bool VEC>
cudaError_t launch_tiles(const float* x, const uint32_t* codes, float* out,
                         int M, int K, int N, int cluster, int tiles,
                         cudaStream_t s) {
  return launch<MODE, 8, VEC>(x, codes, out, M, K, N, cluster, tiles, s);
}

}  // namespace

// mode: 0 ternary, 1 binary; cluster, tiles and vec as packed_gemv_launch
// takes them from gemv_plan (the K split from K and N, never from M).
// Returns the cudaError_t of the launch.
extern "C" int packed_matmul_launch(const void* x, const void* codes,
                                    void* out, int M, int K, int N, int mode,
                                    int cluster, int tiles, int vec,
                                    void* stream) {
  if (M < 1 || (M + 7) / 8 > 65535 ||
      !valid_geometry(codes, K, N, mode, cluster, tiles, vec))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  const uint32_t* cw = static_cast<const uint32_t*>(codes);
  float* of = static_cast<float*>(out);
  cudaError_t err;
  if (mode == 0)
    err = vec ? launch_tiles<0, true>(xf, cw, of, M, K, N, cluster, tiles, s)
              : launch_tiles<0, false>(xf, cw, of, M, K, N, cluster, tiles, s);
  else
    err = vec ? launch_tiles<1, true>(xf, cw, of, M, K, N, cluster, tiles, s)
              : launch_tiles<1, false>(xf, cw, of, M, K, N, cluster, tiles, s);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
