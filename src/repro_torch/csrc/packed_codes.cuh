// The packed weight codes, as the port's kernels write and read them.
//
// A 32-bit word packs G codes along the contraction axis, code j in bits
// [b*j, b*j + b): ternary (b = 2, G = 16) has 0b01 -> +1, 0b11 -> -1 and any
// other code -> 0; binary (b = 1, G = 32) has 1 -> +1 and 0 -> -1, so a zero
// pad word decodes to -1 and adds nothing only because callers zero-pad the
// activations.  (src/repro/core/quantize.py packs them; the port carries the
// words as int32 bit-views and the kernels read them as uint32_t.)
// `encode` writes a code, `decode` reads one: the bit layout lives here.
#pragma once

#include <stdint.h>

namespace packed_codes {

// Code j of `word` as an AND mask and a sign bit for an fp32 value's bits:
// (bits & keep) ^ flip is +x, -x or +0.  MODE 0 is ternary, 1 binary.
template <int MODE>
__device__ __forceinline__ void decode(uint32_t word, int j, uint32_t& keep,
                                       uint32_t& flip) {
  if (MODE == 0) {
    const uint32_t c = (word >> (2 * j)) & 3u;
    keep = 0u - (c & 1u);
    flip = (c & (c >> 1)) << 31;
  } else {
    const uint32_t bit = (word >> j) & 1u;
    keep = 0xffffffffu;
    flip = (bit ^ 1u) << 31;
  }
}

// x times a decoded code, by integer logic alone: no float multiply.
__device__ __forceinline__ float apply(float x, uint32_t keep, uint32_t flip) {
  return __uint_as_float((__float_as_uint(x) & keep) ^ flip);
}

// The code of one stochastic sample (paper Eqs. 4-6), shifted to position j
// of its word: wn = clip(w / alpha, -1, 1), by an IEEE division and a
// NaN-keeping clip.  Ternary: 0b01 where u < |wn| and wn > 0, 0b11 where
// u < |wn| and wn < 0, else 0.  Binary: 1 where u < (wn + 1) * 0.5.  The
// _rn intrinsics keep nvcc from fusing or reordering the arithmetic, so
// the code is bit-equal to the plain PyTorch version and the JAX kernel.
template <int MODE>
__device__ __forceinline__ uint32_t encode(float w, float u, float alpha,
                                           int j) {
  float wn = __fdiv_rn(w, alpha);
  wn = wn < -1.f ? -1.f : (wn > 1.f ? 1.f : wn);
  if (MODE == 0) {
    const uint32_t c = u < fabsf(wn) ? (wn > 0.f ? 1u : (wn < 0.f ? 3u : 0u))
                                     : 0u;
    return c << (2 * j);
  }
  return static_cast<uint32_t>(u < __fmul_rn(__fadd_rn(wn, 1.f), 0.5f)) << j;
}

// Code j of `word` as a float: +1, -1 or +0.
template <int MODE>
__device__ __forceinline__ float value(uint32_t word, int j) {
  uint32_t keep, flip;
  decode<MODE>(word, j, keep, flip);
  return apply(1.f, keep, flip);
}

}  // namespace packed_codes
