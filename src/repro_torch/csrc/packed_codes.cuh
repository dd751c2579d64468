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
// Shifts carry code j's low bit to bit 31; the sign bits (ternary: both
// bits of a code set; binary: the bit clear) do not depend on j, so in a
// loop over the codes of one word the compiler computes them once.
template <int MODE>
__device__ __forceinline__ void decode(uint32_t word, int j, uint32_t& keep,
                                       uint32_t& flip) {
  if (MODE == 0) {
    keep = (uint32_t)((int32_t)(word << (31 - 2 * j)) >> 31);
    flip = ((word & (word >> 1)) << (31 - 2 * j)) & 0x80000000u;
  } else {
    keep = 0xffffffffu;
    flip = (~word << (31 - j)) & 0x80000000u;
  }
}

// The two registers of an mma.sync m16n8k16 bf16 B fragment from one word:
// lo holds codes j and j + 1, hi codes j + 8 and j + 9, each as a bf16 (+1
// 0x3f80, -1 0xbf80, +0), the lower code in the low half.  The bits are
// built in registers; no decoded weight passes through memory.  Ternary:
// one byte permute a register picks each code's two bytes from two
// constant byte tables, and two multiply-adds build both selectors.
// Binary: the sign of -1 flipped where the bit is 1.
template <int MODE>
__device__ __forceinline__ void bf16_fragment(uint32_t word, int j,
                                              uint32_t& lo, uint32_t& hi) {
  if (MODE == 0) {
    // low bytes of +0, +1, +0, -1 by code, and their high bytes
    constexpr uint32_t kLow = 0x80008000u, kHigh = 0xbf003f00u;
    const uint32_t t = word >> (2 * j);  // codes j, j+1 in bits 0-3, j+8, j+9
                                         // in bits 16-19
    // selector nibbles (c0, c0 + 4, c1, c1 + 4) of each pair (c0, c1)
    const uint32_t sel = (t & 0x00030003u) * 0x11u +
                         ((t >> 2) & 0x00030003u) * 0x1100u + 0x40404040u;
    lo = __byte_perm(kLow, kHigh, sel);
    hi = __byte_perm(kLow, kHigh, sel >> 16);
  } else {
    const uint32_t t = word >> j;  // codes j, j+1 in bits 0-1, j+8, j+9 in 8-9
    lo = 0xbf80bf80u ^ ((t & 1u) << 15) ^ (((t >> 1) & 1u) << 31);
    hi = 0xbf80bf80u ^ (((t >> 8) & 1u) << 15) ^ (((t >> 9) & 1u) << 31);
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

}  // namespace packed_codes
