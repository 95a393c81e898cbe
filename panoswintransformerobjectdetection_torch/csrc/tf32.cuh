// 3xTF32 on the tensor cores: float32 products at about float32's accuracy
// from TF32 multiplies, shared by the float32 entries of K1
// (`stem_conv.cu`), K2 (`window_attention.cu`) and K4 (`dense_crop.cu`).
//
// TF32 keeps 10 bits of mantissa, which breaks the f32 tolerances.  So each
// operand is split, a = hi + lo with hi = TF32(a) and lo = TF32(a - hi),
// both rounded to nearest with ties away from zero as `cvt.rna.tf32.f32`
// rounds, and each product is taken as lo.hi + hi.lo + hi.hi with f32
// accumulation, the small products first.  The lo.lo term left out is about
// 2**-22 of the product.  `ops/cuda_build.py` hashes this header with every
// source, so an edit rebuilds all three libraries.

#pragma once

#include <stdint.h>

namespace {
namespace tf32 {

// The bits of a float rounded to TF32, to nearest with ties away from zero,
// as `cvt.rna.tf32.f32` rounds (low 13 bits zero), in two integer
// instructions at the full ALU rate.
__device__ __forceinline__ uint32_t rna_tf32(uint32_t bits) {
  return (bits + 0x1000u) & 0xffffe000u;
}

// f = hi + lo to about 2**-22 |f|: hi its TF32 rounding, lo that of the rest
__device__ __forceinline__ void split(float f, uint32_t& hi, uint32_t& lo) {
  hi = rna_tf32(__float_as_uint(f));
  lo = rna_tf32(__float_as_uint(__fsub_rn(f, __uint_as_float(hi))));
}

// d += a (16 x 8, row) . b (8 x 8, col), TF32 in, f32 accumulators
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a . b in 3xTF32, from the split operands: lo.hi, hi.lo, then hi.hi
__device__ __forceinline__ void mma_3xtf32(float (&d)[4], const uint32_t (&a_hi)[4],
                                           const uint32_t (&a_lo)[4], uint32_t b0_hi,
                                           uint32_t b1_hi, uint32_t b0_lo, uint32_t b1_lo) {
  mma_tf32(d, a_lo, b0_hi, b1_hi);
  mma_tf32(d, a_hi, b0_lo, b1_lo);
  mma_tf32(d, a_hi, b0_hi, b1_hi);
}

}  // namespace tf32
}  // namespace
