// Field arithmetic in 26-bit digits, for the point formulas of csrc/ec26.cuh
// (the scans' madd, the full add of the carry scan and of both BPR stages,
// the masked add and the per-window reduce, the doubling of bpr_stage2 and
// the Horner fold), for the table conversion (csrc/convert.cu) and for the
// normalization's batch inversion (csrc/precompute.cu).
//
// An element is 10 little-endian digits of 26 bits in uint32_t, digit i =
// limb 2i | limb 2i+1 << 13 of the 13-bit form of csrc/field.cuh: the same
// integer, half the words.  The Montgomery radix is the same R = 2^260.
//
// The product takes one 26-bit quotient digit per step with 64-bit column
// sums, as the plain version does (ops/kernels/common.py::mont_mul): 100
// digit products x_i*y_j and 90 q*p_j (p's low digit is 1, and
// N0' = -p^-1 mod 2^26 is 2^26 - 1, so q = -t mod 2^26 needs no multiply),
// each one IMAD.WIDE.U32 (32x32 -> 64 bits plus a 64-bit addend), against
// 840 32-bit multiply-adds of field.cuh's 13-bit carry-free product.
// Montgomery's quotient Q = -x*y*p^-1 mod R does not depend on the digit
// size, so both give the integer (x*y + Q*p)/R mod 2^260, which for inputs
// < 9p never wraps: the same limbs.
//
// The lazy additions, subtraction and negation act on digits too.  Each
// 13-bit one is exact mod 2^260 on normalized limbs (a + b; a + (4p - b);
// 4p - b, with 4p in a headroom form whose every limb but the top is
// >= 2^13 - 1, so only the top limb can wrap, and a wrap of a u32 at limb 19
// is a multiple of 2^260), and returns the normalized limbs of that
// residue.  The digit ones below compute the same residues (4p in a 26-bit
// headroom form, every digit but the top >= 2^26 - 1; a u32 wrap at digit 9
// is a multiple of 2^266) and return its normalized digits: split into
// limbs, the same words.  So a madd kept in digits from its row loads to
// its stores gives the madd in field.cuh's 13-bit limbs (ops/kernels/ec.py's
// plain madd) bit for bit on normalized inputs, and on the pipeline's (table rows < 5.3p, accumulators < 1.3p,
// subtrahends < 3p) both are the JAX package's; the same holds for the full
// add, whose extra product by d takes d*R mod p (< p) as its second input.
//
// tests/test_torch_field_ec.py reads the constants below and checks them
// against ops/kernels/common.py.
#pragma once

#include <cstdint>

#include "field.cuh"

#define MSM_LD 10              // 26-bit digits per field element
#define MSM_DW 26              // digit width in bits
#define MSM_DMASK 0x3FFFFFFu   // 2^26 - 1
#define MSM_N0D 0x3FFFFFFu     // -p^-1 mod 2^26

namespace msm {

// p, R mod p, R^2 mod p, d*R mod p (the curve's d, Montgomery form) and the
// headroom form of 4p, in 26-bit digits.  Functions, not
// arrays: device code may not read a namespace-scope constexpr array, and
// with every loop unrolled each call folds to an immediate operand.
__host__ __device__ constexpr uint32_t d_p(int i) {
  constexpr uint32_t v[MSM_LD] = {
      0x0000001, 0x0600000, 0x00010a1, 0x3fb4000, 0x159aa76,
      0x30dec00, 0x344d1e5, 0x2955982, 0x15e9a2c, 0x004aad9};
  return v[i];
}
__host__ __device__ constexpr uint32_t d_r(int i) {
  constexpr uint32_t v[MSM_LD] = {
      0x3ffff25, 0x1dfffff, 0x3f1c630, 0x0103fff, 0x04b2c34,
      0x3171bb6, 0x0207071, 0x23c6d17, 0x0121bce, 0x001d812};
  return v[i];
}
__host__ __device__ constexpr uint32_t d_r2(int i) {
  constexpr uint32_t v[MSM_LD] = {
      0x1857af1, 0x04eae18, 0x1f163e7, 0x268c164, 0x3eb2abc,
      0x15090ed, 0x300b1e7, 0x2266085, 0x364e92b, 0x001f3fd};
  return v[i];
}
__host__ __device__ constexpr uint32_t d_d(int i) {
  constexpr uint32_t v[MSM_LD] = {
      0x3f5e2f8, 0x0ffffff, 0x3d24b3f, 0x1e5ffd5, 0x03d3d4a,
      0x3d13609, 0x318c6de, 0x1153629, 0x3d5aa80, 0x0029dc5};
  return v[i];
}
__host__ __device__ constexpr uint32_t d_q4(int i) {
  constexpr uint32_t v[MSM_LD] = {
      0x4000004, 0x57fffff, 0x4004283, 0x7ecffff, 0x566a9da,
      0x437b000, 0x5134796, 0x655660a, 0x57a68b1, 0x012ab64};
  return v[i];
}

struct Fd {
  uint32_t v[MSM_LD];
};

// R mod p: the Montgomery form of 1.
__device__ __forceinline__ Fd fd_one() {
  Fd r;
#pragma unroll
  for (int i = 0; i < MSM_LD; ++i) r.v[i] = d_r(i);
  return r;
}

// R^2 mod p: a product by it takes an element into Montgomery form.
__device__ __forceinline__ Fd fd_r2() {
  Fd r;
#pragma unroll
  for (int i = 0; i < MSM_LD; ++i) r.v[i] = d_r2(i);
  return r;
}

// d*R mod p: the Montgomery form of the curve's d.
__device__ __forceinline__ Fd fd_d() {
  Fd r;
#pragma unroll
  for (int i = 0; i < MSM_LD; ++i) r.v[i] = d_d(i);
  return r;
}

__device__ __forceinline__ Fd fd_zero() {
  Fd r;
#pragma unroll
  for (int i = 0; i < MSM_LD; ++i) r.v[i] = 0;
  return r;
}

// 20 normalized 13-bit limbs, one a word (a table row's layout) -> digits.
__device__ __forceinline__ Fd fd_from_limbs(const uint32_t* l) {
  Fd r;
#pragma unroll
  for (int i = 0; i < MSM_LD; ++i) r.v[i] = l[2 * i] | (l[2 * i + 1] << MSM_W);
  return r;
}

// a or b, word by word: a select of whole structs would keep both in local
// memory and select an address.
__device__ __forceinline__ Fd fd_select(bool take_a, const Fd& a, const Fd& b) {
  Fd r;
#pragma unroll
  for (int i = 0; i < MSM_LD; ++i) r.v[i] = take_a ? a.v[i] : b.v[i];
  return r;
}

// Digits -> the 10 packed words of common.py::pack2 (limb 2i in bits 0..12,
// limb 2i+1 in bits 16..28).
__device__ __forceinline__ uint32_t fd_pack_word(uint32_t d) {
  return (d & MSM_MASK) | ((d << 3) & 0xFFFF0000u);
}

// The inverse of fd_pack_word on a word of two normalized limbs.
__device__ __forceinline__ uint32_t fd_unpack_word(uint32_t w) {
  return (w & MSM_MASK) | ((w >> 3) & (MSM_MASK << MSM_W));
}

// Every digit < 2^26; the carry out of digit 9 (bit 260) is dropped.
__device__ __forceinline__ void fd_carry_sweep(Fd& s) {
  uint32_t c = 0;
#pragma unroll
  for (int i = 0; i < MSM_LD; ++i) {
    uint32_t v = s.v[i] + c;
    s.v[i] = v & MSM_DMASK;
    c = v >> MSM_DW;
  }
}

// fr_add_lazy: a + b mod 2^260.
__device__ __forceinline__ Fd fd_add_lazy(const Fd& a, const Fd& b) {
  Fd r;
#pragma unroll
  for (int i = 0; i < MSM_LD; ++i) r.v[i] = a.v[i] + b.v[i];
  fd_carry_sweep(r);
  return r;
}

// fr_sub_lazy: a - b + 4p mod 2^260, borrow-free below the top digit.
__device__ __forceinline__ Fd fd_sub_lazy(const Fd& a, const Fd& b) {
  Fd r;
#pragma unroll
  for (int i = 0; i < MSM_LD; ++i) r.v[i] = a.v[i] + (d_q4(i) - b.v[i]);
  fd_carry_sweep(r);
  return r;
}

// fd_sub_lazy(a, b) where sub is set, else fd_add_lazy(a, b): each digit is
// a + (4p - b) or a + b, the same words as the one chosen, so a lane that
// needs one of the two (madd26_x4) computes only that.
__device__ __forceinline__ Fd fd_addsub_lazy(const Fd& a, const Fd& b, bool sub) {
  Fd r;
#pragma unroll
  for (int i = 0; i < MSM_LD; ++i) r.v[i] = a.v[i] + (sub ? d_q4(i) - b.v[i] : b.v[i]);
  fd_carry_sweep(r);
  return r;
}

// fr_neg_lazy: 4p - b mod 2^260.
__device__ __forceinline__ Fd fd_neg_lazy(const Fd& b) {
  Fd r;
#pragma unroll
  for (int i = 0; i < MSM_LD; ++i) r.v[i] = d_q4(i) - b.v[i];
  fd_carry_sweep(r);
  return r;
}

// The lazy product x*y*R^-1 (no final subtraction), on normalized digits.
// Column m of x*y is a sum of at most 10 products < 2^52, and receives at
// most 9 q*p_j < 2^52 and a carry: < 2^57, no overflow.  As in common.py,
// the carry into the next column is added before its quotient digit.
__device__ __forceinline__ Fd mont26(const Fd& x, const Fd& y) {
  uint64_t c[2 * MSM_LD];
#pragma unroll
  for (int m = 0; m < 2 * MSM_LD; ++m) c[m] = 0;
#pragma unroll
  for (int i = 0; i < MSM_LD; ++i) {
#pragma unroll
    for (int j = 0; j < MSM_LD; ++j) c[i + j] += (uint64_t)x.v[i] * y.v[j];
  }
  uint64_t carry = 0;
#pragma unroll
  for (int m = 0; m < MSM_LD; ++m) {
    const uint64_t t = c[m] + carry;
    const uint32_t q = ((uint32_t)t * MSM_N0D) & MSM_DMASK;
    carry = (t + (uint64_t)q * d_p(0)) >> MSM_DW;  // the low digit cancels
#pragma unroll
    for (int j = 1; j < MSM_LD; ++j) c[m + j] += (uint64_t)q * d_p(j);
  }
  Fd r;
#pragma unroll
  for (int m = 0; m < MSM_LD; ++m) {
    const uint64_t v = c[MSM_LD + m] + carry;
    r.v[m] = (uint32_t)v & MSM_DMASK;
    carry = v >> MSM_DW;
  }
  return r;
}

// a >= p ? a - p : a on normalized digits: field.cuh::cond_sub_p on digits.
// Both compare the integer a with p and subtract p with a borrow chain, so
// they give the same integer, and mont26_reduced below gives the limbs of
// field.cuh's mont_mul(x, y, true): mont26 and the 13-bit product give the
// same integer (above), and this subtraction then does the same to it.
__device__ __forceinline__ void fd_cond_sub_p(Fd& a) {
  bool ge = true;
  uint32_t borrow = 0;
  Fd d;
#pragma unroll
  for (int i = 0; i < MSM_LD; ++i) {
    const uint32_t p = d_p(i);
    ge = (a.v[i] > p) | ((a.v[i] == p) & ge);
    const uint32_t t = a.v[i] + (1u << MSM_DW) - p - borrow;
    borrow = 1u - (t >> MSM_DW);
    d.v[i] = t & MSM_DMASK;
  }
#pragma unroll
  for (int i = 0; i < MSM_LD; ++i) a.v[i] = ge ? d.v[i] : a.v[i];
}

// The reduced product x*y*R^-1 (mont_mul(..., true), common.py::mont_mul's
// default): mont26, then one conditional subtraction of p.
__device__ __forceinline__ Fd mont26_reduced(const Fd& x, const Fd& y) {
  Fd r = mont26(x, y);
  fd_cond_sub_p(r);
  return r;
}

}  // namespace msm
