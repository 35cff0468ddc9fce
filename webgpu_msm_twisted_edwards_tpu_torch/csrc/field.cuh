// Field arithmetic over the ed-on-bls12-377 base field, one element per
// thread: 20 little-endian 13-bit limbs in uint32_t, Montgomery radix
// R = 2^260.
//
// Device counterpart of webgpu_msm_twisted_edwards_tpu/ops/pallas/common.py.
// Every function repeats that file's u32 arithmetic step for step (same
// wrap-around, same dropped carry out of limb 19, same lazy bounds), so the
// kernels built on it produce the JAX package's packed rows bit for bit.
// The plain PyTorch versions are in ops/kernels/common.py.
//
// Loops run over compile-time bounds and are fully unrolled, so each Fe
// lives in registers (indexing with a run-time value would move it to local
// memory).
#pragma once

#include <cstdint>

#define MSM_L 20          // limbs per field element
#define MSM_LP 10         // packed u32 words per field element (2 limbs each)
#define MSM_W 13          // limb width in bits
#define MSM_MASK 0x1FFFu  // 2^13 - 1
#define MSM_N0 0x1FFFu    // -p^-1 mod 2^13
#define MSM_TW 64         // packed point row width in u32 (40 used)
#define MSM_TWR 128       // cached-form table row width in u32 (60 used)
#define MSM_K 64          // entries per scan fragment

namespace msm {

// Columns of common.py::make_consts_array (checked against it by
// tests/test_torch_field_ec.py).
__constant__ uint32_t C_P[MSM_L] = {
    0x0001, 0x0000, 0x0000, 0x0300, 0x10a1, 0x0000, 0x0000, 0x1fda, 0x0a76, 0x0acd,
    0x0c00, 0x186f, 0x11e5, 0x1a26, 0x1982, 0x14aa, 0x1a2c, 0x0af4, 0x0ad9, 0x0025};
// R mod p
__constant__ uint32_t C_R[MSM_L] = {
    0x1f25, 0x1fff, 0x1fff, 0x0eff, 0x0630, 0x1f8e, 0x1fff, 0x0081, 0x0c34, 0x0259,
    0x1bb6, 0x18b8, 0x1071, 0x0103, 0x0d17, 0x11e3, 0x1bce, 0x0090, 0x1812, 0x000e};
// R^2 mod p
__constant__ uint32_t C_R2[MSM_L] = {
    0x1af1, 0x0c2b, 0x0e18, 0x0275, 0x03e7, 0x0f8b, 0x0164, 0x1346, 0x0abc, 0x1f59,
    0x10ed, 0x0a84, 0x11e7, 0x1805, 0x0085, 0x1133, 0x092b, 0x1b27, 0x13fd, 0x000f};
// 4p in headroom form (common.py::_q4_limbs): every limb but the top is
// >= 2^13, so q4 - b never borrows limb-wise for a subtrahend b < 3p.
__constant__ uint32_t C_Q4[MSM_L] = {
    0x2004, 0x1fff, 0x1fff, 0x2bff, 0x2283, 0x2001, 0x1fff, 0x3f67, 0x29da, 0x2b34,
    0x3000, 0x21bc, 0x2796, 0x2899, 0x260a, 0x32aa, 0x28b1, 0x2bd2, 0x2b64, 0x0094};

struct Fe {
  uint32_t v[MSM_L];
};

__device__ __forceinline__ Fe fe_const(const uint32_t* c) {
  Fe r;
#pragma unroll
  for (int i = 0; i < MSM_L; ++i) r.v[i] = c[i];
  return r;
}

__device__ __forceinline__ Fe fe_zero() {
  Fe r;
#pragma unroll
  for (int i = 0; i < MSM_L; ++i) r.v[i] = 0;
  return r;
}

// common.py::carry_sweep — every limb < 2^13; the carry out of limb 19 is
// dropped.
__device__ __forceinline__ void carry_sweep(Fe& s) {
  uint32_t c = 0;
#pragma unroll
  for (int i = 0; i < MSM_L; ++i) {
    uint32_t v = s.v[i] + c;
    s.v[i] = v & MSM_MASK;
    c = v >> MSM_W;
  }
}

// a >= p ? a - p : a, for normalized a < 2p (the JAX package's
// ops/pallas/common.py::cond_sub_p).
__device__ __forceinline__ void cond_sub_p(Fe& a) {
  bool ge = true;
  uint32_t borrow = 0;
  Fe d;
#pragma unroll
  for (int i = 0; i < MSM_L; ++i) {
    uint32_t p = C_P[i];
    ge = (a.v[i] > p) | ((a.v[i] == p) & ge);
    uint32_t t = a.v[i] + (1u << MSM_W) - p - borrow;
    borrow = 1u - (t >> MSM_W);
    d.v[i] = t & MSM_MASK;
  }
#pragma unroll
  for (int i = 0; i < MSM_L; ++i) a.v[i] = ge ? d.v[i] : a.v[i];
}

// x*y*R^-1, carry-free interleaved form (the JAX package's
// ops/pallas/common.py::mont_mul): with 13-bit limbs the accumulator absorbs
// two < 2^26 products per limb in each of the 20 iterations without
// overflowing 32 bits.  reduce=false is the lazy product of mont_many /
// mont_mul(reduce=False): no final subtraction.  common.py::mont_mul gives
// the same limbs with 26-bit quotient digits.
__device__ __forceinline__ Fe mont_mul(const Fe& x, const Fe& y, bool reduce) {
  Fe s = fe_zero();
#pragma unroll
  for (int i = 0; i < MSM_L; ++i) {
    uint32_t xi = x.v[i];
    uint32_t t = s.v[0] + xi * y.v[0];
    uint32_t qi = (MSM_N0 * (t & MSM_MASK)) & MSM_MASK;
    uint32_t c = (s.v[0] + xi * y.v[0] + qi * C_P[0]) >> MSM_W;
#pragma unroll
    for (int j = 1; j < MSM_L; ++j) {
      uint32_t u = s.v[j] + xi * y.v[j] + qi * C_P[j];
      s.v[j - 1] = (j == 1) ? u + c : u;
    }
    s.v[MSM_L - 1] = 0;
  }
  carry_sweep(s);
  if (reduce) cond_sub_p(s);
  return s;
}

__device__ __forceinline__ Fe mont_lazy(const Fe& x, const Fe& y) {
  return mont_mul(x, y, false);
}

// common.py::fr_add_lazy — a + b, carries normalized, not reduced mod p.
__device__ __forceinline__ Fe fr_add_lazy(const Fe& a, const Fe& b) {
  Fe r;
#pragma unroll
  for (int i = 0; i < MSM_L; ++i) r.v[i] = a.v[i] + b.v[i];
  carry_sweep(r);
  return r;
}

// common.py::fr_sub_lazy — a - b + 4p, borrow-free for b < 3p.
__device__ __forceinline__ Fe fr_sub_lazy(const Fe& a, const Fe& b) {
  Fe r;
#pragma unroll
  for (int i = 0; i < MSM_L; ++i) r.v[i] = a.v[i] + (C_Q4[i] - b.v[i]);
  carry_sweep(r);
  return r;
}

// common.py::fr_neg_lazy — 4p - b, borrow-free for b < 3p.
__device__ __forceinline__ Fe fr_neg_lazy(const Fe& b) {
  Fe r;
#pragma unroll
  for (int i = 0; i < MSM_L; ++i) r.v[i] = C_Q4[i] - b.v[i];
  carry_sweep(r);
  return r;
}

// common.py::pack2.
__device__ __forceinline__ void pack2(const Fe& a, uint32_t* w) {
#pragma unroll
  for (int i = 0; i < MSM_LP; ++i) w[i] = a.v[2 * i] | (a.v[2 * i + 1] << 16);
}

}  // namespace msm
