// Batch affine normalization of packed projective point rows.
//
// Replaces webgpu_msm_twisted_edwards_tpu/ops/precompute.py::
// _inv_norm_kernel (normalize_rows): per row, zinv = z^(p-2) by MSB-first
// square-and-multiply from acc = R, then x*zinv and y*zinv, all reduced
// Montgomery products.  The row out holds x*R (packed, words 0..9), y*R
// (words 10..19) and zeros.
//
// Bound on the H100: operations (253 squarings and 133 multiplies for the
// set bits of p-2, plus 2: 388 products, about 326 K multiply-adds, per row
// against 512 bytes read and written).
// Design: one thread per row, z and the accumulator in registers; the
// exponent's words sit in __constant__ memory, read with one address across
// the warp.  Where a bit is 0 the multiply is skipped (the JAX kernel
// computes it and selects; the value kept is the same).  The product is a
// real call (__noinline__), as the point formulas of ec.cuh are, to keep
// the loop body small for nvcc's front end.
#include <cuda_runtime.h>

#include "ec.cuh"

#define MSM_EXP_BITS 253  // bit length of p - 2

namespace msm {

// p - 2, eight little-endian 32-bit words (checked against the field
// parameters by tests/test_torch_precompute.py).
__constant__ uint32_t C_EXP[8] = {0xffffffff, 0x0a117fff, 0xd0000001, 0x59aa76fe,
                                  0x5c37b001, 0x60b44d1e, 0x9a2ca556, 0x12ab655e};

__device__ __noinline__ Fe mont_reduced(const Fe& x, const Fe& y) { return mont_mul(x, y, true); }

__global__ void __launch_bounds__(128)
normalize_kernel(const uint32_t* __restrict__ in, uint32_t* __restrict__ out, long long n) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= n) return;
  const Pt p = pt_load(in + i * MSM_TW);
  Fe acc = fe_const(C_R);
#pragma unroll 1
  for (int b = MSM_EXP_BITS - 1; b >= 0; --b) {
    acc = mont_reduced(acc, acc);
    if ((C_EXP[b >> 5] >> (b & 31)) & 1u) acc = mont_reduced(acc, p.z);
  }
  const Fe xa = mont_reduced(p.x, acc);
  const Fe ya = mont_reduced(p.y, acc);
  uint32_t w[MSM_TW];
  pack2(xa, w);
  pack2(ya, w + MSM_LP);
#pragma unroll
  for (int k = 2 * MSM_LP; k < MSM_TW; ++k) w[k] = 0;
  uint4* r4 = reinterpret_cast<uint4*>(out + i * MSM_TW);
#pragma unroll
  for (int k = 0; k < MSM_TW / 4; ++k)
    r4[k] = make_uint4(w[4 * k], w[4 * k + 1], w[4 * k + 2], w[4 * k + 3]);
}

}  // namespace msm

// in, out: [n, 64] u32.
extern "C" int msm_normalize_rows(const void* in, void* out, long long n, void* stream) {
  if (n > 0) {
    const int threads = 128;
    const long long blocks = (n + threads - 1) / threads;
    msm::normalize_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)in, (uint32_t*)out, n);
  }
  return (int)cudaGetLastError();
}
