// Point operations over packed rows: the masked add, the quarter-store
// extraction and repeated doubling.
//
// Masked add, out_i = mask_i ? a_i + b_i : a_i.
// Replaces webgpu_msm_twisted_edwards_tpu/ops/pallas/ec.py::
// _masked_add_kernel (masked_add_rows).  The MSM uses it for bucket
// extraction, the carry apply of the carry scan, the per-window reduction
// after BPR and the combine of point blocks.
//
// Bound on the H100: operations (one full add, about 7.6 K 32-bit
// multiply-adds, per row against 772 bytes read and written).
// Design: one thread per row; a row whose mask is 0 skips the add (the JAX
// kernel computes and discards it; the stored row is the same).
#include <cuda_runtime.h>

#include "ec.cuh"

namespace msm {

__global__ void __launch_bounds__(128)
masked_add_kernel(const uint32_t* __restrict__ a, const uint32_t* __restrict__ b,
                  const int32_t* __restrict__ mask, uint32_t* __restrict__ out, long long n) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= n) return;
  Pt p = pt_load(a + i * MSM_TW);
  if (mask[i] != 0) p = full_add(p, pt_load(b + i * MSM_TW));
  pt_store(out + i * MSM_TW, p);
}

// Replaces webgpu_msm_twisted_edwards_tpu/ops/pallas/ec.py::
// _double_rows_kernel (double_rows): out_i = 2^times * in_i, the doubling
// chain of the fixed-base precompute (ops/precompute.py), c doublings per
// window over every point.
//
// Bound on the H100: operations (times doublings, 8 products or about
// 6.7 K multiply-adds each, per row against 512 bytes read and written).
// Design: one thread per row, the point in registers across the `times`
// dependent doublings; the stored row has its 24 padding words zero, as
// the JAX kernel writes them.
__global__ void __launch_bounds__(128)
double_rows_kernel(const uint32_t* __restrict__ in, uint32_t* __restrict__ out, long long n,
                   int times) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= n) return;
  Pt p = pt_load(in + i * MSM_TW);
#pragma unroll 1
  for (int k = 0; k < times; ++k) p = pt_double(p);
  pt_store(out + i * MSM_TW, p);
}

// Replaces webgpu_msm_twisted_edwards_tpu/ops/pallas/ec.py::
// _extract_reconstruct_kernel (extract_reconstruct_rows), the extraction of
// the quarter-store scan: per bucket end, the scan value at an unstored step
// replayed from the nearest stored one, then the carry added.  Bits of
// bits[i]: 1 step at 4q (restarting from the identity unless 4), 2 step at
// 4q+1 (restarting unless 8), 16 add the carry.
//
// Bound on the H100: operations (up to two madds and one full add, about
// 19 K multiply-adds, per row against at most 804 used bytes read and 256
// written).
// Design: one thread per row; a step or the carry add whose bit is clear is
// skipped (the JAX kernel computes and discards it; the stored row is the
// same), and the stored row has its 24 padding words zero.
__global__ void __launch_bounds__(128)
extract_reconstruct_kernel(const uint32_t* __restrict__ base, const uint32_t* __restrict__ pair,
                           const int32_t* __restrict__ bits, const uint32_t* __restrict__ carry,
                           uint32_t* __restrict__ out, long long n, long long twr) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int b = bits[i];
  const Pt ident = pt_identity();
  Pt v = pt_load(base + i * MSM_TW);
  const uint32_t* rows = pair + i * 2 * twr;
#pragma unroll 1
  for (int s = 0; s < 2; ++s) {
    if (b & (1 << s)) {
      Fe d2, s2, td2;
      load_cached(rows + s * twr, d2, s2, td2);
      v = madd(pt_select((b & (4 << s)) != 0, v, ident), d2, s2, td2);
    }
  }
  if (b & 16) v = full_add(v, pt_load(carry + i * MSM_TW));
  pt_store(out + i * MSM_TW, v);
}

}  // namespace msm

// a, b, out: [n, 64] u32; mask: [n] i32.
extern "C" int msm_masked_add_rows(const void* a, const void* b, const void* mask, void* out,
                                   long long n, void* stream) {
  if (n > 0) {
    const int threads = 128;
    const long long blocks = (n + threads - 1) / threads;
    msm::masked_add_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)a, (const uint32_t*)b, (const int32_t*)mask, (uint32_t*)out, n);
  }
  return (int)cudaGetLastError();
}

// base, carry, out: [n, 64] u32; pair: [n, 2*twr] u32 (twr % 4 == 0,
// twr >= 60); bits: [n] i32.
extern "C" int msm_extract_reconstruct_rows(const void* base, const void* pair, const void* bits,
                                            const void* carry, void* out, long long n,
                                            long long twr, void* stream) {
  if (n > 0) {
    const int threads = 128;
    const long long blocks = (n + threads - 1) / threads;
    msm::extract_reconstruct_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)base, (const uint32_t*)pair, (const int32_t*)bits,
        (const uint32_t*)carry, (uint32_t*)out, n, twr);
  }
  return (int)cudaGetLastError();
}

// in, out: [n, 64] u32.
extern "C" int msm_double_rows(const void* in, void* out, long long n, long long times,
                               void* stream) {
  if (n > 0) {
    const int threads = 128;
    const long long blocks = (n + threads - 1) / threads;
    msm::double_rows_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)in, (uint32_t*)out, n, (int)times);
  }
  return (int)cudaGetLastError();
}
