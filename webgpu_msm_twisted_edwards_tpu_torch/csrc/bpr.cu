// Bucket-point reduction and the Horner fold over windows.
#include <cuda_runtime.h>

#include "ec.cuh"

namespace msm {

// Replaces webgpu_msm_twisted_edwards_tpu/ops/pallas/bpr.py::
// _bpr_stage1_kernel (bpr_stage1): per chunk of `chunk` buckets, scanned in
// descending order, m += S_j and g += m.
//
// Bound on the H100: operations (two full adds per bucket, about 15 K
// multiply-adds, against 256 bytes read).
// Design: one thread per chunk with m and g in registers.
__global__ void __launch_bounds__(128)
bpr_stage1_kernel(const uint32_t* __restrict__ buckets, uint32_t* __restrict__ m_out,
                  uint32_t* __restrict__ g_out, long long nc, int chunk) {
  const long long ch = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (ch >= nc) return;
  Pt m = pt_identity();
  Pt g = m;
#pragma unroll 1
  for (int i = 0; i < chunk; ++i) {
    const long long j = ch * chunk + (chunk - 1 - i);
    m = full_add(m, pt_load(buckets + j * MSM_TW));
    g = full_add(g, m);
  }
  pt_store(m_out + ch * MSM_TW, m);
  pt_store(g_out + ch * MSM_TW, g);
}

// Replaces webgpu_msm_twisted_edwards_tpu/ops/pallas/bpr.py::
// _bpr_stage2_kernel (bpr_stage2): g += m * ((lane % chunks_per_window) *
// chunk) by MSB-first double-and-add over num_bits bits, the lane being the
// global chunk index (pl.program_id * lblk + lane in the JAX kernel).
//
// Bound on the H100: operations (num_bits doublings and up to 2*num_bits+1
// full adds per chunk; the JAX kernel computes every add and selects).
// Design: one thread per chunk; the add is skipped where the bit is 0.
__global__ void __launch_bounds__(128)
bpr_stage2_kernel(const uint32_t* __restrict__ m_in, const uint32_t* __restrict__ g_in,
                  uint32_t* __restrict__ out, long long nc, long long chunks_per_window,
                  int chunk, int num_bits) {
  const long long l = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (l >= nc) return;
  const long long kfac = (l % chunks_per_window) * chunk;
  const Pt m = pt_load(m_in + l * MSM_TW);
  Pt acc = pt_identity();
#pragma unroll 1
  for (int i = 0; i < num_bits; ++i) {
    const int bit = num_bits - 1 - i;
    acc = pt_double(acc);
    if ((kfac >> bit) & 1) acc = full_add(acc, m);
  }
  pt_store(out + l * MSM_TW, full_add(pt_load(g_in + l * MSM_TW), acc));
}

#define MSM_HORNER_MAX_LANES 64

// Replaces webgpu_msm_twisted_edwards_tpu/ops/pallas/bpr.py::_horner_kernel
// (horner_fold): lane l doubles S_l min(cbits*l, cbits*(w-1)) times (the
// masked ladder: identity padding lanes double too, which changes their
// representative), then log2(lanes) rounds of p_l += p_{(l+shift) % lanes}
// leave the total in lane 0.
//
// Bound on the H100: operations, and latency: it is one block of at most 64
// threads doing about cbits*(w-1) dependent doublings.
// Design: one block of `lanes` threads, one per window; each rotation round
// exchanges points through shared memory.
__global__ void __launch_bounds__(MSM_HORNER_MAX_LANES)
horner_kernel(const uint32_t* __restrict__ sums, uint32_t* __restrict__ out, int w, int cbits,
              int lanes) {
  __shared__ Pt sh[MSM_HORNER_MAX_LANES];
  const int l = threadIdx.x;
  Pt p = pt_load(sums + l * MSM_TW);
  const int nd = min(cbits * (w - 1), cbits * l);
#pragma unroll 1
  for (int d = 0; d < nd; ++d) p = pt_double(p);
#pragma unroll 1
  for (int shift = 1; shift < lanes; shift *= 2) {
    sh[l] = p;
    __syncthreads();
    const Pt rot = sh[(l + shift) % lanes];
    __syncthreads();
    p = full_add(p, rot);
  }
  if (l == 0) pt_store(out, p);
}

}  // namespace msm

// buckets: [nc*chunk, 64] u32; m, g: [nc, 64] u32.
extern "C" int msm_bpr_stage1(const void* buckets, void* m, void* g, long long nc, long long chunk,
                              void* stream) {
  if (nc > 0) {
    const int threads = 128;
    const long long blocks = (nc + threads - 1) / threads;
    msm::bpr_stage1_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)buckets, (uint32_t*)m, (uint32_t*)g, nc, (int)chunk);
  }
  return (int)cudaGetLastError();
}

// m, g, out: [nc, 64] u32.
extern "C" int msm_bpr_stage2(const void* m, const void* g, void* out, long long nc,
                              long long chunks_per_window, long long chunk, long long num_bits,
                              void* stream) {
  if (nc > 0) {
    const int threads = 128;
    const long long blocks = (nc + threads - 1) / threads;
    msm::bpr_stage2_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)m, (const uint32_t*)g, (uint32_t*)out, nc, chunks_per_window,
        (int)chunk, (int)num_bits);
  }
  return (int)cudaGetLastError();
}

// sums: [lanes, 64] u32 (identity-padded past w); out: [1, 64] u32.
// lanes is a power of two <= 64.
extern "C" int msm_horner_fold(const void* sums, void* out, long long w, long long cbits,
                               long long lanes, void* stream) {
  if (lanes < 1 || lanes > MSM_HORNER_MAX_LANES) return (int)cudaErrorInvalidValue;
  msm::horner_kernel<<<1, (int)lanes, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)sums, (uint32_t*)out, (int)w, (int)cbits, (int)lanes);
  return (int)cudaGetLastError();
}
