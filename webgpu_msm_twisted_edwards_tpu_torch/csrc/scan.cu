// Bucket accumulation: the default scan variants and the carry scan across
// fragments.
#include <cuda_runtime.h>

#include "ec.cuh"
#include "scan.cuh"

namespace msm {

// Replaces webgpu_msm_twisted_edwards_tpu/ops/pallas/scan.py::_ab_scan_kernel
// (ab_scan_level): per chunk of kab fragments, the exclusive scan
// C_{j+1} = (a_j ? C_j : identity) + b_j from C_0 = identity, the exclusive
// prefix-AND of a, and the chunk aggregates.
//
// Bound on the H100: operations (one full add, about 7.6 K multiply-adds,
// per fragment against 260 bytes read and written).
// Design: one thread per chunk, walking its kab rows in order.
__global__ void __launch_bounds__(128)
ab_scan_kernel(const int32_t* __restrict__ a, const uint32_t* __restrict__ b,
               uint32_t* __restrict__ c_loc, int32_t* __restrict__ apre_out,
               int32_t* __restrict__ a_agg, uint32_t* __restrict__ b_agg, long long nc, int kab) {
  const long long ch = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (ch >= nc) return;
  const Pt ident = pt_identity();
  Pt acc = ident;
  int apre = 1;
#pragma unroll 1
  for (int j = 0; j < kab; ++j) {
    const long long e = ch * kab + j;
    pt_store(c_loc + e * MSM_TW, acc);
    apre_out[e] = apre;
    const bool aj = a[e] != 0;
    acc = full_add(pt_select(aj, acc, ident), pt_load(b + e * MSM_TW));
    apre = aj ? apre : 0;
  }
  a_agg[ch] = apre;
  pt_store(b_agg + ch * MSM_TW, acc);
}

}  // namespace msm

// The scan of the main path (_msm_scan_rm_sames_kernel, msm_scan_rm_sames):
// row-major rows of the doubled table, hoisted same bits.
// rows: [nf, 64, 128] u32; sames_t: [64, nf] i32; out: [nf, 32, 128] u32.
extern "C" int msm_scan_rm_sames(const void* rows, const void* sames_t, void* out, long long nf,
                                 void* stream) {
  return msm::launch_scan<msm::ROWS_RM, msm::MASK_SAMES, 2>(rows, nullptr, sames_t, out, nf, 1,
                                                            stream);
}

// The fixed-base scan (_msm_scan_rm_signed_kernel, msm_scan_rm_signed): rows
// of the single table, bits_t: [64, nf] i32 (bit 0 same, bit 1 sign).
extern "C" int msm_scan_rm_signed(const void* rows, const void* bits_t, void* out, long long nf,
                                  void* stream) {
  return msm::launch_scan<msm::ROWS_RM, msm::MASK_SIGNED, 2>(rows, nullptr, bits_t, out, nf, 1,
                                                             stream);
}

// a: [nc*kab] i32; b: [nc*kab, 64] u32; c_loc: [nc*kab, 64] u32;
// apre: [nc*kab] i32; a_agg: [nc] i32; b_agg: [nc, 64] u32.
extern "C" int msm_ab_scan_level(const void* a, const void* b, void* c_loc, void* apre,
                                 void* a_agg, void* b_agg, long long nc, long long kab,
                                 void* stream) {
  if (nc > 0) {
    const int threads = 128;
    const long long blocks = (nc + threads - 1) / threads;
    msm::ab_scan_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        (const int32_t*)a, (const uint32_t*)b, (uint32_t*)c_loc, (int32_t*)apre,
        (int32_t*)a_agg, (uint32_t*)b_agg, nc, (int)kab);
  }
  return (int)cudaGetLastError();
}
