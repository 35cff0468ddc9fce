// Bucket accumulation: the scans of the main path and of the fixed base, and
// the carry scan across fragments.
#include <cuda_runtime.h>

#include "ec26.cuh"
#include "scan.cuh"

namespace msm {

// Lanes a chunk, and threads a block: level 0 of the carry scan at 2^20
// points has 4096 chunks, so 512 one-warp blocks, about four on each SM.
constexpr int AB_LANES = 4;
constexpr int AB_THREADS = 32;

// Replaces webgpu_msm_twisted_edwards_tpu/ops/pallas/scan.py::_ab_scan_kernel
// (ab_scan_level): per chunk of kab fragments, the exclusive scan
// C_{j+1} = (a_j ? C_j : identity) + b_j from C_0 = identity, the exclusive
// prefix-AND of a, and the chunk aggregates.
//
// Bound on the H100: by count, operations (one full add, 9 products, per
// fragment against 260 bytes read and written); in fact latency: each chunk
// is a chain of kab = 64 dependent full adds, and a level has at most 4096
// chunks (4096, 64 and 1 at 2^20 points).
// Design: the chain is what counts, so each add is shortened and kept in
// registers.  Four lanes share a chunk and its add (full_add26_x4,
// csrc/ec26.cuh: 3 dependent products where one thread has 9), inlined,
// the point in 26-bit digits from the b row loads to the c_loc and b_agg
// stores: no call and no stack frame.  Occupancy does not matter at so few
// threads, so a thread may take all 255 registers (__maxnreg__), and
// ptxas need not spill the chain to make room.  Step j+1's b row and a flag
// are loaded before step j's add, off the chain; the last step loads its
// own row again rather than branch.  Lane 0 of a chunk stores.  The
// chunk's rows are walked in order, so the adds are the JAX package's, in
// its order.
__global__ void __maxnreg__(255)
ab_scan_kernel(const int32_t* __restrict__ a, const uint32_t* __restrict__ b,
               uint32_t* __restrict__ c_loc, int32_t* __restrict__ apre_out,
               int32_t* __restrict__ a_agg, uint32_t* __restrict__ b_agg, long long nc, int kab) {
  const long long t = blockIdx.x * (long long)AB_THREADS + threadIdx.x;
  const int q = threadIdx.x & (AB_LANES - 1);
  // Lanes past the last chunk repeat it, for the shuffles, and store nothing.
  const bool store = t / AB_LANES < nc && q == 0;
  const long long ch = min(t / AB_LANES, nc - 1);
  const PtD ident = ptd_identity();
  const long long e0 = ch * kab;
  PtD acc = ident;
  int apre = 1;
  PtD bnext = ptd_load_packed(b + e0 * MSM_TW);
  int anext = a[e0];
#pragma unroll 1
  for (int j = 0; j < kab; ++j) {
    const long long e = e0 + j;
    const PtD bj = bnext;
    const bool aj = anext != 0;
    const long long en = e0 + min(j + 1, kab - 1);
    bnext = ptd_load_packed(b + en * MSM_TW);
    anext = a[en];
    if (store) {
      ptd_store_packed(c_loc + e * MSM_TW, acc);
      apre_out[e] = apre;
    }
    acc = full_add26_x4(ptd_select(aj, acc, ident), bj, q);
    apre = aj ? apre : 0;
  }
  if (store) {
    a_agg[ch] = apre;
    ptd_store_packed(b_agg + ch * MSM_TW, acc);
  }
}

}  // namespace msm

// The scan of the main path (_msm_scan_fused_kernel, msm_scan_fused): step
// j of fragment f reads row pidx[j*psj + f*psf] of the doubled table, keys
// compared.  table: [ns, 128] u32; pidx: i32 rows in [0, ns); keys_t:
// [64, nf] i32; out: [nf, 32, 128] u32.
extern "C" int msm_scan_fused(const void* table, const void* pidx, long long psj, long long psf,
                              const void* keys_t, void* out, long long nf, void* stream) {
  return msm::launch_scan<msm::ROWS_TABLE, msm::MASK_KEYS, 2>(
      table, pidx, psj, psf, keys_t, out, nf, 1, stream);
}

// The fixed-base scan (_msm_scan_rm_signed_kernel, msm_scan_rm_signed) with
// the row gather folded in: rows of the single table by index, bits_t:
// [64, nf] i32 (bit 0 same, bit 1 sign).
extern "C" int msm_scan_table_signed(const void* table, const void* pidx, long long psj,
                                     long long psf, const void* bits_t, void* out, long long nf,
                                     void* stream) {
  return msm::launch_scan<msm::ROWS_TABLE, msm::MASK_SIGNED, 2>(
      table, pidx, psj, psf, bits_t, out, nf, 1, stream);
}

// _msm_scan_rm_sames_kernel (msm_scan_rm_sames) on gathered rows.
// rows: [nf, 64, 128] u32; sames_t: [64, nf] i32; out: [nf, 32, 128] u32.
extern "C" int msm_scan_rm_sames(const void* rows, const void* sames_t, void* out, long long nf,
                                 void* stream) {
  return msm::launch_scan<msm::ROWS_RM, msm::MASK_SAMES, 2>(
      rows, nullptr, 0, 0, sames_t, out, nf, 1, stream);
}

// _msm_scan_rm_signed_kernel (msm_scan_rm_signed) on gathered rows of the
// single table, bits_t: [64, nf] i32 (bit 0 same, bit 1 sign).
extern "C" int msm_scan_rm_signed(const void* rows, const void* bits_t, void* out, long long nf,
                                  void* stream) {
  return msm::launch_scan<msm::ROWS_RM, msm::MASK_SIGNED, 2>(
      rows, nullptr, 0, 0, bits_t, out, nf, 1, stream);
}

// a: [nc*kab] i32; b: [nc*kab, 64] u32; c_loc: [nc*kab, 64] u32;
// apre: [nc*kab] i32; a_agg: [nc] i32; b_agg: [nc, 64] u32.
extern "C" int msm_ab_scan_level(const void* a, const void* b, void* c_loc, void* apre,
                                 void* a_agg, void* b_agg, long long nc, long long kab,
                                 void* stream) {
  if (nc > 0) {
    const long long blocks = (nc * msm::AB_LANES + msm::AB_THREADS - 1) / msm::AB_THREADS;
    msm::ab_scan_kernel<<<blocks, msm::AB_THREADS, 0, (cudaStream_t)stream>>>(
        (const int32_t*)a, (const uint32_t*)b, (uint32_t*)c_loc, (int32_t*)apre,
        (int32_t*)a_agg, (uint32_t*)b_agg, nc, (int)kab);
  }
  return (int)cudaGetLastError();
}
