// Bucket accumulation: the in-fragment segmented scan and the carry scan
// across fragments.
#include <cuda_runtime.h>

#include "ec.cuh"

namespace msm {

// Replaces webgpu_msm_twisted_edwards_tpu/ops/pallas/scan.py::
// _msm_scan_rm_sames_kernel (msm_scan_rm_sames, SIGNED = false), the hot loop
// of the MSM: one mixed add per (window, point) entry; and ::
// _msm_scan_rm_signed_kernel (msm_scan_rm_signed, SIGNED = true), the same
// scan over rows of the single (non-negated) table of the fixed-base path.
//
// Per 64-entry fragment f and step j: acc = madd(same ? acc : identity,
// row); the inclusive value after step j is stored packed at
// out[f, j/2, (j%2)*64 .. +64], two steps per 128-word row.  The step word
// bits_t[j, f] is the same-as-previous flag; SIGNED, it is bit 0 and bit 1
// is the digit's sign: a negative entry adds the negated point, whose cached
// form swaps y-x with y+x and negates 2*d*t (4p - v, borrow-free for the
// table's v < 3p).
//
// Bound on the H100: operations (7 Montgomery products, about 5.9 K 32-bit
// multiply-adds, per entry against 244 bytes read and 256 written).
// Design: one thread per fragment, the accumulator in registers for all 64
// steps, 16-byte loads of the 60 used words of each table row and 16-byte
// stores; row offsets are 64-bit (f*64*128 passes 2^31 at 2^20 points).
template <bool SIGNED>
__global__ void __launch_bounds__(128)
scan_rm_kernel(const uint32_t* __restrict__ rows, const int32_t* __restrict__ bits_t,
               uint32_t* __restrict__ out, long long nf) {
  const long long f = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (f >= nf) return;
  const Pt ident = pt_identity();
  Pt acc = ident;
  const uint32_t* frag = rows + f * (long long)(MSM_K * MSM_TWR);
  uint32_t* dst = out + f * (long long)((MSM_K / 2) * 2 * MSM_TW);
#pragma unroll 1
  for (int j = 0; j < MSM_K; ++j) {
    uint32_t w[3 * MSM_L];
    const uint4* r4 = reinterpret_cast<const uint4*>(frag + j * MSM_TWR);
#pragma unroll
    for (int i = 0; i < 3 * MSM_L / 4; ++i) {
      uint4 q = r4[i];
      w[4 * i] = q.x;
      w[4 * i + 1] = q.y;
      w[4 * i + 2] = q.z;
      w[4 * i + 3] = q.w;
    }
    Fe d2, s2, td2;
#pragma unroll
    for (int i = 0; i < MSM_L; ++i) {
      d2.v[i] = w[i];
      s2.v[i] = w[MSM_L + i];
      td2.v[i] = w[2 * MSM_L + i];
    }
    const int bits = bits_t[j * nf + f];
    if (SIGNED && (bits & 2)) {
      const Fe t = d2;
      d2 = s2;
      s2 = t;
      td2 = fr_neg_lazy(td2);
    }
    const bool same = SIGNED ? (bits & 1) != 0 : bits != 0;
    acc = madd(pt_select(same, acc, ident), d2, s2, td2);
    pt_store(dst + (j >> 1) * (2 * MSM_TW) + (j & 1) * MSM_TW, acc);
  }
}

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

namespace msm {

template <bool SIGNED>
static int launch_scan_rm(const void* rows, const void* bits_t, void* out, long long nf,
                          void* stream) {
  if (nf > 0) {
    const int threads = 128;
    const long long blocks = (nf + threads - 1) / threads;
    scan_rm_kernel<SIGNED><<<blocks, threads, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)rows, (const int32_t*)bits_t, (uint32_t*)out, nf);
  }
  return (int)cudaGetLastError();
}

}  // namespace msm

// rows: [nf, 64, 128] u32; sames_t: [64, nf] i32; out: [nf, 32, 128] u32.
extern "C" int msm_scan_rm_sames(const void* rows, const void* sames_t, void* out, long long nf,
                                 void* stream) {
  return msm::launch_scan_rm<false>(rows, sames_t, out, nf, stream);
}

// As msm_scan_rm_sames, with bits_t: [64, nf] i32 (bit 0 same, bit 1 sign).
extern "C" int msm_scan_rm_signed(const void* rows, const void* bits_t, void* out, long long nf,
                                  void* stream) {
  return msm::launch_scan_rm<true>(rows, bits_t, out, nf, stream);
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
