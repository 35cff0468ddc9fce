// The scans of the measurement probes in experiments/: probe_scan_kernel and
// scan_dual_kernel, beside the pipeline's scan_kernel (csrc/scan.cuh, whose
// recurrence, bound and design they share).
//
// Replaces scan_out_probe.py's kern64 / kern128, scan_tune_probe.py's
// _kern_dual, scan_floor_probe.py's _kern (csrc/probe_scan.cu) and
// dma_gather_probe.py's _dma_scan_kernel (csrc/probe_move.cu).
//
// They keep out of scan_kernel: with their choices as branches of its body,
// ptxas gave five of the pipeline's six instantiations in
// csrc/scan_variants.cu other register counts (msm_scan_keys 168 -> 196, so
// 2 blocks a SM, not 3).  Their choices, beyond scan_kernel's ROWS, MASK and
// STORE:
// - ROWS_DMA: the ROWS_TABLE row, prefetched one step ahead into shared
//   memory: step j+1's 60 words go into the thread's other slot with 16-byte
//   cp.async while step j's madd runs (two slots of 240 bytes a thread; a
//   thread waits only on its own copies, so no block barrier).
// - MASK_KEYS_SGN: the key compare, and a second [64, nf] word sgn_t[j, f]:
//   where it is not 0, words 0..19 and 40..59 of the row become 4p - v,
//   swept, with no swap (the probes' older cached layout).
// - STORE 1: every step in its own 64-word row, out[f, j, ..] ([nf, 64, 64]).
// - OPT, the ablations of scan_floor_probe.py (OPT_NOSEL no segment select,
//   OPT_NOWRITE only the last pair stored, OPT_HOIST step 0's row at every
//   step: re-read from L1 each step, since the 60 words held in registers
//   took 255 registers a thread, a third of the SM's threads), OPT_OCC3 (at
//   most 168 registers, so 3 blocks of 128 threads a SM: the occupancy of
//   the scan they ablate), and OPT_DUAL (scan_dual_kernel: two fragments per
//   thread, f and f + nf/2) with OPT_FUSE (their two madds in one call,
//   madd2).
#pragma once

#include <cuda_runtime.h>

#include "ec.cuh"
#include "scan.cuh"

namespace msm {

constexpr int ROWS_DMA = 3;
constexpr int MASK_KEYS_SGN = 3;

enum ScanOpt {
  OPT_NOSEL = 1,
  OPT_NOWRITE = 2,
  OPT_HOIST = 4,
  OPT_DUAL = 8,
  OPT_FUSE = 16,
  OPT_OCC3 = 32,
};

// Words of one fragment's output.
template <int STORE>
__host__ __device__ constexpr long long scan_out_words() {
  return STORE == 1 ? MSM_K * MSM_TW : (MSM_K / STORE) * 2 * MSM_TW;
}

// 16-byte cp.async (global -> shared, L2 only) and its group waits.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(
                   (unsigned)__cvta_generic_to_shared(smem)),
               "l"(gmem)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// ROWS_DMA's slot s of this thread: [2][blockDim][60] words of dynamic
// shared memory (a 240-byte stride keeps a quarter-warp's 16-byte reads on
// distinct banks).
extern __shared__ __align__(16) uint32_t scan_stage[];
__device__ __forceinline__ uint32_t* dma_slot(int s) {
  return scan_stage + (s * blockDim.x + threadIdx.x) * (3 * MSM_L);
}

// Copy the 60 used words of table row pidx_t[j, f] into slot j % 2.
__device__ __forceinline__ void dma_issue(const uint32_t* table, const int32_t* pidx_t,
                                          long long nf, long long f, int j) {
  const uint32_t* row = table + (long long)pidx_t[j * nf + f] * MSM_TWR;
  uint32_t* slot = dma_slot(j & 1);
#pragma unroll
  for (int q = 0; q < 3 * MSM_L / 4; ++q) cp_async16(slot + 4 * q, row + 4 * q);
}

template <int ROWS>
__device__ __forceinline__ const uint32_t* frag_rows(const uint32_t* rows, long long f,
                                                     long long lblk) {
  if constexpr (ROWS == ROWS_RM) return rows + f * (long long)(MSM_K * MSM_TWR);
  if constexpr (ROWS == ROWS_PRET) return rows + (f / lblk) * (MSM_K * 64 * lblk) + f % lblk;
  return rows;
}

// The cached form of step j's row of fragment f (frag from frag_rows).
template <int ROWS>
__device__ __forceinline__ void load_step(const uint32_t* rows, const uint32_t* frag,
                                          const int32_t* pidx_t, long long nf, long long f,
                                          int j, long long lblk, Fe& d2, Fe& s2, Fe& td2) {
  if constexpr (ROWS == ROWS_PRET) {
    const uint32_t* col = frag + j * 64 * lblk;
#pragma unroll
    for (int i = 0; i < MSM_L; ++i) {
      d2.v[i] = col[i * lblk];
      s2.v[i] = col[(MSM_L + i) * lblk];
      td2.v[i] = col[(2 * MSM_L + i) * lblk];
    }
  } else if constexpr (ROWS == ROWS_DMA) {
    if (j + 1 < MSM_K) dma_issue(rows, pidx_t, nf, f, j + 1);
    cp_async_commit();
    cp_async_wait<1>();
    load_cached(dma_slot(j & 1), d2, s2, td2);
  } else {
    const uint32_t* row =
        ROWS == ROWS_RM ? frag + j * MSM_TWR : rows + (long long)pidx_t[j * nf + f] * MSM_TWR;
    load_cached(row, d2, s2, td2);
  }
}

// The same-segment bit of entry e = j*nf + f, and the mask's effect on the
// row.
template <int MASK>
__device__ __forceinline__ bool step_mask(const int32_t* aux_t, const int32_t* sgn_t,
                                          long long e, int& kprev, Fe& d2, Fe& s2, Fe& td2) {
  const int aux = aux_t[e];
  if constexpr (MASK == MASK_KEYS || MASK == MASK_KEYS_SGN) {
    if constexpr (MASK == MASK_KEYS_SGN) {
      if (sgn_t[e] != 0) {
        d2 = fr_neg_lazy(d2);
        td2 = fr_neg_lazy(td2);
      }
    }
    const bool same = aux == kprev;
    kprev = aux;
    return same;
  } else if constexpr (MASK == MASK_SAMES) {
    return aux != 0;
  } else {
    if (aux & 2) {
      const Fe t = d2;
      d2 = s2;
      s2 = t;
      td2 = fr_neg_lazy(td2);
    }
    return (aux & 1) != 0;
  }
}

template <int STORE>
__device__ __forceinline__ void store_step(uint32_t* dst, int j, const Pt& acc) {
  if constexpr (STORE == 1) {
    pt_store(dst + j * MSM_TW, acc);
  } else if constexpr (STORE == 2) {
    pt_store(dst + (j >> 1) * (2 * MSM_TW) + (j & 1) * MSM_TW, acc);
  } else if ((j & 3) >= 2) {
    pt_store(dst + (j >> 2) * (2 * MSM_TW) + ((j & 3) - 2) * MSM_TW, acc);
  }
}

// scan_tune_probe.py::_madd2 with fuse: the two mixed adds of a thread in
// one call, their products side by side.  This is the probe's own formula
// (A = X1*x2, B = Y1*y2, C = T1*td2, E = (X1+Y1)*(x2+y2) - (A+B), D = Z1;
// 8 products), not madd's: its representatives differ from msm_scan's.
// A real call for the same reason as madd (ec.cuh).
__device__ __noinline__ void madd2(const Pt& pa, const Fe& xa, const Fe& ya, const Fe& tda,
                                   const Pt& pb, const Fe& xb, const Fe& yb, const Fe& tdb,
                                   Pt& ra, Pt& rb) {
  Fe s1a = fr_add_lazy(pa.x, pa.y), s2a = fr_add_lazy(xa, ya);
  Fe s1b = fr_add_lazy(pb.x, pb.y), s2b = fr_add_lazy(xb, yb);
  Fe a1 = mont_lazy(pa.x, xa), b1 = mont_lazy(pa.y, ya), c1 = mont_lazy(pa.t, tda),
     e1 = mont_lazy(s1a, s2a);
  Fe a2 = mont_lazy(pb.x, xb), b2 = mont_lazy(pb.y, yb), c2 = mont_lazy(pb.t, tdb),
     e2 = mont_lazy(s1b, s2b);
  Fe h1 = fr_add_lazy(a1, b1), h2 = fr_add_lazy(a2, b2);
  Fe ex1 = fr_sub_lazy(e1, h1), f1 = fr_sub_lazy(pa.z, c1);
  Fe ex2 = fr_sub_lazy(e2, h2), f2 = fr_sub_lazy(pb.z, c2);
  Fe g1 = fr_add_lazy(pa.z, c1), g2 = fr_add_lazy(pb.z, c2);
  ra.x = mont_lazy(ex1, f1);
  ra.y = mont_lazy(g1, h1);
  ra.t = mont_lazy(ex1, h1);
  ra.z = mont_lazy(f1, g1);
  rb.x = mont_lazy(ex2, f2);
  rb.y = mont_lazy(g2, h2);
  rb.t = mont_lazy(ex2, h2);
  rb.z = mont_lazy(f2, g2);
}

template <int ROWS, int MASK, int STORE, int OPT>
__global__ void __launch_bounds__(128, (OPT & OPT_OCC3) ? 3 : 1)
probe_scan_kernel(const uint32_t* __restrict__ rows, const int32_t* __restrict__ pidx_t,
                  const int32_t* __restrict__ aux_t, const int32_t* __restrict__ sgn_t,
                  uint32_t* __restrict__ out, long long nf, long long lblk) {
  const long long f = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (f >= nf) return;
  const Pt ident = pt_identity();
  Pt acc = ident;
  int kprev = -1;
  const uint32_t* frag = frag_rows<ROWS>(rows, f, lblk);
  uint32_t* dst = out + f * scan_out_words<STORE>();
  if constexpr (ROWS == ROWS_DMA) {
    dma_issue(rows, pidx_t, nf, f, 0);
    cp_async_commit();
  }
#pragma unroll 1
  for (int j = 0; j < MSM_K; ++j) {
    Fe d2, s2, td2;
    int step = j;
    // OPT_HOIST: step 0's row at every step, its index hidden from the
    // optimizer so that the load stays in the loop (an L1 hit after step 0).
    if constexpr ((OPT & OPT_HOIST) != 0) asm volatile("mov.u32 %0, 0;" : "=r"(step));
    load_step<ROWS>(rows, frag, pidx_t, nf, f, step, lblk, d2, s2, td2);
    if constexpr ((OPT & OPT_NOSEL) != 0) {
      acc = madd(acc, d2, s2, td2);
    } else {
      const bool same = step_mask<MASK>(aux_t, sgn_t, j * nf + f, kprev, d2, s2, td2);
      acc = madd(pt_select(same, acc, ident), d2, s2, td2);
    }
    if (!(OPT & OPT_NOWRITE) || j >= MSM_K - 2) store_step<STORE>(dst, j, acc);
  }
}

// OPT_DUAL: thread f scans fragments f and f + nf/2 side by side (nf even),
// with two madd calls, or one madd2 under OPT_FUSE.
template <int ROWS, int MASK, int STORE, int OPT>
__global__ void __launch_bounds__(128)
scan_dual_kernel(const uint32_t* __restrict__ rows, const int32_t* __restrict__ pidx_t,
                 const int32_t* __restrict__ aux_t, const int32_t* __restrict__ sgn_t,
                 uint32_t* __restrict__ out, long long nf, long long lblk) {
  static_assert(ROWS == ROWS_RM || ROWS == ROWS_PRET, "dual scans read rm or pret rows");
  const long long fa = blockIdx.x * (long long)blockDim.x + threadIdx.x, fb = fa + nf / 2;
  if (fa >= nf / 2) return;
  const Pt ident = pt_identity();
  Pt acc_a = ident, acc_b = ident;
  int kprev_a = -1, kprev_b = -1;
  const uint32_t* frag_a = frag_rows<ROWS>(rows, fa, lblk);
  const uint32_t* frag_b = frag_rows<ROWS>(rows, fb, lblk);
  uint32_t* dst_a = out + fa * scan_out_words<STORE>();
  uint32_t* dst_b = out + fb * scan_out_words<STORE>();
#pragma unroll 1
  for (int j = 0; j < MSM_K; ++j) {
    Fe da, sa, ta, db, sb, tb;
    load_step<ROWS>(rows, frag_a, pidx_t, nf, fa, j, lblk, da, sa, ta);
    load_step<ROWS>(rows, frag_b, pidx_t, nf, fb, j, lblk, db, sb, tb);
    const bool same_a = step_mask<MASK>(aux_t, sgn_t, j * nf + fa, kprev_a, da, sa, ta);
    const bool same_b = step_mask<MASK>(aux_t, sgn_t, j * nf + fb, kprev_b, db, sb, tb);
    const Pt pa = pt_select(same_a, acc_a, ident), pb = pt_select(same_b, acc_b, ident);
    if constexpr ((OPT & OPT_FUSE) != 0) {
      madd2(pa, da, sa, ta, pb, db, sb, tb, acc_a, acc_b);
    } else {
      acc_a = madd(pa, da, sa, ta);
      acc_b = madd(pb, db, sb, tb);
    }
    store_step<STORE>(dst_a, j, acc_a);
    store_step<STORE>(dst_b, j, acc_b);
  }
}

// rows: as ROWS (the table for ROWS_TABLE and ROWS_DMA); pidx_t: [64, nf]
// i32 table rows (ROWS_TABLE and ROWS_DMA, else null); aux_t: [64, nf] i32;
// sgn_t: [64, nf] i32 (MASK_KEYS_SGN, else null); out: [nf, 64/STORE, 128]
// u32 ([nf, 64, 64] for STORE 1); lblk: the limb-major block (ROWS_PRET
// only).
template <int ROWS, int MASK, int STORE, int OPT>
static int launch_probe_scan(const void* rows, const void* pidx_t, const void* aux_t,
                             const void* sgn_t, void* out, long long nf, long long lblk,
                             void* stream) {
  constexpr bool dual = (OPT & OPT_DUAL) != 0;
  const int threads = 128;
  const long long lanes = dual ? nf / 2 : nf;
  if (lanes > 0) {
    const long long blocks = (lanes + threads - 1) / threads;
    void (*kernel)(const uint32_t*, const int32_t*, const int32_t*, const int32_t*, uint32_t*,
                   long long, long long);
    if constexpr (dual) {
      kernel = scan_dual_kernel<ROWS, MASK, STORE, OPT>;
    } else {
      kernel = probe_scan_kernel<ROWS, MASK, STORE, OPT>;
    }
    int smem = 0;
    if constexpr (ROWS == ROWS_DMA) {
      smem = 2 * threads * 3 * MSM_L * 4;
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    }
    kernel<<<blocks, threads, smem, (cudaStream_t)stream>>>(
        (const uint32_t*)rows, (const int32_t*)pidx_t, (const int32_t*)aux_t,
        (const int32_t*)sgn_t, (uint32_t*)out, nf, lblk);
  }
  return (int)cudaGetLastError();
}

}  // namespace msm
