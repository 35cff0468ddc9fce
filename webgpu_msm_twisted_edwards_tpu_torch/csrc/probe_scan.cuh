// The scans of the measurement probes in experiments/: probe_scan_kernel and
// scan_dual_kernel, beside the pipeline's scan_kernel (csrc/scan.cuh, whose
// recurrence, bound and design they share).
//
// Replaces scan_out_probe.py's kern64 / kern128, scan_tune_probe.py's
// _kern_dual, scan_floor_probe.py's _kern (csrc/probe_scan.cu) and
// dma_gather_probe.py's _dma_scan_kernel (csrc/probe_move.cu).
//
// Design: scan_kernel's.  One thread a fragment, the accumulator in the
// 26-bit digits of csrc/field26.cuh from the row loads to the stores, madd26
// (csrc/ec26.cuh) inlined: no call and no stack frame.  Every stored step
// goes through the warp's staging slots (warp_store_rows), and the last
// warp's lanes past nf recompute fragment nf - 1 and store nothing.  The
// launch geometry is scan_kernel's (SCAN_THREADS, SCAN_MIN_BLOCKS), so the
// floor probe's control runs at the occupancy of the scan it ablates; only
// ROWS_DMA and the dual scans take another (ProbeBlocks).  The digit
// operations give the 13-bit ones' words (field26.cuh), so the outputs are
// the plain versions' bit for bit on any normalized limbs, the probes'
// random 13-bit rows included.
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
//   where it is not 0, y-x and 2*d*t of the row become 4p - v, swept, with no
//   swap (the probes' older cached layout).
// - STORE 1: every step in its own 64-word row, out[f, j, ..] ([nf, 64, 64]).
// - OPT, the ablations of scan_floor_probe.py: OPT_NOSEL no segment select,
//   OPT_NOWRITE only the last pair stored, OPT_HOIST step 0's row at every
//   step (re-read each step, an L1 hit after step 0: held in registers its
//   30 digits would stay live across the whole loop of a thread held to 128
//   registers, and the ablation would change the register allocation it is
//   meant to hold fixed); and OPT_DUAL (scan_dual_kernel: two fragments a
//   thread, f and f + nf/2) with OPT_FUSE (scan_tune_probe.py's G8 formula,
//   madd_g8, in place of madd).
#pragma once

#include <cuda_runtime.h>

#include "ec26.cuh"
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
};

// Blocks a SM (of SCAN_THREADS threads) that each instantiation is compiled
// for.  ROWS_DMA: its 30 KB of prefetch slots and scan_kernel's 11 KB of
// staging slots make 42 KB a block, so 5 blocks fit the SM's 228 KB of shared
// memory (1 KB a block reserved), not 8.  The dual scans hold two
// accumulators and two rows, about 140 live words: at 4 blocks ptxas may give
// each thread all 255 registers.  On an H100, 2 blocks compiled to the same
// code as 4, and 6 and 8 spilled into a stack frame (PERF.md).
constexpr int DMA_MIN_BLOCKS = 5;
constexpr int DUAL_MIN_BLOCKS = 4;

template <int ROWS, int OPT>
struct ProbeBlocks {
  static constexpr int value = (OPT & OPT_DUAL) != 0 ? DUAL_MIN_BLOCKS
                               : ROWS == ROWS_DMA    ? DMA_MIN_BLOCKS
                                                     : SCAN_MIN_BLOCKS;
};

// Words of one fragment's output ([64, 64] for STORE 1, [32, 128] for 2).
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

// Fragment f's first row word.  ROWS_PRET divides in 32 bits (f < nf <
// 2^31): a 64-bit / or % compiles to a call.
template <int ROWS>
__device__ __forceinline__ const uint32_t* frag_rows(const uint32_t* rows, long long f,
                                                     long long lblk) {
  if constexpr (ROWS == ROWS_RM) return rows + f * (long long)(MSM_K * MSM_TWR);
  if constexpr (ROWS == ROWS_PRET) {
    const unsigned fi = (unsigned)f, lb = (unsigned)lblk;
    return rows + (long long)(fi / lb) * (MSM_K * 64 * lblk) + fi % lb;
  }
  return rows;
}

// The cached form of step j's row of fragment f (frag from frag_rows), as
// digits.
template <int ROWS>
__device__ __forceinline__ void load_step(const uint32_t* rows, const uint32_t* frag,
                                          const int32_t* pidx_t, long long nf, long long f,
                                          int j, long long lblk, Fd& d2, Fd& s2, Fd& td2) {
  static_assert(ROWS == ROWS_RM || ROWS == ROWS_PRET || ROWS == ROWS_DMA, "probe rows");
  if constexpr (ROWS == ROWS_PRET) {
    const uint32_t* col = frag + j * 64 * lblk;
    uint32_t w[3 * MSM_L];
#pragma unroll
    for (int i = 0; i < 3 * MSM_L; ++i) w[i] = col[i * lblk];
    d2 = fd_from_limbs(w);
    s2 = fd_from_limbs(w + MSM_L);
    td2 = fd_from_limbs(w + 2 * MSM_L);
  } else if constexpr (ROWS == ROWS_DMA) {
    if (j + 1 < MSM_K) dma_issue(rows, pidx_t, nf, f, j + 1);
    cp_async_commit();
    cp_async_wait<1>();
    load_cached26(dma_slot(j & 1), d2, s2, td2);
  } else {
    load_cached26(frag + j * MSM_TWR, d2, s2, td2);
  }
}

// The same-segment bit of entry e = j*nf + f, and the sign word's effect on
// the row (MASK_KEYS_SGN).
template <int MASK>
__device__ __forceinline__ bool step_same(const int32_t* aux_t, const int32_t* sgn_t,
                                          long long e, int& kprev, Fd& d2, Fd& td2) {
  static_assert(MASK == MASK_KEYS || MASK == MASK_SAMES || MASK == MASK_KEYS_SGN, "probe mask");
  const int aux = aux_t[e];
  if constexpr (MASK == MASK_SAMES) {
    return aux != 0;
  } else {
    if constexpr (MASK == MASK_KEYS_SGN) {
      if (sgn_t[e] != 0) {
        d2 = fd_neg_lazy(d2);
        td2 = fd_neg_lazy(td2);
      }
    }
    const bool same = aux == kprev;
    kprev = aux;
    return same;
  }
}

// The output row of step j, from a fragment's first word dst.
template <int STORE>
__device__ __forceinline__ uint32_t* step_row(uint32_t* dst, int j) {
  static_assert(STORE == 1 || STORE == 2, "probe stores");
  return STORE == 1 ? dst + j * MSM_TW : dst + (j >> 1) * (2 * MSM_TW) + (j & 1) * MSM_TW;
}

// scan_tune_probe.py::madd_g8 (the JAX probe's _madd2 with fuse) for one
// fragment, its operations in its order: A = X1*x2, B = Y1*y2, C = T1*td2,
// E = (X1+Y1)*(x2+y2) - (A+B), F = Z1 - C, G = Z1 + C, H = A + B, then
// (EF, GH, EH, FG).  8 products, not madd's 7: its representatives differ
// from msm_scan's.
__device__ __forceinline__ PtD madd_g8(const PtD& p1, const Fd& x2, const Fd& y2,
                                       const Fd& td2) {
  const Fd s11 = fd_add_lazy(p1.x, p1.y), s22 = fd_add_lazy(x2, y2);
  const Fd a = mont26(p1.x, x2);
  const Fd b = mont26(p1.y, y2);
  const Fd c = mont26(p1.t, td2);
  const Fd e = mont26(s11, s22);
  const Fd h = fd_add_lazy(a, b);
  const Fd ex = fd_sub_lazy(e, h);
  const Fd f = fd_sub_lazy(p1.z, c);
  const Fd g = fd_add_lazy(p1.z, c);
  PtD r;
  r.x = mont26(ex, f);
  r.y = mont26(g, h);
  r.t = mont26(ex, h);
  r.z = mont26(f, g);
  return r;
}

template <int ROWS, int MASK, int STORE, int OPT>
__global__ void __launch_bounds__(SCAN_THREADS, ProbeBlocks<ROWS, OPT>::value)
probe_scan_kernel(const uint32_t* __restrict__ rows, const int32_t* __restrict__ pidx_t,
                  const int32_t* __restrict__ aux_t, const int32_t* __restrict__ sgn_t,
                  uint32_t* __restrict__ out, long long nf, long long lblk) {
  static_assert((OPT & OPT_HOIST) == 0 || ROWS == ROWS_RM, "hoistread reads row-major rows");
  __shared__ __align__(16) uint32_t slots[SCAN_THREADS * ROW_SLOT];
  const long long warp0 = blockIdx.x * (long long)SCAN_THREADS + (threadIdx.x & ~31);
  const long long f = min(warp0 + (threadIdx.x & 31), nf - 1);
  const int rows_valid = (int)min(nf - warp0, 32LL);
  uint32_t* slot = slots + threadIdx.x * ROW_SLOT;
  const uint32_t* wslots = slots + (threadIdx.x & ~31) * ROW_SLOT;
  const PtD ident = ptd_identity();
  PtD acc = ident;
  int kprev = -1;
  const uint32_t* frag = frag_rows<ROWS>(rows, f, lblk);
  constexpr long long fstride = scan_out_words<STORE>();
  uint32_t* dst0 = out + warp0 * fstride;
  if constexpr (ROWS == ROWS_DMA) {
    dma_issue(rows, pidx_t, nf, f, 0);
    cp_async_commit();
  }
#pragma unroll 1
  for (int j = 0; j < MSM_K; ++j) {
    Fd d2, s2, td2;
    int step = j;
    // OPT_HOIST: step 0's row at every step, its index hidden from the
    // optimizer so that the load stays in the loop (an L1 hit after step 0).
    if constexpr ((OPT & OPT_HOIST) != 0) asm volatile("mov.u32 %0, 0;" : "=r"(step));
    load_step<ROWS>(rows, frag, pidx_t, nf, f, step, lblk, d2, s2, td2);
    if constexpr ((OPT & OPT_NOSEL) != 0) {
      acc = madd26(acc, d2, s2, td2);
    } else {
      const bool same = step_same<MASK>(aux_t, sgn_t, j * nf + f, kprev, d2, td2);
      acc = madd26(ptd_select(same, acc, ident), d2, s2, td2);
    }
    if ((OPT & OPT_NOWRITE) == 0 || j >= MSM_K - 2)
      warp_store_rows(acc, slot, wslots, step_row<STORE>(dst0, j), fstride, rows_valid);
  }
}

// OPT_DUAL: thread f scans fragments f and f + nf/2 side by side (nf even),
// two madd26 a step, or two madd_g8 under OPT_FUSE.  Lanes past nf/2
// recompute fragments nf/2 - 1 and nf - 1 and store nothing.
template <int ROWS, int MASK, int STORE, int OPT>
__global__ void __launch_bounds__(SCAN_THREADS, ProbeBlocks<ROWS, OPT>::value)
scan_dual_kernel(const uint32_t* __restrict__ rows, const int32_t* __restrict__ pidx_t,
                 const int32_t* __restrict__ aux_t, const int32_t* __restrict__ sgn_t,
                 uint32_t* __restrict__ out, long long nf, long long lblk) {
  static_assert(ROWS == ROWS_RM || ROWS == ROWS_PRET, "dual scans read rm or pret rows");
  __shared__ __align__(16) uint32_t slots[SCAN_THREADS * ROW_SLOT];
  const long long half = nf / 2;
  const long long warp0 = blockIdx.x * (long long)SCAN_THREADS + (threadIdx.x & ~31);
  const long long fa = min(warp0 + (threadIdx.x & 31), half - 1), fb = fa + half;
  const int rows_valid = (int)min(half - warp0, 32LL);
  uint32_t* slot = slots + threadIdx.x * ROW_SLOT;
  const uint32_t* wslots = slots + (threadIdx.x & ~31) * ROW_SLOT;
  const PtD ident = ptd_identity();
  PtD acc_a = ident, acc_b = ident;
  int kprev_a = -1, kprev_b = -1;
  const uint32_t* frag_a = frag_rows<ROWS>(rows, fa, lblk);
  const uint32_t* frag_b = frag_rows<ROWS>(rows, fb, lblk);
  constexpr long long fstride = scan_out_words<STORE>();
  uint32_t* dst_a = out + warp0 * fstride;
  uint32_t* dst_b = out + (warp0 + half) * fstride;
#pragma unroll 1
  for (int j = 0; j < MSM_K; ++j) {
    Fd da, sa, ta, db, sb, tb;
    load_step<ROWS>(rows, frag_a, pidx_t, nf, fa, j, lblk, da, sa, ta);
    load_step<ROWS>(rows, frag_b, pidx_t, nf, fb, j, lblk, db, sb, tb);
    const bool same_a = step_same<MASK>(aux_t, sgn_t, j * nf + fa, kprev_a, da, ta);
    const bool same_b = step_same<MASK>(aux_t, sgn_t, j * nf + fb, kprev_b, db, tb);
    const PtD pa = ptd_select(same_a, acc_a, ident), pb = ptd_select(same_b, acc_b, ident);
    if constexpr ((OPT & OPT_FUSE) != 0) {
      // The JAX probe's fuse groups both fragments' 8 products as one.
      // Written side by side here (A of f, A of f + nf/2, B of f, ...) they
      // made ptxas spill into a stack frame at 255 registers; one add after
      // the other takes 194 and no frame, and the scheduler may still
      // interleave the two independent chains.  Each product takes the same
      // operands either way, so the bits do not change.
      acc_a = madd_g8(pa, da, sa, ta);
      acc_b = madd_g8(pb, db, sb, tb);
    } else {
      acc_a = madd26(pa, da, sa, ta);
      acc_b = madd26(pb, db, sb, tb);
    }
    warp_store_rows(acc_a, slot, wslots, step_row<STORE>(dst_a, j), fstride, rows_valid);
    warp_store_rows(acc_b, slot, wslots, step_row<STORE>(dst_b, j), fstride, rows_valid);
  }
}

// rows: as ROWS (the table for ROWS_DMA); pidx_t: [64, nf] i32 table rows
// (ROWS_DMA, else null); aux_t: [64, nf] i32; sgn_t: [64, nf] i32
// (MASK_KEYS_SGN, else null); out: [nf, 64/STORE, 128] u32 ([nf, 64, 64] for
// STORE 1); lblk: the limb-major block (ROWS_PRET only).
template <int ROWS, int MASK, int STORE, int OPT>
static int launch_probe_scan(const void* rows, const void* pidx_t, const void* aux_t,
                             const void* sgn_t, void* out, long long nf, long long lblk,
                             void* stream) {
  constexpr bool dual = (OPT & OPT_DUAL) != 0;
  const long long lanes = dual ? nf / 2 : nf;
  if (lanes > 0) {
    const long long blocks = (lanes + SCAN_THREADS - 1) / SCAN_THREADS;
    void (*kernel)(const uint32_t*, const int32_t*, const int32_t*, const int32_t*, uint32_t*,
                   long long, long long);
    if constexpr (dual) {
      kernel = scan_dual_kernel<ROWS, MASK, STORE, OPT>;
    } else {
      kernel = probe_scan_kernel<ROWS, MASK, STORE, OPT>;
    }
    int smem = 0;
    if constexpr (ROWS == ROWS_DMA) {
      smem = 2 * SCAN_THREADS * 3 * MSM_L * 4;
      cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                           cudaSharedmemCarveoutMaxShared);
    }
    kernel<<<blocks, SCAN_THREADS, smem, (cudaStream_t)stream>>>(
        (const uint32_t*)rows, (const int32_t*)pidx_t, (const int32_t*)aux_t,
        (const int32_t*)sgn_t, (uint32_t*)out, nf, lblk);
  }
  return (int)cudaGetLastError();
}

}  // namespace msm
