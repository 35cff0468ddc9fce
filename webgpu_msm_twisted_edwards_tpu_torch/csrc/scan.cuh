// The in-fragment segmented scan, one template for every scan variant of the
// JAX package.
//
// Replaces webgpu_msm_twisted_edwards_tpu/ops/pallas/scan.py::_msm_scan_body
// and the kernels built on it: _msm_scan_fused_kernel (the main path),
// _msm_scan_rm_sames_kernel, _msm_scan_rm_signed_kernel and the latter with
// the row gather (ops/pallas/gather.py::_dma_gather_kernel) folded in (the
// fixed base) in csrc/scan.cu; _msm_scan_kernel, _msm_scan_pret_kernel,
// _msm_scan_sames_kernel, _msm_scan_signed_kernel,
// _msm_scan_rm_sames_q_kernel and _msm_scan_rm_sames_kernel with the row
// gather folded in, in csrc/scan_variants.cu.
//
// Per 64-entry fragment f and step j: acc = madd(same ? acc : identity,
// row_j); the inclusive value after step j is stored packed, two steps per
// 128-word output row.  Three independent choices, as in _msm_scan_body:
// - ROWS, where step j's table row comes from: ROWS_RM the row-major
//   [nf, 64, 128] gather output; ROWS_PRET the limb-major
//   [nf/lblk, 64, 64, lblk] layout, word i of step j of fragment f at
//   ((f/lblk)*64 + j)*64*lblk + i*lblk + f%lblk; ROWS_TABLE the table row
//   pidx[j*psj + f*psf] itself (the gather fused into the scan; the index
//   array read where it lies, [64, nf] with strides (nf, 1) or a transposed
//   view of [nf, 64] with strides (1, 64)).  Tried on an H100 and left
//   out: a prefetch of the next step's row into L2 made the scan slower,
//   and loading the next step's index a step early gained nothing.
// - MASK, where the same-segment bit comes from, out of the [64, nf] step
//   word aux_t[j, f]: MASK_KEYS the sorted bucket key, compared with the
//   previous step's (-1 before step 0); MASK_SAMES the hoisted bit itself;
//   MASK_SIGNED bit 0 the same bit and bit 1 the digit's sign: a negative
//   entry adds the negated point, whose cached form swaps y-x with y+x and
//   negates 2*d*t (4p - v, borrow-free for the table's v < 3p).
// - STORE, the steps stored: 2 stores every step, out[f, j/2, (j%2)*64 ..];
//   4 stores only steps 4i+2 and 4i+3, out[f, i, ..] ([nf, 16, 128]).
//
// Bound on the H100: operations (7 Montgomery products per entry against
// 244 bytes read and 256 written, 128 with STORE 4).
// Design: one thread per fragment, the accumulator in registers for all 64
// steps, in the 26-bit digits of csrc/field26.cuh from the row loads to the
// stores: the madd (madd26, csrc/ec26.cuh) is inlined into the loop, with no call
// and no stack frame, and a product is 190 wide multiply-adds against the
// 13-bit form's 840 32-bit ones (field26.cuh says why the words are the
// same).  Row-major and table rows are read with 16-byte loads of their 60
// used words (one row per thread, so a warp's loads are 32 rows apart); the
// limb-major layout gives 4-byte loads in which a warp's 32 threads read 32
// neighbouring words.  A step's output row goes through shared memory: each
// thread writes its 40 packed words into its slot of its warp's staging
// buffer, then the warp writes two whole 256-byte rows (the 24 zero words
// included) with each 16-byte store instruction, neighbouring lanes on
// neighbouring words (ec26.cuh::warp_store_rows).  The last warp's lanes
// past nf recompute fragment nf - 1 and store nothing.  Every offset is
// 64-bit: the rows and the output pass 2^31 words at 2^20 points.
#pragma once

#include <cuda_runtime.h>

#include "ec26.cuh"

namespace msm {

enum ScanRows { ROWS_RM = 0, ROWS_PRET = 1, ROWS_TABLE = 2 };
enum ScanMask { MASK_KEYS = 0, MASK_SAMES = 1, MASK_SIGNED = 2 };

// Two warps a block and at least 8 blocks a SM: ptxas then gives each
// thread 128 registers (16 warps a SM).  On an H100 this ran the main path's
// scan faster than 128-thread blocks at 3 or 4 blocks a SM (which ptxas
// held to about 110 registers, also 16 warps) and as fast as one-warp
// blocks at 16 a SM.  Five of the eight instantiations spill 4-40 bytes at
// this bound.
constexpr int SCAN_THREADS = 64;
constexpr int SCAN_MIN_BLOCKS = 8;

template <int ROWS, int MASK, int STORE>
__global__ void __launch_bounds__(SCAN_THREADS, SCAN_MIN_BLOCKS)
scan_kernel(const uint32_t* __restrict__ rows, const int32_t* __restrict__ pidx, long long psj,
            long long psf, const int32_t* __restrict__ aux_t, uint32_t* __restrict__ out,
            long long nf, long long lblk) {
  __shared__ __align__(16) uint32_t slots[SCAN_THREADS * ROW_SLOT];
  const long long warp0 = blockIdx.x * (long long)SCAN_THREADS + (threadIdx.x & ~31);
  const long long f = min(warp0 + (threadIdx.x & 31), nf - 1);
  const int rows_valid = (int)min(nf - warp0, 32LL);
  uint32_t* slot = slots + threadIdx.x * ROW_SLOT;
  const uint32_t* wslots = slots + (threadIdx.x & ~31) * ROW_SLOT;
  const PtD ident = ptd_identity();
  PtD acc = ident;
  int kprev = -1;
  const uint32_t* frag = rows;
  if constexpr (ROWS == ROWS_RM) frag = rows + f * (long long)(MSM_K * MSM_TWR);
  if constexpr (ROWS == ROWS_PRET) frag = rows + (f / lblk) * (MSM_K * 64 * lblk) + f % lblk;
  constexpr long long fstride = (MSM_K / STORE) * 2 * MSM_TW;
  uint32_t* dst0 = out + warp0 * fstride;
  const int32_t* fidx = pidx + f * psf;
#pragma unroll 1
  for (int j = 0; j < MSM_K; ++j) {
    Fd d2, s2, td2;
    if constexpr (ROWS == ROWS_PRET) {
      const uint32_t* col = frag + j * 64 * lblk;
      uint32_t w[3 * MSM_L];
#pragma unroll
      for (int i = 0; i < 3 * MSM_L; ++i) w[i] = col[i * lblk];
      d2 = fd_from_limbs(w);
      s2 = fd_from_limbs(w + MSM_L);
      td2 = fd_from_limbs(w + 2 * MSM_L);
    } else {
      const uint32_t* row = ROWS == ROWS_RM ? frag + j * MSM_TWR
                                            : rows + (long long)fidx[j * psj] * MSM_TWR;
      load_cached26(row, d2, s2, td2);
    }
    const int aux = aux_t[j * nf + f];
    bool same;
    if constexpr (MASK == MASK_KEYS) {
      same = aux == kprev;
      kprev = aux;
    } else if constexpr (MASK == MASK_SAMES) {
      same = aux != 0;
    } else {
      if (aux & 2) {
        const Fd t = d2;
        d2 = s2;
        s2 = t;
        td2 = fd_neg_lazy(td2);
      }
      same = (aux & 1) != 0;
    }
    acc = madd26(ptd_select(same, acc, ident), d2, s2, td2);
    if constexpr (STORE == 2) {
      warp_store_rows(acc, slot, wslots, dst0 + (j >> 1) * (2 * MSM_TW) + (j & 1) * MSM_TW,
                      fstride, rows_valid);
    } else if ((j & 3) >= 2) {
      warp_store_rows(acc, slot, wslots,
                      dst0 + (j >> 2) * (2 * MSM_TW) + ((j & 3) - 2) * MSM_TW, fstride,
                      rows_valid);
    }
  }
}

// rows: as ROWS (the table for ROWS_TABLE); pidx: the table row of step j of
// fragment f at pidx[j*psj + f*psf], i32 (ROWS_TABLE only, else null); aux_t:
// [64, nf] i32; out: [nf, 64/STORE, 128] u32; lblk: the limb-major block
// (ROWS_PRET only).
template <int ROWS, int MASK, int STORE>
static int launch_scan(const void* rows, const void* pidx, long long psj, long long psf,
                       const void* aux_t, void* out, long long nf, long long lblk,
                       void* stream) {
  if (nf > 0) {
    const long long blocks = (nf + SCAN_THREADS - 1) / SCAN_THREADS;
    scan_kernel<ROWS, MASK, STORE><<<blocks, SCAN_THREADS, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)rows, (const int32_t*)pidx, psj, psf, (const int32_t*)aux_t,
        (uint32_t*)out, nf, lblk);
  }
  return (int)cudaGetLastError();
}

}  // namespace msm
