// The in-fragment segmented scan, one template for every scan variant of the
// JAX package.
//
// Replaces webgpu_msm_twisted_edwards_tpu/ops/pallas/scan.py::_msm_scan_body
// and the kernels built on it: _msm_scan_rm_sames_kernel,
// _msm_scan_rm_signed_kernel (csrc/scan.cu), and _msm_scan_kernel,
// _msm_scan_pret_kernel, _msm_scan_sames_kernel, _msm_scan_signed_kernel,
// _msm_scan_rm_sames_q_kernel and _msm_scan_fused_kernel
// (csrc/scan_variants.cu).
//
// Per 64-entry fragment f and step j: acc = madd(same ? acc : identity,
// row_j); the inclusive value after step j is stored packed, two steps per
// 128-word output row.  Three independent choices, as in _msm_scan_body:
// - ROWS, where step j's table row comes from: ROWS_RM the row-major
//   [nf, 64, 128] gather output; ROWS_PRET the limb-major
//   [nf/lblk, 64, 64, lblk] layout, word i of step j of fragment f at
//   ((f/lblk)*64 + j)*64*lblk + i*lblk + f%lblk; ROWS_TABLE the table row
//   pidx_t[j, f] itself (the gather fused into the scan).
// - MASK, where the same-segment bit comes from, out of the [64, nf] step
//   word aux_t[j, f]: MASK_KEYS the sorted bucket key, compared with the
//   previous step's (-1 before step 0); MASK_SAMES the hoisted bit itself;
//   MASK_SIGNED bit 0 the same bit and bit 1 the digit's sign: a negative
//   entry adds the negated point, whose cached form swaps y-x with y+x and
//   negates 2*d*t (4p - v, borrow-free for the table's v < 3p).
// - STORE, the steps stored: 2 stores every step, out[f, j/2, (j%2)*64 ..];
//   4 stores only steps 4i+2 and 4i+3, out[f, i, ..] ([nf, 16, 128]).
//
// Bound on the H100: operations (7 Montgomery products, about 5.9 K 32-bit
// multiply-adds, per entry against 244 bytes read and 256 written, 128 with
// STORE 4).
// Design: one thread per fragment, the accumulator in registers for all 64
// steps.  Row-major and table rows are read with 16-byte loads of their 60
// used words (one row per thread, so a warp's loads are 32 rows apart); the
// limb-major layout gives 4-byte loads in which a warp's 32 threads read 32
// neighbouring words.  Stores are 16 bytes.  Every offset is 64-bit: the
// rows and the output pass 2^31 words at 2^20 points.
#pragma once

#include <cuda_runtime.h>

#include "ec.cuh"

namespace msm {

enum ScanRows { ROWS_RM = 0, ROWS_PRET = 1, ROWS_TABLE = 2 };
enum ScanMask { MASK_KEYS = 0, MASK_SAMES = 1, MASK_SIGNED = 2 };

template <int ROWS, int MASK, int STORE>
__global__ void __launch_bounds__(128)
scan_kernel(const uint32_t* __restrict__ rows, const int32_t* __restrict__ pidx_t,
            const int32_t* __restrict__ aux_t, uint32_t* __restrict__ out, long long nf,
            long long lblk) {
  const long long f = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (f >= nf) return;
  const Pt ident = pt_identity();
  Pt acc = ident;
  int kprev = -1;
  const uint32_t* frag = rows;
  if constexpr (ROWS == ROWS_RM) frag = rows + f * (long long)(MSM_K * MSM_TWR);
  if constexpr (ROWS == ROWS_PRET) frag = rows + (f / lblk) * (MSM_K * 64 * lblk) + f % lblk;
  uint32_t* dst = out + f * (long long)((MSM_K / STORE) * 2 * MSM_TW);
#pragma unroll 1
  for (int j = 0; j < MSM_K; ++j) {
    Fe d2, s2, td2;
    if constexpr (ROWS == ROWS_PRET) {
      const uint32_t* col = frag + j * 64 * lblk;
#pragma unroll
      for (int i = 0; i < MSM_L; ++i) {
        d2.v[i] = col[i * lblk];
        s2.v[i] = col[(MSM_L + i) * lblk];
        td2.v[i] = col[(2 * MSM_L + i) * lblk];
      }
    } else {
      const uint32_t* row = ROWS == ROWS_RM
                                ? frag + j * MSM_TWR
                                : rows + (long long)pidx_t[j * nf + f] * MSM_TWR;
      load_cached(row, d2, s2, td2);
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
        const Fe t = d2;
        d2 = s2;
        s2 = t;
        td2 = fr_neg_lazy(td2);
      }
      same = (aux & 1) != 0;
    }
    acc = madd(pt_select(same, acc, ident), d2, s2, td2);
    if constexpr (STORE == 2) {
      pt_store(dst + (j >> 1) * (2 * MSM_TW) + (j & 1) * MSM_TW, acc);
    } else if ((j & 3) >= 2) {
      pt_store(dst + (j >> 2) * (2 * MSM_TW) + ((j & 3) - 2) * MSM_TW, acc);
    }
  }
}

// rows: as ROWS (the table for ROWS_TABLE); pidx_t: [64, nf] i32 table rows
// (ROWS_TABLE only, else null); aux_t: [64, nf] i32; out: [nf, 64/STORE, 128]
// u32; lblk: the limb-major block (ROWS_PRET only).
template <int ROWS, int MASK, int STORE>
static int launch_scan(const void* rows, const void* pidx_t, const void* aux_t, void* out,
                       long long nf, long long lblk, void* stream) {
  if (nf > 0) {
    const int threads = 128;
    const long long blocks = (nf + threads - 1) / threads;
    scan_kernel<ROWS, MASK, STORE><<<blocks, threads, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)rows, (const int32_t*)pidx_t, (const int32_t*)aux_t, (uint32_t*)out,
        nf, lblk);
  }
  return (int)cudaGetLastError();
}

}  // namespace msm
