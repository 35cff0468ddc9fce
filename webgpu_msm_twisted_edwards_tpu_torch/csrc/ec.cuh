// Extended twisted Edwards point arithmetic (a = -1) in the 13-bit limbs of
// csrc/field.cuh, one point per thread, for the fused-gather probe's scans
// (csrc/probe_move.cu).
//
// Device counterpart of webgpu_msm_twisted_edwards_tpu/ops/pallas/ec.py's
// rotated hwcd madd (7 products), with the same lazy products and the same
// order of operations, so the projective representatives match the JAX
// package's bit for bit.  Packed point rows are MSM_TW = 64 u32: x, y, t, z
// as 10 packed words each, then 24 zero words.  The plain PyTorch versions
// are in ops/kernels/ec.py.
#pragma once

#include "field.cuh"

namespace msm {

struct Pt {
  Fe x, y, t, z;
};

// ec.py::pt_identity — (0 : R : 0 : R), Montgomery form of (0 : 1 : 0 : 1).
__device__ __forceinline__ Pt pt_identity() {
  Pt p;
  p.x = fe_zero();
  p.y = fe_const(C_R);
  p.t = fe_zero();
  p.z = fe_const(C_R);
  return p;
}

__device__ __forceinline__ Pt pt_select(bool take_a, const Pt& a, const Pt& b) {
  return take_a ? a : b;
}

// ec.py::pt_pack of one point, written as a full MSM_TW-word row with the
// 24 padding words zero.
__device__ __forceinline__ void pt_store(uint32_t* row, const Pt& p) {
  uint32_t w[MSM_TW];
  pack2(p.x, w);
  pack2(p.y, w + MSM_LP);
  pack2(p.t, w + 2 * MSM_LP);
  pack2(p.z, w + 3 * MSM_LP);
#pragma unroll
  for (int i = 4 * MSM_LP; i < MSM_TW; ++i) w[i] = 0;
  uint4* r4 = reinterpret_cast<uint4*>(row);
#pragma unroll
  for (int i = 0; i < MSM_TW / 4; ++i)
    r4[i] = make_uint4(w[4 * i], w[4 * i + 1], w[4 * i + 2], w[4 * i + 3]);
}

// The cached form (y-x, y+x, 2*d*t) of one table row: its first 3*MSM_L
// words, unpacked limbs, read with 16-byte loads (16-byte aligned row).
__device__ __forceinline__ void load_cached(const uint32_t* row, Fe& d2, Fe& s2, Fe& td2) {
  uint32_t w[3 * MSM_L];
  const uint4* r4 = reinterpret_cast<const uint4*>(row);
#pragma unroll
  for (int i = 0; i < 3 * MSM_L / 4; ++i) {
    uint4 q = r4[i];
    w[4 * i] = q.x;
    w[4 * i + 1] = q.y;
    w[4 * i + 2] = q.z;
    w[4 * i + 3] = q.w;
  }
#pragma unroll
  for (int i = 0; i < MSM_L; ++i) {
    d2.v[i] = w[i];
    s2.v[i] = w[MSM_L + i];
    td2.v[i] = w[2 * MSM_L + i];
  }
}

// madd is a real call (__noinline__): with the 13-bit formulas inlined into
// loop kernels, nvcc's front end (cicc, CUDA 12.8) dies with a segmentation
// fault.  Its arguments and result then pass through the stack frame (local
// memory, cached in L1).  Only the fused-gather probe's scans
// (csrc/probe_move.cu: gather_scan and gather_fused) still call it; every
// kernel of the MSM and the precompute, and the other probes' scans
// (csrc/probe_scan.cuh), run the 26-bit formulas of ec26.cuh (madd26,
// full_add26, pt_double26 and their four-lane forms), which inline.

// ec.py::madd — p1 + a table point in cached form (d2 = y2-x2, s2 = y2+x2,
// td2 = 2*d*t2, affine with Z = R).  Accumulator coordinates < 1.3p, table
// rows < 5.3p: every product input stays < 9p and every subtrahend < 3p.
__device__ __noinline__ Pt madd(const Pt& p1, const Fe& d2, const Fe& s2, const Fe& td2) {
  Fe d1 = fr_sub_lazy(p1.y, p1.x);
  Fe s1 = fr_add_lazy(p1.x, p1.y);
  Fe dd = fr_add_lazy(p1.z, p1.z);
  Fe a = mont_lazy(d1, d2);
  Fe b = mont_lazy(s1, s2);
  Fe cc = mont_lazy(p1.t, td2);
  Fe e = fr_sub_lazy(b, a);
  Fe f = fr_sub_lazy(dd, cc);
  Fe g = fr_add_lazy(dd, cc);
  Fe h = fr_add_lazy(b, a);
  Pt r;
  r.x = mont_lazy(e, f);
  r.y = mont_lazy(g, h);
  r.t = mont_lazy(e, h);
  r.z = mont_lazy(f, g);
  return r;
}

}  // namespace msm
