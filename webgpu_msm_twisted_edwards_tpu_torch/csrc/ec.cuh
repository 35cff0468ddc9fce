// Extended twisted Edwards point arithmetic (a = -1), one point per thread.
//
// Device counterpart of webgpu_msm_twisted_edwards_tpu/ops/pallas/ec.py:
// the rotated hwcd formulas madd (7 products), full_add (9) and double (8),
// with the same lazy products and the same order of operations, so the
// projective representatives match the JAX package's bit for bit.  Packed
// point rows are MSM_TW = 64 u32: x, y, t, z as 10 packed words each, then
// 24 zero words.  The plain PyTorch versions are in ops/kernels/ec.py.
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

// ec.py::pt_unpack of one packed row (16-byte aligned, >= 40 words).
__device__ __forceinline__ Pt pt_load(const uint32_t* row) {
  uint32_t w[4 * MSM_LP];
  const uint4* r4 = reinterpret_cast<const uint4*>(row);
#pragma unroll
  for (int i = 0; i < MSM_LP; ++i) {
    uint4 q = r4[i];
    w[4 * i] = q.x;
    w[4 * i + 1] = q.y;
    w[4 * i + 2] = q.z;
    w[4 * i + 3] = q.w;
  }
  Pt p;
  p.x = unpack2(w);
  p.y = unpack2(w + MSM_LP);
  p.t = unpack2(w + 2 * MSM_LP);
  p.z = unpack2(w + 3 * MSM_LP);
  return p;
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

// madd, full_add and pt_double are real calls (__noinline__): with them
// inlined into loop kernels, nvcc's front end (cicc, CUDA 12.8) dies with a
// segmentation fault.  Their arguments and results then pass through the
// stack frame (local memory, cached in L1).  The kernels that still call
// them: double_rows and extract_reconstruct (ec.cu), and the probes' scans
// (probe_scan.cuh).  The scans, the carry scan, both BPR stages, the Horner
// fold, the masked add and the per-window reduce run the 26-bit formulas of
// ec26.cuh, which inline.

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

// ec.py::full_add — unified add of two arbitrary points, 9 products; the
// product by d (cc1) is lazy.
__device__ __noinline__ Pt full_add(const Pt& p1, const Pt& p2) {
  Fe d1 = fr_sub_lazy(p1.y, p1.x);
  Fe d2 = fr_sub_lazy(p2.y, p2.x);
  Fe s1 = fr_add_lazy(p1.x, p1.y);
  Fe s2 = fr_add_lazy(p2.x, p2.y);
  Fe a = mont_lazy(d1, d2);
  Fe b = mont_lazy(s1, s2);
  Fe t12 = mont_lazy(p1.t, p2.t);
  Fe z12 = mont_lazy(p1.z, p2.z);
  Fe cc1 = mont_lazy(t12, fe_const(C_D));
  Fe cc = fr_add_lazy(cc1, cc1);
  Fe dd = fr_add_lazy(z12, z12);
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

// ec.py::double — dbl-2008-hwcd with a = -1, 8 products.
__device__ __noinline__ Pt pt_double(const Pt& p1) {
  Fe xy = fr_add_lazy(p1.x, p1.y);
  Fe a = mont_lazy(p1.x, p1.x);
  Fe b = mont_lazy(p1.y, p1.y);
  Fe zz = mont_lazy(p1.z, p1.z);
  Fe e_in = mont_lazy(xy, xy);
  Fe cc = fr_add_lazy(zz, zz);
  Fe s_ab = fr_add_lazy(a, b);
  Fe d = fr_neg_lazy(a);
  Fe e = fr_sub_lazy(e_in, s_ab);
  Fe h = fr_sub_lazy(d, b);
  Fe g = fr_add_lazy(d, b);
  Fe f = fr_sub_lazy(g, cc);
  Pt r;
  r.x = mont_lazy(e, f);
  r.y = mont_lazy(g, h);
  r.t = mont_lazy(e, h);
  r.z = mont_lazy(f, g);
  return r;
}

}  // namespace msm
