// Extended twisted Edwards point arithmetic in the 26-bit digits of
// csrc/field26.cuh: the scans (csrc/scan.cuh, and the probes' in
// csrc/probe_scan.cuh and csrc/probe_move.cu), the carry scan
// (csrc/scan.cu), both BPR stages and the Horner fold (csrc/bpr.cu), the
// masked add, the per-window reduce, the quarter-store extraction (madd26
// and full_add26) and the repeated doubling (pt_double26) in csrc/ec.cu;
// its warp-staged row store also serves the normalization
// (csrc/precompute.cu).
//
// madd26, madd26_x4, full_add26, full_add26_x4, pt_double26 and
// pt_double26_x4 repeat the plain versions' madd, full_add and double
// (ops/kernels/ec.py, the JAX package's ec.py::madd, ::full_add, ::double)
// operation for operation, in the same order, on digits: field26.cuh says
// why each digit operation gives the 13-bit one's residue, so on normalized
// inputs these formulas give the plain versions' packed rows bit for bit.
// They are inlined: no call and no stack frame (cicc, CUDA 12.8, could not
// inline the same formulas in 13-bit limbs into a loop kernel, which is why
// no kernel of the port runs those).
#pragma once

#include "field26.cuh"

namespace msm {

// A point in 26-bit digits.
struct PtD {
  Fd x, y, t, z;
};

// a or b, word by word: a select of whole structs would keep both in local
// memory and select an address.
__device__ __forceinline__ PtD ptd_select(bool take_a, const PtD& a, const PtD& b) {
  PtD r;
#pragma unroll
  for (int i = 0; i < MSM_LD; ++i) {
    r.x.v[i] = take_a ? a.x.v[i] : b.x.v[i];
    r.y.v[i] = take_a ? a.y.v[i] : b.y.v[i];
    r.t.v[i] = take_a ? a.t.v[i] : b.t.v[i];
    r.z.v[i] = take_a ? a.z.v[i] : b.z.v[i];
  }
  return r;
}

__device__ __forceinline__ PtD ptd_identity() {
  PtD p;
  p.x = fd_zero();
  p.y = fd_one();
  p.t = fd_zero();
  p.z = fd_one();
  return p;
}

// ec.py::madd in 26-bit digits, the same operations in the same order:
// p1 + a table point in cached form (d2 = y2-x2, s2 = y2+x2, td2 = 2*d*t2).
__device__ __forceinline__ PtD madd26(const PtD& p1, const Fd& d2, const Fd& s2, const Fd& td2) {
  const Fd d1 = fd_sub_lazy(p1.y, p1.x);
  const Fd s1 = fd_add_lazy(p1.x, p1.y);
  const Fd dd = fd_add_lazy(p1.z, p1.z);
  const Fd a = mont26(d1, d2);
  const Fd b = mont26(s1, s2);
  const Fd cc = mont26(p1.t, td2);
  const Fd e = fd_sub_lazy(b, a);
  const Fd f = fd_sub_lazy(dd, cc);
  const Fd g = fd_add_lazy(dd, cc);
  const Fd h = fd_add_lazy(b, a);
  PtD r;
  r.x = mont26(e, f);
  r.y = mont26(g, h);
  r.t = mont26(e, h);
  r.z = mont26(f, g);
  return r;
}

// ec.py::full_add, the unified add of two arbitrary points with the product
// by d (cc1) lazy, on one thread: full_add26_x4's operations in its order,
// its 9 products one after the other.
__device__ __forceinline__ PtD full_add26(const PtD& p1, const PtD& p2) {
  const Fd d1 = fd_sub_lazy(p1.y, p1.x);
  const Fd d2 = fd_sub_lazy(p2.y, p2.x);
  const Fd s1 = fd_add_lazy(p1.x, p1.y);
  const Fd s2 = fd_add_lazy(p2.x, p2.y);
  const Fd a = mont26(d1, d2);
  const Fd b = mont26(s1, s2);
  const Fd t12 = mont26(p1.t, p2.t);
  const Fd z12 = mont26(p1.z, p2.z);
  const Fd cc1 = mont26(t12, fd_d());
  const Fd cc = fd_add_lazy(cc1, cc1);
  const Fd dd = fd_add_lazy(z12, z12);
  const Fd e = fd_sub_lazy(b, a);
  const Fd f = fd_sub_lazy(dd, cc);
  const Fd g = fd_add_lazy(dd, cc);
  const Fd h = fd_add_lazy(b, a);
  PtD r;
  r.x = mont26(e, f);
  r.y = mont26(g, h);
  r.t = mont26(e, h);
  r.z = mont26(f, g);
  return r;
}

// Lane k's a, in each group of four neighbouring lanes (every lane of the
// warp takes part).
__device__ __forceinline__ Fd fd_shfl4(const Fd& a, int k) {
  Fd r;
#pragma unroll
  for (int i = 0; i < MSM_LD; ++i) r.v[i] = __shfl_sync(0xFFFFFFFFu, a.v[i], k, 4);
  return r;
}

// The point whose x, y, t and z lanes 0, 1, 2 and 3 of each group of four
// hold in r.
__device__ __forceinline__ PtD ptd_shfl4(const Fd& r) {
  PtD p;
  p.x = fd_shfl4(r, 0);
  p.y = fd_shfl4(r, 1);
  p.t = fd_shfl4(r, 2);
  p.z = fd_shfl4(r, 3);
  return p;
}

// The q-th of four values, word by word (q is not known at compile time, so
// an array indexed by it would go to local memory).
__device__ __forceinline__ Fd fd_pick4(int q, const Fd& a, const Fd& b, const Fd& c,
                                       const Fd& d) {
  Fd r;
#pragma unroll
  for (int i = 0; i < MSM_LD; ++i)
    r.v[i] = q == 0 ? a.v[i] : q == 1 ? b.v[i] : q == 2 ? c.v[i] : d.v[i];
  return r;
}

// ec.py::full_add, the unified add of two arbitrary points with the product
// by d (cc1) lazy, on a group of four neighbouring lanes that hold the same
// p1 and p2.  Its 9 products are two sets of four
// independent ones and cc1 between them: lane q computes product q of each
// set, the group exchanges the four results by shuffles, and every lane
// returns the sum.  Each product takes the operands it takes in full_add,
// and the lazy operations are full_add's, in its order, so the bits are
// the same; the dependent chain is 3 products long, not 9.
__device__ __forceinline__ PtD full_add26_x4(const PtD& p1, const PtD& p2, int q) {
  const Fd d1 = fd_sub_lazy(p1.y, p1.x);
  const Fd d2 = fd_sub_lazy(p2.y, p2.x);
  const Fd s1 = fd_add_lazy(p1.x, p1.y);
  const Fd s2 = fd_add_lazy(p2.x, p2.y);
  // a = d1*d2, b = s1*s2, t12 = t1*t2, z12 = z1*z2.
  const Fd m = mont26(fd_pick4(q, d1, s1, p1.t, p1.z), fd_pick4(q, d2, s2, p2.t, p2.z));
  const Fd a = fd_shfl4(m, 0);
  const Fd b = fd_shfl4(m, 1);
  const Fd t12 = fd_shfl4(m, 2);
  const Fd z12 = fd_shfl4(m, 3);
  const Fd cc1 = mont26(t12, fd_d());
  const Fd cc = fd_add_lazy(cc1, cc1);
  const Fd dd = fd_add_lazy(z12, z12);
  const Fd e = fd_sub_lazy(b, a);
  const Fd f = fd_sub_lazy(dd, cc);
  const Fd g = fd_add_lazy(dd, cc);
  const Fd h = fd_add_lazy(b, a);
  // x = e*f, y = g*h, t = e*h, z = f*g.
  const Fd r = mont26(fd_pick4(q, e, g, e, f), fd_pick4(q, f, h, h, g));
  return ptd_shfl4(r);
}

// ec.py::madd, p1 + a table point in cached form, on a group of four
// neighbouring lanes that hold the same p1, as full_add26_x4 does the add.
// v2 is the one element of the table point that lane q's first product
// takes: y2-x2 on lane 0, y2+x2 on lane 1, 2*d*t2 on lanes 2 and 3.  The 7
// products are two sets: a = d1*d2, b = s1*s2, cc = t1*td2 on lanes 0-2
// (lane 3 repeats cc), then x = e*f, y = g*h, t = e*h, z = f*g on lanes 0-3;
// the group exchanges the results by shuffles.  Each product takes the
// operands it takes in madd26, and each lazy operation is madd26's on the
// same operands, so the bits are the same; the dependent chain is 2
// products long, not 7.  A lane computes only the lazy operations its
// products take: one of d1 = y1 - x1 and s1 = x1 + y1, then dd, and of
// e = b - a, f = dd - cc, g = dd + cc, h = b + a the two it multiplies.
__device__ __forceinline__ PtD madd26_x4(const PtD& p1, const Fd& v2, int q) {
  const bool lane0 = q == 0;
  const Fd ds1 = fd_addsub_lazy(fd_select(lane0, p1.y, p1.x), fd_select(lane0, p1.x, p1.y),
                                lane0);
  const Fd dd = fd_add_lazy(p1.z, p1.z);
  const Fd m = mont26(fd_select(q < 2, ds1, p1.t), v2);
  const Fd a = fd_shfl4(m, 0);
  const Fd b = fd_shfl4(m, 1);
  const Fd cc = fd_shfl4(m, 2);
  // Lane 0: e, f; 1: g, h; 2: e, h; 3: f, g.
  const bool ba_x = q == 0 || q == 2, ba_y = q == 1 || q == 2;
  const Fd x = fd_addsub_lazy(fd_select(ba_x, b, dd), fd_select(ba_x, a, cc), q != 1);
  const Fd y = fd_addsub_lazy(fd_select(ba_y, b, dd), fd_select(ba_y, a, cc), lane0);
  return ptd_shfl4(mont26(x, y));
}

// ec.py::double (dbl-2008-hwcd with a = -1) on one thread:
// pt_double26_x4's operations in its order, its 8 products one after the
// other.
__device__ __forceinline__ PtD pt_double26(const PtD& p1) {
  const Fd xy = fd_add_lazy(p1.x, p1.y);
  const Fd a = mont26(p1.x, p1.x);
  const Fd b = mont26(p1.y, p1.y);
  const Fd zz = mont26(p1.z, p1.z);
  const Fd e_in = mont26(xy, xy);
  const Fd cc = fd_add_lazy(zz, zz);
  const Fd s_ab = fd_add_lazy(a, b);
  const Fd d = fd_neg_lazy(a);
  const Fd e = fd_sub_lazy(e_in, s_ab);
  const Fd h = fd_sub_lazy(d, b);
  const Fd g = fd_add_lazy(d, b);
  const Fd f = fd_sub_lazy(g, cc);
  PtD r;
  r.x = mont26(e, f);
  r.y = mont26(g, h);
  r.t = mont26(e, h);
  r.z = mont26(f, g);
  return r;
}

// ec.py::double (dbl-2008-hwcd with a = -1) on a group of four neighbouring
// lanes that hold the same p1, as full_add26_x4 does the add.  Its 8
// products are two sets of four independent ones: lane q computes product q
// of each set and the group exchanges the results by shuffles.  The lazy
// operations are double's, in its order, so the bits are the same; the
// dependent chain is 2 products long, not 8.
__device__ __forceinline__ PtD pt_double26_x4(const PtD& p1, int q) {
  const Fd xy = fd_add_lazy(p1.x, p1.y);
  // a = x*x, b = y*y, zz = z*z, e_in = xy*xy.
  const Fd sq = fd_pick4(q, p1.x, p1.y, p1.z, xy);
  const Fd m = mont26(sq, sq);
  const Fd a = fd_shfl4(m, 0);
  const Fd b = fd_shfl4(m, 1);
  const Fd zz = fd_shfl4(m, 2);
  const Fd e_in = fd_shfl4(m, 3);
  const Fd cc = fd_add_lazy(zz, zz);
  const Fd s_ab = fd_add_lazy(a, b);
  const Fd d = fd_neg_lazy(a);
  const Fd e = fd_sub_lazy(e_in, s_ab);
  const Fd h = fd_sub_lazy(d, b);
  const Fd g = fd_add_lazy(d, b);
  const Fd f = fd_sub_lazy(g, cc);
  // x = e*f, y = g*h, t = e*h, z = f*g.
  const Fd r = mont26(fd_pick4(q, e, g, e, f), fd_pick4(q, f, h, h, g));
  return ptd_shfl4(r);
}

// One coordinate's MSM_LP packed words (ec.py::pt_pack) into w.
__device__ __forceinline__ void pack_digits(const Fd& a, uint32_t* w) {
#pragma unroll
  for (int i = 0; i < MSM_LP; ++i) w[i] = fd_pack_word(a.v[i]);
}

// The 40 used words of one packed point row (16-byte aligned), read with
// 16-byte loads.
__device__ __forceinline__ void load_packed_words(const uint32_t* row, uint32_t* w) {
  const uint4* r4 = reinterpret_cast<const uint4*>(row);
#pragma unroll
  for (int i = 0; i < MSM_LP; ++i) {
    const uint4 q = r4[i];
    w[4 * i] = q.x;
    w[4 * i + 1] = q.y;
    w[4 * i + 2] = q.z;
    w[4 * i + 3] = q.w;
  }
}

// The 40 packed words of one point (ec.py::pt_unpack) as digits.  Packed
// rows hold normalized limbs, so word i is digit i spread over bits 0..12
// and 16..28.
__device__ __forceinline__ PtD ptd_from_packed(const uint32_t* w) {
  PtD p;
#pragma unroll
  for (int i = 0; i < MSM_LD; ++i) {
    p.x.v[i] = fd_unpack_word(w[i]);
    p.y.v[i] = fd_unpack_word(w[MSM_LP + i]);
    p.t.v[i] = fd_unpack_word(w[2 * MSM_LP + i]);
    p.z.v[i] = fd_unpack_word(w[3 * MSM_LP + i]);
  }
  return p;
}

// One packed point row as digits.
__device__ __forceinline__ PtD ptd_load_packed(const uint32_t* row) {
  uint32_t w[4 * MSM_LP];
  load_packed_words(row, w);
  return ptd_from_packed(w);
}

// The cached form (y-x, y+x, 2*d*t) of one table row, its first 3*MSM_L
// words (one limb a word), read with 16-byte loads, as digits.
__device__ __forceinline__ void load_cached26(const uint32_t* row, Fd& d2, Fd& s2, Fd& td2) {
  uint32_t w[3 * MSM_L];
  const uint4* r4 = reinterpret_cast<const uint4*>(row);
#pragma unroll
  for (int i = 0; i < 3 * MSM_L / 4; ++i) {
    const uint4 q = r4[i];
    w[4 * i] = q.x;
    w[4 * i + 1] = q.y;
    w[4 * i + 2] = q.z;
    w[4 * i + 3] = q.w;
  }
  d2 = fd_from_limbs(w);
  s2 = fd_from_limbs(w + MSM_L);
  td2 = fd_from_limbs(w + 2 * MSM_L);
}

// The 40 packed words of one point (ec.py::pt_pack) into w.
__device__ __forceinline__ void ptd_pack(const PtD& p, uint32_t* w) {
  pack_digits(p.x, w);
  pack_digits(p.y, w + MSM_LP);
  pack_digits(p.t, w + 2 * MSM_LP);
  pack_digits(p.z, w + 3 * MSM_LP);
}

// ec.py::pt_pack of one point, written by this thread as a whole MSM_TW-word
// row with 16-byte stores, the 24 padding words zero.
__device__ __forceinline__ void ptd_store_packed(uint32_t* row, const PtD& p) {
  uint32_t w[4 * MSM_LP];
  ptd_pack(p, w);
  uint4* r4 = reinterpret_cast<uint4*>(row);
#pragma unroll
  for (int i = 0; i < MSM_LP; ++i)
    r4[i] = make_uint4(w[4 * i], w[4 * i + 1], w[4 * i + 2], w[4 * i + 3]);
#pragma unroll
  for (int i = MSM_LP; i < MSM_TW / 4; ++i) r4[i] = make_uint4(0, 0, 0, 0);
}

// Words of one thread's staging slot in warp_store_packed: the 40 packed
// words, padded so that a quarter-warp's 16-byte shared stores fall on
// distinct banks.
constexpr int ROW_SLOT = 44;

// The warp's store of one packed point row a lane: for r < rows_valid, row
// r of the warp's output (dst0 + r*rstride) gets lane r's 40 words w and 24
// zero words.  slot: this thread's staging slot of ROW_SLOT words in shared
// memory; wslots: the warp's 32 slots.  Each thread writes its words into
// its slot, then the warp writes two whole 256-byte rows with each 16-byte
// store instruction, neighbouring lanes on neighbouring words.
__device__ __forceinline__ void warp_store_packed(const uint32_t* w, uint32_t* slot,
                                                  const uint32_t* wslots, uint32_t* dst0,
                                                  long long rstride, int rows_valid) {
  __syncwarp();  // the previous rows have been read out of the slots
  uint4* s4 = reinterpret_cast<uint4*>(slot);
#pragma unroll
  for (int i = 0; i < MSM_LP; ++i)
    s4[i] = make_uint4(w[4 * i], w[4 * i + 1], w[4 * i + 2], w[4 * i + 3]);
  __syncwarp();
  // Half-warp h writes rows 2r + h: lane c of it the 16-byte chunk c, zero
  // past the 40 packed words.
  const int lane = threadIdx.x & 31, half = lane >> 4, chunk = lane & 15;
#pragma unroll
  for (int r = 0; r < 16; ++r) {
    const int row = 2 * r + half;
    if (row < rows_valid) {
      uint4 v = make_uint4(0, 0, 0, 0);
      if (chunk < MSM_LP) v = reinterpret_cast<const uint4*>(wslots + row * ROW_SLOT)[chunk];
      reinterpret_cast<uint4*>(dst0 + row * rstride)[chunk] = v;
    }
  }
}

// warp_store_packed of each lane's point p, packed (ec.py::pt_pack).
__device__ __forceinline__ void warp_store_rows(const PtD& p, uint32_t* slot,
                                                const uint32_t* wslots, uint32_t* dst0,
                                                long long rstride, int rows_valid) {
  uint32_t w[4 * MSM_LP];
  ptd_pack(p, w);
  warp_store_packed(w, slot, wslots, dst0, rstride, rows_valid);
}

}  // namespace msm
