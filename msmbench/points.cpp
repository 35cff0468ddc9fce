// The benchmark's point generator: n affine points of the prime-order
// subgroup of ed-on-bls12-377, each with a discrete logarithm the caller
// chose, so the reference (reference.py) knows every point as a multiple of
// the generator G.
//
// Point i*cols + j is A_i + B_j with A_i = alpha_i*G and B_j = beta_j*G, so
// its logarithm is alpha_i + beta_j mod r.  The rows' and columns' multiples
// come from the caller (inputs.py draws them from the seed).  Each thread
// takes a range of points, adds them in extended coordinates and turns its
// range affine with one batched (Montgomery-trick) inversion.
//
// The field and curve code is a frozen copy of the repository's C++ oracle
// (4x64-bit limbs in Montgomery form, add-2008-hwcd and dbl-2008-hwcd on
// a = -1, d = 3021), kept here so that no change to the program moves the
// benchmark's inputs.
//
// Built by inputs.py with the host's C++ compiler into build/ beside this
// file, and called through ctypes.

#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

using u64 = std::uint64_t;
using u128 = unsigned __int128;

namespace {

struct Fp {
  u64 v[4];
};

const u64 P_LIMBS[4] = {0x0a11800000000001ULL, 0x59aa76fed0000001ULL, 0x60b44d1e5c37b001ULL,
                        0x12ab655e9a2ca556ULL};
u64 R2_LIMBS[4];
u64 PINV;

inline int cmp256(const u64 a[4], const u64 b[4]) {
  for (int i = 3; i >= 0; --i) {
    if (a[i] < b[i]) return -1;
    if (a[i] > b[i]) return 1;
  }
  return 0;
}

inline void sub256(u64 r[4], const u64 a[4], const u64 b[4]) {
  u128 borrow = 0;
  for (int i = 0; i < 4; ++i) {
    u128 d = (u128)a[i] - b[i] - borrow;
    r[i] = (u64)d;
    borrow = (d >> 64) & 1;
  }
}

inline u64 add256(u64 r[4], const u64 a[4], const u64 b[4]) {
  u128 carry = 0;
  for (int i = 0; i < 4; ++i) {
    u128 s = (u128)a[i] + b[i] + carry;
    r[i] = (u64)s;
    carry = s >> 64;
  }
  return (u64)carry;
}

inline void fp_add(Fp &r, const Fp &a, const Fp &b) {
  u64 carry = add256(r.v, a.v, b.v);
  if (carry || cmp256(r.v, P_LIMBS) >= 0) {
    u64 t[4];
    sub256(t, r.v, P_LIMBS);
    std::memcpy(r.v, t, sizeof t);
  }
}

inline void fp_sub(Fp &r, const Fp &a, const Fp &b) {
  if (cmp256(a.v, b.v) >= 0) {
    sub256(r.v, a.v, b.v);
  } else {
    u64 t[4];
    add256(t, a.v, P_LIMBS);
    sub256(r.v, t, b.v);
  }
}

// CIOS Montgomery product, R = 2^256.
inline void fp_mul(Fp &r, const Fp &a, const Fp &b) {
  u64 t[6] = {0, 0, 0, 0, 0, 0};
  for (int i = 0; i < 4; ++i) {
    u128 carry = 0;
    for (int j = 0; j < 4; ++j) {
      u128 cur = (u128)t[j] + (u128)a.v[i] * b.v[j] + carry;
      t[j] = (u64)cur;
      carry = cur >> 64;
    }
    u128 cur = (u128)t[4] + carry;
    t[4] = (u64)cur;
    t[5] = (u64)(cur >> 64);
    u64 m = t[0] * PINV;
    carry = ((u128)t[0] + (u128)m * P_LIMBS[0]) >> 64;
    for (int j = 1; j < 4; ++j) {
      u128 cur2 = (u128)t[j] + (u128)m * P_LIMBS[j] + carry;
      t[j - 1] = (u64)cur2;
      carry = cur2 >> 64;
    }
    u128 c4 = (u128)t[4] + carry;
    t[3] = (u64)c4;
    t[4] = t[5] + (u64)(c4 >> 64);
    t[5] = 0;
  }
  std::memcpy(r.v, t, 4 * sizeof(u64));
  if (t[4] || cmp256(r.v, P_LIMBS) >= 0) {
    u64 s[4];
    sub256(s, r.v, P_LIMBS);
    std::memcpy(r.v, s, sizeof s);
  }
}

Fp FP_ZERO, FP_ONE, FP_D;

inline void fp_from_raw(Fp &r, const u64 raw[4]) {
  Fp tmp, r2;
  std::memcpy(tmp.v, raw, sizeof tmp.v);
  std::memcpy(r2.v, R2_LIMBS, sizeof r2.v);
  fp_mul(r, tmp, r2);
}

inline void fp_to_raw(u64 raw[4], const Fp &a) {
  Fp one = {{1, 0, 0, 0}}, r;
  fp_mul(r, a, one);
  std::memcpy(raw, r.v, 4 * sizeof(u64));
}

inline void fp_neg(Fp &r, const Fp &a) {
  if ((a.v[0] | a.v[1] | a.v[2] | a.v[3]) == 0) {
    r = a;
  } else {
    sub256(r.v, P_LIMBS, a.v);
  }
}

// a^(p-2) by square and multiply.
Fp fp_inv(const Fp &a) {
  u64 e[4];
  const u64 two[4] = {2, 0, 0, 0};
  sub256(e, P_LIMBS, two);
  Fp inv = FP_ONE, base = a;
  for (int limb = 0; limb < 4; ++limb)
    for (int b = 0; b < 64; ++b) {
      if ((e[limb] >> b) & 1) fp_mul(inv, inv, base);
      fp_mul(base, base, base);
    }
  return inv;
}

struct Pt {
  Fp x, y, t, z;
};

void pt_identity(Pt &p) {
  p.x = FP_ZERO;
  p.y = FP_ONE;
  p.t = FP_ZERO;
  p.z = FP_ONE;
}

// add-2008-hwcd, unified, a = -1.
void pt_add(Pt &r, const Pt &p, const Pt &q) {
  Fp a, b, c, d, e, f, g, h, t1, t2;
  fp_mul(a, p.x, q.x);
  fp_mul(b, p.y, q.y);
  fp_mul(t1, p.t, q.t);
  fp_mul(c, FP_D, t1);
  fp_mul(d, p.z, q.z);
  fp_add(t1, p.x, p.y);
  fp_add(t2, q.x, q.y);
  fp_mul(e, t1, t2);
  fp_sub(e, e, a);
  fp_sub(e, e, b);
  fp_sub(f, d, c);
  fp_add(g, d, c);
  fp_add(h, b, a);
  fp_mul(r.x, e, f);
  fp_mul(r.y, g, h);
  fp_mul(r.t, e, h);
  fp_mul(r.z, f, g);
}

// dbl-2008-hwcd, a = -1.
void pt_double(Pt &r, const Pt &p) {
  Fp a, b, c, d, e, f, g, h, t1;
  fp_mul(a, p.x, p.x);
  fp_mul(b, p.y, p.y);
  fp_mul(t1, p.z, p.z);
  fp_add(c, t1, t1);
  fp_neg(d, a);
  fp_add(t1, p.x, p.y);
  fp_mul(e, t1, t1);
  fp_sub(e, e, a);
  fp_sub(e, e, b);
  fp_add(g, d, b);
  fp_sub(f, g, c);
  fp_sub(h, d, b);
  fp_mul(r.x, e, f);
  fp_mul(r.y, g, h);
  fp_mul(r.t, e, h);
  fp_mul(r.z, f, g);
}

void pt_scalar_mul(Pt &r, const Pt &p, const u64 k[4]) {
  pt_identity(r);
  Pt base = p;
  for (int limb = 0; limb < 4; ++limb)
    for (int b = 0; b < 64; ++b) {
      if ((k[limb] >> b) & 1) {
        Pt t;
        pt_add(t, r, base);
        r = t;
      }
      Pt t2;
      pt_double(t2, base);
      base = t2;
    }
}

void init_constants() {
  u64 inv = 1;
  for (int i = 0; i < 63; ++i) inv *= 2 - P_LIMBS[0] * inv;
  PINV = ~inv + 1;
  u64 acc[4] = {1, 0, 0, 0};
  for (int i = 0; i < 512; ++i) {
    u64 carry = add256(acc, acc, acc);
    if (carry || cmp256(acc, P_LIMBS) >= 0) {
      u64 t[4];
      sub256(t, acc, P_LIMBS);
      std::memcpy(acc, t, sizeof t);
    }
  }
  std::memcpy(R2_LIMBS, acc, sizeof acc);
  std::memset(FP_ZERO.v, 0, sizeof FP_ZERO.v);
  const u64 one_raw[4] = {1, 0, 0, 0};
  fp_from_raw(FP_ONE, one_raw);
  const u64 d_raw[4] = {3021, 0, 0, 0};
  fp_from_raw(FP_D, d_raw);
}

struct InitOnce {
  InitOnce() { init_constants(); }
} init_once;

// The affine generator of the prime-order subgroup.
const u64 GX[4] = {0x137e82844bbe49c5ULL, 0xe7608833a9dd83f3ULL, 0x16b294b80d905006ULL,
                   0x036824eb02475007ULL};
const u64 GY[4] = {0xd50dce7d8bcda9d4ULL, 0x7f6758f4c08bc255ULL, 0x37c0a81e810abce5ULL,
                   0x11b1d8d5c1d897a3ULL};

template <class F>
void parallel_for(std::size_t n, int nthreads, F f) {
  std::vector<std::thread> ts;
  const std::size_t per = (n + nthreads - 1) / nthreads;
  for (int t = 0; t < nthreads; ++t) {
    const std::size_t lo = t * per, hi = lo + per < n ? lo + per : n;
    if (lo < hi) ts.emplace_back(f, lo, hi);
  }
  for (auto &th : ts) th.join();
}

}  // namespace

extern "C" {

// alpha: rows x 4 u64, beta: cols x 4 u64 (little-endian scalars).
// out: n x 8 u64, point k = i*cols + j as affine (x, y), each 4 u64,
// n <= rows*cols.  Returns 0, or 1 on bad sizes.
int msmbench_grid_points(const u64 *alpha, long long rows, const u64 *beta, long long cols,
                         long long n, int nthreads, u64 *out) {
  if (rows <= 0 || cols <= 0 || n < 0 || n > rows * cols || nthreads <= 0) return 1;
  Pt g;
  fp_from_raw(g.x, GX);
  fp_from_raw(g.y, GY);
  fp_mul(g.t, g.x, g.y);
  g.z = FP_ONE;
  std::vector<Pt> a(rows), b(cols);
  parallel_for(rows + cols, nthreads, [&](std::size_t lo, std::size_t hi) {
    for (std::size_t k = lo; k < hi; ++k) {
      if ((long long)k < rows)
        pt_scalar_mul(a[k], g, alpha + 4 * k);
      else
        pt_scalar_mul(b[k - rows], g, beta + 4 * (k - rows));
    }
  });
  parallel_for(n, nthreads, [&](std::size_t lo, std::size_t hi) {
    std::vector<Pt> pts(hi - lo);
    std::vector<Fp> prefix(hi - lo);
    Fp acc = FP_ONE;
    for (std::size_t k = lo; k < hi; ++k) {
      Pt &p = pts[k - lo];
      pt_add(p, a[k / cols], b[k % cols]);
      prefix[k - lo] = acc;
      fp_mul(acc, acc, p.z);
    }
    Fp inv = fp_inv(acc);
    for (std::size_t k = hi; k-- > lo;) {
      const Pt &p = pts[k - lo];
      Fp zinv, ax, ay;
      fp_mul(zinv, inv, prefix[k - lo]);
      fp_mul(inv, inv, p.z);
      fp_mul(ax, p.x, zinv);
      fp_mul(ay, p.y, zinv);
      fp_to_raw(out + k * 8, ax);
      fp_to_raw(out + k * 8 + 4, ay);
    }
  });
  return 0;
}

}  // extern "C"
