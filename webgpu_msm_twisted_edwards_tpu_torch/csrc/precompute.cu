// Batch affine normalization of packed projective point rows.
//
// Replaces webgpu_msm_twisted_edwards_tpu/ops/precompute.py::
// _inv_norm_kernel (normalize_rows): per row, zinv = z^(p-2) by MSB-first
// square-and-multiply from acc = R, then x*zinv and y*zinv, all reduced
// Montgomery products.  The row out holds x*R (packed, words 0..9), y*R
// (words 10..19) and zeros.
//
// Bound on the H100: operations.  The least work is Montgomery's batch
// inversion: per row a prefix product, two products on the way back and
// x*zinv, y*zinv (5 products), plus one inversion (386 products) a batch;
// against it 120 bytes read and 256 written a row.  The JAX kernel's
// Fermat chain per row (388 products) is what it chose on the TPU, where
// the associative-scan batch inversion compiled for many minutes; CUDA has
// no such limit.
//
// Design: each thread takes K rows, each block T threads (row i of thread
// t is base + i*T + t, so a warp's lanes read and write neighbouring rows).
// Every product is field26.cuh::mont26_reduced, inlined: no call and no
// stack frame.
//  1. The thread forms the prefix products of its rows' z from R.  Each
//     prefix waits in words 20..29 of its row of out, which the final
//     store overwrites with zeros: shared memory would hold too few rows a
//     block to keep every block of a launch in one wave.
//  2. Its total is inverted: warp 0 inverts the block's T totals as one
//     batch (local prefixes, a shuffle scan over the lanes, one Fermat
//     chain a block, a shuffle suffix scan, back over the local prefixes).
//     The chain walks the bits of p-2 from __constant__ memory as the
//     plain version does.
//  3. Back over the rows: zinv_i = inv * P_i and inv *= z_i, then x*zinv
//     and y*zinv, each warp's 32 rows written whole through shared memory
//     (ec26.cuh::warp_store_packed).
// Why the bits are the plain version's: every product here has one input
// below p (R, a prefix, a total, an inverse) and the other below 2^260, so
// (x*y + Q*p)/R < 2p and the one conditional subtraction leaves the
// canonical residue.  The plain version's products have the same property
// (acc < p), so its zinv, x*zinv and y*zinv are canonical residues too; a
// residue has one canonical form, so any exact schedule gives its words.
// No bound on z beyond 2^260 is needed; the z rows that double_rows makes
// are below 1.21p (its lazy product f*g with f < 9.01p, g < 5.01p:
// tests/test_torch_precompute.py computes the bound).
// Zero rows: the plain version maps any z = 0 mod p (the zero row, and z
// words of p, 2p, ...) to zinv = 0, so x = y = 0.  A prefix times such a z
// is the canonical 0, so such a row is found there: the prefix is kept as
// it was (z taken as R), the row gets zinv = 0, and no other row of the
// batch is touched.  Rows past n take R and store nothing.
#include <cuda_runtime.h>

#include "ec26.cuh"

#define MSM_EXP_BITS 253  // bit length of p - 2

namespace msm {

// p - 2, eight little-endian 32-bit words (checked against the field
// parameters by tests/test_torch_precompute.py).
__constant__ uint32_t C_EXP[8] = {0xffffffff, 0x0a117fff, 0xd0000001, 0x59aa76fe,
                                  0x5c37b001, 0x60b44d1e, 0x9a2ca556, 0x12ab655e};

// Coordinate c (0 x, 1 y, 3 z) of one packed row as digits, read with 8-byte
// loads (a coordinate's 40 bytes start 8-byte aligned).
__device__ __forceinline__ Fd fd_load_coord(const uint32_t* row, int c) {
  const uint2* r2 = reinterpret_cast<const uint2*>(row + c * MSM_LP);
  Fd r;
#pragma unroll
  for (int i = 0; i < MSM_LD / 2; ++i) {
    const uint2 v = r2[i];
    r.v[2 * i] = fd_unpack_word(v.x);
    r.v[2 * i + 1] = fd_unpack_word(v.y);
  }
  return r;
}

__device__ __forceinline__ bool fd_is_zero(const Fd& a) {
  uint32_t o = 0;
#pragma unroll
  for (int i = 0; i < MSM_LD; ++i) o |= a.v[i];
  return o == 0;
}

// A prefix's digits in words 2*MSM_LP .. 3*MSM_LP-1 of an output row, read
// back by the thread that wrote it (R where the row holds none).
__device__ __forceinline__ void fd_put_scratch(uint32_t* row, const Fd& a) {
  uint2* s = reinterpret_cast<uint2*>(row + 2 * MSM_LP);
#pragma unroll
  for (int i = 0; i < MSM_LD / 2; ++i) s[i] = make_uint2(a.v[2 * i], a.v[2 * i + 1]);
}

__device__ __forceinline__ Fd fd_get_scratch(const uint32_t* row, bool held) {
  Fd r = fd_one();
  if (held) {
    const uint2* s = reinterpret_cast<const uint2*>(row + 2 * MSM_LP);
#pragma unroll
    for (int i = 0; i < MSM_LD / 2; ++i) {
      const uint2 v = s[i];
      r.v[2 * i] = v.x;
      r.v[2 * i + 1] = v.y;
    }
  }
  return r;
}

// Element j of an array of `stride` elements in shared memory, digit-major
// (neighbouring j on neighbouring banks).
__device__ __forceinline__ void fd_put(uint32_t* s, int stride, int j, const Fd& a) {
#pragma unroll
  for (int i = 0; i < MSM_LD; ++i) s[i * stride + j] = a.v[i];
}

__device__ __forceinline__ Fd fd_get(const uint32_t* s, int stride, int j) {
  Fd r;
#pragma unroll
  for (int i = 0; i < MSM_LD; ++i) r.v[i] = s[i * stride + j];
  return r;
}

// a^(p-2) (a^-1 for a != 0 mod p) from acc = R, the plain version's chain.
__device__ __forceinline__ Fd fd_inv_fermat(const Fd& a) {
  Fd acc = fd_one();
#pragma unroll 1
  for (int b = MSM_EXP_BITS - 1; b >= 0; --b) {
    acc = mont26_reduced(acc, acc);
    if ((C_EXP[b >> 5] >> (b & 31)) & 1u) acc = mont26_reduced(acc, a);
  }
  return acc;
}

// The lane `off` below (up: true) or above; lanes at the edge get R.
__device__ __forceinline__ Fd fd_shfl_step(const Fd& a, int off, bool up) {
  const int lane = threadIdx.x & 31;
  Fd r;
#pragma unroll
  for (int i = 0; i < MSM_LD; ++i)
    r.v[i] = up ? __shfl_up_sync(0xFFFFFFFFu, a.v[i], off)
                : __shfl_down_sync(0xFFFFFFFFu, a.v[i], off);
  return fd_select(up ? lane >= off : lane + off < 32, r, fd_one());
}

// Warp 0 of the block: tot (T elements, nonzero and canonical) <- their
// inverses, as one batch.  Lane j takes elements j*G .. j*G+G-1 (local
// prefixes in lp), the lanes' products are scanned both ways by shuffles,
// and one Fermat chain inverts the block's product.
template <int T>
__device__ __forceinline__ void block_invert(uint32_t* tot, uint32_t* lp) {
  constexpr int G = T / 32;
  const int lane = threadIdx.x & 31;
  Fd v = fd_one();
#pragma unroll 1
  for (int g = 0; g < G; ++g) {
    fd_put(lp + g * MSM_LD * 32, 32, lane, v);
    v = mont26_reduced(v, fd_get(tot, T, lane * G + g));
  }
  // inc: v_0 ... v_lane; suf: v_lane ... v_31.
  Fd inc = v, suf = v;
#pragma unroll 1
  for (int off = 1; off < 32; off *= 2) {
    inc = mont26_reduced(fd_shfl_step(inc, off, true), inc);
    suf = mont26_reduced(suf, fd_shfl_step(suf, off, false));
  }
  Fd total;
#pragma unroll
  for (int i = 0; i < MSM_LD; ++i) total.v[i] = __shfl_sync(0xFFFFFFFFu, inc.v[i], 31);
  // v^-1 = total^-1 * (v_0 ... v_lane-1) * (v_lane+1 ... v_31).
  Fd inv = mont26_reduced(mont26_reduced(fd_inv_fermat(total), fd_shfl_step(suf, 1, false)),
                          fd_shfl_step(inc, 1, true));
#pragma unroll 1
  for (int g = G - 1; g >= 0; --g) {
    const Fd e = fd_get(tot, T, lane * G + g);
    fd_put(tot, T, lane * G + g, mont26_reduced(inv, fd_get(lp + g * MSM_LD * 32, 32, lane)));
    inv = mont26_reduced(inv, e);
  }
}

// Rows a thread and threads a block.  They were chosen by timing k = 8, 16
// and 32 rows a thread, with and without the block's batch inversion, on
// the precompute's rows (PERF.md §6).
constexpr int NORM_K = 16, NORM_T = 128;

// Dynamic shared memory of one block: the staging slots, the totals and
// warp 0's local prefixes (32 KB).
constexpr int NORM_SMEM =
    (NORM_T * ROW_SLOT + MSM_LD * NORM_T + (NORM_T / 32) * MSM_LD * 32) * sizeof(uint32_t);
static_assert(NORM_SMEM <= 48 * 1024, "normalize_kernel needs no opt-in shared memory");

__global__ void __launch_bounds__(NORM_T)
normalize_kernel(const uint32_t* __restrict__ in, uint32_t* __restrict__ out, long long n) {
  constexpr int K = NORM_K, T = NORM_T;
  extern __shared__ __align__(16) uint32_t smem[];
  uint32_t* slots = smem;
  uint32_t* tot = slots + T * ROW_SLOT;
  uint32_t* lp = tot + MSM_LD * T;
  const int t = threadIdx.x;
  const long long base = blockIdx.x * (long long)(T * K) + t;

  // 1. Prefix products; bit i of skip: row i is = 0 mod p or past n.
  Fd acc = fd_one();
  uint32_t skip = 0;
#pragma unroll 1
  for (int i = 0; i < K; ++i) {
    const long long r = base + (long long)i * T;
    bool zero = true;
    if (r < n) {
      fd_put_scratch(out + r * MSM_TW, acc);
      const Fd next = mont26_reduced(acc, fd_load_coord(in + r * MSM_TW, 3));
      zero = fd_is_zero(next);
      acc = fd_select(zero, acc, next);
    }
    skip |= (uint32_t)zero << i;
  }

  // 2. The inverse of this thread's total.
  fd_put(tot, T, t, acc);
  __syncthreads();
  if (t < 32) block_invert<T>(tot, lp);
  __syncthreads();
  acc = fd_get(tot, T, t);

  // 3. Back over the rows.
  uint32_t* slot = slots + t * ROW_SLOT;
  const uint32_t* wslots = slots + (t & ~31) * ROW_SLOT;
#pragma unroll 1
  for (int i = K - 1; i >= 0; --i) {
    const long long r = base + (long long)i * T;
    const long long r0 = r - (t & 31);  // the warp's first row of this step
    const bool zero = (skip >> i) & 1u;
    const uint32_t* row = in + min(r, n - 1) * MSM_TW;
    const Fd zinv = fd_select(zero, fd_zero(),
                              mont26_reduced(acc, fd_get_scratch(out + r * MSM_TW, r < n)));
    acc = fd_select(zero, acc, mont26_reduced(acc, fd_load_coord(row, 3)));
    uint32_t w[4 * MSM_LP];
    pack_digits(mont26_reduced(fd_load_coord(row, 0), zinv), w);
    pack_digits(mont26_reduced(fd_load_coord(row, 1), zinv), w + MSM_LP);
#pragma unroll
    for (int k = 2 * MSM_LP; k < 4 * MSM_LP; ++k) w[k] = 0;
    if (r0 < n)
      warp_store_packed(w, slot, wslots, out + r0 * MSM_TW, MSM_TW, (int)min(n - r0, 32LL));
  }
}

}  // namespace msm

// in, out: [n, 64] u32.  Returns the first CUDA error: a refused launch is
// not 0.
extern "C" int msm_normalize_rows(const void* in, void* out, long long n, void* stream) {
  using namespace msm;
  if (n <= 0) return (int)cudaGetLastError();
  const long long blocks = (n + NORM_T * NORM_K - 1) / (NORM_T * NORM_K);
  normalize_kernel<<<blocks, NORM_T, NORM_SMEM, (cudaStream_t)stream>>>((const uint32_t*)in,
                                                                        (uint32_t*)out, n);
  return (int)cudaGetLastError();
}
