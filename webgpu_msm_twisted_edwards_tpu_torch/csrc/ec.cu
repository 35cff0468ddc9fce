// Point operations over packed rows: the masked add and the per-window
// reduce built on it, the quarter-store extraction and repeated doubling.
//
// Masked add, out_i = mask_i ? a_i + b_i : a_i.
// Replaces webgpu_msm_twisted_edwards_tpu/ops/pallas/ec.py::
// _masked_add_kernel (masked_add_rows).  The MSM uses it for bucket
// extraction, the carry apply of the carry scan and the combine of point
// blocks; the per-window reduction after BPR, a loop of it in the JAX
// package, is one launch of reduce_rows_kernel below.
//
// Bound on the H100: bytes (772 bytes read and written a row, against one
// full add, 3420 32-bit multiply-adds in 26-bit digits, a set row: at the
// 2^20 path's extraction, 524288 rows, 0.121 ms against at most 0.107).
// Design: one thread per row, the add in the 26-bit digits of
// csrc/field26.cuh (full_add26, csrc/ec26.cuh, inlined: no call and no
// stack frame), from the row loads (ptd_load_packed) to the packed words;
// a row whose mask is 0 skips the add (the JAX kernel computes and
// discards it) and keeps its 40 words as they were loaded.  The warp writes
// its 32 rows whole through shared memory (row_store).
// Rows hold normalized limbs (every packed row the pipeline makes), on
// which the digits give the plain full add bit for bit (ec26.cuh).
#include <cuda_runtime.h>

#include "ec26.cuh"

namespace msm {

// Threads of a block of the row-wise kernels (masked add, doubling,
// extraction): one row a thread, each warp's 32 rows staged in the block's
// `slots` and written whole.
constexpr int ROW_THREADS = 128;

// The first row of this thread's warp in a row-wise kernel.  A warp whose
// first row is n or more returns whole (the kernels sync only warps); the
// lanes of the last warp past row n - 1 repeat it (row_of) and store
// nothing (row_store).
__device__ __forceinline__ long long row_warp0() {
  return blockIdx.x * (long long)ROW_THREADS + (threadIdx.x & ~31);
}

__device__ __forceinline__ long long row_of(long long warp0, long long n) {
  return min(warp0 + (threadIdx.x & 31), n - 1);
}

// The warp's output rows from each lane's 40 packed words w
// (ec26.cuh::warp_store_packed): two 256-byte rows a 16-byte store
// instruction, the 24 padding words zero.
__device__ __forceinline__ void row_store(const uint32_t* w, uint32_t* slots,
                                          uint32_t* __restrict__ out, long long warp0,
                                          long long n) {
  warp_store_packed(w, slots + threadIdx.x * ROW_SLOT, slots + (threadIdx.x & ~31) * ROW_SLOT,
                    out + warp0 * MSM_TW, MSM_TW, (int)min(n - warp0, 32LL));
}

__device__ __forceinline__ void row_store(const PtD& p, uint32_t* slots,
                                          uint32_t* __restrict__ out, long long warp0,
                                          long long n) {
  uint32_t w[4 * MSM_LP];
  ptd_pack(p, w);
  row_store(w, slots, out, warp0, n);
}

__global__ void __launch_bounds__(ROW_THREADS)
masked_add_kernel(const uint32_t* __restrict__ a, const uint32_t* __restrict__ b,
                  const int32_t* __restrict__ mask, uint32_t* __restrict__ out, long long n) {
  __shared__ __align__(16) uint32_t slots[ROW_THREADS * ROW_SLOT];
  const long long warp0 = row_warp0();
  if (warp0 >= n) return;
  const long long i = row_of(warp0, n);
  uint32_t w[4 * MSM_LP];
  load_packed_words(a + i * MSM_TW, w);
  if (mask[i] != 0) ptd_pack(full_add26(ptd_from_packed(w), ptd_load_packed(b + i * MSM_TW)), w);
  row_store(w, slots, out, warp0, n);
}

// Lanes that share one add in reduce_rows_kernel, the most threads of its
// blocks (64 adds at a time, so that every thread may take 255 registers:
// under __launch_bounds__(256) alone ptxas held it to 64 and spilled), and
// the most rows of a window it holds in shared memory (160 bytes each as
// digits: 160 KB of the 227 KB a block may have).
constexpr int REDUCE_LANES = 4;
constexpr int REDUCE_THREADS = 256;
constexpr int REDUCE_MAX_ROWS = 1024;

// A point kept as 4*MSM_LP digit words (x, y, t, z) in 16-byte aligned
// shared memory.
__device__ __forceinline__ PtD ptd_read_digits(const uint32_t* d) {
  uint32_t w[4 * MSM_LP];
  const uint4* d4 = reinterpret_cast<const uint4*>(d);
#pragma unroll
  for (int i = 0; i < MSM_LP; ++i) {
    const uint4 q = d4[i];
    w[4 * i] = q.x;
    w[4 * i + 1] = q.y;
    w[4 * i + 2] = q.z;
    w[4 * i + 3] = q.w;
  }
  PtD p;
#pragma unroll
  for (int i = 0; i < MSM_LD; ++i) {
    p.x.v[i] = w[i];
    p.y.v[i] = w[MSM_LD + i];
    p.t.v[i] = w[2 * MSM_LD + i];
    p.z.v[i] = w[3 * MSM_LD + i];
  }
  return p;
}

// Replaces the JAX package's per-window reduction,
// webgpu_msm_twisted_edwards_tpu/ops/pallas/bpr.py::reduce_rows_per_window:
// log2(per_window) rounds of _masked_add_kernel with every mask set, each
// round row i = row i + row (i + half) for i < half over each window's
// rows.
//
// Bound on the H100: by count, operations (per_window - 1 full adds a
// window against 256 bytes read a row); in fact latency: at 2^20 points
// and in the fixed base a window is a chain of 9 rounds of at most 256 adds
// (16 and 1 windows of 512 rows), at 2^16 points of 6 rounds (20 windows
// of 64).
// Design: one block a window, one launch for all the rounds.  The window's
// rows are loaded once, coalesced, into dynamic shared memory as 26-bit
// digits, and stay there between rounds, with a __syncthreads after each:
// a round's sums are normalized digits, which pack -> store -> load would
// give back unchanged, so the bits are the loop's.  Each add runs on four
// lanes (full_add26_x4, csrc/ec26.cuh: 3 dependent products where one
// thread has 9), inlined, no call and no stack frame; lane q writes
// coordinate q of the sum.  Adds of one round write rows below half and
// read rows i and i + half, so no add reads a row another one writes; a
// warp that holds fewer adds than groups gives its spare groups row half
// (not written in the round) and lets them store nothing.  Row 0 of the
// window is written out packed, with its 24 zero words.
__global__ void __maxnreg__(255)
reduce_rows_kernel(const uint32_t* __restrict__ rows, uint32_t* __restrict__ out,
                   int per_window) {
  extern __shared__ __align__(16) uint32_t pts[];  // per_window rows of 4*MSM_LP digits
  constexpr int RW = 4 * MSM_LP;
  const uint32_t* src = rows + blockIdx.x * (long long)per_window * MSM_TW;
  for (int k = threadIdx.x; k < per_window * MSM_LP; k += blockDim.x) {
    const int r = k / MSM_LP, c = k % MSM_LP;
    const uint4 v = reinterpret_cast<const uint4*>(src + r * MSM_TW)[c];
    reinterpret_cast<uint4*>(pts + r * RW)[c] =
        make_uint4(fd_unpack_word(v.x), fd_unpack_word(v.y), fd_unpack_word(v.z),
                   fd_unpack_word(v.w));
  }
  __syncthreads();
  const int q = threadIdx.x & (REDUCE_LANES - 1), group = threadIdx.x / REDUCE_LANES;
  const int groups = blockDim.x / REDUCE_LANES, warp_group0 = (threadIdx.x & ~31) / REDUCE_LANES;
#pragma unroll 1
  for (int half = per_window / 2; half >= 1; half /= 2) {
#pragma unroll 1
    for (int base = 0; base < half; base += groups) {
      if (base + warp_group0 < half) {  // the whole warp, for the shuffles
        const int i = base + group;
        const bool real = i < half;
        const PtD s = full_add26_x4(ptd_read_digits(pts + (real ? i : half) * RW),
                                    ptd_read_digits(pts + (real ? i + half : half) * RW), q);
        __syncwarp();  // the group has read row i before any lane writes it
        if (real) {
          const Fd c = fd_pick4(q, s.x, s.y, s.t, s.z);
          uint2* d2 = reinterpret_cast<uint2*>(pts + i * RW + q * MSM_LD);
#pragma unroll
          for (int k = 0; k < MSM_LD / 2; ++k) d2[k] = make_uint2(c.v[2 * k], c.v[2 * k + 1]);
        }
      }
    }
    __syncthreads();
  }
  if (threadIdx.x < MSM_TW / 4) {
    uint4 v = make_uint4(0, 0, 0, 0);
    if (threadIdx.x < MSM_LP) {
      const uint4 d = reinterpret_cast<const uint4*>(pts)[threadIdx.x];
      v = make_uint4(fd_pack_word(d.x), fd_pack_word(d.y), fd_pack_word(d.z), fd_pack_word(d.w));
    }
    reinterpret_cast<uint4*>(out + blockIdx.x * (long long)MSM_TW)[threadIdx.x] = v;
  }
}

// Replaces webgpu_msm_twisted_edwards_tpu/ops/pallas/ec.py::
// _double_rows_kernel (double_rows): out_i = 2^times * in_i, the doubling
// chain of the fixed-base precompute (ops/precompute.py), c doublings per
// window over every point.
//
// Bound on the H100: operations (times doublings a row, each 4 products
// and 4 squarings, 2680 multiply-adds at least (a squaring needs 55 of the
// 100 digit products), against 512 bytes read and written: at the
// precompute's 2^20 rows and times = 16, 2.684 ms).
// Design: one thread per row, the doubling in the 26-bit digits of
// csrc/field26.cuh (pt_double26, csrc/ec26.cuh, inlined: no call and no
// stack frame), the point kept in registers as digits from its row load
// (ptd_load_packed) across the `times` dependent doublings.  At 2^20 rows
// the chains fill the card, so its issue rate counts, not a chain's
// latency: one thread a row issues each product once, where four lanes a
// row (pt_double26_x4) repeat the lazy operations on every lane and
// exchange the products by shuffles (on an H100 at the precompute's 2^20
// rows, 3.74 ms a launch against the four-lane form's 4.60).  The warp
// writes its 32 rows whole through shared memory (row_store), the padding
// words zero, as the JAX kernel writes them.
// Input rows hold normalized limbs (the precompute's Montgomery rows, or
// this kernel's lazy output fed back), on which the digits give the plain
// doubling bit for bit (ec26.cuh).
__global__ void __launch_bounds__(ROW_THREADS)
double_rows_kernel(const uint32_t* __restrict__ in, uint32_t* __restrict__ out, long long n,
                   int times) {
  __shared__ __align__(16) uint32_t slots[ROW_THREADS * ROW_SLOT];
  const long long warp0 = row_warp0();
  if (warp0 >= n) return;
  PtD p = ptd_load_packed(in + row_of(warp0, n) * MSM_TW);
#pragma unroll 1
  for (int k = 0; k < times; ++k) p = pt_double26(p);
  row_store(p, slots, out, warp0, n);
}

// Replaces webgpu_msm_twisted_edwards_tpu/ops/pallas/ec.py::
// _extract_reconstruct_kernel (extract_reconstruct_rows), the extraction of
// the quarter-store scan: per bucket end, the scan value at an unstored step
// replayed from the nearest stored one, then the carry added.  Bits of
// bits[i]: 1 step at 4q (restarting from the identity unless 4), 2 step at
// 4q+1 (restarting unless 8), 16 add the carry.
//
// Bound on the H100: operations (up to two madds and one full add, 7 and 9
// products of 380 multiply-adds, per row against at most 804 used bytes
// read and 256 written: 0.121 ms at the quarter store's 2^20 call).
// Design: one thread per row, in the 26-bit digits of csrc/field26.cuh from
// the row loads to the store: madd26 and full_add26 (csrc/ec26.cuh),
// inlined, no call and no stack frame.  The pair rows' cached form is read
// with load_cached26; a step that restarts takes the identity word by word
// (ptd_select).  A step or the carry add whose bit is clear is skipped (the
// JAX kernel computes and discards it; the stored row is the same), and
// the steps are one loop body, so a warp whose lanes take different steps
// runs one madd's code twice at most.  The warp writes its 32 rows whole
// through shared memory (row_store), the 24 padding words zero.
__global__ void __launch_bounds__(ROW_THREADS)
extract_reconstruct_kernel(const uint32_t* __restrict__ base, const uint32_t* __restrict__ pair,
                           const int32_t* __restrict__ bits, const uint32_t* __restrict__ carry,
                           uint32_t* __restrict__ out, long long n, long long twr) {
  __shared__ __align__(16) uint32_t slots[ROW_THREADS * ROW_SLOT];
  const long long warp0 = row_warp0();
  if (warp0 >= n) return;
  const long long i = row_of(warp0, n);
  const int b = bits[i];
  PtD v = ptd_load_packed(base + i * MSM_TW);
  const uint32_t* rows = pair + i * 2 * twr;
#pragma unroll 1
  for (int s = 0; s < 2; ++s) {
    if (b & (1 << s)) {
      Fd d2, s2, td2;
      load_cached26(rows + s * twr, d2, s2, td2);
      v = madd26(ptd_select((b & (4 << s)) != 0, v, ptd_identity()), d2, s2, td2);
    }
  }
  if (b & 16) v = full_add26(v, ptd_load_packed(carry + i * MSM_TW));
  row_store(v, slots, out, warp0, n);
}

}  // namespace msm

// a, b, out: [n, 64] u32; mask: [n] i32.
extern "C" int msm_masked_add_rows(const void* a, const void* b, const void* mask, void* out,
                                   long long n, void* stream) {
  if (n > 0) {
    const long long blocks = (n + msm::ROW_THREADS - 1) / msm::ROW_THREADS;
    msm::masked_add_kernel<<<blocks, msm::ROW_THREADS, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)a, (const uint32_t*)b, (const int32_t*)mask, (uint32_t*)out, n);
  }
  return (int)cudaGetLastError();
}

// rows: [w*per_window, 64] u32, window-major; out: [w, 64] u32.  per_window
// a power of two in [2, 1024] (else cudaErrorInvalidValue).  Returns the
// first CUDA error: a refused shared-memory size or launch is not 0.
extern "C" int msm_reduce_rows_per_window(const void* rows, void* out, long long w,
                                          long long per_window, void* stream) {
  if (per_window < 2 || per_window > msm::REDUCE_MAX_ROWS || (per_window & (per_window - 1)))
    return (int)cudaErrorInvalidValue;
  if (w <= 0) return (int)cudaGetLastError();
  const size_t smem = (size_t)per_window * 4 * MSM_LP * sizeof(uint32_t);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        msm::reduce_rows_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  // Four lanes an add of the first round, at least one warp.
  long long threads = msm::REDUCE_LANES * (per_window / 2);
  if (threads < 32) threads = 32;
  if (threads > msm::REDUCE_THREADS) threads = msm::REDUCE_THREADS;
  msm::reduce_rows_kernel<<<(unsigned)w, (unsigned)threads, smem, (cudaStream_t)stream>>>(
      (const uint32_t*)rows, (uint32_t*)out, (int)per_window);
  return (int)cudaGetLastError();
}

// base, carry, out: [n, 64] u32; pair: [n, 2*twr] u32 (twr % 4 == 0,
// twr >= 60); bits: [n] i32.
extern "C" int msm_extract_reconstruct_rows(const void* base, const void* pair, const void* bits,
                                            const void* carry, void* out, long long n,
                                            long long twr, void* stream) {
  if (n > 0) {
    const long long blocks = (n + msm::ROW_THREADS - 1) / msm::ROW_THREADS;
    msm::extract_reconstruct_kernel<<<blocks, msm::ROW_THREADS, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)base, (const uint32_t*)pair, (const int32_t*)bits,
        (const uint32_t*)carry, (uint32_t*)out, n, twr);
  }
  return (int)cudaGetLastError();
}

// in, out: [n, 64] u32.
extern "C" int msm_double_rows(const void* in, void* out, long long n, long long times,
                               void* stream) {
  if (n > 0) {
    const long long blocks = (n + msm::ROW_THREADS - 1) / msm::ROW_THREADS;
    msm::double_rows_kernel<<<blocks, msm::ROW_THREADS, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)in, (uint32_t*)out, n, (int)times);
  }
  return (int)cudaGetLastError();
}
