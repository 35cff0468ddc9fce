// Point conversion: affine u32 words -> cached Montgomery table rows, and
// optionally the rows of their negations.
//
// Replaces webgpu_msm_twisted_edwards_tpu/ops/pallas/convert.py::
// _convert_kernel_full (build_table_doubled: the negations in rows n..2n-1
// of one output) and ::_convert_kernel (build_table_pair: the negations as a
// second output; build_table keeps only the first).
//
// Bound on the H100: bytes.  Each point costs 4 Montgomery products (1520
// 32-bit multiply-adds in 26-bit digits) against 64 bytes read and 512
// bytes written per output row: at 2^20 points the 1.07 GB of rows take
// 0.32 ms at the card's memory rate, the products 0.1 ms.
// Design: so the stores are what counts.  One thread per point computes in
// the 26-bit digits of csrc/field26.cuh (the words read straight into
// digits, mont26 and its reduced form, the lazy operations of
// common.py's order), inlined, no call and no stack frame; field26.cuh says
// why the digits split into the 13-bit limbs of field.cuh's product.  A
// warp's 32 points own 32 adjacent rows, 16 KB in one piece, and as many
// at n + i for the negations.  Its input words come in with coalesced
// 16-byte loads through the warp's slots in shared memory; each thread then
// writes the 80 limb words of its two rows (y-x, y+x, 2*d*t and 4p - 2*d*t)
// into its slot, and the warp writes its rows whole: one 16-byte store
// instruction a row, lane c on piece c, the 68 zero words from lanes 15-31.
// Lanes past the last point repeat it and store nothing.  build_table
// passes a null `neg`: the fixed-base table of 2^24 rows would otherwise
// write 8.6 GB that nothing reads.
#include <cuda_runtime.h>

#include "field26.cuh"

namespace msm {

constexpr int CONV_THREADS = 128;
// Words of one point's staging slot: its 16 input words on the way in, the
// 80 limb words of its rows on the way out, padded so that a quarter-warp's
// 16-byte stores of its slots fall on distinct banks.
constexpr int CONV_SLOT = 84;
// Limb words a row takes from the slot (y-x, y+x, 2*d*t), in 16-byte pieces.
constexpr int CONV_PIECES = 3 * MSM_L / 4;

// ops/convert.py::u32_words_to_limbs in digits: 8 LE u32 words -> 10
// 26-bit digits (digit i = limb 2i | limb 2i+1 << 13: bits 26i..26i+25).
__device__ __forceinline__ Fd fd_from_words(const uint32_t* w) {
  Fd r;
#pragma unroll
  for (int i = 0; i < MSM_LD; ++i) {
    const int b = i * MSM_DW, idx = b / 32, off = b % 32;
    uint32_t v = w[idx] >> off;
    if (off + MSM_DW > 32 && idx + 1 < 8) v |= w[idx + 1] << (32 - off);
    r.v[i] = v & MSM_DMASK;
  }
  return r;
}

// One element's 20 limbs (one a word, the table row's layout) into 16-byte
// aligned shared memory.
__device__ __forceinline__ void put_limbs(uint32_t* dst, const Fd& a) {
  uint4* d4 = reinterpret_cast<uint4*>(dst);
#pragma unroll
  for (int i = 0; i < MSM_LD / 2; ++i)
    d4[i] = make_uint4(a.v[2 * i] & MSM_MASK, a.v[2 * i] >> MSM_W, a.v[2 * i + 1] & MSM_MASK,
                       a.v[2 * i + 1] >> MSM_W);
}

__global__ void __launch_bounds__(CONV_THREADS)
convert_kernel(const uint32_t* __restrict__ words, uint32_t* __restrict__ out,
               uint32_t* __restrict__ neg, long long n) {
  __shared__ __align__(16) uint32_t slots[CONV_THREADS * CONV_SLOT];
  const int lane = threadIdx.x & 31;
  const long long warp0 = blockIdx.x * (long long)CONV_THREADS + (threadIdx.x & ~31);
  if (warp0 >= n) return;  // the whole warp: the kernel syncs only warps
  const int rows_valid = (int)min(n - warp0, 32LL);
  uint32_t* wslots = slots + (threadIdx.x & ~31) * CONV_SLOT;
  uint32_t* slot = wslots + lane * CONV_SLOT;

  // The warp's input, 4 pieces of 16 bytes a point, contiguous.
  const uint4* src = reinterpret_cast<const uint4*>(words + warp0 * 16);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int piece = k * 32 + lane;
    if (piece < 4 * rows_valid)
      reinterpret_cast<uint4*>(wslots + (piece >> 2) * CONV_SLOT)[piece & 3] = src[piece];
  }
  __syncwarp();
  uint32_t w[16];
  const uint4* mine = reinterpret_cast<const uint4*>(wslots + min(lane, rows_valid - 1) * CONV_SLOT);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const uint4 q = mine[k];
    w[4 * k] = q.x;
    w[4 * k + 1] = q.y;
    w[4 * k + 2] = q.z;
    w[4 * k + 3] = q.w;
  }
  __syncwarp();  // every input read before the slots are overwritten

  const Fd x = fd_from_words(w);
  const Fd y = fd_from_words(w + 8);
  const Fd xm = mont26(x, fd_r2());           // lazy, as mont_many
  const Fd ym = mont26(y, fd_r2());
  const Fd tm = mont26_reduced(xm, ym);       // reduced
  const Fd tdm = mont26_reduced(tm, fd_d());
  const Fd dm = fd_sub_lazy(ym, xm);          // y - x (+4p)
  const Fd sm = fd_add_lazy(xm, ym);          // y + x
  const Fd td2 = fd_add_lazy(tdm, tdm);       // 2*d*t
  put_limbs(slot, dm);
  put_limbs(slot + MSM_L, sm);
  put_limbs(slot + 2 * MSM_L, td2);
  put_limbs(slot + 3 * MSM_L, fd_neg_lazy(td2));
  __syncwarp();

  // Row r of the warp is point warp0 + r; lane c writes its piece c.  The
  // negation's row takes y+x, y-x, 4p - 2*d*t: pieces 5-9, 0-4, 15-19 of
  // the slot.
  const int neg_piece = lane < 5 ? lane + 5 : lane < 10 ? lane - 5 : lane + 5;
  uint4* dst = reinterpret_cast<uint4*>(out + warp0 * MSM_TWR);
#pragma unroll 4
  for (int r = 0; r < 32; ++r) {
    if (r < rows_valid) {
      uint4 v = make_uint4(0, 0, 0, 0);
      if (lane < CONV_PIECES) v = reinterpret_cast<const uint4*>(wslots + r * CONV_SLOT)[lane];
      dst[r * (MSM_TWR / 4) + lane] = v;
    }
  }
  if (neg == nullptr) return;
  dst = reinterpret_cast<uint4*>(neg + warp0 * MSM_TWR);
#pragma unroll 4
  for (int r = 0; r < 32; ++r) {
    if (r < rows_valid) {
      uint4 v = make_uint4(0, 0, 0, 0);
      if (lane < CONV_PIECES)
        v = reinterpret_cast<const uint4*>(wslots + r * CONV_SLOT)[neg_piece];
      dst[r * (MSM_TWR / 4) + lane] = v;
    }
  }
}

static int launch_convert(const void* words, void* out, void* neg, long long n, void* stream) {
  if (n > 0) {
    const long long blocks = (n + CONV_THREADS - 1) / CONV_THREADS;
    convert_kernel<<<blocks, CONV_THREADS, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)words, (uint32_t*)out, (uint32_t*)neg, n);
  }
  return (int)cudaGetLastError();
}

}  // namespace msm

// words: [n, 16] u32 (x words 0..7, y words 8..15); out: [2n, 128] u32.
extern "C" int msm_build_table_doubled(const void* words, void* out, long long n, void* stream) {
  return msm::launch_convert(words, out, (uint32_t*)out + n * MSM_TWR, n, stream);
}

// words: [n, 16] u32; out, neg: [n, 128] u32.
extern "C" int msm_build_table_pair(const void* words, void* out, void* neg, long long n,
                                    void* stream) {
  return msm::launch_convert(words, out, neg, n, stream);
}

// words: [n, 16] u32; out: [n, 128] u32 (the points' rows only).
extern "C" int msm_build_table(const void* words, void* out, long long n, void* stream) {
  return msm::launch_convert(words, out, nullptr, n, stream);
}
