// The bucket sort's input, in one pass over the scalars: for each scalar
// its signed c-bit digits over every window, and for the windows
// [w0, w0 + wg) each entry's sort key and signed table row, window-major.
//
//   digit d of window w: (bits [w*c, w*c + c) of the scalar) + carry, and a
//   digit >= 2^(c-1) wraps to d - 2^c with carry 1 (the final carry is
//   dropped); key[w - w0, i] = d == 0 ? nb : |d| - 1;
//   idx[w - w0, i] = row_base + w*row_stride + i, plus sbit if d < 0.
//
// Replaces no TPU kernel: the JAX package leaves this work to XLA
// (ops/convert.py::decompose_scalars_signed, then the key and row
// preparation of ops/msm_pipeline.py::window_group_bucket_sums), which the
// port ran as some 140 small PyTorch operations a scalar vector, on int64
// columns of the scalars and on the digits' transposed view.  The plain
// version (ops/kernels/digits.py) is still those operations.
//
// Bound on the H100: bytes (32 read a scalar, 8 written an entry; at 2^20
// scalars and 16 windows 160 MB).  Design: one thread a scalar.  It loads
// the scalar's eight words once, as two 16-byte loads, and runs the carry
// chain over the windows in registers: the loop over the words is
// unrolled, so each word is a register, and the windows that start in a
// word read it and the next as one 64-bit value, which covers a window
// that straddles two words (c = 13).  Consecutive threads hold consecutive
// scalars, so each window's keys and rows are written coalesced.  The
// chain stops after the last window written.
#include <cuda_runtime.h>

#include <cstdint>

namespace msm {

constexpr int DIGITS_THREADS = 256;

__global__ void __launch_bounds__(DIGITS_THREADS)
signed_window_entries_kernel(const uint4* __restrict__ scalars, int32_t* __restrict__ keys,
                             int32_t* __restrict__ idxs, int n, int c, int w0, int wg, int nb,
                             int sbit, int row_base, int row_stride) {
  const int i = blockIdx.x * DIGITS_THREADS + threadIdx.x;
  if (i >= n) return;
  const uint4 lo = __ldg(scalars + 2 * i), hi = __ldg(scalars + 2 * i + 1);
  const uint32_t s[9] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w, 0u};
  const uint32_t size = 1u << c, half = size >> 1;
  const uint64_t mask = size - 1;
  const int w1 = w0 + wg;
  uint32_t carry = 0;
  int w = 0;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const uint64_t pair = (uint64_t)s[k] | ((uint64_t)s[k + 1] << 32);
    // The windows whose first bit lies in word k.
    for (; w < w1 && w * c < 32 * (k + 1); ++w) {
      const uint32_t d = (uint32_t)((pair >> (w * c - 32 * k)) & mask) + carry;
      carry = d >= half;
      if (w >= w0) {
        const int digit = carry ? (int)d - (int)size : (int)d;
        const int at = (w - w0) * n + i;
        keys[at] = digit == 0 ? nb : abs(digit) - 1;
        idxs[at] = row_base + w * row_stride + i + (digit < 0 ? sbit : 0);
      }
    }
  }
}

}  // namespace msm

// scalars: [n, 8] u32 words, 16-byte aligned; keys, idxs: [wg, n] i32, every
// element written.  The wrapper checks that c <= 30, that every window
// written starts below bit 256, and that wg*n and every row index fit in
// 31 bits.  Returns the launch's CUDA error.
extern "C" int msm_signed_window_entries(const void* scalars, void* keys, void* idxs, long long n,
                                         long long c, long long w0, long long wg, long long nb,
                                         long long sbit, long long row_base,
                                         long long row_stride, void* stream) {
  if (n <= 0 || wg <= 0) return (int)cudaGetLastError();
  const unsigned blocks = (unsigned)((n + msm::DIGITS_THREADS - 1) / msm::DIGITS_THREADS);
  msm::signed_window_entries_kernel<<<blocks, msm::DIGITS_THREADS, 0, (cudaStream_t)stream>>>(
      (const uint4*)scalars, (int32_t*)keys, (int32_t*)idxs, (int)n, (int)c, (int)w0, (int)wg,
      (int)nb, (int)sbit, (int)row_base, (int)row_stride);
  return (int)cudaGetLastError();
}
