// Point conversion: affine u32 words -> cached Montgomery table rows, and
// optionally the rows of their negations.
//
// Replaces webgpu_msm_twisted_edwards_tpu/ops/pallas/convert.py::
// _convert_kernel_full (build_table_doubled: the negations in rows n..2n-1
// of one output) and ::_convert_kernel (build_table_pair: the negations as a
// second output; build_table keeps only the first).
//
// Bound on the H100: operations.  Each point costs 4 Montgomery products
// (about 3.4 K 32-bit multiply-adds) against 64 bytes read and 512 bytes
// written per output row.
// Design: one thread per point, registers only; it writes the point's row
// and, where `neg` is not null, its negation's row (y-x and y+x swapped,
// 4p - 2dt) with 16-byte stores.  build_table passes null: the fixed-base
// table of 2^24 rows would otherwise write 8.6 GB that nothing reads.
#include <cuda_runtime.h>

#include "field.cuh"

namespace msm {

// ops/convert.py::u32_words_to_limbs — 8 LE u32 words -> 20 13-bit limbs.
__device__ __forceinline__ Fe limbs_from_words(const uint32_t* w) {
  Fe r;
#pragma unroll
  for (int i = 0; i < MSM_L; ++i) {
    const int b = i * MSM_W, idx = b / 32, off = b % 32;
    uint32_t v = w[idx] >> off;
    if (off + MSM_W > 32 && idx + 1 < 8) v |= w[idx + 1] << (32 - off);
    r.v[i] = v & MSM_MASK;
  }
  return r;
}

__device__ __forceinline__ void store_row(uint32_t* row, const Fe& a, const Fe& b, const Fe& c) {
  uint32_t w[MSM_TWR];
#pragma unroll
  for (int i = 0; i < MSM_L; ++i) {
    w[i] = a.v[i];
    w[MSM_L + i] = b.v[i];
    w[2 * MSM_L + i] = c.v[i];
  }
#pragma unroll
  for (int i = 3 * MSM_L; i < MSM_TWR; ++i) w[i] = 0;
  uint4* r4 = reinterpret_cast<uint4*>(row);
#pragma unroll
  for (int i = 0; i < MSM_TWR / 4; ++i)
    r4[i] = make_uint4(w[4 * i], w[4 * i + 1], w[4 * i + 2], w[4 * i + 3]);
}

__global__ void __launch_bounds__(128)
convert_kernel(const uint32_t* __restrict__ words, uint32_t* __restrict__ out,
               uint32_t* __restrict__ neg, long long n) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= n) return;
  uint32_t w[16];
  const uint4* w4 = reinterpret_cast<const uint4*>(words + i * 16);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    uint4 q = w4[k];
    w[4 * k] = q.x;
    w[4 * k + 1] = q.y;
    w[4 * k + 2] = q.z;
    w[4 * k + 3] = q.w;
  }
  const Fe x = limbs_from_words(w);
  const Fe y = limbs_from_words(w + 8);
  const Fe r2 = fe_const(C_R2);
  const Fe xm = mont_mul(x, r2, false);      // lazy, as mont_many
  const Fe ym = mont_mul(y, r2, false);
  const Fe tm = mont_mul(xm, ym, true);      // reduced
  const Fe tdm = mont_mul(tm, fe_const(C_D), true);
  const Fe dm = fr_sub_lazy(ym, xm);         // y - x (+4p)
  const Fe sm = fr_add_lazy(xm, ym);         // y + x
  const Fe td2 = fr_add_lazy(tdm, tdm);      // 2*d*t
  store_row(out + i * MSM_TWR, dm, sm, td2);
  if (neg != nullptr) store_row(neg + i * MSM_TWR, sm, dm, fr_neg_lazy(td2));
}

static int launch_convert(const void* words, void* out, void* neg, long long n, void* stream) {
  if (n > 0) {
    const int threads = 128;
    const long long blocks = (n + threads - 1) / threads;
    convert_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
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
