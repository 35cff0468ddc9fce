// Row gather into scan order: out[f*K + j] = table[pidx_t[j, f]].
//
// Replaces webgpu_msm_twisted_edwards_tpu/ops/pallas/gather.py::
// _dma_gather_kernel (dma_row_gather), which drove the TPU's DMA engines
// with one row-copy descriptor per entry.
//
// Bound on the H100: bytes (one table row read and one written per entry,
// 512 B each at the 128-word rows of the scan input).
// Design: one warp per output row, each lane moving 16 bytes, so a warp
// reads one whole row and writes one whole row in single coalesced
// transactions.  Row and word offsets are 64-bit: at 2^20 points and c=16
// the output holds 2^31 words.
#include <cuda_runtime.h>

#include <cstdint>

namespace msm {

__global__ void __launch_bounds__(256)
row_gather_kernel(const uint4* __restrict__ table, const int32_t* __restrict__ pidx_t,
                  uint4* __restrict__ out, long long nf, long long k, long long w4) {
  const long long r = (blockIdx.x * (long long)blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (r >= nf * k) return;
  const long long f = r / k, j = r % k;
  const long long src = (long long)pidx_t[j * nf + f] * w4;
  const long long dst = r * w4;
  for (long long c = lane; c < w4; c += 32) out[dst + c] = table[src + c];
}

}  // namespace msm

// table: [nt, w] u32 (w % 4 == 0); pidx_t: [k, nf] i32 row indices in
// [0, nt); out: [nf*k, w] u32.
extern "C" int msm_row_gather(const void* table, const void* pidx_t, void* out, long long nf,
                              long long k, long long w, void* stream) {
  const long long rows = nf * k;
  if (rows > 0) {
    const int threads = 256;
    const long long blocks = (rows * 32 + threads - 1) / threads;
    msm::row_gather_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        (const uint4*)table, (const int32_t*)pidx_t, (uint4*)out, nf, k, w / 4);
  }
  return (int)cudaGetLastError();
}
