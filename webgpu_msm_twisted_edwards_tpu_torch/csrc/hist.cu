// Bucket counts per window: counts[w, b] = #{i : keys[w, i] == b}, b < nb.
//
// Replaces webgpu_msm_twisted_edwards_tpu/ops/pallas/hist.py::_hist_body
// (bucket_counts), a one-hot matrix product on the TPU's matrix unit.
//
// Bound on the H100: bytes (4 bytes read per key, 4 written per bucket).
// Design: one thread per key and one atomicAdd on the count in global memory,
// which the L2 serves; the sentinel key nb (a zero digit) is not counted.
// Equal keys contend on one address; a shared-memory histogram per block is
// the later, faster design.
#include <cuda_runtime.h>

#include <cstdint>

namespace msm {

__global__ void __launch_bounds__(256)
hist_kernel(const int32_t* __restrict__ keys, int32_t* __restrict__ counts, long long n,
            long long total, int nb) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= total) return;
  const int k = keys[i];
  if (k >= 0 && k < nb) atomicAdd(counts + (i / n) * nb + k, 1);
}

}  // namespace msm

// keys: [wg, n] i32 in [0, nb]; counts: [wg, nb] i32, zeroed by the caller.
extern "C" int msm_bucket_counts(const void* keys, void* counts, long long wg, long long n,
                                 long long nb, void* stream) {
  const long long total = wg * n;
  if (total > 0) {
    const int threads = 256;
    const long long blocks = (total + threads - 1) / threads;
    msm::hist_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        (const int32_t*)keys, (int32_t*)counts, n, total, (int)nb);
  }
  return (int)cudaGetLastError();
}
