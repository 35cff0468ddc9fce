// Bucket counts per window: counts[w, b] = #{i : keys[w, i] == b}, b < nb.
//
// Replaces webgpu_msm_twisted_edwards_tpu/ops/pallas/hist.py::_hist_body
// (bucket_counts), a one-hot matrix product on the TPU's matrix unit.
//
// Bound on the H100: bytes (4 bytes read per key, 4 written per bucket).
// Design: per-block histograms in shared memory, added up across a thread
// block cluster.  Each block keeps all nb counters of a window (128 KB at
// nb = 32768: dynamic shared memory above the 48 KB default, so the launch
// raises the limit first; a larger nb is split into nr ranges of at most
// 32768 buckets, one cluster each, every one reading all the keys) and
// counts its slice of the window's keys with atomics on its own shared
// memory.  The keys are read once, where they lie: coalesced for contiguous
// rows; for the pipeline's [n, wg]-major keys each 32-byte sector holds 8
// windows' keys, which the windows' clusters read at about the same time,
// from L2.  Equal keys of one warp are added once, by their lowest lane,
// with their count (__match_any_sync, taken only where two neighbouring
// lanes hold the same key): sorted keys, or keys that all fall in one
// bucket, do not serialise on one address, and random keys pay one shuffle
// and one vote for it.  The sentinel nb (a zero digit) and any key outside
// [0, nb) is not counted.  The cs <= 8 blocks of a cluster then split the
// buckets, and each adds its share over the cluster's histograms, read from
// their shared memory (distributed shared memory), and writes it with
// plain stores: no global atomics, nothing to zero first.  Where the
// windows give fewer clusters than the card has SMs (the fixed base's
// single merged window) each window's keys are split over g clusters,
// whose sums are added into the zeroed output with one global atomic per
// non-zero count.  (A first design gave each block of the cluster a range
// of the counters and sent every key to its owner's shared memory: on an
// H100 it took 2.7 times as long on the 2^20 path's keys, whose top window,
// scalar bits 240-249, falls in the 1024 buckets of one block's range.)
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace cg = cooperative_groups;

namespace msm {

constexpr int HIST_THREADS = 1024;
constexpr int HIST_MAX_CLUSTER = 8;  // the portable cluster size
constexpr int HIST_UNROLL = 4;       // independent key loads in flight a thread
constexpr int HIST_MAX_BINS = 32768; // counters a block: 128 KB of shared memory

// Grid: wg * nr * g clusters of cs blocks; cluster c counts, of window
// c / (nr*g), the buckets of range (c / g) % nr (rb each, from bucket
// lo = range*rb) among the keys of slice c % g.  bins: rb i32 counters of
// dynamic shared memory.
__global__ void __launch_bounds__(HIST_THREADS)
hist_kernel(const int32_t* __restrict__ keys, int32_t* __restrict__ counts, long long n, int nb,
            int rb, int nr, int g, long long stride_w, long long stride_i) {
  extern __shared__ int32_t bins[];
  cg::cluster_group cluster = cg::this_cluster();
  const int cs = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const long long c = blockIdx.x / cs, w = c / ((long long)nr * g);
  const int lo = (int)((c / g) % nr) * rb;
  const int nbins = nb - lo < rb ? nb - lo : rb;
  for (int i = threadIdx.x; i < nbins; i += HIST_THREADS) bins[i] = 0;
  __syncthreads();

  const long long slices = (long long)g * cs, slice = (c % g) * cs + rank;
  const long long per = (n + slices - 1) / slices;
  const long long i0 = slice * per, i1 = i0 + per < n ? i0 + per : n;
  const int32_t* wk = keys + w * stride_w;
  const unsigned lane = threadIdx.x & 31;
  // Every thread runs the same trip count, so that whole warps vote.  Keys
  // past the slice read as -1, which no range counts.
  for (long long base = i0; base < i1; base += (long long)HIST_THREADS * HIST_UNROLL) {
    int k[HIST_UNROLL];
#pragma unroll
    for (int u = 0; u < HIST_UNROLL; ++u) {
      const long long i = base + u * HIST_THREADS + threadIdx.x;
      k[u] = i < i1 ? __ldg(wk + i * stride_i) : -1;
    }
#pragma unroll
    for (int u = 0; u < HIST_UNROLL; ++u) {
      const int key = (unsigned)k[u] - (unsigned)lo < (unsigned)nbins ? k[u] - lo : -1;
      const int prev = __shfl_up_sync(0xffffffffu, key, 1);
      if (__any_sync(0xffffffffu, lane > 0 && key >= 0 && key == prev)) {
        const unsigned peers = __match_any_sync(0xffffffffu, key);
        if (key >= 0 && lane == (unsigned)(__ffs(peers) - 1)) atomicAdd(bins + key, __popc(peers));
      } else if (key >= 0) {
        atomicAdd(bins + key, 1);
      }
    }
  }
  cluster.sync();  // every block's histogram is complete

  const int range = (nbins + cs - 1) / cs;
  const int b0 = rank * range, b1 = b0 + range < nbins ? b0 + range : nbins;
  int32_t* out = counts + w * nb + lo;
  for (int b = b0 + threadIdx.x; b < b1; b += HIST_THREADS) {
    int32_t sum = 0;
    for (int r = 0; r < cs; ++r) sum += cluster.map_shared_rank(bins, (unsigned)r)[b];
    if (g == 1) {
      out[b] = sum;
    } else if (sum) {
      atomicAdd(out + b, sum);
    }
  }
  cluster.sync();  // no block leaves while another reads its histogram
}

}  // namespace msm

// keys: [wg, n] i32, key i of window w at keys[w*stride_w + i*stride_i]
// (the pipeline's keys are the transpose of [n, wg] digits: stride_i = wg);
// counts: [wg, nb] i32, every element written.  Returns the first CUDA
// error: a refused shared-memory size or launch is not 0.
extern "C" int msm_bucket_counts(const void* keys, void* counts, long long wg, long long n,
                                 long long nb, long long stride_w, long long stride_i,
                                 void* stream) {
  if (wg <= 0 || nb <= 0) return (int)cudaGetLastError();
  const long long nr = (nb + msm::HIST_MAX_BINS - 1) / msm::HIST_MAX_BINS;
  const long long rb = (nb + nr - 1) / nr;
  const size_t smem = (size_t)rb * sizeof(int32_t);
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  // Blocks a cluster: up to 8, at least 8 K keys each.  Clusters a window:
  // enough to cover the SMs, no more than one per 64 K keys.
  long long cs = (n + 8191) / 8192;
  if (cs > msm::HIST_MAX_CLUSTER) cs = msm::HIST_MAX_CLUSTER;
  if (cs < 1) cs = 1;
  long long g = sms / (wg * nr * cs);
  const long long by_keys = (n + 65535) / 65536;
  if (g > by_keys) g = by_keys;
  if (g < 1) g = 1;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(msm::hist_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  if (g > 1) {
    err = cudaMemsetAsync(counts, 0, (size_t)(wg * nb) * sizeof(int32_t), (cudaStream_t)stream);
    if (err != cudaSuccess) return (int)err;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(wg * nr * g * cs));
  cfg.blockDim = dim3(msm::HIST_THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, msm::hist_kernel, (const int32_t*)keys, (int32_t*)counts, n,
                           (int)nb, (int)rb, (int)nr, (int)g, stride_w, stride_i);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
