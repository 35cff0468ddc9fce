// The row movers of the measurement probes in experiments/: the bulk-copy
// gather, the scan with prefetched table rows, the gather staged in shared
// memory, and the partition of rows into bins.
#include <cuda_runtime.h>

#include <cstdint>

#include "probe_scan.cuh"

namespace msm {

// ---------------------------------------------------------------------------
// Replaces experiments/dma_gather_probe.py::_dma_gather_kernel (dma_gather):
// out[f*K + j] = table[pidx_t[j, f]], whole 128-word rows, one DMA
// descriptor per row on the TPU.
//
// Bound on the H100: bytes (a 512-byte row read and one written per entry,
// and its index).
// Design: the Hopper counterpart of a descriptor per row is the bulk-copy
// engine (TMA without a tensor map).  Each thread owns a 512-byte slot of
// shared memory and an mbarrier; per row it issues one cp.async.bulk global
// -> shared completing on the mbarrier, waits for it, and issues one
// cp.async.bulk shared -> global store; the slot is reused once that store
// has read it.  Threads walk entries i = j*nf + f, so a warp's index loads
// are coalesced; each row is written whole.  64 threads a block (32 KB of
// slots), a grid of a few blocks per SM striding over the rows.

constexpr int BG_THREADS = 64;
constexpr unsigned BG_ROW_BYTES = MSM_TWR * 4;

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__global__ void __launch_bounds__(BG_THREADS)
bulk_gather_kernel(const uint32_t* __restrict__ table, const int32_t* __restrict__ pidx_t,
                   uint32_t* __restrict__ out, long long nf) {
  __shared__ __align__(128) uint32_t slot[BG_THREADS][MSM_TWR];
  __shared__ __align__(8) uint64_t bar[BG_THREADS];
  const int t = threadIdx.x;
  const unsigned s_slot = smem_u32(slot[t]), s_bar = smem_u32(&bar[t]);
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(s_bar) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  unsigned parity = 0;
  const long long rows = nf * MSM_K;
  for (long long i = blockIdx.x * (long long)BG_THREADS + t; i < rows;
       i += (long long)gridDim.x * BG_THREADS) {
    const long long j = i / nf, f = i % nf;
    const uint32_t* src = table + (long long)pidx_t[i] * MSM_TWR;
    uint32_t* dst = out + (f * MSM_K + j) * MSM_TWR;
    // The previous row's store has finished reading the slot.
    asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(s_bar),
                 "r"(BG_ROW_BYTES)
                 : "memory");
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
        "[%3];" ::"r"(s_slot),
        "l"(src), "r"(BG_ROW_BYTES), "r"(s_bar)
        : "memory");
    unsigned done = 0;
    do {
      asm volatile(
          "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
          " selp.u32 %0, 1, 0, p;\n}\n"
          : "=r"(done)
          : "r"(s_bar), "r"(parity)
          : "memory");
    } while (!done);
    parity ^= 1;
    asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;" ::"l"(dst),
                 "r"(s_slot), "r"(BG_ROW_BYTES)
                 : "memory");
    asm volatile("cp.async.bulk.commit_group;" ::: "memory");
  }
  asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

// ---------------------------------------------------------------------------
// Replaces experiments/fused_gather_probe.py::kern_copy, kern_scan and
// kern_fused (build): the copy phase stages each entry's table row
// table[pidx_t[j, f]] in fast memory, the scan phase is scan_out_probe.py's
// out64 scan (keys compared, sign words, every step a 64-word row) over the
// staged rows.  Copy-only writes what the TPU kernel writes,
// out[f, 0, 0..63] = the first 64 words of step 0's row; scan-only runs the
// scan phase over rows that a gather has already put in step order
// (staged[j, f] = table[pidx_t[j, f]]; on the TPU that kernel read a scratch
// that nothing wrote); fused runs both.
//
// Bound on the H100: operations for fused and scan-only (one 7-product madd
// an entry), bytes for copy-only; and latency: a fragment is a chain of 64
// dependent madds, and the probe's default has 4096 fragments, about 31 a
// SM.
// Design: four lanes a fragment on madd26_x4 (csrc/ec26.cuh), inlined, in
// 26-bit digits from the row loads to the stores: the madd's 7 products are
// two sets, so a step's dependent chain is 2 products long, not 7.  Lane q
// loads only the element of the cached row that its first product takes
// (y-x, y+x, 2*d*t on lanes 0, 1, 2; lane 3 repeats 2*d*t), negated (4p - v)
// on lanes 0, 2 and 3 where the sign word is set; the four lanes compare the
// key and select alike.  The key and sign words come a stage ahead, and
// scan-only's rows (in device memory) a step ahead, of their use, so that a
// step waits on its products, not on a load.  Each lane writes its
// coordinate's 10 packed words of the step's 64-word row and 6 of its 24
// zero words.  A block is 32 fragments: 128 threads for the scans (the
// default's 4096 fragments fill 128 of the 132 SMs; a fragment's lanes
// cannot be spread wider, so smaller blocks would still leave 32 fragments
// on the busiest SM), one warp for copy-only (with 128 threads it took
// 0.0384 ms against one warp's 0.0326 on an H100 80GB HBM3 at 700 W).
// The copy stages FG_STEPS steps at a time in shared memory (64 words a
// row at a 68-word stride, so a quarter-warp's 16-byte accesses fall on
// distinct banks), double-buffered: the block's warps issue the 16-byte
// cp.async copies of stage s+1 into one buffer (a warp a step under the
// scans), the block waits for stage s's in the other (cp.async.wait_group
// 1, then a barrier), and scans stage s while the copies of s+1 are in
// flight (2 x 4 x 32 x 272 B = 68 KB a block).  The
// quads of fragments past nf recompute fragment nf - 1 and store nothing.

constexpr int FG_FRAGS = 32;
constexpr int FG_STEPS = 4;
constexpr int FG_ROW = 68;
constexpr int FG_BUF = FG_STEPS * FG_FRAGS * FG_ROW;  // words of one stage buffer
constexpr int FG_SMEM = 2 * FG_BUF * 4;

extern __shared__ __align__(16) uint32_t fg_stage[];

// Lanes a fragment: four for the scans, one for copy-only, which has no
// products to share out.
template <bool SCAN>
__host__ __device__ constexpr int fg_lanes() {
  return SCAN ? 4 : 1;
}

// Copy the first 64 words of the table rows of steps j0 .. j0+FG_STEPS-1 of
// the block's nloc fragments into buf, row (s, l) at (s*FG_FRAGS + l)*FG_ROW.
// Each of the block's NW warps takes FG_STEPS / NW of the steps: lane l
// loads fragment l's index of each (a warp's loads on neighbouring words,
// one latency for all), then the warp copies two rows at a time, lane t the
// 16-byte piece t % 16 of row 2i + t / 16, whose index it takes from that
// row's lane by a shuffle.
template <int NW>
__device__ __forceinline__ void fg_issue(const uint32_t* table, const int32_t* pidx_t,
                                         long long nf, long long f0, int nloc, int j0,
                                         uint32_t* buf) {
  static_assert(FG_FRAGS == 32 && FG_STEPS % NW == 0, "a warp stages whole steps");
  constexpr int SPW = FG_STEPS / NW;
  const int s0 = (threadIdx.x >> 5) * SPW, t = threadIdx.x & 31, q = t & 15, half = t >> 4;
  int idx[SPW];
#pragma unroll
  for (int u = 0; u < SPW; ++u)
    idx[u] = t < nloc ? pidx_t[(j0 + s0 + u) * nf + f0 + t] : 0;
#pragma unroll
  for (int u = 0; u < SPW; ++u) {
#pragma unroll 4
    for (int i = 0; i < FG_FRAGS / 2; ++i) {
      const int l = 2 * i + half;
      const int row = __shfl_sync(0xffffffffu, idx[u], l);
      if (l < nloc)
        cp_async16(buf + ((s0 + u) * FG_FRAGS + l) * FG_ROW + 4 * q,
                   table + (long long)row * MSM_TWR + 4 * q);
    }
  }
}

// The raw words of lane q's element of a cached row (16-byte aligned): y-x,
// y+x or 2*d*t (words 0, 20 or 40, one limb a word) for q = 0, 1 and 2,
// 2*d*t for q = 3.
__device__ __forceinline__ void fg_load(const uint32_t* row, int q, uint4 (&w)[MSM_L / 4]) {
  const uint4* r4 = reinterpret_cast<const uint4*>(row + (q < 2 ? q : 2) * MSM_L);
#pragma unroll
  for (int i = 0; i < MSM_L / 4; ++i) w[i] = r4[i];
}

// fg_load's words as digits, negated (4p - v) where neg is set and the
// element is y-x or 2*d*t, as scan_out_probe.py's step negates them under
// the sign word.
__device__ __forceinline__ Fd fg_element(const uint4 (&w)[MSM_L / 4], int q, bool neg) {
  uint32_t l[MSM_L];
#pragma unroll
  for (int i = 0; i < MSM_L / 4; ++i) {
    l[4 * i] = w[i].x;
    l[4 * i + 1] = w[i].y;
    l[4 * i + 2] = w[i].z;
    l[4 * i + 3] = w[i].w;
  }
  const Fd v = fd_from_limbs(l);
  return neg && q != 1 ? fd_neg_lazy(v) : v;
}

// Lane q's part of one step's 64-word row (ec.py::pt_pack): coordinate q's
// 10 packed words at 10q, and zero words 40 + 6q .. 45 + 6q.
__device__ __forceinline__ void fg_store(uint32_t* row, const PtD& p, int q) {
  static_assert(MSM_TW - 4 * MSM_LP == 6 * 4, "six zero words a lane");
  uint32_t w[MSM_LP];
  pack_digits(fd_pick4(q, p.x, p.y, p.t, p.z), w);
  uint2* r2 = reinterpret_cast<uint2*>(row + q * MSM_LP);
#pragma unroll
  for (int i = 0; i < MSM_LP / 2; ++i) r2[i] = make_uint2(w[2 * i], w[2 * i + 1]);
  uint2* z2 = reinterpret_cast<uint2*>(row + 4 * MSM_LP + 6 * q);
#pragma unroll
  for (int i = 0; i < 3; ++i) z2[i] = make_uint2(0, 0);
}

// The key and sign words of steps j0 .. j0+FG_STEPS-1 of fragment f.
__device__ __forceinline__ void fg_words(const int32_t* keys_t, const int32_t* sgn_t,
                                         long long nf, long long f, int j0, int (&key)[FG_STEPS],
                                         int (&sgn)[FG_STEPS]) {
#pragma unroll
  for (int s = 0; s < FG_STEPS; ++s) {
    key[s] = keys_t[(j0 + s) * nf + f];
    sgn[s] = sgn_t[(j0 + s) * nf + f];
  }
}

template <bool COPY, bool SCAN>
__global__ void __launch_bounds__(FG_FRAGS * fg_lanes<SCAN>())
fused_gather_kernel(const uint32_t* __restrict__ table, const int32_t* __restrict__ pidx_t,
                    const int32_t* __restrict__ keys_t, const int32_t* __restrict__ sgn_t,
                    const uint32_t* __restrict__ staged, uint32_t* __restrict__ out,
                    long long nf) {
  constexpr int LANES = fg_lanes<SCAN>(), NW = FG_FRAGS * LANES / 32;
  const int q = threadIdx.x % LANES, l = threadIdx.x / LANES;
  const long long f0 = blockIdx.x * (long long)FG_FRAGS;
  const int nloc = (int)(nf - f0 < FG_FRAGS ? nf - f0 : FG_FRAGS);
  const bool live = l < nloc;
  const int lr = live ? l : nloc - 1;  // the fragment this quad reads
  const long long f = f0 + lr;
  const PtD ident = ptd_identity();
  PtD acc = ident;
  int kprev = -1;
  uint32_t* dst = out + f * scan_out_words<1>();  // written only where live
  // The scan's loads come a stage (keys, signs) or a step (scan-only's
  // staged rows, in device memory) ahead of their use, so that a step's
  // chain is its products, not a load's latency.
  int key[FG_STEPS], sgn[FG_STEPS];
  uint4 next[MSM_L / 4];
  if constexpr (SCAN) {
    fg_words(keys_t, sgn_t, nf, f, 0, key, sgn);
    if constexpr (!COPY) fg_load(staged + f * MSM_TWR, q, next);
  }
  if constexpr (COPY) {
    fg_issue<NW>(table, pidx_t, nf, f0, nloc, 0, fg_stage);
    cp_async_commit();
  }
#pragma unroll 1
  for (int j0 = 0; j0 < MSM_K; j0 += FG_STEPS) {
    const uint32_t* buf = fg_stage + ((j0 / FG_STEPS) & 1) * FG_BUF;
    if constexpr (COPY) {
      // Stage s+1 goes into the buffer that stage s-1 used; the barrier at
      // the end of the last pass has freed it.
      if (j0 + FG_STEPS < MSM_K)
        fg_issue<NW>(table, pidx_t, nf, f0, nloc, j0 + FG_STEPS,
                     fg_stage + ((j0 / FG_STEPS + 1) & 1) * FG_BUF);
      cp_async_commit();
      cp_async_wait<1>();
      __syncthreads();
      if constexpr (!SCAN) {
        if (j0 == 0 && live) {
          constexpr int PIECES = MSM_TW / 4 / LANES;
          const uint4* row = reinterpret_cast<const uint4*>(buf + l * FG_ROW);
          uint4* o4 = reinterpret_cast<uint4*>(dst);
#pragma unroll
          for (int c = 0; c < PIECES; ++c) o4[q * PIECES + c] = row[q * PIECES + c];
        }
      }
    }
    if constexpr (SCAN) {
      int key_n[FG_STEPS], sgn_n[FG_STEPS];
      if (j0 + FG_STEPS < MSM_K) fg_words(keys_t, sgn_t, nf, f, j0 + FG_STEPS, key_n, sgn_n);
#pragma unroll
      for (int s = 0; s < FG_STEPS; ++s) {
        const int j = j0 + s;
        uint4 w[MSM_L / 4];
        if constexpr (COPY) {
          fg_load(buf + (s * FG_FRAGS + lr) * FG_ROW, q, w);
        } else {
#pragma unroll
          for (int i = 0; i < MSM_L / 4; ++i) w[i] = next[i];
          if (j + 1 < MSM_K) fg_load(staged + ((j + 1) * nf + f) * MSM_TWR, q, next);
        }
        const bool same = key[s] == kprev;
        kprev = key[s];
        acc = madd26_x4(ptd_select(same, acc, ident), fg_element(w, q, sgn[s] != 0), q);
        if (live) fg_store(dst + j * MSM_TW, acc, q);
      }
#pragma unroll
      for (int s = 0; s < FG_STEPS; ++s) {
        key[s] = key_n[s];
        sgn[s] = sgn_n[s];
      }
    }
    if constexpr (COPY) __syncthreads();
  }
}

template <bool COPY, bool SCAN>
static int launch_fused_gather(const void* table, const void* pidx_t, const void* keys_t,
                               const void* sgn_t, const void* staged, void* out, long long nf,
                               void* stream) {
  if (nf > 0) {
    const long long blocks = (nf + FG_FRAGS - 1) / FG_FRAGS;
    const int smem = COPY ? FG_SMEM : 0;
    auto kernel = fused_gather_kernel<COPY, SCAN>;
    if (COPY) cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    kernel<<<blocks, FG_FRAGS * fg_lanes<SCAN>(), smem, (cudaStream_t)stream>>>(
        (const uint32_t*)table, (const int32_t*)pidx_t, (const int32_t*)keys_t,
        (const int32_t*)sgn_t, (const uint32_t*)staged, (uint32_t*)out, nf);
  }
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Replaces experiments/partition_probe.py::_partition_kernel (partition):
// rows routed to bins; bin b's rows, in input order, fill the 64-row tiles
// out[b*cap + 64*t ..]; only full tiles are written (a bin's tail, and every
// tile past cap, are not).  A row whose bin lies outside [0, nbins) goes
// nowhere, so the kernels need no check of the bins on the host.
//
// Bound on the H100: bytes (each row and its bin read, each row of a full
// tile written).
// Design: the TPU kernel walked rows in grid order and kept one counter per
// bin; blocks here run in no order, so a stable counting partition in three
// launches: per block of tblk rows its bin counts (shared-memory atomics);
// per bin the exclusive sum of those counts over blocks (one thread a bin)
// and its number of rows in full tiles; then per block each warp ranks its
// tblk/warps consecutive rows, 32 at a time, by the block's base, the earlier
// warps' counts and a match over the warp (stable), and copies every row
// that lands in a full tile with the whole warp, 16 bytes a lane.

constexpr int PT_TILE = 64;

__global__ void partition_count_kernel(const int32_t* __restrict__ bins,
                                       int32_t* __restrict__ counts, long long n, int tblk,
                                       int nbins) {
  extern __shared__ int32_t pt_hist[];
  for (int b = threadIdx.x; b < nbins; b += blockDim.x) pt_hist[b] = 0;
  __syncthreads();
  const long long r0 = blockIdx.x * (long long)tblk;
  for (int i = threadIdx.x; i < tblk && r0 + i < n; i += blockDim.x) {
    const int b = bins[r0 + i];
    if (0 <= b && b < nbins) atomicAdd(&pt_hist[b], 1);
  }
  __syncthreads();
  for (int b = threadIdx.x; b < nbins; b += blockDim.x)
    counts[blockIdx.x * (long long)nbins + b] = pt_hist[b];
}

// counts [nblk, nbins] becomes each block's first rank in each bin; full[b]
// the rows of bin b in full tiles that fit in cap.
__global__ void partition_offsets_kernel(int32_t* __restrict__ counts, int32_t* __restrict__ full,
                                         long long nblk, int nbins, long long cap) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= nbins) return;
  long long run = 0;
  for (long long blk = 0; blk < nblk; ++blk) {
    const int c = counts[blk * nbins + b];
    counts[blk * nbins + b] = (int)run;
    run += c;
  }
  const long long tiles = run / PT_TILE < cap / PT_TILE ? run / PT_TILE : cap / PT_TILE;
  full[b] = (int)(tiles * PT_TILE);
}

__global__ void partition_scatter_kernel(const uint4* __restrict__ rows,
                                         const int32_t* __restrict__ bins,
                                         const int32_t* __restrict__ base,
                                         const int32_t* __restrict__ full, uint4* __restrict__ out,
                                         long long n, int tblk, int nbins, long long cap) {
  extern __shared__ int32_t pt_warp[];  // [warps][nbins]
  const int t = threadIdx.x, w = t >> 5, lane = t & 31, nw = blockDim.x >> 5;
  const int per = tblk / nw;
  const long long w0 = blockIdx.x * (long long)tblk + (long long)w * per;
  int32_t* mine = pt_warp + w * nbins;
  for (int i = t; i < nw * nbins; i += blockDim.x) pt_warp[i] = 0;
  __syncthreads();
  for (int c = lane; c < per; c += 32) {
    const int b = w0 + c < n ? bins[w0 + c] : -1;
    if (0 <= b && b < nbins) atomicAdd(&mine[b], 1);
  }
  __syncthreads();
  for (int b = t; b < nbins; b += blockDim.x) {
    int run = base[blockIdx.x * (long long)nbins + b];
    for (int ww = 0; ww < nw; ++ww) {
      const int c = pt_warp[ww * nbins + b];
      pt_warp[ww * nbins + b] = run;
      run += c;
    }
  }
  __syncthreads();
  const unsigned lower = (1u << lane) - 1;
  for (int c = 0; c < per; c += 32) {
    const long long r = w0 + c + lane;
    int b = c + lane < per && r < n ? bins[r] : -1;
    const bool ok = 0 <= b && b < nbins;
    b = ok ? b : -1;
    const unsigned peers = __match_any_sync(0xffffffffu, b);
    const int rank = ok ? mine[b] + __popc(peers & lower) : 0;
    __syncwarp();
    if (ok && (peers & lower) == 0) mine[b] += __popc(peers);
    __syncwarp();
    unsigned todo = __ballot_sync(0xffffffffu, ok && rank < full[ok ? b : 0]);
    while (todo) {
      const int src = __ffs(todo) - 1;
      todo &= todo - 1;
      const long long rr = __shfl_sync(0xffffffffu, r, src);
      const long long bb = __shfl_sync(0xffffffffu, b, src);
      const long long rk = __shfl_sync(0xffffffffu, rank, src);
      out[(bb * cap + rk) * (MSM_TWR / 4) + lane] = rows[rr * (MSM_TWR / 4) + lane];
    }
  }
}

}  // namespace msm

using namespace msm;

// table: [nt, 128] u32; pidx_t: [64, nf] i32 rows in [0, nt);
// out: [nf*64, 128] u32.
extern "C" int msm_probe_bulk_gather(const void* table, const void* pidx_t, void* out,
                                     long long nf, void* stream) {
  const long long rows = nf * MSM_K;
  if (rows > 0) {
    int dev = 0, sms = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    const long long want = (rows + BG_THREADS - 1) / BG_THREADS;
    const long long blocks = want < 6LL * sms ? want : 6LL * sms;
    bulk_gather_kernel<<<blocks, BG_THREADS, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)table, (const int32_t*)pidx_t, (uint32_t*)out, nf);
  }
  return (int)cudaGetLastError();
}

// experiments/dma_gather_probe.py::_dma_scan_kernel (msm_scan_dma): the rm
// + sames scan over table rows pidx_t[j, f], each prefetched a step ahead
// into shared memory (ROWS_DMA).  table: [nt, 128] u32; pidx_t, sames_t:
// [64, nf] i32; out: [nf, 32, 128] u32.
extern "C" int msm_probe_scan_dma(const void* table, const void* pidx_t, const void* sames_t,
                                  void* out, long long nf, void* stream) {
  return launch_probe_scan<ROWS_DMA, MASK_SAMES, 2, 0>(table, pidx_t, sames_t, nullptr, out, nf,
                                                       1, stream);
}

// table: [nt, 128] u32; pidx_t, keys_t, sgn_t: [64, nf] i32; staged:
// [64, nf, 128] u32 (scan-only); out: [nf, 64, 64] u32.
extern "C" int msm_probe_gather_copy(const void* table, const void* pidx_t, void* out,
                                     long long nf, void* stream) {
  return launch_fused_gather<true, false>(table, pidx_t, nullptr, nullptr, nullptr, out, nf,
                                          stream);
}

extern "C" int msm_probe_gather_scan(const void* staged, const void* keys_t, const void* sgn_t,
                                     void* out, long long nf, void* stream) {
  return launch_fused_gather<false, true>(nullptr, nullptr, keys_t, sgn_t, staged, out, nf,
                                          stream);
}

extern "C" int msm_probe_gather_fused(const void* table, const void* pidx_t, const void* keys_t,
                                      const void* sgn_t, void* out, long long nf, void* stream) {
  return launch_fused_gather<true, true>(table, pidx_t, keys_t, sgn_t, nullptr, out, nf, stream);
}

// rows: [n, 128] u32; bins: [n] i32 in [0, nbins); counts: [ceil(n/tblk),
// nbins] i32 scratch; full: [nbins] i32 scratch; out: [nbins*cap, 128] u32.
// tblk a power of two >= 32, nbins <= 256.
extern "C" int msm_probe_partition(const void* rows, const void* bins, void* counts, void* full,
                                   void* out, long long n, long long tblk, long long nbins,
                                   long long cap, void* stream) {
  if (n > 0) {
    cudaStream_t s = (cudaStream_t)stream;
    const long long nblk = (n + tblk - 1) / tblk;
    const int threads = (int)(tblk < 1024 ? tblk : 1024);
    partition_count_kernel<<<nblk, 256, nbins * 4, s>>>((const int32_t*)bins, (int32_t*)counts,
                                                        n, (int)tblk, (int)nbins);
    partition_offsets_kernel<<<(nbins + 63) / 64, 64, 0, s>>>((int32_t*)counts, (int32_t*)full,
                                                              nblk, (int)nbins, cap);
    partition_scatter_kernel<<<nblk, threads, (threads / 32) * nbins * 4, s>>>(
        (const uint4*)rows, (const int32_t*)bins, (const int32_t*)counts, (const int32_t*)full,
        (uint4*)out, n, (int)tblk, (int)nbins, cap);
  }
  return (int)cudaGetLastError();
}
