// Row gather into scan order: out[f*K + j] = table[pidx_t[j, f]], whole
// rows of any width that is a multiple of 4 words.
//
// Replaces webgpu_msm_twisted_edwards_tpu/ops/pallas/gather.py::
// _dma_gather_kernel (dma_row_gather), which drove the TPU's DMA engines
// with one row-copy descriptor per entry.
//
// Bound on the H100: bytes (each table row read once, each output row
// written once, the indices read once).
// Design: at the quarter store's call (2^24 entries over the 2^21-row
// doubled table at 2^20 points) each row is named about 8 times, by entries
// sorted by bucket, so in entry order the card's 50 MB L2 catches none of
// the repeats and a copy in entry order reads about 8 tables from HBM.  So
// where a call has more than twice as many entries as table rows
// (ops/kernels/gather.py: PARTITION_ENTRIES_PER_ROW), the rows are copied in
// the order of their tile of 2^tile_log2 table rows, after a counting
// partition of the entries by tile that moves only 8-byte (output row,
// table row) pairs, in three kernels: per partition block of
// RG_PART_ENTRIES entries, its count of each tile; per tile, the exclusive
// sum of those counts over the blocks; then each block ranks its entries in
// their tiles by shared-memory atomics (one for a warp whose entries share
// a tile), stages the pairs in shared memory in tile order, and writes each
// tile's run at the tile's start plus the block's offset in it, neighbouring
// threads on neighbouring pairs.  The copy's warps in flight then name rows
// of a few tiles, which the L2 holds, and its work is split by entries, not
// by tiles, so a tile that many entries name (zero digits, padding, a hot
// row) spreads over many warps.  The order within a tile is that of the
// atomics; every order gives the same output.  Other calls copy in entry
// order in one pass, which there beats the partition's fixed cost of three
// launches (0.03-0.05 ms on the H100): the extraction gathers under
// MSM_DMA_EXTRACT at 2^20 points, up to two entries a row, fall here.
// Both copies: one warp takes 32 entries, each lane reading one entry's
// indices (coalesced: entries are numbered e = j*nf + f, the order of
// pidx_t), then moves the rows with 16-byte loads and streaming stores
// (st.global.cs, so that the written rows leave the L2 before the table's),
// a row per warp instruction at 128 words (32 lanes x 16 bytes), two at 64,
// four rows in flight a warp.  Entry numbers and divisions are 32-bit (a
// 64-bit / or % compiles to a call); row and word offsets are 64-bit: at
// 2^20 points and c = 16 the output holds 2^31 words.
#include <cuda_runtime.h>

#include <cstdint>

namespace msm {

constexpr unsigned RG_FULL = 0xffffffffu;
constexpr int RG_THREADS = 256;
// Most tiles a partition takes (8 bytes of the placing kernel's shared
// memory each).
constexpr int RG_MAX_TILES = 4096;
constexpr int RG_PART_THREADS = 1024;
// Entries a thread, and a block, of the partition.
constexpr int RG_PART_PER = 16;
constexpr unsigned RG_PART_ENTRIES = RG_PART_THREADS * RG_PART_PER;
// The placing kernel's dynamic shared memory: the block's staged pairs, and
// two words a tile.
constexpr int RG_PLACE_SMEM = RG_PART_ENTRIES * 8 + 2 * RG_MAX_TILES * 4;
// Passes of the copy in flight a warp.
constexpr int RG_UNROLL = 4;

// For i < n: the row table[src of entry i] to out[dst of entry i], where
// lane i of the warp holds entry i's (dst, src); w4 16-byte chunks a row.
// W4 == w4 where the width is 16, 32 or 64 chunks (rows of 64, 128, 256
// words), else 0 (w4 at run time, one row at a time).  n is the same on
// every lane.
template <int W4>
__device__ __forceinline__ void warp_copy_rows(const uint4* __restrict__ table,
                                               uint4* __restrict__ out, int dst, int src, int n,
                                               int w4) {
  const int lane = threadIdx.x & 31;
  if constexpr (W4 == 0) {
    for (int i = 0; i < n; ++i) {
      const long long d = (long long)__shfl_sync(RG_FULL, dst, i) * w4;
      const long long s = (long long)__shfl_sync(RG_FULL, src, i) * w4;
      for (int c = lane; c < w4; c += 32) __stcs(out + d + c, table[s + c]);
    }
  } else {
    static_assert(W4 % 32 == 0 || 32 % W4 == 0, "rows of whole or part warps");
    constexpr int G = W4 >= 32 ? 1 : 32 / W4;   // rows a pass
    constexpr int CH = W4 >= 32 ? W4 / 32 : 1;  // chunks a lane a row
    const int sub = lane / (32 / G), c0 = lane % (32 / G);
    for (int i0 = 0; i0 < n; i0 += G * RG_UNROLL) {
      uint4 v[RG_UNROLL][CH];
      long long d[RG_UNROLL];
#pragma unroll
      for (int u = 0; u < RG_UNROLL; ++u) {
        const int i = i0 + u * G + sub;
        const int from = i < n ? i : 0;
        const long long s = (long long)__shfl_sync(RG_FULL, src, from) * W4;
        d[u] = i < n ? (long long)__shfl_sync(RG_FULL, dst, from) * W4 : -1;
        if (d[u] >= 0) {
#pragma unroll
          for (int ch = 0; ch < CH; ++ch) v[u][ch] = table[s + c0 + 32 * ch];
        }
      }
#pragma unroll
      for (int u = 0; u < RG_UNROLL; ++u) {
        if (d[u] >= 0) {
#pragma unroll
          for (int ch = 0; ch < CH; ++ch) __stcs(out + d[u] + c0 + 32 * ch, v[u][ch]);
        }
      }
    }
  }
}

// The copy: warp w takes entries 32w .. 32w+31.  SORTED: entry e's (dst,
// src) is order[e]; else e is pidx_t's entry e = j*nf + f, dst = f*k + j.
template <int W4, bool SORTED>
__global__ void __launch_bounds__(RG_THREADS)
row_gather_kernel(const uint4* __restrict__ table, const int32_t* __restrict__ pidx_t,
                  const int2* __restrict__ order, uint4* __restrict__ out, unsigned nf,
                  unsigned k, unsigned entries, int w4) {
  const unsigned e0 = (blockIdx.x * RG_THREADS + threadIdx.x) & ~31u;
  if (e0 >= entries) return;
  const unsigned e = e0 + (threadIdx.x & 31);
  int dst = 0, src = 0;
  if (e < entries) {
    if constexpr (SORTED) {
      const int2 o = order[e];
      dst = o.x;
      src = o.y;
    } else {
      const unsigned j = e / nf, f = e - j * nf;
      src = pidx_t[e];
      dst = (int)(f * k + j);
    }
  }
  const unsigned left = entries - e0;
  warp_copy_rows<W4>(table, out, dst, src, left < 32 ? (int)left : 32, w4);
}

// Entry e's table row (-1 past the entries) and its tile (-1 with it).
__device__ __forceinline__ int rg_row(const int32_t* __restrict__ pidx_t, unsigned e,
                                      unsigned entries, int tile_log2, int& t) {
  const int row = e < entries ? pidx_t[e] : -1;
  t = row < 0 ? -1 : row >> tile_log2;
  return row;
}

// This entry's rank among the block's entries of tile t so far (hist[t]
// counts them), by a shared-memory atomic; a warp whose 32 entries share
// one tile takes its ranks by one atomic, so a hot row does not serialize
// the block.  t < 0: no entry, no rank.
__device__ __forceinline__ int rg_rank(int* hist, int t) {
  const int lane = threadIdx.x & 31;
  const int t0 = __shfl_sync(RG_FULL, t, 0);
  if (__all_sync(RG_FULL, t == t0)) {
    int base = 0;
    if (lane == 0 && t0 >= 0) base = atomicAdd(&hist[t0], 32);
    return __shfl_sync(RG_FULL, base, 0) + lane;
  }
  return t >= 0 ? atomicAdd(&hist[t], 1) : 0;
}

// The exclusive sum of v over the block (RG_PART_THREADS threads) and, in
// total, its sum; wsum: 32 words of shared memory.
__device__ __forceinline__ int rg_block_scan(int v, int& total, int* wsum) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int n = __shfl_up_sync(RG_FULL, incl, o);
    if (lane >= o) incl += n;
  }
  if (lane == 31) wsum[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    int w = wsum[lane];
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int n = __shfl_up_sync(RG_FULL, w, o);
      if (lane >= o) w += n;
    }
    wsum[lane] = w;
  }
  __syncthreads();
  total = wsum[31];
  const int excl = incl - v + (warp ? wsum[warp - 1] : 0);
  __syncthreads();
  return excl;
}

// Per partition block b (entries b*RG_PART_ENTRIES ..), its entries in each
// tile: counts[t*nblk + b] (tile-major, so that a tile's counts are
// neighbours).
__global__ void __launch_bounds__(RG_PART_THREADS)
rg_count_kernel(const int32_t* __restrict__ pidx_t, int32_t* __restrict__ counts,
                unsigned entries, int tile_log2, int ntiles, int nblk) {
  __shared__ int hist[RG_MAX_TILES];
  for (int t = threadIdx.x; t < ntiles; t += RG_PART_THREADS) hist[t] = 0;
  __syncthreads();
  const unsigned e0 = blockIdx.x * RG_PART_ENTRIES + threadIdx.x;
#pragma unroll
  for (int p = 0; p < RG_PART_PER; ++p) {
    int t;
    rg_row(pidx_t, e0 + p * RG_PART_THREADS, entries, tile_log2, t);
    rg_rank(hist, t);
  }
  __syncthreads();
  for (int t = threadIdx.x; t < ntiles; t += RG_PART_THREADS)
    counts[(long long)t * nblk + blockIdx.x] = hist[t];
}

// Block t: tile t's counts over the partition blocks become each block's
// offset in the tile's run; totals[t] the tile's entries.
__global__ void __launch_bounds__(RG_PART_THREADS)
rg_offsets_kernel(int32_t* __restrict__ counts, int32_t* __restrict__ totals, int nblk) {
  __shared__ int wsum[32];
  int32_t* col = counts + (long long)blockIdx.x * nblk;
  int carry = 0;
  for (int b0 = 0; b0 < nblk; b0 += RG_PART_THREADS) {
    const int b = b0 + threadIdx.x;
    const int c = b < nblk ? col[b] : 0;
    int total;
    const int excl = rg_block_scan(c, total, &wsum[0]);
    if (b < nblk) col[b] = carry + excl;
    carry += total;
  }
  if (threadIdx.x == 0) totals[blockIdx.x] = carry;
}

// Each partition block places its entries: it ranks them in their tiles
// (rg_rank), stages each (f*k + j, pidx_t[j, f]) in shared memory at its
// tile's start in the block plus its rank, then writes the staged pairs out
// in order, a tile's run at the tile's start (the exclusive sum of totals,
// taken again by every block, 4 tiles a thread) plus the block's offset in
// it: neighbouring threads write neighbouring pairs.
__global__ void __launch_bounds__(RG_PART_THREADS)
rg_place_kernel(const int32_t* __restrict__ pidx_t, const int32_t* __restrict__ counts,
                const int32_t* __restrict__ totals, int2* __restrict__ order, unsigned nf,
                unsigned k, unsigned entries, int tile_log2, int ntiles, int nblk) {
  constexpr int PER_TILE = RG_MAX_TILES / RG_PART_THREADS;
  extern __shared__ __align__(16) int rg_smem[];
  int2* stage = reinterpret_cast<int2*>(rg_smem);     // [RG_PART_ENTRIES]
  int* local = rg_smem + 2 * RG_PART_ENTRIES;          // [RG_MAX_TILES]
  int* gbase = local + RG_MAX_TILES;                   // [RG_MAX_TILES]
  __shared__ int wsum[32];
  const int tid = threadIdx.x;
  int v[PER_TILE], sum = 0, total;
#pragma unroll
  for (int p = 0; p < PER_TILE; ++p) {
    const int t = tid * PER_TILE + p;
    v[p] = t < ntiles ? totals[t] : 0;
    sum += v[p];
  }
  int base = rg_block_scan(sum, total, &wsum[0]);
#pragma unroll
  for (int p = 0; p < PER_TILE; ++p) {
    const int t = tid * PER_TILE + p;
    if (t < ntiles) {
      gbase[t] = base + counts[(long long)t * nblk + blockIdx.x];
      local[t] = 0;
    }
    base += v[p];
  }
  __syncthreads();
  const unsigned e0 = blockIdx.x * RG_PART_ENTRIES;
  int row[RG_PART_PER], rank[RG_PART_PER];
#pragma unroll
  for (int p = 0; p < RG_PART_PER; ++p) {
    int t;
    row[p] = rg_row(pidx_t, e0 + p * RG_PART_THREADS + tid, entries, tile_log2, t);
    rank[p] = rg_rank(local, t);
  }
  __syncthreads();
  // local: the block's count of each tile becomes the tile's start in stage.
  sum = 0;
#pragma unroll
  for (int p = 0; p < PER_TILE; ++p) {
    const int t = tid * PER_TILE + p;
    v[p] = t < ntiles ? local[t] : 0;
    sum += v[p];
  }
  base = rg_block_scan(sum, total, &wsum[0]);
#pragma unroll
  for (int p = 0; p < PER_TILE; ++p) {
    const int t = tid * PER_TILE + p;
    if (t < ntiles) local[t] = base;
    base += v[p];
  }
  __syncthreads();
#pragma unroll
  for (int p = 0; p < RG_PART_PER; ++p) {
    if (row[p] >= 0) {
      const unsigned e = e0 + p * RG_PART_THREADS + tid, j = e / nf, f = e - j * nf;
      stage[local[row[p] >> tile_log2] + rank[p]] = make_int2((int)(f * k + j), row[p]);
    }
  }
  __syncthreads();
  const int n = (int)(entries - e0 < RG_PART_ENTRIES ? entries - e0 : RG_PART_ENTRIES);
  for (int i = tid; i < n; i += RG_PART_THREADS) {
    const int2 o = stage[i];
    const int t = o.y >> tile_log2;
    order[gbase[t] + (i - local[t])] = o;
  }
}

template <bool SORTED>
static int launch_copy(const void* table, const void* pidx_t, const void* order, void* out,
                       long long nf, long long k, long long entries, long long w,
                       cudaStream_t stream) {
  if (entries <= 0) return (int)cudaGetLastError();
  if (entries >= (1LL << 31) || w <= 0 || w % 4) return (int)cudaErrorInvalidValue;
  const int w4 = (int)(w / 4);
  void (*kernel)(const uint4*, const int32_t*, const int2*, uint4*, unsigned, unsigned, unsigned,
                 int);
  switch (w4) {
    case 16: kernel = row_gather_kernel<16, SORTED>; break;
    case 32: kernel = row_gather_kernel<32, SORTED>; break;
    case 64: kernel = row_gather_kernel<64, SORTED>; break;
    default: kernel = row_gather_kernel<0, SORTED>; break;
  }
  const unsigned blocks = (unsigned)((entries + RG_THREADS - 1) / RG_THREADS);
  kernel<<<blocks, RG_THREADS, 0, stream>>>((const uint4*)table, (const int32_t*)pidx_t,
                                            (const int2*)order, (uint4*)out, (unsigned)nf,
                                            (unsigned)k, (unsigned)entries, w4);
  return (int)cudaGetLastError();
}

}  // namespace msm

// The copy in entry order.  table: [nt, w] u32 (w % 4 == 0); pidx_t: [k, nf]
// i32 row indices in [0, nt); out: [nf*k, w] u32; nf*k < 2^31.
extern "C" int msm_row_gather(const void* table, const void* pidx_t, void* out, long long nf,
                              long long k, long long w, void* stream) {
  return msm::launch_copy<false>(table, pidx_t, nullptr, out, nf, k, nf * k, w,
                                 (cudaStream_t)stream);
}

// The partition of pidx_t's entries by tile of 2^tile_log2 table rows
// (ntiles of them, at most RG_MAX_TILES).  counts: [ntiles,
// ceil(nf*k / RG_PART_ENTRIES)] i32 and totals: [ntiles] i32 scratch;
// order: [nf*k, 2] i32, (output row, table row) of every entry, tiles in
// non-decreasing order.
extern "C" int msm_row_gather_partition(const void* pidx_t, void* counts, void* totals,
                                        void* order, long long nf, long long k,
                                        long long tile_log2, long long ntiles, void* stream) {
  const long long entries = nf * k;
  if (entries <= 0) return (int)cudaGetLastError();
  if (entries >= (1LL << 31) || ntiles < 1 || ntiles > msm::RG_MAX_TILES || tile_log2 < 0 ||
      tile_log2 > 30)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int nblk = (int)((entries + msm::RG_PART_ENTRIES - 1) / msm::RG_PART_ENTRIES);
  const cudaError_t err = cudaFuncSetAttribute(
      msm::rg_place_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, msm::RG_PLACE_SMEM);
  if (err != cudaSuccess) return (int)err;
  msm::rg_count_kernel<<<nblk, msm::RG_PART_THREADS, 0, s>>>(
      (const int32_t*)pidx_t, (int32_t*)counts, (unsigned)entries, (int)tile_log2, (int)ntiles,
      nblk);
  msm::rg_offsets_kernel<<<(unsigned)ntiles, msm::RG_PART_THREADS, 0, s>>>(
      (int32_t*)counts, (int32_t*)totals, nblk);
  msm::rg_place_kernel<<<nblk, msm::RG_PART_THREADS, msm::RG_PLACE_SMEM, s>>>(
      (const int32_t*)pidx_t, (const int32_t*)counts, (const int32_t*)totals, (int2*)order,
      (unsigned)nf, (unsigned)k, (unsigned)entries, (int)tile_log2, (int)ntiles, nblk);
  return (int)cudaGetLastError();
}

// The copy in the order of msm_row_gather_partition: out[order[e, 0]] =
// table[order[e, 1]] for every e < entries.  table: [nt, w] u32 (w % 4 ==
// 0); out: [entries, w] u32.
extern "C" int msm_row_gather_sorted(const void* table, const void* order, void* out,
                                     long long entries, long long w, void* stream) {
  return msm::launch_copy<true>(table, nullptr, order, out, 1, 1, entries, w,
                                (cudaStream_t)stream);
}
