// Bucket-point reduction and the Horner fold over windows.
#include <cuda_runtime.h>

#include "ec26.cuh"

namespace msm {

// Lanes that share one point operation (full_add26_x4, pt_double26_x4).  A
// chunk of bpr_stage1 takes two such groups, one for each of its chains, a
// chunk of bpr_stage2 one; both run in one-warp blocks.
constexpr int BPR_LANES = 4;
constexpr int BPR1_LANES = 2 * BPR_LANES;
constexpr int BPR1_THREADS = 32;
constexpr int BPR2_THREADS = 32;

// The point of the lane `mask` away (every lane of the warp takes part).
__device__ __forceinline__ PtD ptd_shfl_xor(const PtD& p, int mask) {
  PtD r;
#pragma unroll
  for (int i = 0; i < MSM_LD; ++i) {
    r.x.v[i] = __shfl_xor_sync(0xFFFFFFFFu, p.x.v[i], mask);
    r.y.v[i] = __shfl_xor_sync(0xFFFFFFFFu, p.y.v[i], mask);
    r.t.v[i] = __shfl_xor_sync(0xFFFFFFFFu, p.t.v[i], mask);
    r.z.v[i] = __shfl_xor_sync(0xFFFFFFFFu, p.z.v[i], mask);
  }
  return r;
}

// Replaces webgpu_msm_twisted_edwards_tpu/ops/pallas/bpr.py::
// _bpr_stage1_kernel (bpr_stage1): per chunk of `chunk` buckets, scanned in
// descending order, m += S_j and g += m.
//
// Bound on the H100: by count, operations (two full adds, 18 products, per
// bucket against 256 bytes read); in fact latency where chunks are few
// (512 in the fixed base, 1280 at 2^16 points): each chunk is a chain of
// dependent full adds.  At 2^20 points (8192 chunks) the card is full and
// its instruction rate counts.
// Design: as the carry scan's (csrc/scan.cu::ab_scan_kernel), the chain is
// shortened and kept in registers: full_add26_x4 (csrc/ec26.cuh, four
// lanes share an add, 3 dependent products where one thread has 9),
// inlined, m and g in 26-bit digits from the bucket row loads to their
// stores, no call and no stack frame.  g += m_i needs only m_i, so eight
// lanes share a chunk: lanes 0-3 run the m chain, m_i = m_{i-1} + S_j, and
// lanes 4-7 beside them the g chain, g += m_{i-1}, with m_{i-1} passed
// across by shuffle.  Both groups run the same code, so the warp does not
// diverge; the g group drops step 0's add (there is no m_{-1}) and the m
// group the last step's, so the chain is chunk + 1 = 65 dependent adds, not
// 128.  Each add is the plain version's, its operands in its order, so the
// bits are the same.  Lanes past the last chunk repeat it, for the
// shuffles, and store nothing; lane 0 stores m and lane 4 g.  The next
// bucket row is loaded a step ahead, off the chain (the last steps load
// row 0 again rather than branch).
__global__ void __maxnreg__(255)
bpr_stage1_kernel(const uint32_t* __restrict__ buckets, uint32_t* __restrict__ m_out,
                  uint32_t* __restrict__ g_out, long long nc, int chunk) {
  const long long t = blockIdx.x * (long long)BPR1_THREADS + threadIdx.x;
  const int q = threadIdx.x & (BPR_LANES - 1);
  const bool g_lane = (threadIdx.x & BPR_LANES) != 0;
  const bool store = t / BPR1_LANES < nc && q == 0;
  const long long ch = min(t / BPR1_LANES, nc - 1);
  const uint32_t* rows = buckets + ch * chunk * MSM_TW;
  PtD acc = ptd_identity();  // m on lanes 0-3, g on lanes 4-7
  PtD s = ptd_load_packed(rows + (chunk - 1) * MSM_TW);
#pragma unroll 1
  for (int i = 0; i <= chunk; ++i) {
    const PtD snext = ptd_load_packed(rows + max(chunk - 2 - i, 0) * MSM_TW);
    const PtD m_prev = ptd_shfl_xor(acc, BPR_LANES);
    const PtD sum = full_add26_x4(acc, ptd_select(g_lane, m_prev, s), q);
    acc = ptd_select(g_lane ? i > 0 : i < chunk, sum, acc);
    s = snext;
  }
  if (store) ptd_store_packed((g_lane ? g_out : m_out) + ch * MSM_TW, acc);
}

// Replaces webgpu_msm_twisted_edwards_tpu/ops/pallas/bpr.py::
// _bpr_stage2_kernel (bpr_stage2): g += m * ((lane % chunks_per_window) *
// chunk) by MSB-first double-and-add over num_bits bits, the lane being the
// global chunk index (pl.program_id * lblk + lane in the JAX kernel).
//
// Bound on the H100: by count, operations (num_bits doublings, an add per
// set bit of the factor and the final add, per chunk); in fact latency
// where chunks are few (512 in the fixed base, 1280 at 2^16 points): each
// chunk is a chain of num_bits dependent doublings and the adds between.
// Design: as Horner's ladder (horner_kernel below), the chain is shortened
// and kept in registers: four lanes a chunk, the doubling pt_double26_x4 (2
// dependent products where one thread has 8) and the add full_add26_x4 (3
// where it has 9), inlined, m, acc and g in 26-bit digits from their row
// loads to the store, no call and no stack frame.  The groups shuffle with
// the full mask, so a group may not skip an add that its warp-mates run:
// the warp takes a bit's add when some chunk of it has the bit set, and
// each chunk keeps the sum only where its own bit is set.  The plain
// version computes every add and selects likewise, so the kept value is
// the same; chunk = 64 makes the factor's six low bits 0 in every chunk,
// and a warp's eight neighbouring chunks share most high bits, so most of
// the adds are skipped warp-wide.  The order is the plain version's: acc
// starts at the identity and doubles MSB first (the leading doublings of
// the identity stay: they change its representative), and the last add is
// g + acc, g first.  Lanes past the last chunk repeat it, for the
// shuffles, and store nothing; lane 0 of each group stores.
__global__ void __maxnreg__(255)
bpr_stage2_kernel(const uint32_t* __restrict__ m_in, const uint32_t* __restrict__ g_in,
                  uint32_t* __restrict__ out, long long nc, long long chunks_per_window,
                  int chunk, int num_bits) {
  const long long t = blockIdx.x * (long long)BPR2_THREADS + threadIdx.x;
  const int q = threadIdx.x & (BPR_LANES - 1);
  const bool store = t / BPR_LANES < nc && q == 0;
  const long long l = min(t / BPR_LANES, nc - 1);
  // 32-bit: a 64-bit remainder is a call.
  const int kfac = (int)l % (int)chunks_per_window * chunk;
  const PtD m = ptd_load_packed(m_in + l * MSM_TW);
  PtD acc = ptd_identity();
#pragma unroll 1
  for (int bit = num_bits - 1; bit >= 0; --bit) {
    acc = pt_double26_x4(acc, q);
    const bool set = (kfac >> bit) & 1;
    if (__any_sync(0xFFFFFFFFu, set)) acc = ptd_select(set, full_add26_x4(acc, m, q), acc);
  }
  const PtD sum = full_add26_x4(ptd_load_packed(g_in + l * MSM_TW), acc, q);
  if (store) ptd_store_packed(out + l * MSM_TW, sum);
}

#define MSM_HORNER_MAX_LANES 64

// Replaces webgpu_msm_twisted_edwards_tpu/ops/pallas/bpr.py::_horner_kernel
// (horner_fold): lane l doubles S_l min(cbits*l, cbits*(w-1)) times (the
// masked ladder: identity padding lanes double too, which changes their
// representative), then log2(lanes) rounds of p_l += p_{(l+shift) % lanes}
// leave the total in lane 0.
//
// Bound on the H100: latency: one block does cbits*(w-1) dependent
// doublings (240 at 2^20 points) and log2(lanes) dependent full adds; its
// products would take under 0.05 ms even at one SM's multiply rate.
// Design: the chain is what counts, so each doubling is shortened and kept
// in registers.  Four lanes share a window (pt_double26_x4, csrc/ec26.cuh:
// 2 dependent products where one thread has 8; full_add26_x4 for the
// rounds), inlined, the point in 26-bit digits from its row load to its
// store: no call and no stack frame.  The groups shuffle with the full
// mask, so no lane may leave the ladder early: every lane walks all
// cbits*(w-1) steps and keeps the doubling while d < cbits*l, the JAX
// kernel's masked ladder (ops/pallas/bpr.py:204-207), with the same bits.
// Each round exchanges points through shared memory and adds them in the
// plain version's operand order.  The padding lanes start from the identity
// here, so the wrapper copies no padding row to the card.
__global__ void __launch_bounds__(BPR_LANES * MSM_HORNER_MAX_LANES)
horner_kernel(const uint32_t* __restrict__ sums, uint32_t* __restrict__ out, int w, int cbits,
              int lanes) {
  __shared__ PtD sh[MSM_HORNER_MAX_LANES];
  const int l = threadIdx.x / BPR_LANES;
  const int q = threadIdx.x & (BPR_LANES - 1);
  // Lanes past the last window hold the identity (the plain version's
  // padding rows).
  PtD p = ptd_select(l < w, ptd_load_packed(sums + min(l, w - 1) * MSM_TW), ptd_identity());
  const int target = cbits * l;
#pragma unroll 1
  for (int d = 0; d < cbits * (w - 1); ++d) p = ptd_select(d < target, pt_double26_x4(p, q), p);
#pragma unroll 1
  for (int shift = 1; shift < lanes; shift *= 2) {
    if (q == 0) sh[l] = p;
    __syncthreads();
    const PtD rot = sh[(l + shift) % lanes];
    __syncthreads();
    p = full_add26_x4(p, rot, q);
  }
  if (threadIdx.x == 0) ptd_store_packed(out, p);
}

}  // namespace msm

// buckets: [nc*chunk, 64] u32; m, g: [nc, 64] u32.
extern "C" int msm_bpr_stage1(const void* buckets, void* m, void* g, long long nc, long long chunk,
                              void* stream) {
  if (nc > 0) {
    const long long blocks =
        (nc * msm::BPR1_LANES + msm::BPR1_THREADS - 1) / msm::BPR1_THREADS;
    msm::bpr_stage1_kernel<<<blocks, msm::BPR1_THREADS, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)buckets, (uint32_t*)m, (uint32_t*)g, nc, (int)chunk);
  }
  return (int)cudaGetLastError();
}

// m, g, out: [nc, 64] u32.
extern "C" int msm_bpr_stage2(const void* m, const void* g, void* out, long long nc,
                              long long chunks_per_window, long long chunk, long long num_bits,
                              void* stream) {
  if (nc > 0) {
    const long long blocks =
        (nc * msm::BPR_LANES + msm::BPR2_THREADS - 1) / msm::BPR2_THREADS;
    msm::bpr_stage2_kernel<<<blocks, msm::BPR2_THREADS, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)m, (const uint32_t*)g, (uint32_t*)out, nc, chunks_per_window,
        (int)chunk, (int)num_bits);
  }
  return (int)cudaGetLastError();
}

// sums: [w, 64] u32; out: [1, 64] u32.  lanes is a power of two >= w and
// <= 64; the lanes past w start from the identity.
extern "C" int msm_horner_fold(const void* sums, void* out, long long w, long long cbits,
                               long long lanes, void* stream) {
  if (w < 1 || lanes < w || lanes > MSM_HORNER_MAX_LANES) return (int)cudaErrorInvalidValue;
  msm::horner_kernel<<<1, msm::BPR_LANES * (int)lanes, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)sums, (uint32_t*)out, (int)w, (int)cbits, (int)lanes);
  return (int)cudaGetLastError();
}
