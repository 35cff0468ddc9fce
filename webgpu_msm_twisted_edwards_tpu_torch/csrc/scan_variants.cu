// The other scan variants of the JAX package's ops/pallas/scan.py, each an
// instantiation of scan_kernel (csrc/scan.cuh), which says what they compute,
// what bounds them and how.  They sit in their own library so that nvcc
// builds them beside scan.cu's, not after them.
#include "scan.cuh"

// _msm_scan_kernel (msm_scan): row-major rows, keys compared in the kernel.
// rows: [nf, 64, 128] u32; keys_t: [64, nf] i32; out: [nf, 32, 128] u32.
extern "C" int msm_scan_keys(const void* rows, const void* keys_t, void* out, long long nf,
                             void* stream) {
  return msm::launch_scan<msm::ROWS_RM, msm::MASK_KEYS, 2>(
      rows, nullptr, 0, 0, keys_t, out, nf, 1, stream);
}

// _msm_scan_pret_kernel (msm_scan_pret): limb-major rows, keys compared.
// rows_t: [nf/lblk, 64, 64, lblk] u32; keys_t: [64, nf] i32.
extern "C" int msm_scan_pret_keys(const void* rows_t, const void* keys_t, void* out,
                                  long long nf, long long lblk, void* stream) {
  return msm::launch_scan<msm::ROWS_PRET, msm::MASK_KEYS, 2>(
      rows_t, nullptr, 0, 0, keys_t, out, nf, lblk, stream);
}

// _msm_scan_sames_kernel (msm_scan_sames): limb-major rows, hoisted same bits.
extern "C" int msm_scan_pret_sames(const void* rows_t, const void* sames_t, void* out,
                                   long long nf, long long lblk, void* stream) {
  return msm::launch_scan<msm::ROWS_PRET, msm::MASK_SAMES, 2>(
      rows_t, nullptr, 0, 0, sames_t, out, nf, lblk, stream);
}

// _msm_scan_signed_kernel (msm_scan_signed): limb-major rows of the single
// table, bits_t (bit 0 same, bit 1 sign).
extern "C" int msm_scan_pret_signed(const void* rows_t, const void* bits_t, void* out,
                                    long long nf, long long lblk, void* stream) {
  return msm::launch_scan<msm::ROWS_PRET, msm::MASK_SIGNED, 2>(
      rows_t, nullptr, 0, 0, bits_t, out, nf, lblk, stream);
}

// _msm_scan_rm_sames_q_kernel (msm_scan_rm_sames_q): row-major rows, hoisted
// same bits, steps 4i+2 and 4i+3 stored.  out: [nf, 16, 128] u32.
extern "C" int msm_scan_rm_sames_q(const void* rows, const void* sames_t, void* out,
                                   long long nf, void* stream) {
  return msm::launch_scan<msm::ROWS_RM, msm::MASK_SAMES, 4>(
      rows, nullptr, 0, 0, sames_t, out, nf, 1, stream);
}

// _msm_scan_rm_sames_kernel (msm_scan_rm_sames) with the row gather folded
// in: step j of fragment f reads row pidx[j*psj + f*psf] of the doubled
// table, hoisted same bits.  table: [ns, 128] u32; sames_t: [64, nf] i32.
extern "C" int msm_scan_table_sames(const void* table, const void* pidx, long long psj,
                                    long long psf, const void* sames_t, void* out, long long nf,
                                    void* stream) {
  return msm::launch_scan<msm::ROWS_TABLE, msm::MASK_SAMES, 2>(
      table, pidx, psj, psf, sames_t, out, nf, 1, stream);
}
