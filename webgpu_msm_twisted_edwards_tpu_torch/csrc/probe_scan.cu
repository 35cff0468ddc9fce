// The scans of the measurement probes in experiments/, each an instantiation
// of probe_scan_kernel or scan_dual_kernel (csrc/probe_scan.cuh, which says
// what they compute, what bounds them and how).  The probes' other scans are
// kernels of the pipeline: scan_floor_probe.py's full variant is
// msm_scan_rm_sames (csrc/scan.cu), scan_tune_probe.py's msm_scan_pret and
// msm_scan_sames are msm_scan_pret_keys and msm_scan_pret_sames
// (csrc/scan_variants.cu).
#include "probe_scan.cuh"

using namespace msm;

// experiments/scan_out_probe.py::kern64 and kern128 (build): row-major rows,
// keys compared, words 0..19 and 40..59 negated where sgn_t is set.
// rows: [nf, 64, 128] u32; keys_t, sgn_t: [64, nf] i32; out: [nf, 64, 64]
// u32 (every step a row) or [nf, 32, 128] (two steps a row).
extern "C" int msm_probe_scan_out64(const void* rows, const void* keys_t, const void* sgn_t,
                                    void* out, long long nf, void* stream) {
  return launch_probe_scan<ROWS_RM, MASK_KEYS_SGN, 1, 0>(rows, nullptr, keys_t, sgn_t, out, nf,
                                                         1, stream);
}

extern "C" int msm_probe_scan_out128(const void* rows, const void* keys_t, const void* sgn_t,
                                     void* out, long long nf, void* stream) {
  return launch_probe_scan<ROWS_RM, MASK_KEYS_SGN, 2, 0>(rows, nullptr, keys_t, sgn_t, out, nf,
                                                         1, stream);
}

// experiments/scan_tune_probe.py::_kern_dual (msm_scan_dual): keys
// compared, thread f scans fragments f and f + nf/2 (two madd26 a step, or
// the G8 formula for both in dualf); out: [nf, 32, 128] u32,
// the concatenation of the probe's two outputs.  rows: [nf, 64, 128] u32
// (dual, dualf) or the limb-major [nf/lblk, 64, 64, lblk] (pret_dual).
extern "C" int msm_probe_scan_dual(const void* rows, const void* keys_t, void* out, long long nf,
                                   void* stream) {
  return launch_probe_scan<ROWS_RM, MASK_KEYS, 2, OPT_DUAL>(rows, nullptr, keys_t, nullptr, out,
                                                            nf, 1, stream);
}

extern "C" int msm_probe_scan_dualf(const void* rows, const void* keys_t, void* out, long long nf,
                                    void* stream) {
  return launch_probe_scan<ROWS_RM, MASK_KEYS, 2, OPT_DUAL | OPT_FUSE>(rows, nullptr, keys_t,
                                                                       nullptr, out, nf, 1, stream);
}

extern "C" int msm_probe_scan_pret_dual(const void* rows_t, const void* keys_t, void* out,
                                        long long nf, long long lblk, void* stream) {
  return launch_probe_scan<ROWS_PRET, MASK_KEYS, 2, OPT_DUAL>(rows_t, nullptr, keys_t, nullptr,
                                                              out, nf, lblk, stream);
}

// experiments/scan_floor_probe.py::_kern (variant) with one or all of its
// ablations: msm_scan_rm_sames (row-major rows, hoisted same bits, every
// step stored) without the segment select (nosel), storing only pair 31
// (nowrite), reading step 0's rows at every step (hoistread), or all three
// (floor); and control, the same kernel with no ablation, against which the
// ablations are measured.  All at msm_scan_rm_sames's launch geometry and
// register bound (SCAN_THREADS, SCAN_MIN_BLOCKS).  rows: [nf, 64, 128] u32;
// sames_t: [64, nf] i32; out: [nf, 32, 128] u32.
template <int OPT>
static int floor_variant(const void* rows, const void* sames_t, void* out, long long nf,
                         void* stream) {
  return launch_probe_scan<ROWS_RM, MASK_SAMES, 2, OPT>(rows, nullptr, sames_t, nullptr, out,
                                                        nf, 1, stream);
}

extern "C" int msm_probe_scan_control(const void* rows, const void* sames_t, void* out,
                                      long long nf, void* stream) {
  return floor_variant<0>(rows, sames_t, out, nf, stream);
}

extern "C" int msm_probe_scan_nosel(const void* rows, const void* sames_t, void* out,
                                    long long nf, void* stream) {
  return floor_variant<OPT_NOSEL>(rows, sames_t, out, nf, stream);
}

extern "C" int msm_probe_scan_nowrite(const void* rows, const void* sames_t, void* out,
                                      long long nf, void* stream) {
  return floor_variant<OPT_NOWRITE>(rows, sames_t, out, nf, stream);
}

extern "C" int msm_probe_scan_hoistread(const void* rows, const void* sames_t, void* out,
                                        long long nf, void* stream) {
  return floor_variant<OPT_HOIST>(rows, sames_t, out, nf, stream);
}

extern "C" int msm_probe_scan_floor(const void* rows, const void* sames_t, void* out,
                                    long long nf, void* stream) {
  return floor_variant<OPT_NOSEL | OPT_NOWRITE | OPT_HOIST>(rows, sames_t, out, nf, stream);
}
