#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one CUDA card.

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero):
1. the card's name and power limit, the torch and CUDA versions;
2. build of every kernel from csrc/ (nvcc, in parallel), its seconds,
   each kernel function's registers and spills, the IMAD.WIDE.U32 count of
   the main path's scan (cuobjdump -sass), from which MONT is taken, and
   the registers, stack frame and calls of the kernels whose point or field
   operations are inlined (INLINED: the carry scan, bpr_stage1, bpr_stage2,
   the Horner fold, the masked add, the per-window reduce, the quarter-store
   extraction, the repeated doubling, the table conversion, the
   normalization, every instantiation of the probes' two scan templates and
   of the fused-gather probe's kernel, and the row gather's copies and its
   partition's three kernels; a frame or a call fails);
3. the main path: compute_msm at 2^16 points (c=13) and at 2^20 points
   (c=16) on inputs resident on the card (points from the native oracle's
   generator, scalars from a seeded numpy generator): kernel launch counts
   of one run, started from zero (the scan that reads the table by index
   once per window group, no gather kernel and no scan of gathered rows,
   MASKED_ADD_LAUNCHES masked adds and one per-window reduce), then one
   warm and five timed runs, and the result checked against the C++
   oracle;
4. each of the nine kernels replayed on the inputs of its largest call in
   the 2^20 run, held bit for bit against its plain PyTorch version, and
   timed beside that version, the PyTorch library call that computes the
   same function (where one exists) and its bound; bpr_stage2 also held on
   the 2^16 run's input;
5. the fixed-base path on the 2^20 inputs: precompute_msm_base (c=16, W'=16,
   a merged table of 2^24 rows) timed with its launch counts, then
   compute_msm_precomputed with its launch counts (the single table read by
   index in the scan, no gather), one warm and five timed runs, its result
   checked against the 2^20 compute_msm answer (which phase 3 held to the
   oracle), and once more forced into two entry blocks;
6. the four kernels of the fixed-base path replayed as in 4; the whole
   output of each row-wise one (convert_pair, double_rows, normalize) is
   held against its plain version in chunks of PLAIN_ROWS rows; double_rows
   and normalize also on each of the precompute's other inputs and
   bpr_stage2 on the fixed-base MSM's input;
7. the scan configurations at 2^20: compute_msm under each setting of the
   pipeline's switches in CONFIGS (the module attributes, set and restored
   here), launch counts of one run from zero, then one warm and three
   timed runs, each result equal to the 2^20 answer of phase 3; the fused
   gather-scan (window_group_bucket_sums(fused=True), which the default
   runs too) on the 2^20 table and digits of one window group, its bucket
   rows bit for bit equal to the quarter store's (a scan of rows that the
   gather kernel copied), and on the same inputs the fused scan timed
   against msm_scan_table_sames with the same-bit pass it needs, on the
   indices where they lie and on a contiguous copy; and the ten kernels of
   these configurations replayed as in 4 (extract_reconstruct in chunks of
   PLAIN_ROWS rows; the row gather, its partition and copy timed as one
   call, on the quarter store's call, where a launch counts a call of a C
   entry (the partition's runs three kernels, then the copy: 2); the four
   scans that no configuration runs: msm_scan_table_sames on the fused
   call's inputs, the scans of gathered rows on the rows of the
   quarter-store run, with its same bits or the keys of the pret run with
   the same bits off, and on the single-table run's rows gathered by
   indexing);
8. the measurement probes of experiments/ (webgpu_msm_twisted_edwards_tpu_
   torch/experiments/): each probe's main() at the JAX probe's default
   shape, its launch counts from zero, then each of its kernels replayed on
   the inputs of its largest call as in 4, on the part of the output that
   it writes (the ablations that store one pair, copy-only's first step,
   the partition's full tiles), copy-only's library call timed both on that
   output and, as library_staging_ms, on all the rows it stages;
9. the small-input path: compute_msm at each of SMALL_CASES (511 and 4095
   points at the sizing rule's c=4, 4096 points at c=6) on the benchmark
   inputs, launch counts from zero (no kernel may launch), one warm and
   SMALL_RUNS timed runs, each result checked against the oracle; and
   use_kernels=False at 4096 points, c=8, equal to the kernels' answer;
10. compute_msm_batch at 2^20 over BATCH_K scalar vectors on the card (the
   first is phase 3's): launch counts from zero (one table conversion,
   BATCH_K scans a window group), each result equal to compute_msm on its
   vector, the median of BATCH_RUNS timed runs beside BATCH_K times phase
   3's one-shot median, then once more forced into two point blocks (two
   conversions), equal;
11. validate_pipeline at each of VALIDATE_CASES (1024 points at c=8, and at
   c=4, whose bucket counts are a binary search), every stage "ok", with
   its seconds;
12. the benchmark CLI (webgpu_msm_twisted_edwards_tpu_torch/benchmarks/):
   main() in this process on each argument list of BENCH_COMMANDS, every
   subcommand once (scaling in both modes); each table printed with its
   seconds, every "correct" cell must read ✓ (a subcommand's own check
   raises), and the launch counts of each subcommand, from zero, must
   include the kernels BENCH_KERNELS names for it;
13. the multi-device layer (webgpu_msm_twisted_edwards_tpu_torch/parallel/):
   compute_msm_sharded at 2^20 over meshes of SHARD_MESHES shards (distinct
   cards where the machine has them, else cuda:0 repeated), staged and
   shard after shard, and CHAIN_SHARDS shards at CHAIN_N points (the chain
   fold), each with its launch counts of one run from zero
   (sharded_launches), the fold's reduce or masked adds held against their
   plain versions, SHARDED_RUNS timed runs and its peak memory, each result
   equal to phase 3's answer (the chain's to compute_msm and the oracle);
   compute_msm_batch_sharded over phase 10's vectors on BATCH_SHARDS shards,
   equal to phase 10's answers; and torch.distributed jobs in child
   processes (two gloo ranks on the card, one NCCL rank, two NCCL ranks on
   two cards where there are two), each rank's compute_msm_multihost equal
   to phase 3's answer and its compute_msm_batch_multihost to phase 10's.

It prints, on lines of their own before the last, the card line from
nvidia-smi and one JSON object {"kernels": [...]}, and as its last line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import time
from typing import Callable, NamedTuple

import numpy as np
import torch

#: Peaks of one H100 SXM (NVIDIA data sheet, 700 W): HBM bytes/s, and the
#: 32-bit integer multiply-add rate.  The data sheet gives only the fp32
#: rate outside the tensor cores (67e12 operations/s, 128 FMAs of 2
#: operations per clock per SM); the CUDA C++ Programming Guide's throughput
#: table gives 64 32-bit integer multiply-adds per clock per SM against
#: those 128 FMAs for compute capability 9.0, so a quarter of it.
PEAK_BYTES_PER_S = 3.35e12
PEAK_IMAD_PER_S = 67e12 / 4
#: 32-bit multiply-adds of one Montgomery product, the fewest a kernel of
#: the port issues: the scans' product in 26-bit digits (csrc/field26.cuh)
#: is 190 IMAD.WIDE.U32 (100 x_i*y_j and 90 q*p_j; p's low digit is 1 and
#: the quotient digit is a negation), each counted as two 32-bit
#: multiply-adds; phase 2 prints the count in the compiled scan.  A
#: squaring needs only 55 of the 100 digit products
#: (x_i*x_j once for i < j, then doubled) for the same column sums, so its
#: least work is 2 * (55 + 90); a doubling's 8 products are 4 squarings.
MONT = 2 * 190
SQR = 2 * (55 + 90)
MADD, FULL_ADD, DOUBLE = 7 * MONT, 9 * MONT, 4 * MONT + 4 * SQR

RUNS = 5
#: Rows of each call of a row-wise kernel's plain version: the kernel's
#: output over the whole input is held against it chunk by chunk.
PLAIN_ROWS = 1 << 16
REPO = os.path.dirname(os.path.abspath(__file__))
JAX_PKG = "webgpu_msm_twisted_edwards_tpu/ops/"


def log(msg: str) -> None:
    print(msg, flush=True)


def sass_count(lib: str, kernel: str, opcode: str) -> int | None:
    """Instructions of one opcode (exactly, modifiers included) in a kernel
    of a built library (cuobjdump -sass); None where the toolkit has no
    cuobjdump."""
    from webgpu_msm_twisted_edwards_tpu_torch.ops.kernels import _build

    exe = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(exe):
        return None
    sass = subprocess.run([exe, "-sass", "-fun", kernel, _build._lib_path(lib)],
                          capture_output=True, text=True, check=True).stdout
    return sum(1 for ln in sass.splitlines() if f" {opcode} " in ln)


def ptxas_function(lib: str, part: str) -> str:
    """The mangled name of the one function of a built library whose name
    holds `part`, from the library's ptxas report."""
    from webgpu_msm_twisted_edwards_tpu_torch.ops.kernels import _build

    names = [ln.split(":")[0] for ln in _build.ptxas_report()[lib] if part in ln.split(":")[0]]
    if len(names) != 1:
        raise AssertionError(f"{lib}: functions named like {part}: {names}")
    return names[0]


#: (library, kernel, instantiations) of the kernels whose point or field
#: operations are inlined (csrc/ec26.cuh, csrc/field26.cuh): every function
#: of the library whose name holds `kernel` (a template's instantiations) has
#: no stack frame and no call, and there are `instantiations` of them, or
#: phase 2 fails.  The probes' templates: probe_scan_kernel's out64, out128
#: and five floor variants and scan_dual_kernel's dual, dualf and pret+dual
#: (csrc/probe_scan.cu), probe_scan_kernel's prefetching scan and
#: fused_gather_kernel's copy-only, scan-only and fused (csrc/probe_move.cu).
#: The row gather's copy (four widths, two orders) and its partition's three
#: kernels divide in 32 bits, so they too have no call.
INLINED = (("scan", "ab_scan_kernel", 1), ("bpr", "bpr_stage1_kernel", 1),
           ("bpr", "bpr_stage2_kernel", 1), ("bpr", "horner_kernel", 1),
           ("ec", "masked_add_kernel", 1), ("ec", "reduce_rows_kernel", 1),
           ("ec", "extract_reconstruct_kernel", 1), ("ec", "double_rows_kernel", 1),
           ("convert", "convert_kernel", 1), ("precompute", "normalize_kernel", 1),
           ("probe_scan", "probe_scan_kernel", 7), ("probe_scan", "scan_dual_kernel", 3),
           ("probe_move", "probe_scan_kernel", 1), ("probe_move", "fused_gather_kernel", 3),
           ("gather", "row_gather_kernel", 8), ("gather", "rg_count_kernel", 1),
           ("gather", "rg_offsets_kernel", 1), ("gather", "rg_place_kernel", 1))
#: masked_add launches of one MSM at 2^16 and 2^20 points and in the fixed
#: base (one entry block): the bucket extraction and the carry scan's two
#: carry applies; the per-window reduce after BPR is one reduce_rows launch.
MASKED_ADD_LAUNCHES = 3


def check_inlined(lib: str, kernel: str, instantiations: int) -> None:
    """Log the ptxas line (registers, frame, spills) and the calls in SASS of
    every function of `lib` whose name holds `kernel`; raise unless there are
    `instantiations` of them, or if one has a stack frame or a call, or if
    cuobjdump cannot show that it has none."""
    from webgpu_msm_twisted_edwards_tpu_torch.ops.kernels import _build

    lines = [ln for ln in _build.ptxas_report()[lib] if kernel in ln.split(":")[0]]
    if len(lines) != instantiations:
        raise AssertionError(f"{lib}: {len(lines)} functions named like {kernel}, expected "
                             f"{instantiations}: {lines}")
    for line in lines:
        fn = line.split(":")[0]
        frame = int(re.search(r": (\d+) bytes stack frame", line).group(1))
        calls = sass_count(lib, fn, "CALL.REL.NOINC")
        log(f"{kernel if instantiations == 1 else fn}: {line.split(': ', 1)[1]}; "
            f"{'calls not counted' if calls is None else f'{calls} calls'}")
        if frame or calls is None or calls:
            raise AssertionError(f"{fn} has a stack frame or calls: {line}, {calls}")


@contextlib.contextmanager
def every_call(*kernels: str):
    """Within the block, keep the arguments of every call of the wrappers of
    `kernels` (by capture and launch key): yields {kernel: [args, ...]}."""
    from webgpu_msm_twisted_edwards_tpu_torch.ops.kernels import _build

    record, calls = _build.capture, {k: [] for k in kernels}

    def capture(kernel, *args):
        if kernel in calls:
            calls[kernel].append(args)
        record(kernel, *args)

    _build.capture = capture
    try:
        yield calls
    finally:
        _build.capture = record


def hold_calls(name: str, wrapper, plain, calls: list, chunk: int | None = None) -> None:
    """Hold the kernel's whole output on each call's arguments bit for bit
    against its plain version (a row-wise kernel's in chunks of `chunk`
    rows); raise on a difference."""
    for args in calls:
        got = wrapper(*args)
        n = args[0].shape[0]
        step = chunk or n
        for i in range(0, n, step):
            sub = tuple(a[i:i + step] if chunk and isinstance(a, torch.Tensor)
                        and a.shape[0] == n else a for a in args)
            err = max_err(name, (got[i:i + step],), (plain(*sub),))
            if err:
                raise AssertionError(f"{name}: kernel differs from its plain version (max abs "
                                     f"err {err}) on {[tuple(a.shape) for a in args[:1]]}")
        del got
    log(f"kernel {name}: match on {len(calls)} more call(s), rows "
        f"{[a[0].shape[0] for a in calls]}")


def card_inputs(n: int):
    """The benchmark inputs at n points: numpy (points, scalars) and the
    packed [n, 2, 8] and [n, 8] int32 tensors on the card."""
    from webgpu_msm_twisted_edwards_tpu_torch.utils.interop import from_numpy_u32
    from webgpu_msm_twisted_edwards_tpu_torch.utils.profiling import bench_inputs

    pts, sc = bench_inputs(n)
    coords = from_numpy_u32(pts.view(np.uint32).reshape(n, 2, 8), "cuda")
    scalars = from_numpy_u32(sc.view(np.uint32).reshape(n, 8), "cuda")
    torch.cuda.synchronize()
    return pts, sc, coords, scalars


def main_path(n: int, capture: bool) -> dict:
    """Drive compute_msm at n points; returns its numbers."""
    from webgpu_msm_twisted_edwards_tpu_torch import compute_msm
    from webgpu_msm_twisted_edwards_tpu_torch.ops import msm_pipeline as MP
    from webgpu_msm_twisted_edwards_tpu_torch.ops.kernels import _build
    from webgpu_msm_twisted_edwards_tpu_torch.utils import oracle
    from webgpu_msm_twisted_edwards_tpu_torch.utils.params import tpu_msm_config

    pts, sc, coords, scalars = card_inputs(n)
    cfg = tpu_msm_config(n)
    groups = cfg.num_windows // MP.default_window_group(n, cfg.num_windows, coords.device)

    _build.captures = {} if capture else None
    _build.reset_launch_counts()
    # Every masked_add call of this run, for the bound of all of them; the
    # bpr_stage2 call, held against its plain version at every size.
    with every_call("masked_add", "bpr2") as calls:
        t0 = time.time()
        res = compute_msm(coords, scalars)
        first_ms = (time.time() - t0) * 1e3
    masked_adds = calls["masked_add"]
    launches = dict(_build.launches)
    captures, _build.captures = _build.captures, None
    masked_add_bound_ms = sum(bound_ms(*work("masked_add", args, args[0])) for args in masked_adds)

    times = []
    for _ in range(RUNS):
        t0 = time.time()
        again = compute_msm(coords, scalars)
        times.append((time.time() - t0) * 1e3)
        if again != res:
            raise AssertionError(f"2^{n.bit_length() - 1}: runs disagree")
    t0 = time.time()
    want = oracle.msm_parallel(pts, sc, c=16)
    oracle_s = time.time() - t0
    if (res["x"], res["y"]) != want:
        raise AssertionError(f"2^{n.bit_length() - 1}: got {res}, oracle {want}")
    return {"n": n, "launches": launches, "groups": groups, "first_ms": first_ms,
            "runs_ms": times, "median_ms": statistics.median(times), "oracle": "MATCH",
            "oracle_s": oracle_s, "masked_add_rows": [a[0].shape[0] for a in masked_adds],
            "masked_add_bound_ms": masked_add_bound_ms, "captures": captures,
            "bpr2_calls": calls["bpr2"], "result": res}


#: Kernels each run of the fixed-base path must launch.
PRECOMPUTE_LAUNCHES = {"convert_pair": 1, "double_rows": 15, "normalize": 15}
FIXED_BASE_MSM_KERNELS = ("hist", "scan_table_signed", "ab_scan", "masked_add", "bpr1", "bpr2",
                          "reduce_rows")


def fixed_base_path(n: int, want: dict) -> dict:
    """Drive precompute_msm_base and compute_msm_precomputed at n points;
    `want` is compute_msm's answer on the same inputs.  Returns the numbers
    and the captured inputs of the four fixed-base kernels."""
    from webgpu_msm_twisted_edwards_tpu_torch import compute_msm_precomputed, precompute_msm_base
    from webgpu_msm_twisted_edwards_tpu_torch.ops import precompute as PRE
    from webgpu_msm_twisted_edwards_tpu_torch.ops.kernels import _build

    _, _, coords, scalars = card_inputs(n)
    _build.captures = {}
    _build.reset_launch_counts()
    with every_call("double_rows", "normalize") as pre_calls:
        t0 = time.time()
        pre = precompute_msm_base(coords)
        torch.cuda.synchronize()
        precompute_s = time.time() - t0
    pre_launches = dict(_build.launches)
    if pre_launches != PRECOMPUTE_LAUNCHES:
        raise AssertionError(f"precompute launches {pre_launches}, expected {PRECOMPUTE_LAUNCHES}")
    if (pre.cfg.chunk_size, pre.cfg.num_windows, pre.table.shape[0]) != (16, 16, 16 * n):
        raise AssertionError(f"precompute: c={pre.cfg.chunk_size}, W'={pre.cfg.num_windows}, "
                             f"table {tuple(pre.table.shape)}")

    _build.reset_launch_counts()
    with every_call("bpr2") as msm_calls:
        t0 = time.time()
        res = compute_msm_precomputed(pre, scalars)
        first_ms = (time.time() - t0) * 1e3
    launches = dict(_build.launches)
    captures = {k: v for k, v in _build.captures.items()
                if k in ("convert_pair", "double_rows", "normalize", "scan_table_signed")}
    _build.captures = None
    if res != want:
        raise AssertionError(f"fixed base: got {res}, compute_msm {want}")
    missing = [k for k in FIXED_BASE_MSM_KERNELS if launches.get(k, 0) < 1]
    if (missing or launches["masked_add"] != MASKED_ADD_LAUNCHES
            or launches["reduce_rows"] != 1
            or any(launches.get(k, 0) for k in ("gather", "scan_signed", "scan_fused", "horner"))):
        raise AssertionError(f"fixed-base MSM launches {launches}; missing {missing}")

    times = []
    compute_msm_precomputed(pre, scalars)
    for _ in range(RUNS):
        t0 = time.time()
        again = compute_msm_precomputed(pre, scalars)
        times.append((time.time() - t0) * 1e3)
        if again != res:
            raise AssertionError("fixed base: runs disagree")

    # Two entry blocks, as a smaller card would stream them: the blocks'
    # bucket arrays are added on the masked-add kernel (counted by a spy on
    # that stage).
    pre2 = dataclasses.replace(pre, nblk=pre.n_entries // 2, blocks=2)
    accum, accum_calls = PRE._stage_merged_accum, []
    PRE._stage_merged_accum = lambda acc, part: (accum_calls.append(1), accum(acc, part))[1]
    _build.reset_launch_counts()
    try:
        t0 = time.time()
        res2 = compute_msm_precomputed(pre2, scalars)
        two_block_ms = (time.time() - t0) * 1e3
    finally:
        PRE._stage_merged_accum = accum
    launches2 = dict(_build.launches)
    if res2 != want:
        raise AssertionError(f"fixed base, two blocks: got {res2}, compute_msm {want}")
    if len(accum_calls) != 1 or launches2.get("masked_add", 0) <= launches["masked_add"]:
        raise AssertionError(f"two blocks: {len(accum_calls)} accumulations, launches "
                             f"{launches2}")
    del pre, pre2
    return {"n": n, "precompute_s": precompute_s, "precompute_launches": pre_launches,
            "launches": launches, "first_ms": first_ms, "runs_ms": times,
            "median_ms": statistics.median(times), "two_block_ms": two_block_ms,
            "two_block_launches": launches2, "equals_compute_msm": True,
            "captures": captures, "calls": {**pre_calls, **msm_calls}}


#: Phase 7: configuration name, switch settings (attributes of
#: ops/msm_pipeline.py), and the scan kernels its branch must launch (any
#: other scan kernel must not launch).
CONFIGS = (
    ("pret", {"_SCAN_LAYOUT": "pret"}, {"scan_pret"}),
    ("pret, sames off", {"_SCAN_LAYOUT": "pret", "_SCAN_SAMES": False}, {"scan_pret_keys"}),
    ("single table, rm", {"_SINGLE_TABLE": True}, {"scan_table_signed"}),
    ("single table, pret", {"_SINGLE_TABLE": True, "_SCAN_LAYOUT": "pret"},
     {"scan_pret_signed"}),
    ("quarter store", {"_SCAN_QSTORE": True}, {"scan_q", "extract_reconstruct"}),
    ("MSM_DMA_EXTRACT", {"_DMA_EXTRACT": True}, {"scan_fused"}),
    ("MSM_SORT_I64", {"_SORT_I64": True}, {"scan_fused"}),
    ("MSM_DMA_GATHER=0, quarter store", {"_DMA_GATHER": False, "_SCAN_QSTORE": True},
     {"scan_q", "extract_reconstruct"}),
)
SWITCHES = ("_SCAN_SAMES", "_SINGLE_TABLE", "_SCAN_LAYOUT", "_DMA_GATHER", "_DMA_EXTRACT",
            "_SORT_I64", "_SCAN_QSTORE", "_DMA_GATHER_MIN_ROWS")
SCAN_KERNELS = {"scan", "scan_signed", "scan_keys", "scan_pret", "scan_pret_keys",
                "scan_pret_signed", "scan_q", "scan_fused", "scan_table", "scan_table_signed"}
#: Kernels of the main and fixed-base paths, captured and replayed there.
PATH_KERNELS = {"scan_fused", "scan_table_signed"}
#: Scans that no configuration runs: replayed on other configurations'
#: inputs.
REPLAYED = ("scan", "scan_signed", "scan_keys", "scan_table")
CONFIG_RUNS = 3


def configs_path(n: int, want: dict, default_launches: dict) -> dict:
    """Drive compute_msm at n points in each configuration of CONFIGS and the
    fused gather-scan on one window group; `want` is the default
    configuration's answer (held to the oracle), `default_launches` its
    launch counts.  Returns the numbers and the captured inputs of the ten
    kernels these configurations add."""
    from webgpu_msm_twisted_edwards_tpu_torch import compute_msm
    from webgpu_msm_twisted_edwards_tpu_torch.ops import msm_pipeline as MP
    from webgpu_msm_twisted_edwards_tpu_torch.ops.convert import decompose_scalars_signed
    from webgpu_msm_twisted_edwards_tpu_torch.ops.kernels import _build
    from webgpu_msm_twisted_edwards_tpu_torch.ops.kernels import scan as S
    from webgpu_msm_twisted_edwards_tpu_torch.ops.kernels.scan import K, TWR
    from webgpu_msm_twisted_edwards_tpu_torch.utils.params import tpu_msm_config

    _, _, coords, scalars = card_inputs(n)
    saved = {a: getattr(MP, a) for a in SWITCHES}
    out, captures, launches = {}, {}, {k: 0 for k in (*REPLAYED, "gather")}
    try:
        for name, switches, scans in CONFIGS:
            for a, v in {**saved, **switches}.items():
                setattr(MP, a, v)
            _build.captures = {}
            _build.reset_launch_counts()
            t0 = time.time()
            res = compute_msm(coords, scalars)
            first_ms = (time.time() - t0) * 1e3
            ran = dict(_build.launches)
            for k in REPLAYED:
                launches[k] += ran.get(k, 0)
            for k in scans - PATH_KERNELS:
                captures[k] = _build.captures[k]
                launches[k] = ran[k]
            if name == "quarter store":
                captures["gather"] = _build.captures["gather"]
                launches["gather"] = ran["gather"]
            if name == "single table, rm":
                rows_signed = _build.captures["scan_table_signed"][1]
            _build.captures = None
            if res != want:
                raise AssertionError(f"{name}: got {res}, the default configuration {want}")
            launched = {k for k, v in ran.items() if v}
            bad = (scans - launched) | (launched & SCAN_KERNELS - scans)
            gathers, default_gathers = ran.get("gather", 0), default_launches.get("gather", 0)
            if (bad or (name == "MSM_DMA_EXTRACT" and gathers <= default_gathers)
                    or (name == "quarter store" and not gathers)
                    or (name.startswith("MSM_DMA_GATHER=0") and gathers)):
                raise AssertionError(f"{name}: launches {ran}")
            compute_msm(coords, scalars)
            times = []
            for _ in range(CONFIG_RUNS):
                t0 = time.time()
                again = compute_msm(coords, scalars)
                times.append((time.time() - t0) * 1e3)
                if again != res:
                    raise AssertionError(f"{name}: runs disagree")
            out[name] = {"launches": ran, "first_ms": first_ms, "runs_ms": times,
                         "median_ms": statistics.median(times), "equals_default": True}
            log(f"compute_msm 2^{n.bit_length() - 1} {name}: median {out[name]['median_ms']:.2f} "
                f"ms of {CONFIG_RUNS} {[round(t, 2) for t in times]}, first run "
                f"{first_ms:.1f} ms, equal to the default, launches {ran}")
            torch.cuda.empty_cache()
    finally:
        for a, v in saved.items():
            setattr(MP, a, v)
        _build.captures = None
    # The scans of gathered rows run on no branch: they are replayed on the
    # quarter-store run's rows (the gather kernel's) with its same bits or
    # the keys of the pret run, and on the single-table run's rows gathered
    # by indexing with its bits.  msm_scan_table_sames is replayed below.
    captures["scan"] = captures["scan_q"]
    captures["scan_keys"] = (None, (captures["scan_q"][1][0], captures["scan_pret_keys"][1][1]))
    table_s, pidx_t, bits_t = rows_signed
    captures["scan_signed"] = (None, (table_s[pidx_t.T.reshape(-1).to(torch.int64)].reshape(
        -1, K, TWR), bits_t))
    del rows_signed, table_s, pidx_t, bits_t

    cfg = tpu_msm_config(n)
    table = MP.build_full_table(coords)
    digits_g = decompose_scalars_signed(scalars, cfg).T[:MP.default_window_group(
        n, cfg.num_windows, coords.device)].contiguous()
    _build.captures = {}
    _build.reset_launch_counts()
    fused = MP.window_group_bucket_sums(table, digits_g, cfg.num_buckets, fused=True)
    for k in REPLAYED:
        launches[k] += _build.launches.get(k, 0)
    fused_args = _build.captures["scan_fused"][1]
    _build.captures = None
    try:
        MP._SCAN_QSTORE = True
        gathered = MP.window_group_bucket_sums(table, digits_g, cfg.num_buckets)
    finally:
        MP._SCAN_QSTORE = saved["_SCAN_QSTORE"]
    if not torch.equal(fused, gathered):
        raise AssertionError("fused gather-scan: bucket rows differ from the quarter store's")
    table_t, pidx_t, keys_t = fused_args
    captures["scan_table"] = (None, (table_t, pidx_t, S.keys_to_sames(keys_t)))
    out["fused"] = {"windows": digits_g.shape[0], "bucket_rows": fused.shape[0],
                    "equals_quarter_store": True,
                    "table_scan_choices": table_scan_choices(*fused_args)}
    log(f"window_group_bucket_sums fused=True, {digits_g.shape[0]} windows of 2^"
        f"{n.bit_length() - 1}: {fused.shape[0]} bucket rows equal to the quarter store's; "
        f"table scans, ms: {out['fused']['table_scan_choices']}")
    del table, digits_g, fused, gathered, fused_args, table_t, pidx_t, keys_t
    return {"configs": out, "captures": captures, "launches": launches}


def table_scan_choices(table, pidx_t, keys_t) -> dict:
    """Mean ms of the choices the default's scan was picked from, on one
    window group's table, indices (the pipeline's transposed view) and
    sorted keys: msm_scan_fused, which compares the keys in the kernel (the
    default's); msm_scan_table_sames with the same-bit pass it needs, on
    the indices where they lie and on a contiguous copy (the copy timed)."""
    from webgpu_msm_twisted_edwards_tpu_torch.ops.kernels import scan as S

    return {
        "table_sames": time_kernel(lambda: S.msm_scan_table_sames(
            table, pidx_t, S.keys_to_sames(keys_t))),
        "table_sames_contiguous_indices": time_kernel(lambda: S.msm_scan_table_sames(
            table, pidx_t.contiguous(), S.keys_to_sames(keys_t))),
        "fused_keys": time_kernel(lambda: S.msm_scan_fused(table, pidx_t, keys_t)),
        "keys_to_sames": time_kernel(lambda: S.keys_to_sames(keys_t)),
    }


#: Probe scans whose first argument holds one row per entry.
PROBE_ROW_SCANS = {"scan_control", "scan_nosel", "scan_nowrite", "scan_hoistread", "scan_floor",
                   "scan_dual", "scan_dualf", "scan_out64", "scan_out128", "gather_scan"}


def cuda_ms(fn, reps: int) -> float:
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def time_kernel(fn) -> float:
    """Mean ms of fn() after one warm call, over enough calls to fill about
    0.2 s (at most 20)."""
    once = cuda_ms(fn, 1)
    return cuda_ms(fn, max(1, min(20, int(200 / max(once, 1e-3)))))


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts if isinstance(t, torch.Tensor))


def work(name: str, args, out) -> tuple[int, int]:
    """(bytes moved, 32-bit multiply-adds) that this call's data needs:
    each input read once and each output written once; data-dependent
    loops counted as these inputs run them."""
    from webgpu_msm_twisted_edwards_tpu_torch.ops.kernels.common import L
    from webgpu_msm_twisted_edwards_tpu_torch.ops.kernels.precompute import EXP, EXP_BITS

    outs = out if isinstance(out, tuple) else (out,)
    moved = nbytes(*args) + nbytes(*outs)
    if name in ("convert", "convert_pair"):
        return moved, args[0].shape[0] * 4 * MONT
    if name in ("hist", "gather"):
        return moved, 0
    if name in PROBE_ROW_SCANS:
        # Rows [nf, K, TWR] (staged [K, nf, TWR]) of which each entry's 3L
        # used words are read (only step 0's under a hoisted read); the
        # written outputs; one madd an entry (dualf: 8 products).
        rows = args[0]
        entries = rows.shape[0] * rows.shape[1]
        read = (rows.shape[0] if name in ("scan_hoistread", "scan_floor") else entries) * 3 * L * 4
        return moved - nbytes(rows) + read, entries * (8 * MONT if name == "scan_dualf" else MADD)
    if name in ("scan_dma", "gather_fused"):
        # As scan_fused: the table's used words once, one madd an entry.
        table, pidx_t = args[0], args[1]
        return moved - nbytes(table) + table.shape[0] * 3 * L * 4, pidx_t.numel() * MADD
    if name == "bulk_gather":
        return moved, 0
    if name == "gather_copy":
        # The 64 words of each table row that the copy reads, the indices,
        # the rows written.
        table = args[0]
        return moved - nbytes(table) + table.shape[0] * 64 * 4, 0
    if name == "partition":
        return moved, 0
    if name in ("scan", "scan_signed", "scan_keys", "scan_q"):
        # The scan reads the 3L words of each gathered row that madd uses.
        entries = args[0].shape[0] * args[0].shape[1]
        return moved - nbytes(args[0]) + entries * 3 * L * 4, entries * MADD
    if name in ("scan_pret", "scan_pret_keys", "scan_pret_signed", "scan_pret_dual"):
        # Limb-major rows: 3L of the 64 words of each entry are used.
        entries = args[0].numel() // 64
        return moved - nbytes(args[0]) + entries * 3 * L * 4, entries * MADD
    if name in ("scan_fused", "scan_table", "scan_table_signed"):
        # The used words of each table row that the indices name, read
        # once; one madd per entry.
        table, pidx_t = args[0], args[1]
        rows = int(torch.unique(pidx_t).numel())
        return moved - nbytes(table) + rows * 3 * L * 4, pidx_t.numel() * MADD
    if name == "extract_reconstruct":
        # Per row: the 4·LP used words of the base row, the 3L used words of
        # each pair half whose step runs, the used words of the carry where
        # it is added, the bits word, and the 64-word row written.
        from webgpu_msm_twisted_edwards_tpu_torch.ops.kernels.common import LP
        bits = args[2]
        steps = int(((bits & 1) != 0).sum() + ((bits & 2) != 0).sum())
        carries = int(((bits & 16) != 0).sum())
        rows = bits.shape[0]
        moved = (4 * (rows * (4 * LP + 1) + steps * 3 * L + carries * 4 * LP)
                 + nbytes(*outs))
        return moved, steps * MADD + carries * FULL_ADD
    if name == "ab_scan":
        return moved, args[0].shape[0] * FULL_ADD
    if name == "masked_add":
        # The 4·LP used words of each a row, and of each b row whose mask is
        # set; the mask; the whole rows written.  One full add a set row.
        from webgpu_msm_twisted_edwards_tpu_torch.ops.kernels.common import LP
        a, _, mask = args
        added = int((mask != 0).sum())
        return (4 * 4 * LP * (a.shape[0] + added) + nbytes(mask) + nbytes(*outs),
                added * FULL_ADD)
    if name == "reduce_rows":
        # W*(per_window - 1) full adds; the 4·LP used words of each row read
        # once, the whole sums written.
        from webgpu_msm_twisted_edwards_tpu_torch.ops.kernels.common import LP
        rows, per_window = args
        return (4 * 4 * LP * rows.shape[0] + nbytes(*outs),
                (rows.shape[0] - rows.shape[0] // per_window) * FULL_ADD)
    if name == "bpr1":
        return moved, args[0].shape[0] * 2 * FULL_ADD
    if name == "bpr2":
        m, _, cpw, chunk = args
        nc = m.shape[0]
        bits = max(1, int((cpw - 1) * chunk).bit_length())
        kfac = (np.arange(nc) % cpw) * chunk
        ones = sum(bin(int(k)).count("1") for k in kfac)
        return moved, nc * (bits * DOUBLE + FULL_ADD) + ones * FULL_ADD
    if name == "horner":
        w, cbits = args[0].shape[0], args[1]
        lanes = 1 << max(3, (w - 1).bit_length())
        dbl = sum(min(cbits * (w - 1), cbits * ln) for ln in range(lanes))
        return moved, dbl * DOUBLE + (lanes.bit_length() - 1) * lanes * FULL_ADD
    if name == "double_rows":
        return moved, args[0].shape[0] * args[1] * DOUBLE
    if name == "normalize":
        # The batch inversion's least work: per row a prefix product, two
        # products back and x, y (5), and one inversion a call (a squaring
        # per bit of p-2, a multiply per set bit); the 3·LP used words of x,
        # y and z read, the whole rows written.
        from webgpu_msm_twisted_edwards_tpu_torch.ops.kernels.common import LP
        rows = args[0].shape[0]
        return (4 * 3 * LP * rows + nbytes(*outs),
                (5 * rows + bin(EXP).count("1")) * MONT + EXP_BITS * SQR)
    raise KeyError(name)


def bound_ms(moved: int, imads: int) -> float:
    """The least time of a call that moves `moved` bytes and does `imads`
    32-bit multiply-adds: the larger of the two over the card's peaks."""
    return max(moved / PEAK_BYTES_PER_S, imads / PEAK_IMAD_PER_S) * 1e3


def lib_gather(table, pidx_t):
    """index_select of the rows a gather kernel moves (its library call)."""
    flat = pidx_t.T.reshape(-1).to(torch.int64)
    return lambda: torch.index_select(table, 0, flat)


class Spec(NamedTuple):
    """A kernel of the kernels line: its name, the wrapper the path runs
    (timed on the whole captured input), the wrapper held against the plain
    version and that version, the source, the TPU kernel it replaces (body
    line, or a probe's pallas_call line), the library call (or None), the
    rows of each call of the plain version (None: one call on the whole
    input), its capture and launch key (None: the name), the part of its
    output that it writes (None: all of it), and a library call of the work
    the kernel does beyond that part (None: none), timed as
    library_staging_ms."""

    name: str
    timed: Callable
    checked: Callable
    plain: Callable
    src: str
    replaces: str
    library: Callable | None = None
    chunk: int | None = None
    key: str | None = None
    region: Callable | None = None
    staging: Callable | None = None


def kernel_specs() -> tuple[list, list, list]:
    """(main path, fixed-base path, scan configurations) kernel specs."""
    from webgpu_msm_twisted_edwards_tpu_torch.ops.kernels import bpr as B
    from webgpu_msm_twisted_edwards_tpu_torch.ops.kernels import convert as CV
    from webgpu_msm_twisted_edwards_tpu_torch.ops.kernels import ec as E
    from webgpu_msm_twisted_edwards_tpu_torch.ops.kernels import gather as G
    from webgpu_msm_twisted_edwards_tpu_torch.ops.kernels import hist as H
    from webgpu_msm_twisted_edwards_tpu_torch.ops.kernels import precompute as PK
    from webgpu_msm_twisted_edwards_tpu_torch.ops.kernels import scan as S

    def lib_hist(keys, nb):
        wg = keys.shape[0]
        flat = (keys.to(torch.int64) + torch.arange(wg, device=keys.device)[:, None] * (nb + 1)
                ).reshape(-1)
        return lambda: torch.bincount(flat, minlength=wg * (nb + 1))

    def same(name, wrapper, plain, src, body, library=None, chunk=None):
        return Spec(name, wrapper, wrapper, plain, src, JAX_PKG + body, library, chunk)

    main = [
        same("convert", CV.build_table_doubled, CV.build_table_doubled_plain, "convert.cu",
             "pallas/convert.py:116"),
        same("hist", H.bucket_counts, H.bucket_counts_plain, "hist.cu", "pallas/hist.py:36",
             lib_hist),
        same("scan_fused", S.msm_scan_fused, S.msm_scan_fused_plain, "scan.cu",
             "pallas/scan.py:164"),
        same("ab_scan", S.ab_scan_level, S.ab_scan_level_plain, "scan.cu",
             "pallas/scan.py:409"),
        same("masked_add", E.masked_add_rows, E.masked_add_rows_plain, "ec.cu",
             "pallas/ec.py:130"),
        # The JAX package's per-window reduce is a loop of masked adds
        # (pallas/bpr.py:154); the port's runs every round in one launch.
        same("reduce_rows", B.reduce_rows_per_window, B.reduce_rows_per_window_plain, "ec.cu",
             "pallas/bpr.py:154"),
        same("bpr1", B.bpr_stage1, B.bpr_stage1_plain, "bpr.cu", "pallas/bpr.py:42"),
        same("bpr2", B.bpr_stage2, B.bpr_stage2_plain, "bpr.cu", "pallas/bpr.py:99"),
        same("horner", B.horner_fold, B.horner_fold_plain, "bpr.cu", "pallas/bpr.py:189"),
    ]
    fixed = [
        # The path runs build_table (no negation rows); both outputs of the
        # pair are held against the plain version, build_table's against the
        # pair's first.
        Spec("convert_pair", CV.build_table, CV.build_table_pair, CV.build_table_pair_plain,
             "convert.cu", JAX_PKG + "pallas/convert.py:41", None, PLAIN_ROWS),
        # msm_scan_rm_signed over the rows that the JAX package gathers for
        # it, read by index.
        same("scan_table_signed", S.msm_scan_table_signed, S.msm_scan_table_signed_plain,
             "scan.cu", "pallas/scan.py:378"),
        same("double_rows", E.double_rows, E.double_rows_plain, "ec.cu", "pallas/ec.py:278",
             chunk=PLAIN_ROWS),
        same("normalize", PK.normalize_rows, PK.normalize_rows_plain, "precompute.cu",
             "precompute.py:117", chunk=PLAIN_ROWS),
    ]
    variants = [
        same("gather", G.row_gather, G.row_gather_plain, "gather.cu", "pallas/gather.py:48",
             lib_gather),
        same("scan", S.msm_scan_rm_sames, S.msm_scan_rm_sames_plain, "scan.cu",
             "pallas/scan.py:337"),
        same("scan_signed", S.msm_scan_rm_signed, S.msm_scan_rm_signed_plain, "scan.cu",
             "pallas/scan.py:378"),
        same("scan_keys", S.msm_scan, S.msm_scan_plain, "scan_variants.cu",
             "pallas/scan.py:62"),
        same("scan_pret_keys", S.msm_scan_pret, S.msm_scan_pret_plain, "scan_variants.cu",
             "pallas/scan.py:265"),
        same("scan_pret", S.msm_scan_sames, S.msm_scan_sames_plain, "scan_variants.cu",
             "pallas/scan.py:284"),
        same("scan_pret_signed", S.msm_scan_signed, S.msm_scan_signed_plain,
             "scan_variants.cu", "pallas/scan.py:314"),
        same("scan_q", S.msm_scan_rm_sames_q, S.msm_scan_rm_sames_q_plain, "scan_variants.cu",
             "pallas/scan.py:357"),
        # msm_scan_rm_sames over the rows that the JAX package's gather
        # (pallas/gather.py:48) copies for it, read by index.
        same("scan_table", S.msm_scan_table_sames, S.msm_scan_table_sames_plain,
             "scan_variants.cu", "pallas/scan.py:337"),
        same("extract_reconstruct", E.extract_reconstruct_rows,
             E.extract_reconstruct_rows_plain, "ec.cu",
             "pallas/ec.py:185", chunk=PLAIN_ROWS),
    ]
    return main, fixed, variants


def max_err(name: str, got: tuple, ref: tuple) -> int:
    if len(got) != len(ref) or any(g.shape != r.shape for g, r in zip(got, ref)):
        raise AssertionError(f"{name}: shapes {[g.shape for g in got]} against its plain "
                             f"version's {[r.shape for r in ref]}")
    return max(0 if torch.equal(g, r) else int((g.to(torch.int64) - r.to(torch.int64)).abs().max())
               for g, r in zip(got, ref))


def kernels_phase(specs: list, captures: dict, launches: dict) -> list[dict]:
    """Replay each kernel on its captured input: the output it writes held bit
    for bit against its plain version (a row-wise kernel's chunk by chunk),
    then timed beside it, the library call and the bound."""
    from webgpu_msm_twisted_edwards_tpu_torch.ops.kernels.convert import build_table_doubled_plain

    # Load the torch kernels the plain versions run, so that the first
    # timed plain call does not pay for it.
    build_table_doubled_plain(torch.zeros((128, 2, 8), dtype=torch.int32, device="cuda"))
    torch.cuda.synchronize()
    pkg = "webgpu_msm_twisted_edwards_tpu_torch/csrc/"
    rows = []
    for spec in specs:
        name, timed, checked, plain = spec[:4]
        chunk, key = spec.chunk, spec.key or name
        args = captures[key][1]
        shapes = [tuple(a.shape) if isinstance(a, torch.Tensor) else a for a in args]
        out = checked(*args)
        got = out if isinstance(out, tuple) else (out,)
        if spec.region:
            got = tuple(spec.region(g, args) for g in got)
        n = args[0].shape[0]
        step = n if chunk is None else chunk
        err, plain_ms = 0, 0.0
        for i in range(0, n, step):
            # A row-wise kernel's plain version takes a chunk of every row
            # argument.
            sub = tuple(a[i:i + step] if chunk and isinstance(a, torch.Tensor)
                        and a.shape[0] == n else a for a in args)
            torch.cuda.synchronize()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            want = plain(*sub)
            end.record()
            torch.cuda.synchronize()
            plain_ms += start.elapsed_time(end)
            ref = want if isinstance(want, tuple) else (want,)
            if spec.region:
                ref = tuple(spec.region(r, args) for r in ref)
            err = max(err, max_err(name, got if chunk is None
                                   else tuple(g[i:i + step] for g in got), ref))
            del want, ref
        if timed is not checked:
            # The path's wrapper against the checked wrapper's first output.
            err = max(err, max_err(name, (timed(*args),), got[:1]))
        if err:
            raise AssertionError(f"{name}: kernel differs from its plain version "
                                 f"(max abs err {err}) on {shapes}")
        del got, out
        out = timed(*args)
        ms = time_kernel(lambda: timed(*args))
        library_ms = time_kernel(spec.library(*args)) if spec.library else None
        staging = {"library_staging_ms": time_kernel(spec.staging(*args))} if spec.staging else {}
        if spec.region:
            out = tuple(spec.region(o, args) for o in (out if isinstance(out, tuple) else (out,)))
        moved, imads = work(key, args, out)
        del out
        bound_bytes_ms = moved / PEAK_BYTES_PER_S * 1e3
        bound_ops_ms = imads / PEAK_IMAD_PER_S * 1e3
        rows.append({
            "name": name, "route": "cuda", "source": pkg + spec.src,
            "replaces": spec.replaces,
            "launches": launches.get(key, 0), "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(bound_bytes_ms, bound_ops_ms),
            "bound_by": "bytes" if bound_bytes_ms >= bound_ops_ms else "operations",
            "library_ms": library_ms, **staging, "shapes": str(shapes),
            "plain_calls": -(-n // step),
        })
        log(f"kernel {name}: match, {ms:.4f} ms (plain {plain_ms:.1f} ms in "
            f"{rows[-1]['plain_calls']} calls, library "
            f"{library_ms if library_ms is None else round(library_ms, 4)} ms, bound "
            f"{rows[-1]['bound_ms']:.4f} ms by {rows[-1]['bound_by']}) on {shapes}")
        torch.cuda.empty_cache()
    return rows


def probe_specs() -> dict[str, list]:
    """Phase 8: per probe module of experiments/, the specs of its kernels,
    each of which its main() must launch; `replaces` is the JAX probe's
    pallas_call line."""
    from webgpu_msm_twisted_edwards_tpu_torch.experiments import dma_gather_probe as DP
    from webgpu_msm_twisted_edwards_tpu_torch.experiments import fused_gather_probe as GP
    from webgpu_msm_twisted_edwards_tpu_torch.experiments import partition_probe as PP
    from webgpu_msm_twisted_edwards_tpu_torch.experiments import scan_floor_probe as FP
    from webgpu_msm_twisted_edwards_tpu_torch.experiments import scan_out_probe as OP
    from webgpu_msm_twisted_edwards_tpu_torch.experiments import scan_tune_probe as TP
    from webgpu_msm_twisted_edwards_tpu_torch.ops.kernels import scan as S

    def spec(name, wrapper, plain, src, site, key=None, region=None, library=None, staging=None):
        return Spec(name, wrapper, wrapper, plain, src, "experiments/" + site, library, None, key,
                    region, staging)

    def floor(v):
        flags = FP.VARIANTS[v]
        return spec(f"scan_{v}", lambda r, s: FP.variant(r, s, *flags, control=v == "control"),
                    lambda r, s: FP.variant_plain(r, s, *flags), "probe_scan.cu",
                    "scan_floor_probe.py:99",
                    region=lambda o, a: FP.defined(o, flags[1]))

    def dual(name, fuse, pret):
        return spec(name, lambda r, k: TP.msm_scan_dual(r, k, fuse, pret),
                    lambda r, k: TP.msm_scan_dual_plain(r, k, fuse, pret), "probe_scan.cu",
                    "scan_tune_probe.py:201")

    def out(store):
        return spec(f"scan_out{64 * store}", lambda r, k, g: OP.scan_out(r, k, g, store),
                    lambda r, k, g: OP.scan_out_plain(r, k, g, store), "probe_scan.cu",
                    "scan_out_probe.py:87")

    return {
        "scan_floor_probe": [
            spec("scan (scan_floor_probe full)", S.msm_scan_rm_sames, S.msm_scan_rm_sames_plain,
                 "scan.cu", "scan_floor_probe.py:99", key="scan"),
            *(floor(v) for v in ("control", "nosel", "nowrite", "hoistread", "floor"))],
        "scan_tune_probe": [
            spec("scan_pret_keys (scan_tune_probe pret)", S.msm_scan_pret,
                 S.msm_scan_pret_plain, "scan_variants.cu", "scan_tune_probe.py:93",
                 key="scan_pret_keys"),
            dual("scan_dual", False, False), dual("scan_dualf", True, False),
            dual("scan_pret_dual", False, True),
            spec("scan_pret (scan_tune_probe sames)", S.msm_scan_sames, S.msm_scan_sames_plain,
                 "scan_variants.cu", "scan_tune_probe.py:266", key="scan_pret")],
        "scan_out_probe": [out(1), out(2)],
        "dma_gather_probe": [
            spec("bulk_gather", DP.dma_gather, DP.dma_gather_plain, "probe_move.cu",
                 "dma_gather_probe.py:108", library=lib_gather),
            spec("scan_dma", DP.msm_scan_dma, DP.msm_scan_dma_plain, "probe_move.cu",
                 "dma_gather_probe.py:193")],
        "fused_gather_probe": [
            # The library call computes the output held against the plain
            # version, the first 64 words of the step-0 rows; the staging
            # call moves those words of all K*NF rows that the kernel stages,
            # the work it does.
            spec("gather_copy", GP.gather_copy, GP.gather_copy_plain, "probe_move.cu",
                 "fused_gather_probe.py:100", region=lambda o, a: o[:, 0],
                 library=lambda table, pidx_t: lib_gather(table[:, :64], pidx_t[:1]),
                 staging=lambda table, pidx_t: lib_gather(table[:, :64], pidx_t)),
            spec("gather_scan", GP.gather_scan, GP.gather_scan_plain, "probe_move.cu",
                 "fused_gather_probe.py:100"),
            spec("gather_fused", GP.gather_fused, GP.gather_fused_plain, "probe_move.cu",
                 "fused_gather_probe.py:100")],
        "partition_probe": [
            spec("partition", PP.partition, lambda r, b, nb, t: PP.partition_plain(r, b, nb),
                 "probe_move.cu", "partition_probe.py:125",
                 region=lambda o, a: o[PP.written(a[1], a[2])])],
    }


def probes_path() -> dict:
    """Drive each probe's main() at its defaults, its launch counts started
    from zero, then replay its kernels (kernels_phase).  Returns what each
    main() returned with its launches and seconds, and the kernels' rows."""
    from webgpu_msm_twisted_edwards_tpu_torch.ops.kernels import _build

    out, kernels = {}, []
    for probe, specs in probe_specs().items():
        mod = importlib.import_module(f"webgpu_msm_twisted_edwards_tpu_torch.experiments.{probe}")
        _build.captures = {}
        _build.reset_launch_counts()
        t0 = time.time()
        try:
            res = mod.main([])
            torch.cuda.synchronize()
            ran = dict(_build.launches)
            captures = _build.captures
        finally:
            _build.captures = None
        missing = [s.key or s.name for s in specs if ran.get(s.key or s.name, 0) < 1]
        if missing:
            raise AssertionError(f"{probe}: {missing} not launched; launches {ran}")
        out[probe] = {"results": res, "launches": ran, "s": time.time() - t0}
        log(f"probe {probe}: {out[probe]['s']:.1f} s, launches {ran}")
        kernels += kernels_phase(specs, captures, ran)
        del captures
        torch.cuda.empty_cache()
    return {"probes": out, "kernels": kernels}


#: Phase 9: (n, chunk_size) of the small-input path; None takes the sizing
#: rule (c = 4 below 4096 points).
SMALL_CASES = ((511, None), (4095, None), (4096, 6))
#: One timed run after the warm one: 4095 points at c = 4 take about 11 s a
#: run, and phase 12 needs the time.
SMALL_RUNS = 1


def small_path() -> dict:
    """Drive compute_msm on the small-input path: no kernel may launch, each
    result equals the oracle; then use_kernels=False at 4096 points and c=8
    against the kernels' answer."""
    from webgpu_msm_twisted_edwards_tpu_torch import compute_msm
    from webgpu_msm_twisted_edwards_tpu_torch.ops.kernels import _build
    from webgpu_msm_twisted_edwards_tpu_torch.utils import oracle

    out = {}
    for n, c in SMALL_CASES:
        pts, sc, coords, scalars = card_inputs(n)
        _build.reset_launch_counts()
        t0 = time.time()
        res = compute_msm(coords, scalars, chunk_size=c)
        first_ms = (time.time() - t0) * 1e3
        launched = {k: v for k, v in _build.launches.items() if v}
        if launched:
            raise AssertionError(f"small path n={n}, c={c}: kernels launched {launched}")
        times = []
        for _ in range(SMALL_RUNS):
            t0 = time.time()
            again = compute_msm(coords, scalars, chunk_size=c)
            times.append((time.time() - t0) * 1e3)
            if again != res:
                raise AssertionError(f"small path n={n}, c={c}: runs disagree")
        if (res["x"], res["y"]) != oracle.msm_parallel(pts, sc, c=16):
            raise AssertionError(f"small path n={n}, c={c}: got {res}, not the oracle's")
        median = statistics.median(times)
        out[f"{n}, c={c or 4}"] = {"first_ms": first_ms, "runs_ms": times, "median_ms": median,
                                   "oracle": "MATCH"}
        log(f"small path n={n}, c={c or 4}: median {median:.1f} ms of {SMALL_RUNS} "
            f"{[round(t, 1) for t in times]}, first run {first_ms:.1f} ms, no kernel launched, "
            f"oracle MATCH")
    _, _, coords, scalars = card_inputs(4096)
    want = compute_msm(coords, scalars, chunk_size=8)
    _build.reset_launch_counts()
    t0 = time.time()
    forced = compute_msm(coords, scalars, chunk_size=8, use_kernels=False)
    forced_ms = (time.time() - t0) * 1e3
    if forced != want or any(_build.launches.values()):
        raise AssertionError(f"use_kernels=False at 4096, c=8: {forced} against the kernels' "
                             f"{want}; launches {dict(_build.launches)}")
    out["4096, c=8, use_kernels=False"] = {"ms": forced_ms, "equals_kernel_path": True}
    log(f"small path forced at 4096, c=8: {forced_ms:.1f} ms, equal to the kernels' answer")
    return out


#: Phase 10: scalar vectors of the batch (the first is phase 3's), their
#: numpy seed, and its timed runs.
BATCH_K = 4
BATCH_SEED = 43
BATCH_RUNS = 3


def batch_vectors(n: int, scalars: torch.Tensor) -> list[torch.Tensor]:
    """The batch's BATCH_K scalar vectors on the card: `scalars` (phase 3's)
    and BATCH_K - 1 more below 2^250 from numpy seed BATCH_SEED."""
    from webgpu_msm_twisted_edwards_tpu_torch.utils.interop import from_numpy_u32

    rng = np.random.default_rng(BATCH_SEED)
    vectors = [scalars]
    for _ in range(BATCH_K - 1):
        sc = rng.integers(0, 1 << 62, size=(n, 4), dtype=np.uint64)
        sc[:, 3] &= (1 << 58) - 1
        vectors.append(from_numpy_u32(sc.view(np.uint32).reshape(n, 8), "cuda"))
    return vectors


def batch_path(n: int, want: dict, one_shot_ms: float) -> dict:
    """Drive compute_msm_batch over BATCH_K vectors at n points: one table
    conversion and BATCH_K scans a window group, each result equal to
    compute_msm on its vector (the first to phase 3's answer); timed against
    BATCH_K one-shot calls; then forced into two point blocks."""
    from webgpu_msm_twisted_edwards_tpu_torch import compute_msm, compute_msm_batch
    from webgpu_msm_twisted_edwards_tpu_torch.ops import msm_pipeline as MP
    from webgpu_msm_twisted_edwards_tpu_torch.ops.kernels import _build
    from webgpu_msm_twisted_edwards_tpu_torch.utils.params import tpu_msm_config

    _, _, coords, scalars = card_inputs(n)
    vectors = batch_vectors(n, scalars)
    cfg = tpu_msm_config(n)
    groups = cfg.num_windows // MP.default_window_group(n, cfg.num_windows, coords.device)

    _build.reset_launch_counts()
    t0 = time.time()
    res = compute_msm_batch(coords, vectors)
    first_ms = (time.time() - t0) * 1e3
    launches = dict(_build.launches)
    if launches.get("convert") != 1 or launches.get("scan_fused") != BATCH_K * groups:
        raise AssertionError(f"batch launches {launches}, {groups} window groups")
    if res[0] != want:
        raise AssertionError(f"batch: got {res[0]}, compute_msm {want}")
    for i, v in enumerate(vectors[1:], 1):
        if compute_msm(coords, v) != res[i]:
            raise AssertionError(f"batch: vector {i} differs from compute_msm")
    times = []
    for _ in range(BATCH_RUNS):
        t0 = time.time()
        again = compute_msm_batch(coords, vectors)
        times.append((time.time() - t0) * 1e3)
        if again != res:
            raise AssertionError("batch: runs disagree")

    # Two point blocks, as a smaller card would stream them: the table is
    # converted once a block (counted by a spy on that stage).
    block_size, stage, tables = MP.default_block_size, MP._stage_table, []
    MP.default_block_size = lambda n, device=None: n // 2
    MP._stage_table = lambda coords: (tables.append(coords.shape[0]), stage(coords))[1]
    _build.reset_launch_counts()
    try:
        t0 = time.time()
        res2 = compute_msm_batch(coords, vectors)
        two_block_ms = (time.time() - t0) * 1e3
    finally:
        MP.default_block_size, MP._stage_table = block_size, stage
    launches2 = dict(_build.launches)
    if res2 != res or tables != [n // 2, n // 2] or launches2.get("convert") != 2:
        raise AssertionError(f"batch, two blocks: {tables} tables, launches {launches2}, "
                             f"{'equal' if res2 == res else 'different results'}")
    median = statistics.median(times)
    return {"n": n, "k": BATCH_K, "launches": launches, "first_ms": first_ms,
            "runs_ms": times, "median_ms": median, "one_shot_median_ms": one_shot_ms,
            "k_one_shot_ms": BATCH_K * one_shot_ms, "two_block_ms": two_block_ms,
            "two_block_launches": launches2, "equals_compute_msm": True, "results": res}


#: Phase 11: (n, chunk_size) of validate_pipeline.
VALIDATE_CASES = ((1024, 8), (1024, 4))


def validate_path() -> dict:
    """validate_pipeline on the card: every stage must say "ok"."""
    from webgpu_msm_twisted_edwards_tpu_torch import validate_pipeline
    from webgpu_msm_twisted_edwards_tpu_torch.utils.limbs import u32_words_to_ints

    out = {}
    for n, c in VALIDATE_CASES:
        pts, sc, _, _ = card_inputs(n)
        words = pts.view(np.uint32).reshape(n, 2, 8)
        points = list(zip(u32_words_to_ints(words[:, 0]), u32_words_to_ints(words[:, 1])))
        scalars = u32_words_to_ints(sc.view(np.uint32).reshape(n, 8))
        t0 = time.time()
        status = validate_pipeline(points, scalars, chunk_size=c)
        seconds = time.time() - t0
        if set(status.values()) != {"ok"} or len(status) != 4:
            raise AssertionError(f"validate_pipeline n={n}, c={c}: {status}")
        out[f"{n}, c={c}"] = {"status": status, "s": seconds}
        log(f"validate_pipeline n={n}, c={c}: {status}, {seconds:.1f} s")
    return out


#: Phase 12: the argument lists of the benchmark CLI's main(), each
#: subcommand once (scaling in both modes); sizes are the CLI's defaults
#: unless a subcommand took over 30 s with them (PERF.md lists each cut).
BENCH_COMMANDS = (
    ("full", "--powers", "16", "20", "--runs", "5"),
    ("batch", "--power", "20", "--k", "4", "--precompute", "--resident"),
    ("dashboard", "--power", "12", "--runs", "0"),
    ("stages", "--power", "20"),
    ("sweep", "--powers", "20", "--chunks", "13", "14", "15", "16", "--runs", "3"),
    ("trace", "--power", "16"),
    ("mont",), ("barrett",), ("barrett-domb",), ("convert",), ("decompose",),
    ("data-transfer",), ("add-points",), ("scalar-mul", "--runs", "0"), ("bucket-reduction",),
    ("horners-rule",), ("smtvp", "--n", "256", "--runs", "1"), ("device-info",),
    ("scaling", "--power", "20"), ("scaling", "--power", "20", "--mode", "batch"),
)
#: Launch keys of the kernels each subcommand must run (the bucket pipeline
#: on the default path: table, counts, the row-reading scan, the carry
#: scan, the masked adds, BPR and the fold).
_PIPELINE = {"convert", "hist", "scan_fused", "ab_scan", "masked_add", "bpr1", "bpr2",
             "reduce_rows", "horner"}
BENCH_KERNELS = {
    "full": _PIPELINE,
    "batch": _PIPELINE | {"convert_pair", "double_rows", "normalize", "scan_table_signed"},
    "dashboard": _PIPELINE | {"convert_pair", "double_rows", "normalize", "scan_table_signed"},
    "stages": {"gather", "scan", "scan_keys", "scan_pret_keys", "scan_fused", "bpr1", "bpr2",
               "reduce_rows"},
    "sweep": _PIPELINE,
    "trace": _PIPELINE - {"horner"},
    "convert": {"convert", "convert_pair"},
    "add-points": {"masked_add"},
    "bucket-reduction": {"bpr1", "bpr2", "reduce_rows"},
    "horners-rule": {"horner"},
    "smtvp": _PIPELINE - {"horner"},
    "scaling": _PIPELINE,
}


def bench_path() -> dict:
    """Phase 12: the benchmark CLI's main() on each of BENCH_COMMANDS, its
    table echoed, its seconds and launch counts kept; raises unless every
    "correct" cell reads ✓ and each subcommand launched its kernels."""
    import io

    from webgpu_msm_twisted_edwards_tpu_torch.benchmarks.__main__ import main as bench_main
    from webgpu_msm_twisted_edwards_tpu_torch.ops.kernels import _build

    out = {}
    for argv in BENCH_COMMANDS:
        cmd = argv[0]
        buf = io.StringIO()
        _build.reset_launch_counts()
        t0 = time.time()
        with contextlib.redirect_stdout(buf):
            rc = bench_main(list(argv))
        seconds = time.time() - t0
        launched = {k: v for k, v in _build.launches.items() if v}
        text = buf.getvalue()
        log(f"benchmarks {' '.join(argv)}: {seconds:.1f} s, launches {launched}\n{text.rstrip()}")
        # The table main() prints last (subcommands print rows as they go).
        table = [ln for ln in text.rstrip().rsplit("\n\n", 1)[-1].splitlines()
                 if ln.startswith("| ")]
        head = [c.strip() for c in table[0].strip("|").split("|")] if table else []
        cells = []
        if "correct" in head:
            col = head.index("correct")
            cells = [ln.strip("|").split("|")[col].strip() for ln in table[1:]]
            if not cells or any(c != "✓" for c in cells):
                raise AssertionError(f"benchmarks {cmd}: correct cells {cells}")
        missing = BENCH_KERNELS.get(cmd, set()) - set(launched)
        if rc != 0 or missing:
            raise AssertionError(f"benchmarks {cmd}: rc {rc}, kernels not launched {missing}")
        out[" ".join(argv)] = {"s": seconds, "launches": launched, "correct": cells}
        torch.cuda.empty_cache()
    return out


#: Phase 13: the point-axis meshes of compute_msm_sharded at 2^20 (shards),
#: each run staged and shard after shard; the mesh of the chain fold and its
#: point count; the batch's mesh; timed runs a configuration; the seconds a
#: torch.distributed job may take.
SHARD_MESHES = (1, 2, 4)
CHAIN_SHARDS, CHAIN_N = 3, 3 << 18
BATCH_SHARDS = 4
SHARDED_RUNS = 3
DIST_TIMEOUT_S = 300


def phase_mesh(k: int) -> list[torch.device]:
    """k shards: card i % device_count, so distinct cards where the machine
    has k of them, and cuda:0 repeated on a one-card machine."""
    count = torch.cuda.device_count()
    return [torch.device("cuda", i % count) for i in range(k)]


def sharded_launches(k: int, groups: int) -> dict:
    """Launches of one compute_msm_sharded over k shards of `groups` window
    groups each: per shard and group the counts, the row-reading scan, the
    carry scan's three levels and three masked adds (its two carry applies
    and the extraction); per shard the table, the two BPR stages and the
    per-window reduce; then the cross-shard fold (one reduce over a
    power-of-two mesh of two or more, else k - 1 masked adds) and one Horner
    fold."""
    pow2 = k & (k - 1) == 0
    return {"convert": k, "hist": k * groups, "scan_fused": k * groups,
            "ab_scan": 3 * k * groups,
            "masked_add": MASKED_ADD_LAUNCHES * k * groups + (0 if pow2 else k - 1),
            "bpr1": k, "bpr2": k, "reduce_rows": k + (1 if pow2 and k > 1 else 0), "horner": 1}


def sharded_run(coords, scalars, k: int, staged: bool, want: dict) -> dict:
    """compute_msm_sharded over phase_mesh(k): launch counts of the first run
    from zero against sharded_launches, its result against `want`, the
    fold's reduce or masked adds held against their plain versions, then
    SHARDED_RUNS timed runs."""
    from webgpu_msm_twisted_edwards_tpu_torch import compute_msm_sharded
    from webgpu_msm_twisted_edwards_tpu_torch.ops import msm_pipeline as MP
    from webgpu_msm_twisted_edwards_tpu_torch.ops.kernels import _build
    from webgpu_msm_twisted_edwards_tpu_torch.ops.kernels import bpr as B
    from webgpu_msm_twisted_edwards_tpu_torch.ops.kernels import ec as E
    from webgpu_msm_twisted_edwards_tpu_torch.parallel import sharded

    n = coords.shape[0]
    mesh = phase_mesh(k)
    cfg, pipeline = sharded.sharded_msm_plan(n, k)
    groups = cfg.num_windows // MP.default_window_group(n // k, cfg.num_windows, mesh[0])
    name = f"{k} shards, {'staged' if staged else 'shard after shard'}"
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    with every_call("reduce_rows", "masked_add") as calls:
        t0 = time.time()
        res = compute_msm_sharded(coords, scalars, mesh=mesh, staged=staged)
        first_ms = (time.time() - t0) * 1e3
    launches = {key: v for key, v in _build.launches.items() if v}
    peak_bytes = torch.cuda.max_memory_allocated()
    if res != want:
        raise AssertionError(f"sharded {name}: got {res}, want {want}")
    expected = {key: v for key, v in sharded_launches(k, groups).items() if v}
    if pipeline != "kernels" or launches != expected:
        raise AssertionError(f"sharded {name}: launches {launches}, expected {expected}")
    w = cfg.num_windows
    if k & (k - 1) == 0 and k > 1:
        fold = calls["reduce_rows"][-1:]
        if fold[0][0].shape[0] != w * k or fold[0][1] != k:
            raise AssertionError(f"sharded {name}: the last reduce is not the fold")
        hold_calls(f"reduce_rows (fold of {k})", B.reduce_rows_per_window,
                   B.reduce_rows_per_window_plain, fold)
    elif k > 1:
        fold = calls["masked_add"][-(k - 1):]
        if any(a[0].shape[0] != w for a in fold):
            raise AssertionError(f"sharded {name}: the last masked adds are not the fold")
        hold_calls(f"masked_add (fold of {k})", E.masked_add_rows, E.masked_add_rows_plain, fold)
    del calls
    times = []
    for _ in range(SHARDED_RUNS):
        t0 = time.time()
        again = compute_msm_sharded(coords, scalars, mesh=mesh, staged=staged)
        times.append((time.time() - t0) * 1e3)
        if again != res:
            raise AssertionError(f"sharded {name}: runs disagree")
    out = {"mesh": [str(d) for d in mesh], "c": cfg.chunk_size, "groups": groups,
           "launches": launches, "first_ms": first_ms, "runs_ms": times,
           "median_ms": statistics.median(times), "max_memory_allocated": peak_bytes}
    log(f"compute_msm_sharded at {n} points over {name} {out['mesh']} (c="
        f"{cfg.chunk_size}): median {out['median_ms']:.2f} ms of {SHARDED_RUNS} "
        f"{[round(t, 2) for t in times]}, first run {first_ms:.1f} ms, peak "
        f"{peak_bytes / 2**30:.2f} GiB, launches {launches}")
    torch.cuda.empty_cache()
    return out


def dist_worker(backend: str, world: str, rank: str, port: str) -> int:
    """One rank of phase 13's torch.distributed job (run in a child process
    from the repository's root): compute_msm_multihost on its share of the
    2^20 inputs, then compute_msm_batch_multihost on two of phase 10's
    vectors; prints one line "DIST {json}"."""
    sys.path.insert(0, REPO)
    from webgpu_msm_twisted_edwards_tpu_torch.ops.kernels import _build
    from webgpu_msm_twisted_edwards_tpu_torch.parallel import distributed as D

    world, rank = int(world), int(rank)
    D.initialize(f"tcp://127.0.0.1:{port}", world_size=world, rank=rank, backend=backend)
    n = 1 << 20
    _, _, coords, scalars = card_inputs(n)
    per = n // world
    _build.reset_launch_counts()
    t0 = time.time()
    res = D.compute_msm_multihost(coords[rank * per:(rank + 1) * per],
                                  scalars[rank * per:(rank + 1) * per])
    msm_ms = (time.time() - t0) * 1e3
    launches = {k: v for k, v in _build.launches.items() if v}
    mine = batch_vectors(n, scalars)[2 * rank:2 * rank + 2]
    batch = D.compute_msm_batch_multihost(coords, mine)
    print("DIST " + json.dumps({
        "backend": backend, "world": world, "rank": rank, "device": str(coords.device),
        "result": [str(res["x"]), str(res["y"])], "first_ms": msm_ms, "launches": launches,
        "batch": [[str(r["x"]), str(r["y"])] for r in batch]}), flush=True)
    torch.distributed.destroy_process_group()
    return 0


def dist_jobs(want: dict, batch_want: list) -> list[dict]:
    """The torch.distributed jobs of phase 13, all started at once in child
    processes: two ranks over gloo on the card (two ranks on one card), one
    NCCL rank, and two NCCL ranks a card each where the machine has two
    cards.  Every rank's MSM must equal `want` (phase 3's 2^20 answer) and
    its two batch results phase 10's of its vectors; a child that exits
    non-zero or outlasts DIST_TIMEOUT_S fails the phase."""
    import socket

    jobs = [("gloo", 2), ("nccl", 1)] + ([("nccl", 2)] if torch.cuda.device_count() >= 2 else [])
    env = dict(os.environ, GLOO_SOCKET_IFNAME="lo", NCCL_SOCKET_IFNAME="lo")
    procs = []
    for backend, world in jobs:
        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            port = sock.getsockname()[1]
        for rank in range(world):
            cmd = [sys.executable, "-c",
                   "import sys, chip_smoke; sys.exit(chip_smoke.dist_worker(*sys.argv[1:]))",
                   backend, str(world), str(rank), str(port)]
            procs.append(((backend, world, rank), subprocess.Popen(
                cmd, cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
    outs = {}
    try:
        deadline = time.time() + DIST_TIMEOUT_S
        for key, proc in procs:
            outs[key] = proc.communicate(timeout=max(1.0, deadline - time.time()))[0]
    finally:
        for _, proc in procs:
            if proc.poll() is None:
                proc.kill()
            proc.wait()
    rows = []
    for key, proc in procs:
        out = outs[key]
        lines = [ln for ln in out.splitlines() if ln.startswith("DIST ")]
        if proc.returncode != 0 or len(lines) != 1:
            raise AssertionError(f"distributed {key}: rc {proc.returncode}\n{out[-3000:]}")
        row = json.loads(lines[0][5:])
        res = {"x": int(row["result"][0]), "y": int(row["result"][1])}
        rank = key[2]
        batch = [{"x": int(x), "y": int(y)} for x, y in row["batch"]]
        if res != want or batch != batch_want[2 * rank:2 * rank + 2]:
            raise AssertionError(f"distributed {key}: {res}, batch {batch}")
        missing = set(sharded_launches(1, 1)) - set(row["launches"])
        if missing:
            raise AssertionError(f"distributed {key}: kernels not launched {missing}")
        rows.append({k: row[k] for k in ("backend", "world", "rank", "device", "first_ms",
                                        "launches")})
        log(f"distributed {key[0]}, {key[1]} rank(s), rank {rank} on {row['device']}: equal to "
            f"the 2^20 answer and to phase 10's batch answers, first MSM {row['first_ms']:.1f} "
            f"ms, launches {row['launches']}")
    return rows


def multi_device_path(want: dict, batch_want: list) -> dict:
    """Phase 13: compute_msm_sharded at 2^20 over SHARD_MESHES, staged and
    shard after shard, equal to phase 3's answer `want`; CHAIN_SHARDS shards
    at CHAIN_N points, equal to compute_msm and the oracle;
    compute_msm_batch_sharded over phase 10's vectors, equal to its answers
    `batch_want`; the torch.distributed jobs."""
    from webgpu_msm_twisted_edwards_tpu_torch import compute_msm, compute_msm_batch_sharded
    from webgpu_msm_twisted_edwards_tpu_torch.ops.kernels import _build
    from webgpu_msm_twisted_edwards_tpu_torch.utils import oracle

    out = {"cards": torch.cuda.device_count(), "meshes": {}}
    _, _, coords, scalars = card_inputs(1 << 20)
    for k in SHARD_MESHES:
        for staged in (True, False):
            out["meshes"][f"{k}, staged={staged}"] = sharded_run(coords, scalars, k, staged, want)
    cpts, csc, ccoords, cscalars = card_inputs(CHAIN_N)
    chain_want = compute_msm(ccoords, cscalars)
    if (chain_want["x"], chain_want["y"]) != oracle.msm_parallel(cpts, csc, c=16):
        raise AssertionError(f"compute_msm at {CHAIN_N} points differs from the oracle")
    out["meshes"][f"{CHAIN_SHARDS} at {CHAIN_N}, staged=True"] = sharded_run(
        ccoords, cscalars, CHAIN_SHARDS, True, chain_want)
    del cpts, csc, ccoords, cscalars

    mesh = phase_mesh(BATCH_SHARDS)
    vectors = batch_vectors(1 << 20, scalars)
    _build.reset_launch_counts()
    t0 = time.time()
    got = compute_msm_batch_sharded(coords, vectors, mesh=mesh)
    batch_ms = (time.time() - t0) * 1e3
    launches = {k: v for k, v in _build.launches.items() if v}
    per = len(vectors) // BATCH_SHARDS
    if got != batch_want or launches.get("convert") != BATCH_SHARDS or launches.get(
            "horner") != len(vectors) or launches.get("scan_fused", 0) < len(vectors):
        raise AssertionError(f"batch sharded: launches {launches}, "
                             f"{'equal' if got == batch_want else 'different results'}")
    out["batch"] = {"mesh": [str(d) for d in mesh], "k": len(vectors), "per_shard": per,
                    "first_ms": batch_ms, "launches": launches}
    log(f"compute_msm_batch_sharded 2^20, k={len(vectors)} over {out['batch']['mesh']}: "
        f"{batch_ms:.1f} ms (first run), equal to phase 10's answers, launches {launches}")
    del vectors, coords, scalars
    torch.cuda.empty_cache()

    t0 = time.time()
    out["distributed"] = dist_jobs(want, batch_want)
    out["distributed_s"] = time.time() - t0
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from webgpu_msm_twisted_edwards_tpu_torch.ops.kernels import _build
    from webgpu_msm_twisted_edwards_tpu_torch.ops.kernels import bpr as B
    from webgpu_msm_twisted_edwards_tpu_torch.ops.kernels import ec as E
    from webgpu_msm_twisted_edwards_tpu_torch.ops.kernels import precompute as PK
    from webgpu_msm_twisted_edwards_tpu_torch.utils.runtime import card_info

    t_start = time.time()
    card = card_info()
    kind = torch.cuda.get_device_name(0)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, {kind}")

    build_s = _build.build_all()
    log(f"build: {build_s:.1f} s")
    for lib, lines in _build.ptxas_report().items():
        for ln in lines:
            log(f"ptxas {lib}: {ln}")
    # The main path's scan, msm_scan_fused: one step of its loop is one
    # madd, 7 products.
    scan_fn = ptxas_function("scan", "scan_kernelILi2ELi0ELi2E")
    wide = sass_count("scan", scan_fn, "IMAD.WIDE.U32")
    log(f"sass scan (msm_scan_fused): {wide} IMAD.WIDE.U32, "
        f"{'not counted' if wide is None else round(wide / 7, 1)} a product; MONT = {MONT}")
    for lib, kernel, instantiations in INLINED:
        check_inlined(lib, kernel, instantiations)
    main_specs, fixed_specs, variant_specs = kernel_specs()

    e2e = {}
    for logn, capture in ((16, False), (20, True)):
        r = main_path(1 << logn, capture)
        e2e[f"2^{logn}"] = r
        log(f"compute_msm 2^{logn}: median {r['median_ms']:.2f} ms of {RUNS} "
            f"{[round(t, 2) for t in r['runs_ms']]}, first run {r['first_ms']:.1f} ms, "
            f"oracle {r['oracle']} ({r['oracle_s']:.1f} s), launches {r['launches']}; "
            f"masked_add's {len(r['masked_add_rows'])} calls on {r['masked_add_rows']} rows, "
            f"bound {r['masked_add_bound_ms']:.4f} ms in all")
        # Every kernel of the path, the table scan once per window group.
        ran = {k: v for k, v in r["launches"].items() if v > 0}
        if (sorted(ran) != sorted(s[0] for s in main_specs) or ran["scan_fused"] != r["groups"]
                or ran["masked_add"] != MASKED_ADD_LAUNCHES or ran["reduce_rows"] != 1):
            raise AssertionError(f"2^{logn}: launches {r['launches']}, {r['groups']} window "
                                 f"groups")
    kernels = kernels_phase(main_specs, e2e["2^20"].pop("captures"), e2e["2^20"]["launches"])
    e2e["2^20"].pop("bpr2_calls")
    hold_calls("bpr2 (2^16)", B.bpr_stage2, B.bpr_stage2_plain, e2e["2^16"].pop("bpr2_calls"))

    t_fb = time.time()
    fb = fixed_base_path(1 << 20, e2e["2^20"]["result"])
    log(f"precompute_msm_base 2^20: {fb['precompute_s']:.3f} s, launches "
        f"{fb['precompute_launches']}")
    log(f"compute_msm_precomputed 2^20: median {fb['median_ms']:.2f} ms of {RUNS} "
        f"{[round(t, 2) for t in fb['runs_ms']]}, first run {fb['first_ms']:.1f} ms, "
        f"equal to compute_msm and the oracle, launches {fb['launches']}; two blocks "
        f"{fb['two_block_ms']:.1f} ms, equal, launches {fb['two_block_launches']}")
    fb_launches = {**fb["launches"], **fb["precompute_launches"]}
    captures = fb.pop("captures")
    kernels += kernels_phase(fixed_specs, captures, fb_launches)
    calls = fb.pop("calls")
    # The replay held the captured call; every other call is held here.
    for name, wrapper, plain in (("double_rows", E.double_rows, E.double_rows_plain),
                                 ("normalize", PK.normalize_rows, PK.normalize_rows_plain)):
        rows = captures[name][1][0]
        rest = [args for args in calls[name] if args[0] is not rows]
        if len(rest) != len(calls[name]) - 1:
            raise AssertionError(f"{name}: the replayed call is not one of the precompute's")
        hold_calls(name, wrapper, plain, rest, PLAIN_ROWS)
    hold_calls("bpr2 (fixed base)", B.bpr_stage2, B.bpr_stage2_plain, calls["bpr2"])
    norm_rows = captures["normalize"][1][0].shape[0]
    fermat = norm_rows * ((bin(PK.EXP).count("1") + 2) * MONT + PK.EXP_BITS * SQR)
    row = next(k for k in kernels if k["name"] == "normalize")
    log(f"normalize bound: {row['bound_ms']:.4f} ms by {row['bound_by']} "
        f"(batch inversion); {bound_ms(0, fermat):.4f} ms by the Fermat chain's count, "
        f"388 products a row, 253 of them squarings")
    del captures, calls, rows, rest, row
    fb["phase_s"] = time.time() - t_fb
    log(f"fixed-base phase with its kernel replay: {fb['phase_s']:.1f} s")

    t_cf = time.time()
    cf = configs_path(1 << 20, e2e["2^20"]["result"], e2e["2^20"]["launches"])
    kernels += kernels_phase(variant_specs, cf.pop("captures"), cf.pop("launches"))
    cf["phase_s"] = time.time() - t_cf
    log(f"scan configurations phase with its kernel replay: {cf['phase_s']:.1f} s")

    t_pr = time.time()
    pr = probes_path()
    kernels += pr.pop("kernels")
    pr["phase_s"] = time.time() - t_pr
    log(f"probes phase with its kernel replay: {pr['phase_s']:.1f} s")

    t_sp = time.time()
    sp = small_path()
    sp["phase_s"] = time.time() - t_sp
    log(f"small-input path phase: {sp['phase_s']:.1f} s")

    t_bt = time.time()
    bt = batch_path(1 << 20, e2e["2^20"]["result"], e2e["2^20"]["median_ms"])
    batch_want = bt.pop("results")
    bt["phase_s"] = time.time() - t_bt
    log(f"compute_msm_batch 2^20, k={bt['k']}: median {bt['median_ms']:.2f} ms of "
        f"{BATCH_RUNS} {[round(t, 2) for t in bt['runs_ms']]} against {bt['k']} x the "
        f"one-shot median {bt['k_one_shot_ms']:.2f} ms, first run {bt['first_ms']:.1f} ms, "
        f"launches {bt['launches']}; two blocks {bt['two_block_ms']:.1f} ms, equal; phase "
        f"{bt['phase_s']:.1f} s")

    t_vp = time.time()
    vp = validate_path()
    vp["phase_s"] = time.time() - t_vp
    log(f"validator phase: {vp['phase_s']:.1f} s")

    t_bn = time.time()
    bn = bench_path()
    bench_s = time.time() - t_bn
    log(f"benchmarks phase: {bench_s:.1f} s; by subcommand, s: "
        f"{ {k: round(v['s'], 1) for k, v in bn.items()} }")

    t_md = time.time()
    md = multi_device_path(e2e["2^20"]["result"], batch_want)
    md["phase_s"] = time.time() - t_md
    by_mesh = {k: (round(v["median_ms"], 2), round(v["first_ms"], 1))
               for k, v in md["meshes"].items()}
    log(f"multi-device phase: {md['phase_s']:.1f} s ({md['cards']} card(s)); by mesh, median "
        f"and first-run ms: {by_mesh}; 4 shards' peak "
        f"{md['meshes']['4, staged=True']['max_memory_allocated'] / 2**30:.2f} GiB; "
        f"distributed jobs {md['distributed_s']:.1f} s")

    log(json.dumps({"e2e": {k: {"median_ms": v["median_ms"], "runs_ms": v["runs_ms"],
                                "first_ms": v["first_ms"], "launches": v["launches"],
                                "masked_add_bound_ms": v["masked_add_bound_ms"],
                                "oracle": v["oracle"]} for k, v in e2e.items()},
                    "fixed_base_2^20": fb, "configs_2^20": cf, "probes": pr["probes"],
                    "small_path": sp, "batch_2^20": bt, "validate": vp,
                    "benchmarks": {"phase_s": bench_s, "commands": bn}, "multi_device": md,
                    "build_s": build_s,
                    "total_s": time.time() - t_start}))
    log(card)
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
