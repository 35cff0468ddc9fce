"""Micro-benchmarks: one function a stage or arithmetic variant.

| function | what it times |
|---|---|
| mont_mul | chained Montgomery products at limb widths 12-16 (ops/montgomery_variants.py) |
| barrett_mul | the Barrett product (ops/barrett.py) |
| barrett_domb_mul | Barrett-Domb beside Barrett and the Montgomery product, and its host mirror |
| convert_inputs | the table conversion kernels (#10 build_table_pair's single table, #1 the doubled table) |
| decompose_scalars | the signed window digits (torch ops) |
| data_transfer | host->device and device->host copies |
| add_points | the masked full-add kernel (#6) beside ops/curve.py's add |
| scalar_mul | double-and-add against Booth recoding (ops/scalar_mul.py) |
| bucket_reduction | BPR on its kernels (#7, #8, the per-window reduce #6') |
| horners_rule | the Horner fold kernel (#9) beside ops/curve.py's loop and the host fold |
| smtvp | bucket sums by scatter (ops/smtvp.py) beside the pipeline |
| stages | the bucket-sum stage's parts at 2^power: sort, gathers, scans, BPR |
| dashboard | every MSM of models/baselines.py at one size, checked |
| device_info_table | the device's identity and memory |
| trace | a torch.profiler trace of one MSM's window sums |

Every function runs on the CUDA card unless `device="cpu"` is given (the
kernels' plain versions).  Times are host ms up to a synchronize of the
output's device (timing.py); the first call loads the kernel library and,
on a fresh tree, builds it.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from ..utils.limbs import ints_to_u32_words
from ..utils.params import PARAMS, MsmConfig
from ..utils.runtime import resolve_device
from .timing import Table, force, median, time_device

#: Where `trace` writes by default: trace/ at the repository's root.
DEFAULT_TRACE_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "trace")


def _rand_limbs(rng, batch, params, device) -> torch.Tensor:
    return torch.from_numpy(rng.integers(0, 1 << params.word_size,
                                         size=(batch, params.num_words))).to(device)


def _rand_i32(rng, shape, bound: int, device) -> torch.Tensor:
    """Random int32 words below `bound` (at most 2^32: the u32 bits)."""
    return torch.from_numpy(rng.integers(0, bound, size=shape, dtype=np.uint64)
                            .astype(np.uint32).view(np.int32)).to(device)


def _coords_of(points) -> np.ndarray:
    """Affine (x, y) ints -> [n, 2, 8] uint32 words."""
    return np.stack([ints_to_u32_words([x for x, _ in points]),
                     ints_to_u32_words([y for _, y in points])], axis=1)


def _mont_points(coords: torch.Tensor):
    """[n, 2, 8] int32 affine words -> a PointXYTZ of Montgomery limbs."""
    from ..ops import convert as CV
    from ..ops import curve as C
    from ..ops import field as F

    xm, ym, tm = CV.points_to_mont_limbs(coords)
    return C.PointXYTZ(xm, ym, tm, F.r_limbs(coords.device).expand_as(xm))


def mont_mul(batch: int = 1 << 17, chain: int = 16, runs: int = 3, device=None) -> Table:
    """Chains of dependent Montgomery products at limb widths 12-16, each
    width in the family the study picks for it."""
    from ..ops.montgomery_variants import cost_loop

    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    table = Table(["limb width", "algorithm", "num words",
                   f"{chain} chained muls x {batch} lanes: first run (ms)",
                   "median run (ms)", "M mont/s"])
    for w in (12, 13, 14, 15, 16):
        params, fn = cost_loop(w, batch, chain)
        algo = ("optimised (carry-free)" if params.nsafe >= params.num_words
                else ("modified" if params.nsafe >= 1 else "CIOS"))
        x = _rand_limbs(rng, batch, params, dev)
        y = _rand_limbs(rng, batch, params, dev)
        first, ts = time_device(fn, x, y, runs=runs)
        m = median(ts)
        table.add(w, algo, params.num_words, round(first), round(m, 2),
                  round(batch * chain / m / 1e3, 1))
    return table


def barrett_mul(batch: int = 1 << 17, runs: int = 3, device=None) -> Table:
    from ..ops.barrett import barrett_mul as bmul

    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    x = _rand_limbs(rng, batch, PARAMS, dev)
    y = _rand_limbs(rng, batch, PARAMS, dev)
    first, ts = time_device(bmul, x, y, runs=runs)
    t = Table(["batch", "first run (ms)", "median (ms)", "M mul/s"])
    t.add(batch, round(first), round(median(ts), 2), round(batch / median(ts) / 1e3, 1))
    return t


def barrett_domb_mul(batch: int = 1 << 17, runs: int = 3, samples: int = 2000,
                     device=None) -> Table:
    """Barrett-Domb beside Barrett and the Montgomery product (torch ops on
    the device), and the host mirror's rate."""
    import random

    from ..cpu.barrett_domb import barrett_domb_mul_int
    from ..ops.barrett import barrett_mul as bmul
    from ..ops.barrett_domb import barrett_domb_mul as bdmul
    from ..ops.field import mont_mul as fmont

    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    x = _rand_limbs(rng, batch, PARAMS, dev)
    y = _rand_limbs(rng, batch, PARAMS, dev)
    t = Table(["algorithm", "batch", "first run (ms)", "median (ms)", "M mul/s"])
    for name, fn in (("barrett-domb (device)", bdmul), ("barrett (device)", bmul),
                     ("montgomery (device, torch ops)", fmont)):
        first, ts = time_device(fn, x, y, runs=runs)
        m = median(ts)
        t.add(name, batch, round(first), round(m, 2), round(batch / m / 1e3, 1))

    r = random.Random(0)
    xs = [r.randrange(0, PARAMS.p) for _ in range(samples)]
    ys = [r.randrange(0, PARAMS.p) for _ in range(samples)]
    t0 = time.time()
    for xi, yi in zip(xs, ys):
        barrett_domb_mul_int(xi, yi)
    dt = (time.time() - t0) * 1e3
    t.add("barrett-domb (cpu mirror)", samples, "-", round(dt, 1), round(samples / dt / 1e3, 4))
    return t


def convert_inputs(batch: int = 1 << 18, runs: int = 3, device=None) -> Table:
    """Points into the Montgomery-form table: the single table (kernel #10's
    first output, the fixed-base path's) and the doubled table (#1, the
    main path's)."""
    from ..ops.kernels import convert as KC

    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    coords = rng.integers(0, 1 << 32, size=(batch, 2, 8), dtype=np.uint64).astype(np.uint32)
    coords[:, :, 7] = 0
    dcoords = torch.from_numpy(coords.view(np.int32)).to(dev)
    t = Table(["table", "points", "first run (ms)", "median (ms)", "M points/s"])
    for name, fn in (("single (build_table)", KC.build_table),
                     ("doubled (build_table_doubled)", KC.build_table_doubled)):
        first, ts = time_device(fn, dcoords, runs=runs)
        t.add(name, batch, round(first), round(median(ts), 2),
              round(batch / median(ts) / 1e3, 1))
    return t


def decompose_scalars(batch: int = 1 << 20, runs: int = 3, device=None) -> Table:
    from ..ops import convert as CV

    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    sc = _rand_i32(rng, (batch, 8), 1 << 32, dev)
    cfg = MsmConfig(chunk_size=16)
    first, ts = time_device(lambda s: CV.decompose_scalars_signed(s, cfg), sc, runs=runs)
    t = Table(["scalars", "first run (ms)", "median (ms)", "M scalars/s"])
    t.add(batch, round(first), round(median(ts), 2), round(batch / median(ts) / 1e3, 1))
    return t


def data_transfer(mb: int = 64, runs: int = 3, device=None) -> Table:
    """Host->device and device->host copies of `mb` MB from and to pageable
    host memory, each ended by a synchronize."""
    dev = resolve_device(device)
    n = mb * (1 << 20) // 4
    host = np.arange(n, dtype=np.uint32)
    t = Table(["direction", "MB", "median (ms)", "GB/s"])
    ts = []
    for i in range(runs):
        host_i = torch.from_numpy((host + np.uint32(i)).view(np.int32))  # a fresh buffer
        t0 = time.time()
        on_dev = force(host_i.to(dev))
        ts.append((time.time() - t0) * 1e3)
    m = median(ts)
    t.add("host->device", mb, round(m, 2), round(mb / 1024 / (m / 1e3), 2))
    first = runs - 1                                       # the last copy's word 0
    ts = []
    for i in range(runs):
        computed = force(on_dev + (i + 1))                 # a fresh result a run
        t0 = time.time()
        arr = computed.cpu()
        ts.append((time.time() - t0) * 1e3)
        if int(arr[0]) != first + i + 1:
            raise AssertionError(f"device->host: word 0 is {int(arr[0])}, not {first + i + 1}")
    m = median(ts)
    t.add("device->host", mb, round(m, 2), round(mb / 1024 / (m / 1e3), 2))
    return t


def add_points(batch: int = 1 << 18, runs: int = 3, device=None) -> Table:
    """Batched point adds: the masked full-add kernel (#6) on packed rows,
    and ops/curve.py's add in torch ops."""
    from ..ops import curve as C
    from ..ops.kernels.ec import TW, masked_add_rows

    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    # Words in the limb range are enough for timing.
    a = _rand_i32(rng, (batch, TW), 1 << 26, dev)
    b = _rand_i32(rng, (batch, TW), 1 << 26, dev)
    mask = torch.ones((batch,), dtype=torch.int32, device=dev)
    t = Table(["impl", "adds", "first run (ms)", "median (ms)", "M adds/s"])
    first, ts = time_device(masked_add_rows, a, b, mask, runs=runs)
    m = median(ts)
    t.add("masked_add_rows (kernel #6)", batch, round(first), round(m, 2),
          round(batch / m / 1e3, 2))

    x = _rand_limbs(rng, batch, PARAMS, dev)
    pt = C.PointXYTZ(x, x, x, x)
    first, ts = time_device(lambda p: C.add(p, p), pt, runs=runs)
    m = median(ts)
    t.add("torch ops curve.add", batch, round(first), round(m, 2), round(batch / m / 1e3, 2))
    return t


def scalar_mul(batch: int = 4096, runs: int = 3, device=None) -> Table:
    """Double-and-add against Booth recoding over 256 bits, on the
    generator with random scalars (Booth wins only on long runs of ones).
    runs=0 times the first run alone."""
    from ..cpu.curve import GENERATOR
    from ..ops import scalar_mul as SM

    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    coords = np.repeat(_coords_of([GENERATOR.to_affine()]), batch, axis=0)
    pts = _mont_points(torch.from_numpy(coords.view(np.int32)).to(dev))
    k = _rand_i32(rng, (batch, 8), 1 << 32, dev)
    t = Table(["strategy", "batch", "first run (ms)", "median (ms)", "k mults/s"])
    for name, fn in (("double_and_add", SM.double_and_add), ("booth", SM.booth)):
        first, ts = time_device(lambda p, s: fn(p, s, num_bits=256), pts, k, runs=runs)
        m = median(ts) if ts else None
        t.add(name, batch, round(first), "-" if m is None else round(m, 2),
              "-" if m is None else round(batch / m, 1))
    return t


def bucket_reduction(num_windows: int = 16, runs: int = 3, device=None) -> Table:
    """BPR alone on its kernels (#7, #8 and the per-window reduce), over
    num_windows windows of 2^15 identity buckets."""
    from ..ops.kernels import bpr as KB
    from ..ops.kernels.ec import identity_row

    dev = resolve_device(device)
    nb = MsmConfig(chunk_size=16).num_buckets
    rows = identity_row(dev).expand(num_windows * nb, -1).contiguous()
    first, ts = time_device(lambda r: KB.bpr(r, num_windows), rows, runs=runs)
    t = Table(["buckets", "first run (ms)", "median (ms)"])
    t.add(num_windows * nb, round(first), round(median(ts), 2))
    return t


def dashboard(power: int = 16, runs: int = 1, device=None) -> Table:
    """Every MSM of models/baselines.py at 2^power points, each result
    checked against the answer: one first run, then the median of `runs`
    steady runs (runs=0: the first run alone).  The naive MSM is skipped
    above 2^14 points, the fixed-base row on the CPU (its precompute of
    the kernels' plain versions takes minutes)."""
    from ..models.baselines import ALL_MSM_FUNCTIONS
    from .full import OK, BAD, _inputs_for_power

    dev = resolve_device(device)
    coords, scalars, expected, _src = _inputs_for_power(power)
    t = Table(["function", "first run incl. kernel load/build (ms)", "steady (ms)", "correct"])
    for name, fn in ALL_MSM_FUNCTIONS.items():
        if "naive" in name and power > 14:
            t.add(name, "skipped (the naive MSM is O(256 n) products)", "-", "-")
            continue
        if "precomputed" in name and dev.type == "cpu":
            t.add(name, "skipped (the precompute's plain versions on the CPU)", "-", "-")
            continue
        t0 = time.time()
        res = fn(coords, scalars, device=dev)
        first_ms = (time.time() - t0) * 1e3
        steady = []
        for _ in range(runs):
            t0 = time.time()
            again = fn(coords, scalars, device=dev)
            steady.append((time.time() - t0) * 1e3)
            if again != res:
                raise AssertionError(f"{name}: runs disagree")
        ok = "-"
        if expected is not None:
            ok = OK if (res["x"], res["y"]) == tuple(expected) else BAD
        t.add(name, round(first_ms, 1), round(median(steady), 1) if steady else "-", ok)
        print(t.markdown().splitlines()[-1], flush=True)
    return t


def device_info_table(device=None) -> Table:
    """The device's identity and memory."""
    from ..utils.runtime import device_info, device_memory_bytes

    info = device_info(device)
    t = Table(["property", "value"])
    for k in ("backend", "kind", "id", "num_devices", "process_index", "compute_capability",
              "multiprocessors", "card"):
        if k in info:
            t.add(k, info[k])
    t.add("memory_bytes", device_memory_bytes(device))
    for k, v in (info.get("memory_stats") or {}).items():
        t.add(k, v)
    return t


def stages(power: int = 20, runs: int = 3, device=None) -> Table:
    """The parts of the bucket-sum stage at 2^power points, c = 16, one
    window group of 8: the sort, the row gathers, the scans, and BPR over a
    full window set.  The production row times what
    ops/msm_pipeline.py::window_group_bucket_sums runs: kernel #12 reading
    each entry's row of the doubled table by index, on the sorted keys and
    row indices of the sort row, as the pipeline lays them out."""
    from ..ops import msm_pipeline as MP
    from ..ops.kernels import bpr as KB
    from ..ops.kernels import scan as KS
    from ..ops.kernels.ec import TW
    from ..ops.kernels.gather import row_gather

    dev = resolve_device(device)
    n = 1 << power
    wg = 8
    nb = 1 << 15
    K, TWR = KS.K, 128
    rng = np.random.default_rng(0)
    t = Table(["stage", "shape", "first run (ms)", "median (ms)", "rate"])

    def row(stage, shape, fn, *args, unit="entries", count=wg * n):
        first, ts = time_device(fn, *args, runs=runs)
        m = median(ts)
        t.add(stage, shape, round(first), round(m, 3), f"{count / m / 1e3:.0f} M {unit}/s")
        print(t.markdown().splitlines()[-1], flush=True)

    # The sort (stable, as lax.sort): [wg, n] keys with their row indices.
    digits = torch.from_numpy(rng.integers(-nb, nb, size=(wg, n)).astype(np.int32)).to(dev)
    keys = torch.where(digits == 0, nb, digits.abs() - 1).to(torch.int32)
    idx = torch.arange(n, dtype=torch.int32, device=dev)
    idxs = torch.where(digits < 0, idx + n, idx)              # the doubled table's rows
    row("sort (stable torch.sort)", f"[{wg}, 2^{power}]", MP._sort_entries, keys, idxs)
    keys_s, idxs_s = MP._sort_entries(keys, idxs)

    # Row gathers in sorted order from an [n, TWR] table, wg*n rows.
    table = _rand_i32(rng, (n, TWR), 1 << 13, dev)
    nf = wg * n // K
    gidx = torch.from_numpy(rng.integers(0, n, size=(wg * n,)).astype(np.int32)).to(dev)
    pidx_t = gidx.reshape(nf, K).T.contiguous()
    shape = f"{wg}*2^{power} rows x {TWR * 4} B"
    row("gather (torch index)", shape, lambda tb, ix: tb[ix.to(torch.int64)], table, gidx,
        unit="rows")
    row("gather (#3 row_gather kernel)", shape, row_gather, table, pidx_t, unit="rows")
    row("gather+transpose (limb-major)", f"{wg}*2^{power} rows -> limb-major", MP._pret_rows,
        table, gidx, nf, unit="rows")

    # The scans over gathered rows, on keys sorted inside each fragment.
    rows = table[gidx.to(torch.int64)].reshape(nf, K, TWR)
    skeys = torch.from_numpy(np.sort(rng.integers(0, nb, size=(K, nf)).astype(np.int32),
                                     axis=0)).to(dev)
    scan_shape = f"{wg}*2^{power} entries"
    rate = dict(unit="entries")
    row("scan (11b-1 msm_scan, row-major)", scan_shape, KS.msm_scan, rows, skeys, **rate)
    row("scan (#4 msm_scan_rm_sames, with its same-bit pass)", scan_shape,
        lambda r, k: KS.msm_scan_rm_sames(r, KS.keys_to_sames(k)), rows, skeys, **rate)
    rows_t = MP._pret_rows(table, gidx, nf)
    del rows
    row("scan (11b-2 msm_scan_pret)", scan_shape, KS.msm_scan_pret, rows_t, skeys, **rate)
    del rows_t

    # Production: kernel #12 reads each entry's doubled-table row by index,
    # the keys and indices the sort left, viewed [K, NF] as the pipeline
    # passes them.
    table2 = torch.cat([table, _rand_i32(rng, (n, TWR), 1 << 13, dev)])
    del table
    keys_t = keys_s.reshape(nf, K).T
    sorted_pidx_t = idxs_s.reshape(nf, K).T
    row("scan (#12 msm_scan_fused, rows read by index: production)", scan_shape,
        KS.msm_scan_fused, table2, sorted_pidx_t, keys_t, **rate)
    del table2

    # BPR over one full window set (16 windows x 2^15 buckets).
    w = 16
    buckets = _rand_i32(rng, (w * nb, TW), 1 << 13, dev)
    row("bpr", f"{w} windows x 2^15 buckets", lambda b: KB.bpr(b, w), buckets,
        unit="buckets", count=w * nb)
    return t


def smtvp(n: int = 1 << 12, runs: int = 3, device=None) -> Table:
    """Bucket sums by scatter, one window, one point a step (ops/smtvp.py),
    beside the pipeline's window sums over all windows (on a card)."""
    from ..ops import convert as CV
    from ..ops import msm_pipeline as MP
    from ..ops.smtvp import smtvp_buckets
    from ..utils import oracle

    dev = resolve_device(device)
    cfg = MsmConfig(chunk_size=16 if n >= (1 << 16) else 13)
    rng = np.random.default_rng(0)
    coords = oracle.gen_points(n, seed=1).view(np.uint32).reshape(n, 2, 8)
    sc = rng.integers(0, 1 << 32, size=(n, 8), dtype=np.uint64).astype(np.uint32)
    sc[:, 7] &= 0xFFFF
    dcoords = torch.from_numpy(coords.view(np.int32)).to(dev)
    dsc = torch.from_numpy(sc.view(np.int32)).to(dev)

    def one_window_smtvp(c, s):
        digits = CV.decompose_scalars_signed(s, cfg)
        return smtvp_buckets(_mont_points(c), digits[:, 0], cfg.num_buckets)

    t = Table(["method", "n", "windows", "first run (ms)", "median (ms)", "M (point,window)/s"])
    first, ts = time_device(one_window_smtvp, dcoords, dsc, runs=runs)
    m = median(ts)
    t.add("smtvp scatter (1 window)", n, 1, round(first), round(m, 1), round(n / m / 1e3, 3))
    if dev.type == "cuda" and n % 64 == 0:
        first, ts = time_device(lambda c, s: MP.msm_window_sums(c, s, cfg), dcoords, dsc,
                                runs=runs)
        m = median(ts)
        t.add("pipeline window sums (all windows)", n, cfg.num_windows, round(first),
              round(m, 2), round(n * cfg.num_windows / m / 1e3, 1))
    return t


def horners_rule(runs: int = 3, device=None) -> Table:
    """The Horner fold of 16 window sums (c = 16): the fold kernel (#9) on
    packed rows, the same fold as ops/curve.py doublings and adds in torch
    ops, and the host's python-int fold."""
    from ..cpu.curve import GENERATOR
    from ..cpu.mirrors import horner as host_horner
    from ..ops import curve as C
    from ..ops.kernels import bpr as KB
    from ..ops.kernels.common import LP, W as WBITS
    from ..ops.kernels.ec import TW

    dev = resolve_device(device)
    w, c = 16, 16
    pts, g = [], GENERATOR
    for _ in range(w):
        pts.append(g)
        g = g.add(GENERATOR)
    coords = _coords_of([p.to_affine() for p in pts])
    p = _mont_points(torch.from_numpy(coords.view(np.int32)).to(dev))

    def device_horner(p):
        acc = p.at(slice(w - 1, w))
        for idx in range(w - 2, -1, -1):
            for _ in range(c):
                acc = C.double(acc)
            acc = C.add(acc, p.at(slice(idx, idx + 1)))
        return acc

    first, ts = time_device(device_horner, p, runs=runs)
    t = Table(["impl", "first run (ms)", "median (ms)"])
    t.add("device (torch ops, 15x(16 dbl + add))", round(first), round(median(ts), 2))

    rows = np.zeros((w, TW), np.uint32)
    for i, pt in enumerate(pts):
        for ci, v in enumerate((pt.x, pt.y, pt.t, pt.z)):
            m = PARAMS.to_mont(v % PARAMS.p)
            limbs = [(m >> (WBITS * k)) & ((1 << WBITS) - 1) for k in range(2 * LP)]
            for k in range(LP):
                rows[i, ci * LP + k] = limbs[2 * k] | (limbs[2 * k + 1] << 16)
    drows = torch.from_numpy(rows.view(np.int32)).to(dev)
    first, ts = time_device(lambda r: KB.horner_fold(r, c), drows, runs=runs)
    t.add("device (#9 horner_fold kernel, production)", round(first), round(median(ts), 3))

    hts = []
    for _ in range(runs):
        t0 = time.time()
        host_horner(pts, c)
        hts.append((time.time() - t0) * 1e3)
    t.add("host (python int)", 0, round(median(hts), 3))
    return t


def trace(power: int = 16, log_dir: str = DEFAULT_TRACE_DIR, device=None) -> Table:
    """One MSM's window sums (the pipeline without the fold) under
    torch.profiler, after a warm call: its chrome trace written to log_dir,
    and the device's busy time and idle share (utils/profiling.py)."""
    from ..models import cuzk
    from ..ops import msm_pipeline as MP
    from ..utils.params import tpu_msm_config
    from ..utils.profiling import device_profile
    from .full import _inputs_for_power

    dev = resolve_device(device)
    coords, scalars, _, _ = _inputs_for_power(power)
    cfg = tpu_msm_config(coords.shape[0])
    dcoords, dscalars = cuzk.prepare_inputs(coords, scalars, dev)
    fn = lambda: force(MP.msm_window_sums(dcoords, dscalars, cfg))  # noqa: E731
    fn()
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, f"msm_2^{power}.json")
    prof = device_profile(fn, trace_path=path)
    t = Table(["power", "trace", "wall (ms)", "device busy (ms)", "device idle share"])
    idle = prof["device_idle_share"]
    t.add(power, path, round(prof["wall_ms"], 2), round(prof["device_busy_ms"], 2),
          "-" if idle is None else round(idle, 3))
    return t
