"""End-to-end MSM benchmarks: latency over powers, the window-size sweep,
and the batch against one-shot calls.

Per power: one first run, then `runs` timed runs 100 ms apart, on inputs
staged on the device first; the table keeps the first run (which loads the
kernel library, and on a fresh tree builds it) apart from the steady
median.  The inputs are the fixture of that power when one exists under
test-data/, else bench.py's: points from the native oracle's walk (seed
20230923), scalars below 2^250 from numpy's default_rng(42), the answer
from the oracle's serial Pippenger.  Results are checked against the
answer.

The steady medians of a run can be kept as this device's curve
(`save_baseline`) in curve_baseline.json beside this module (not checked
in); later runs on the same device kind report their change against it and
print a line for every power slower by more than 3%.
"""

from __future__ import annotations

import json
import os
import time
from functools import lru_cache

import numpy as np
import torch

from ..utils import oracle, test_data
from ..utils.limbs import ints_to_u32_words
from ..utils.params import MsmConfig
from ..utils.runtime import resolve_device, to_device
from .timing import Table, median

#: This device's recorded steady-state curve (ms per power).
_CURVE_BASELINE = os.path.join(os.path.dirname(__file__), "curve_baseline.json")

#: Relative slowdown against the recorded curve that counts as a regression.
_REGRESSION_TOL = 0.03

#: What the "correct" column reads.
OK, BAD = "✓", "✗"


def load_curve_baseline(path: str | None = None) -> dict | None:
    """{"device_kind": ..., "curve": {"<power>": ms}}, or None if absent."""
    try:
        with open(path or _CURVE_BASELINE) as fh:
            return json.load(fh)
    except (OSError, ValueError):
        return None


def save_curve_baseline(curve: dict[int, float], device_kind: str,
                        path: str | None = None) -> None:
    """Merge the measured powers into the recorded curve of this device
    kind: powers not measured now keep their recorded ms.  A curve recorded
    on another device kind is replaced."""
    base = load_curve_baseline(path)
    merged = dict(base["curve"]) if base and base.get("device_kind") == device_kind else {}
    merged.update({str(p): round(ms, 1) for p, ms in curve.items()})
    with open(path or _CURVE_BASELINE, "w") as fh:
        json.dump({"device_kind": device_kind, "curve": merged}, fh, indent=1, sort_keys=True)
        fh.write("\n")


def check_regressions(curve: dict[int, float], device_kind: str,
                      path: str | None = None,
                      tol: float = _REGRESSION_TOL) -> list[str]:
    """One warning line per power whose median is slower than the recorded
    curve by more than `tol`; none without a recorded curve or when it was
    recorded on another device kind."""
    base = load_curve_baseline(path)
    if not base or base.get("device_kind") != device_kind:
        return []
    warnings = []
    for p, ms in sorted(curve.items()):
        ref = base["curve"].get(str(p))
        if ref and ms > ref * (1 + tol):
            warnings.append(
                f"REGRESSION 2^{p}: {ms:.1f} ms vs recorded {ref:.1f} ms "
                f"(+{(ms / ref - 1) * 100:.1f}%, tol {tol * 100:.0f}%)"
            )
    return warnings


@lru_cache(maxsize=4)
def _generated_inputs(p: int, seed: int):
    """bench.py's inputs at 2^p points with the oracle's answer; kept for
    the process, as every benchmark of a power reads the same ones."""
    n = 1 << p
    pts_u64 = oracle.gen_points(n, seed=seed)
    rng = np.random.default_rng(42)
    sc_u64 = rng.integers(0, 1 << 62, size=(n, 4), dtype=np.uint64)
    sc_u64[:, 3] &= (1 << 58) - 1
    expected = oracle.msm(pts_u64, sc_u64, c=16)
    return pts_u64.view(np.uint32).reshape(n, 2, 8), sc_u64.view(np.uint32).reshape(n, 8), expected


def _inputs_for_power(p: int, seed: int = 20230923, base_dir: str | None = None):
    """(coords [n, 2, 8] uint32, scalars [n, 8] uint32, expected (x, y) or
    None, source): the fixture if one exists, else the generated inputs."""
    if test_data.available(p, base_dir):
        tc = test_data.load_test_case(p, base_dir)
        coords = np.stack([ints_to_u32_words([x for x, _ in tc.points]),
                           ints_to_u32_words([y for _, y in tc.points])], axis=1)
        return coords, ints_to_u32_words(tc.scalars), tc.expected, "fixture"
    coords, scalars, expected = _generated_inputs(p, seed)
    return coords, scalars, expected, "native walk"


def _device_kind(dev: torch.device) -> str:
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def _one_run_fn(dcoords: torch.Tensor, dscalars: torch.Tensor, cfg: MsmConfig):
    """A function of no arguments: one MSM as compute_msm runs it on staged
    inputs (the bucket pipeline for n >= 512 and c >= 8, else the
    small-input path), returning ({x, y}, host ms)."""
    from ..models import cuzk
    from ..ops import msm_pipeline as MP

    n = dcoords.shape[0]
    if n >= 512 and cfg.chunk_size >= 8:
        if n % 4096:
            raise ValueError(f"n={n}: the bucket pipeline runs whole blocks of 4096 points")

        def msm():
            return cuzk._affine_result(
                MP.msm_window_sums_blocked(dcoords, dscalars, cfg, fold=True))
    else:
        def msm():
            return cuzk._small_path_msm(dcoords, dscalars, cfg)

    def one_run():
        t0 = time.time()
        res = msm()
        return (res["x"], res["y"]), (time.time() - t0) * 1e3

    return one_run


def run(powers=(16, 17, 18, 19, 20), runs: int = 5, csv_path: str | None = None,
        check: bool = True, base_dir: str | None = None,
        save_baseline: bool = False, device=None) -> Table:
    """MSM latency at each power, on the CUDA card unless `device="cpu"`."""
    from ..models import cuzk

    dev = resolve_device(device)
    device_kind = _device_kind(dev)
    base = load_curve_baseline()
    diff_col = bool(base and base.get("device_kind") == device_kind)
    table = Table(["n", "inputs", "first run incl. kernel load/build (ms)",
                   "median steady (ms)", "runs (ms)", "vs recorded", "correct"])
    curve: dict[int, float] = {}
    for p in powers:
        coords, scalars, expected, src = _inputs_for_power(p, base_dir=base_dir)
        n = coords.shape[0]
        cfg = cuzk._config(n, None)
        # Staged once: packed and guarded as compute_msm does, on the device.
        one_run = _one_run_fn(*cuzk.prepare_inputs(coords, scalars, dev), cfg)
        res, first_ms = one_run()
        ts = []
        for _ in range(runs):
            ts.append(one_run()[1])
            time.sleep(0.1)
        ok = "-"
        if check and expected is not None:
            ok = OK if res == tuple(expected) else BAD
        m = median(ts)
        curve[p] = m
        vs = "-"
        if diff_col and base["curve"].get(str(p)):
            vs = f"{(m / base['curve'][str(p)] - 1) * 100:+.1f}%"
        table.add(f"2^{p}", src, round(first_ms), round(m, 2), [round(t, 2) for t in ts], vs, ok)
        print(table.markdown().splitlines()[-1], flush=True)
    for line in check_regressions(curve, device_kind):
        print(line, flush=True)
    if save_baseline:
        save_curve_baseline(curve, device_kind)
    if csv_path:
        table.save_csv(csv_path)
    return table


def sweep(powers=(18, 19, 20), chunks=(13, 14, 15, 16), runs: int = 3,
          base_dir: str | None = None, device=None) -> Table:
    """Steady ms of the bucket pipeline for each (n, c): the measurement
    behind utils/params.py::tpu_msm_config's window sizes.  Each result is
    held to the answer; a mismatch raises."""
    from ..models import cuzk

    dev = resolve_device(device)
    table = Table(["n"] + [f"c={c} (ms)" for c in chunks] + ["winner"])
    for p in powers:
        coords, scalars, expected, _src = _inputs_for_power(p, base_dir=base_dir)
        staged = cuzk.prepare_inputs(coords, scalars, dev)
        row = []
        for c in chunks:
            if c < 8:
                raise ValueError(f"c={c}: the sweep times the bucket pipeline, c >= 8")
            one_run = _one_run_fn(*staged, MsmConfig(chunk_size=c))
            res, _first = one_run()
            if expected is not None and res != tuple(expected):
                raise AssertionError(f"2^{p}, c={c}: MISMATCH against the answer")
            ts = []
            for _ in range(runs):
                ts.append(one_run()[1])
                time.sleep(0.1)
            row.append(round(median(ts), 2))
        best = chunks[int(np.argmin(row))]
        table.add(f"2^{p}", *row, f"c={best}")
        print(table.markdown().splitlines()[-1], flush=True)
    return table


def run_batch(power: int = 18, k: int = 4, check: bool = True,
              base_dir: str | None = None, resident: bool = False,
              precompute: bool = False, pre_chunk: int | None = None, device=None) -> Table:
    """One point set, `k` scalar vectors (the prover's many MSMs over its
    SRS), in ms an MSM:
      - batch: one compute_msm_batch call / k.  The points are packed and
        their table built once (once per point block), and every MSM is
        queued before any result is read back;
      - one-shot: k compute_msm calls / k, each packing the points, building
        the table and reading its result back before the next;
      - with `precompute`, precomputed: compute_msm_batch_precomputed over a
        base that precompute_msm_base built once (its seconds, a warm call
        included, in "setup").
    Each is timed after a warm call.  `resident` stages the points and
    scalars on the device first, so the columns time the device work and
    the read-back, not the host copies.  The results must agree, and vector
    1's must equal the threaded oracle's."""
    from ..models import cuzk

    dev = resolve_device(device)
    coords, sc, _expected, src = _inputs_for_power(power, base_dir=base_dir)
    rng = np.random.default_rng(7)
    np_coords, np_scs = coords, [sc] + [rng.permutation(sc, axis=0) for _ in range(k - 1)]
    scs = np_scs
    if resident:
        coords = to_device(coords, dev)
        scs = [to_device(s_, dev) for s_ in np_scs]
        src = src + " (device-resident)"

    # Warm calls (both entry points load the same kernels).
    cuzk.compute_msm_batch(coords, scs, device=dev)
    cuzk.compute_msm(coords, scs[0], device=dev)

    t0 = time.time()
    res_batch = cuzk.compute_msm_batch(coords, scs, device=dev)
    batch_ms = (time.time() - t0) * 1e3 / k

    t0 = time.time()
    res_one = [cuzk.compute_msm(coords, s_, device=dev) for s_ in scs]
    oneshot_ms = (time.time() - t0) * 1e3 / k

    pre_ms = setup_s = None
    res_pre = None
    if precompute:
        t0 = time.time()
        pre = cuzk.precompute_msm_base(coords, chunk_size=pre_chunk, device=dev)
        res_pre = cuzk.compute_msm_batch_precomputed(pre, scs)      # warm call
        setup_s = time.time() - t0
        t0 = time.time()
        res_pre = cuzk.compute_msm_batch_precomputed(pre, scs)
        pre_ms = (time.time() - t0) * 1e3 / k
        del pre

    ok = "-"
    if check:
        same = all(a == b for a, b in zip(res_batch, res_one))
        if res_pre is not None:
            same = same and all(a == b for a, b in zip(res_batch, res_pre))
        ok = OK if same else BAD
        if same and k > 1:
            # Vector 1 against the independent native oracle (u32 LE words
            # read as the oracle's u64 layout).
            want = oracle.msm_parallel(
                np.ascontiguousarray(np_coords).view(np.uint64).reshape(-1, 8),
                np.ascontiguousarray(np_scs[1]).view(np.uint64).reshape(-1, 4))
            ok = OK if (res_batch[1]["x"], res_batch[1]["y"]) == want else BAD

    cols = ["n", "k", "inputs", "batch (ms/MSM)", "one-shot (ms/MSM)", "speedup", "correct"]
    row = [f"2^{power}", k, src, round(batch_ms, 2), round(oneshot_ms, 2),
           f"{oneshot_ms / batch_ms:.2f}x", ok]
    if precompute:
        cols[6:6] = ["precomp (ms/MSM)", "setup (s)"]
        row[6:6] = [round(pre_ms, 2), round(setup_s, 2)]
    table = Table(cols)
    table.add(*row)
    return table
