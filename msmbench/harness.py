"""One run of one cell: set-up, the measured window, the check, the result.

Set-up makes the inputs from the seed, puts them on the device, builds and
loads the kernels, runs the configuration's one-time work (a fixed base's
precompute) and the traffic's warm-up calls.  `setup_s` is the time from the
process's start to the window's.

The window is a closed loop with one caller: each call of the cell's entry
point starts when the last one has returned its affine {x, y} to Python,
with no pause between, for `seconds`; the call that runs over the end is
counted in full.  `msm_ms` is the window's wall time over the MSMs it
completed; `call_p95_ms` the 95th percentile of every call's latency, none
trimmed.  With `--trace 1`, `trace_msms` MSMs' worth of calls, starting
`trace_after_s` into the window, run under torch.profiler, and the per-layer
metrics are read from them once the window has closed.

Then the program's state is freed and every call's answer is compared with
the plain reference (reference.py).
"""

from __future__ import annotations

import dataclasses
import gc
import json
import subprocess
import sys
import time

import numpy as np
import torch

from . import FORBIDDEN_MODULES, inputs, reference, spec, stats, trace, workcount
from .entries import PortSystem, sync

#: Sampled points checked against their logarithm after each run.
POINT_SAMPLE = 16


@dataclasses.dataclass
class Call:
    ids: list[int]
    latency_s: float
    answers: list | None        # the {x, y} of each MSM; None if the call raised
    error: str = ""


def _to_device(arr: np.ndarray, device: str) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(arr).view(np.int32)).to(device)


def _log(msg: str) -> None:
    print(f"msmbench: {msg}", file=sys.stderr, flush=True)


def _timed_call(system, ids: list[int]) -> Call:
    t0 = time.perf_counter()
    try:
        answers = system.call(ids)
    except Exception as e:  # a failed call is counted, and the window goes on
        return Call(ids, time.perf_counter() - t0, None, f"{type(e).__name__}: {e}")
    return Call(ids, time.perf_counter() - t0, answers)


def forbidden_loaded() -> list[str]:
    """The forbidden top-level modules that this process has loaded, names
    compared whole."""
    tops = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN_MODULES))


def _power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return "unknown"
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout else "unknown"


def check(calls: list[Call], inp: inputs.Inputs, seed: int) -> dict:
    """Every call's answers against the reference's, and a sample of the
    points against their logarithms: each number with its limit."""
    expected = [reference.expected(v, inp.alpha, inp.beta) for v in inp.vectors]
    wrong = missing = compared = 0
    for c in calls:
        if c.answers is None or len(c.answers) != len(c.ids):
            missing += len(c.ids)
            continue
        for i, ans in zip(c.ids, c.answers):
            compared += 1
            got = (ans.get("x"), ans.get("y")) if isinstance(ans, dict) else ans
            wrong += got != expected[i]
    sample = np.random.default_rng([seed, 1]).integers(0, inp.points.shape[0], POINT_SAMPLE)
    return {
        "wrong_answers": {"value": wrong, "limit": 0},
        "missing_answers": {"value": missing, "limit": 0},
        "wrong_points": {"value": reference.wrong_points(inp.points, inp.alpha, inp.beta, sample),
                         "limit": 0},
        "answers_compared": {"value": compared, "limit": 1, "at_least": True},
    }


def passed(checks: dict) -> bool:
    return all(c["value"] >= c["limit"] if c.get("at_least") else c["value"] <= c["limit"]
               for c in checks.values())


def run(root: str, workload: str, seed: int, seconds: float, traced: bool,
        device: str = "cuda", t_process: float | None = None, system_factory=PortSystem) -> dict:
    """One run of cell `workload` of the benchmark at `root`: the result's
    line as a dict (keys in the contract's order, `checks` last)."""
    t_process = time.perf_counter() if t_process is None else t_process
    phases = {"start": time.perf_counter() - t_process}
    cell = spec.cell(root, workload)
    conf, mix = cell.config, cell.traffic
    n, k = int(conf["n"]), int(mix["msms_per_call"])
    gen_build_s = inputs.build()
    inp = inputs.make(seed, n, int(mix["vectors"]))
    phases["inputs"] = time.perf_counter() - t_process
    cuda = device.startswith("cuda")
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    coords = _to_device(inp.points.view(np.uint32).reshape(n, 2, 8), device)
    vectors = [_to_device(v, device) for v in inp.vectors]
    sync(device)
    phases["upload"] = time.perf_counter() - t_process
    system = system_factory(conf, mix, coords, vectors, device, host_inputs=inp)
    phases["import"] = time.perf_counter() - t_process
    kernels_s = system.load_kernels()
    phases["kernels"] = time.perf_counter() - t_process
    facts = system.setup()
    phases["setup"] = time.perf_counter() - t_process
    nvec = len(vectors)
    schedule = lambda c: [(c * k + b) % nvec for b in range(k)]  # noqa: E731
    for c in range(int(mix["warmup_calls"])):
        system.call(schedule(c))
        phases[f"warm{c}"] = time.perf_counter() - t_process
    sync(device)
    gc.collect()
    setup_s = time.perf_counter() - t_process
    _log(f"set-up {setup_s:.3f} s (point generator build {gen_build_s:.1f} s, "
         f"kernels {kernels_s:.1f} s, {facts}); phases end at "
         + ", ".join(f"{k} {v:.3f}" for k, v in phases.items()))

    calls: list[Call] = []
    prof = None
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        if traced and prof is None and time.perf_counter() - t0 >= float(mix["trace_after_s"]):
            prof, traced_calls = _traced(system, schedule, len(calls), mix, device)
            calls += traced_calls
            continue
        calls.append(_timed_call(system, schedule(len(calls))))
    window_s = time.perf_counter() - t0
    if traced and prof is None:    # a window too short to reach the traced calls
        prof, traced_calls = _traced(system, schedule, len(calls), mix, device)
        calls += traced_calls
    peak = int(torch.cuda.max_memory_allocated()) if cuda else 0
    system.close()
    del system, coords, vectors
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    t_ref = time.perf_counter()
    checks = check(calls, inp, seed)
    _log(f"reference and check {time.perf_counter() - t_ref:.3f} s")
    msms = sum(len(c.ids) for c in calls)
    failed = sum(len(c.ids) for c in calls if c.answers is None)
    for c in calls:
        if c.error:
            _log(f"call over vectors {c.ids} failed: {c.error}")
            break

    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": cell.chips, "memory_peak_bytes": peak}
    result = {"correct": passed(checks), "attempted": msms, "failed": failed}
    if traced:
        t_trace = time.perf_counter()
        tw = _trace_window(prof, traced_calls, conf, inp, facts)
        _log(f"trace read {time.perf_counter() - t_trace:.3f} s")
        traced_ids = {id(c) for c in traced_calls}
        tw.window_calls_ms = [c.latency_s * 1e3 for c in calls if id(c) not in traced_ids]
        result["metrics"] = _per_layer(root, cell, tw)
        dev["busy_s"] = trace.busy_us(tw) / 1e6
        dev["window_s"] = tw.wall_us / 1e6
    else:
        lat = [c.latency_s * 1e3 for c in calls]
        # MSMs whose call raised are not completed; with none completed the
        # whole window stands for one.
        values = {"msm_ms": stats.msm_ms(window_s, max(1, msms - failed)),
                  "call_p95_ms": stats.p95(lat) if len(lat) > 1 else lat[0],
                  "setup_s": setup_s}
        units = {m["name"]: m["unit"] for m in cell.end_to_end}
        result["metrics"] = {name: {"value": values[name], "unit": unit}
                             for name, unit in units.items()}
        _log_latencies(calls, msms, window_s, lat)
    result["device"] = dev
    if traced:
        result["breakdown"] = trace.breakdown(tw)
    result["power"] = _power_limit() if cuda else "cpu"
    result["checks"] = checks
    return result


def _log_latencies(calls: list[Call], msms: int, window_s: float, lat: list[float]) -> None:
    """The window's calls in numbers: quantiles, the slow calls and where
    they fell."""
    med = float(np.median(lat))
    q = np.percentile(lat, [50, 90, 95, 99]).round(3).tolist()
    slow = [(i, round(x, 1)) for i, x in enumerate(lat) if x > 1.5 * med]
    _log(f"{len(calls)} calls, {msms} MSMs in {window_s:.3f} s; latency ms min {min(lat):.3f} "
         f"p50/p90/p95/p99 {q} max {max(lat):.3f}; first calls "
         f"{[round(x, 3) for x in lat[:5]]}; {len(slow)} over 1.5x the median "
         f"(call, ms): {slow[:40]}")


def _traced(system, schedule, start: int, mix: dict, device: str):
    """Run trace_msms MSMs' worth of calls under torch.profiler; the
    profiler, read once the window has closed, and the calls."""
    from torch.profiler import ProfilerActivity, profile, record_function

    ncalls = max(1, int(mix["trace_msms"]) // int(mix["msms_per_call"]))
    activities = [ProfilerActivity.CPU]
    if device.startswith("cuda"):
        activities.append(ProfilerActivity.CUDA)
    calls = []
    sync(device)
    with profile(activities=activities) as prof:
        with record_function(trace.WINDOW_SPAN):
            for c in range(start, start + ncalls):
                with record_function(trace.CALL_SPAN):
                    calls.append(_timed_call(system, schedule(c)))
    return prof, calls


def _trace_window(prof, calls: list[Call], conf: dict, inp: inputs.Inputs,
                  facts: dict) -> trace.TraceWindow:
    """The TraceWindow of the traced calls, with the work their MSMs
    needed counted from their inputs."""
    c_bits, windows = int(conf["window_bits"]), int(conf["windows"])
    digits = {}
    for call in calls:
        for i in call.ids:
            if i not in digits:
                digits[i] = workcount.nonzero_signed_digits(inp.vectors[i], c_bits, windows)
    nonzero = sum(digits[i] for call in calls for i in call.ids)
    msms = sum(len(call.ids) for call in calls)
    nbytes = msms * workcount.accum_input_bytes(int(conf["n"]), windows,
                                                bool(conf.get("fixed_base", False)))
    return trace.from_profiler(prof, msms, nonzero, nbytes, facts)


def _per_layer(root: str, cell: spec.Cell, tw: trace.TraceWindow) -> dict:
    out = {}
    for m in cell.per_layer:
        value = spec.metric_reader(root, m["name"])(tw)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def print_result(result: dict) -> None:
    """The numbers compared, beside their limits, as the last lines of
    standard error; then the result as the last line of standard output."""
    for name, c in result["checks"].items():
        rel = ">=" if c.get("at_least") else "<="
        print(f"check {name} = {c['value']} (limit {rel} {c['limit']})", file=sys.stderr)
    print(f"correct = {str(result['correct']).lower()}", file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
