"""BENCHMARK.json and the files it names, found by name.

- a configuration: the `file` of its entry in `configs`
  (msmbench/configs/<name>.json);
- a traffic mix: msmbench/traffic/<traffic>.json;
- a per-layer metric: msmbench/metrics/<name>.py, a module with
  `read(tw) -> float | None`, or msmbench/metrics/<name>.json, a sum of
  device time a MSM over kernel-name patterns ({"include": [...],
  "exclude": [...]}, regular expressions).
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os

TRAFFIC_DIR = os.path.join("msmbench", "traffic")
METRICS_DIR = os.path.join("msmbench", "metrics")

#: The keys of a traffic mix, every one required.  Every mix is a closed
#: loop with one caller: each call starts when the last one has returned.
TRAFFIC_KEYS = (
    "why",
    "msms_per_call",            # 1: the single-MSM entry; k > 1: the batch entry
    "vectors",                  # scalar vectors in the pool, used in turn
    "warmup_calls",             # calls in set-up, not timed
    "trace_after_s",            # --trace 1: the traced calls start this far in
    "trace_msms",               # --trace 1: MSMs in the traced sub-window
)


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list[dict]
    per_layer: list[dict]


def load_benchmark(root: str) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def _load_json(root: str, rel: str) -> dict:
    with open(os.path.join(root, rel)) as f:
        return json.load(f)


def traffic(root: str, name: str) -> dict:
    """The traffic mix `name`; a key missing or unknown is refused."""
    mix = _load_json(root, os.path.join(TRAFFIC_DIR, f"{name}.json"))
    if set(mix) != set(TRAFFIC_KEYS):
        raise ValueError(f"traffic {name}: unknown keys {sorted(set(mix) - set(TRAFFIC_KEYS))}, "
                         f"missing {sorted(set(TRAFFIC_KEYS) - set(mix))}")
    return mix


def _applies(metric: dict, cell: str, reported: set[str]) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric["moves"] in reported


def cell(root: str, name: str) -> Cell:
    """The cell `name` of BENCHMARK.json with its configuration, traffic and
    the metrics it reports."""
    bench = load_benchmark(root)
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == entry["config"])
    e2e = [m for m in bench["end_to_end"] if name in m.get("workloads", [name])]
    reported = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"] if _applies(m, name, reported)]
    return Cell(name, int(entry["chips"]), _load_json(root, conf["file"]),
                traffic(root, entry["traffic"]), e2e, per_layer)


def metric_reader(root: str, name: str):
    """The reader of per-layer metric `name`: a function of a TraceWindow
    that returns the value, or None where it finds nothing to read."""
    base = os.path.join(root, METRICS_DIR, name)
    if os.path.exists(base + ".py"):
        spec = importlib.util.spec_from_file_location(f"msmbench_metric_{name}", base + ".py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod.read
    if os.path.exists(base + ".json"):
        return kernel_ms_reader(_load_json(root, os.path.join(METRICS_DIR, name + ".json")))
    raise FileNotFoundError(f"no reader for metric {name!r} ({base}.py or .json)")


def kernel_ms_reader(spec: dict):
    """Device ms a MSM of the events matching spec["include"] (every event
    if absent) and none of spec["exclude"]; None where none matches."""
    include, exclude = spec.get("include", []), spec.get("exclude", [])

    def read(tw):
        us, count = tw.device_us(include, exclude)
        if not count or not tw.msms:
            return None
        return us / 1e3 / tw.msms

    return read
