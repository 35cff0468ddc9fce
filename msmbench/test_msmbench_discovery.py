"""BENCHMARK.json against the contract's shape, and discovery by file name:
a configuration, a traffic mix and a per-layer metric added as files are
taken up without an edit to any file already there."""

from __future__ import annotations

import json
import os
import re

import pytest

from msmbench import spec, testroot, trace

REPO = testroot.REPO
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.fixture(scope="module")
def bench():
    return spec.load_benchmark(REPO)


def test_contract_keys(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert bench["paths"] == ["msmbench"] and 1 <= bench["run_seconds"] <= 51
    assert len(bench["command"]) <= 32 and not any(w.startswith("/") for w in bench["command"])
    e2e = {m["name"] for m in bench["end_to_end"]}
    assert {"msm_ms", "setup_s"} <= e2e
    for m in bench["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25


def test_names_units_and_lines(bench):
    names = []
    for sec in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in bench[sec]:
            assert NAME.match(e["name"]), e["name"]
            names.append((sec in ("end_to_end", "per_layer"), e["name"]))
            for key in ("why", "layer", "source"):
                if key in e and sec != "end_to_end":
                    assert 1 <= len(e[key]) <= 200 and "\n" not in e[key] and "\t" not in e[key]
            if "unit" in e:
                assert UNIT.match(e["unit"]), e["unit"]
                assert e["better"] in ("lower", "higher")
    assert len(names) == len(set(names))
    layers = {m["layer"] for m in bench["per_layer"]}
    assert all(m["moves"] in {e["name"] for e in bench["end_to_end"]} for m in bench["per_layer"])
    assert layers


@pytest.mark.parametrize("name", ["oneshot-2p20", "fixedbase-2p20", "oneshot-2p20-batch4"])
def test_every_cell_resolves(name, bench):
    cell = spec.cell(REPO, name)
    assert cell.chips == 1 and cell.config["n"] == 1 << 20
    assert {m["name"] for m in cell.end_to_end} >= {"msm_ms", "setup_s"}
    for m in cell.per_layer:
        assert callable(spec.metric_reader(REPO, m["name"]))
    used = {w["config"] for w in bench["workloads"]}
    assert used == {c["name"] for c in bench["configs"]}


def test_config_files_state_their_cut(bench):
    for c in bench["configs"]:
        with open(os.path.join(REPO, c["file"])) as f:
            conf = json.load(f)
        assert conf["name"] == c["name"] and c["file"].startswith("msmbench/")
        assert conf["reduced"] == c["reduced"] == []
        assert conf["n"] == 1 << 20 and conf["window_bits"] * conf["windows"] >= 253


def test_files_added_at_test_time_are_found(tmp_path):
    root = testroot.make_root(str(tmp_path))
    before = {p: open(p, "rb").read() for p in _files(root)}
    with open(os.path.join(root, "msmbench", "traffic", "closed-witness.json"), "w") as f:
        json.dump({"why": "added", "msms_per_call": 2, "vectors": 6, "warmup_calls": 1,
                   "trace_after_s": 1.0, "trace_msms": 64}, f)
    with open(os.path.join(root, "msmbench", "metrics", "sort_ms.json"), "w") as f:
        json.dump({"include": ["RadixSort"]}, f)
    with open(os.path.join(root, "msmbench", "metrics", "halves.py"), "w") as f:
        f.write("def read(tw):\n    return tw.msms / 2 if tw.msms else None\n")
    bench = spec.load_benchmark(root)
    bench["workloads"].append({"name": "tiny-witness", "config": "tiny",
                               "traffic": "closed-witness", "chips": 1, "why": "added"})
    bench["per_layer"] += [
        {"name": "sort_ms", "unit": "ms", "better": "lower", "source": "device_trace",
         "layer": "stage glue: ops/msm_pipeline.py", "moves": "msm_ms"},
        {"name": "halves", "unit": "msm", "better": "lower", "source": "program_counter",
         "layer": "device", "moves": "msm_ms", "workloads": ["tiny-witness"]}]
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    cell = spec.cell(root, "tiny-witness")
    assert cell.traffic["msms_per_call"] == 2 and cell.traffic["vectors"] == 6
    assert {"sort_ms", "halves", "torch_glue_ms"} <= {m["name"] for m in cell.per_layer}
    tw = trace.TraceWindow([trace.Event("DeviceRadixSortOnesweepKernel", 0, 500),
                            trace.Event("msm::scan_kernel<2, 0, 2>", 500, 1500)],
                           [], 0, 2000, 4, 0, 0, {})
    assert spec.metric_reader(root, "sort_ms")(tw) == pytest.approx(0.125)
    assert spec.metric_reader(root, "halves")(tw) == 2
    assert spec.metric_reader(root, "torch_glue_ms")(tw) == pytest.approx(0.125)
    for p, data in before.items():
        if not p.endswith("BENCHMARK.json"):
            assert open(p, "rb").read() == data, f"{p} was edited"


def test_unknown_or_missing_traffic_key_is_refused(tmp_path):
    root = testroot.make_root(str(tmp_path))
    with open(os.path.join(root, "msmbench", "traffic", "closed-single-v4.json")) as f:
        good = json.load(f)
    for name, mix in (("extra", {**good, "rate_hz": 5}),
                      ("short", {k: v for k, v in good.items() if k != "vectors"})):
        with open(os.path.join(root, "msmbench", "traffic", f"{name}.json"), "w") as f:
            json.dump(mix, f)
    with pytest.raises(ValueError, match="rate_hz"):
        spec.traffic(root, "extra")
    with pytest.raises(ValueError, match="vectors"):
        spec.traffic(root, "short")


def _files(root):
    for d, _, fs in os.walk(root):
        for f in fs:
            yield os.path.join(d, f)
