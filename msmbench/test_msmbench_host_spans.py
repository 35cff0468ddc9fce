"""The host-dispatch metrics that read the port's host spans (hostspans.py,
metrics/host_*.py), the configuration zprize23-oneshot-2p16 and its cell,
and whole CPU runs at 4096 points with that configuration's shape: c = 13
and W = 20, the port's bucket pipeline on its plain versions.  The traced
run takes about two minutes on one thread (most of it torch.profiler
nesting the plain versions' 1.2 M operators)."""

from __future__ import annotations

import json
import os

import pytest
import torch

from msmbench import control, harness, spec, testroot, trace

REPO = testroot.REPO
CONFIG = "zprize23-oneshot-2p16"
METRICS = ("host_issue_ms", "host_wait_ms", "host_syncs_per_msm")


def _read(name, tw, root=REPO):
    return spec.metric_reader(root, name)(tw)


def _tw(host, msms):
    return trace.TraceWindow([], [trace.Event(*h) for h in host], 0.0, 10_000.0, msms, 0, 0, {})


def test_readers_by_hand():
    call = trace.CALL_SPAN
    host = [(call, 0, 1000), ("msm.wait.guard", 100, 150), ("aten::nonzero", 150, 170),
            ("msm.wait.meminfo", 200, 210), ("msm.wait.meminfo", 220, 240),
            ("msm.wait.result", 600, 900), ("msm.host.decode", 920, 990),
            (call, 1000, 1600), ("msm.wait.guard", 1100, 1120), ("msm.wait.result", 1400, 1500),
            ("msm.host.decode", 1520, 1590),
            ("msm.wait.result", 1700, 1800)]      # between calls: not a call's wait
    tw = _tw(host, 2)
    waits = 50 + 10 + 20 + 300 + 20 + 100
    assert _read("host_wait_ms", tw) == pytest.approx(waits / 1e3 / 2)
    assert _read("host_issue_ms", tw) == pytest.approx((1600 - waits) / 1e3 / 2)
    assert _read("host_syncs_per_msm", tw) == 3.0
    # A batch of 4 MSMs in one call, as compute_msm_batch waits: one guard,
    # two memory queries and the four results, counted a MSM.
    batch = host[:5] + [("msm.wait.result", 600 + 50 * i, 620 + 50 * i) for i in range(4)]
    assert _read("host_syncs_per_msm", _tw(batch, 4)) == 7 / 4
    assert _read("host_wait_ms", _tw(batch, 4)) == pytest.approx((80 + 80) / 1e3 / 4)


def test_a_window_without_waits_reads_zero_waits():
    tw = _tw([(trace.CALL_SPAN, 0, 400), ("msm.host.decode", 300, 390),
              (trace.CALL_SPAN, 400, 700), ("msm.host.decode", 600, 690)], 2)
    assert _read("host_wait_ms", tw) == 0
    assert _read("host_syncs_per_msm", tw) == 0
    assert _read("host_issue_ms", tw) == pytest.approx(0.7 / 2)


def test_a_program_without_spans_gives_no_reading():
    # No span of the port (a program that has none): nothing to read.
    tw = _tw([(trace.CALL_SPAN, 0, 400), ("aten::nonzero", 10, 20), ("cudaMemGetInfo", 30, 90)], 1)
    no_msms = _tw([(trace.CALL_SPAN, 0, 400), ("msm.wait.guard", 10, 20)], 0)
    no_calls = _tw([("msm.wait.guard", 10, 20)], 1)
    for name in METRICS:
        assert _read(name, tw) is None
        assert _read(name, no_msms) is None
        assert _read(name, no_calls) is None


def test_the_configuration_and_its_cell():
    bench = spec.load_benchmark(REPO)
    entry = next(c for c in bench["configs"] if c["name"] == CONFIG)
    with open(os.path.join(REPO, entry["file"])) as f:
        conf = json.load(f)
    assert conf["name"] == CONFIG and conf["reduced"] == entry["reduced"] == []
    assert (conf["n"], conf["window_bits"], conf["windows"]) == (1 << 16, 13, 20)
    assert conf["window_bits"] * conf["windows"] >= conf["scalar_bits"] == 253
    assert not conf["fixed_base"]
    cell = spec.cell(REPO, "oneshot-2p16")
    assert cell.chips == 1 and cell.traffic["msms_per_call"] == 1
    assert {m["name"] for m in cell.end_to_end} == {"msm_ms", "setup_s"}
    names = {m["name"] for m in cell.per_layer}
    assert set(METRICS) <= names and "precompute_s" not in names
    for m in cell.per_layer:
        assert callable(spec.metric_reader(REPO, m["name"]))
    for name in METRICS:     # read in every cell
        assert name in {m["name"] for m in spec.cell(REPO, "fixedbase-2p20").per_layer}


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """A root with the configuration at 4096 points and a traffic mix that
    traces one call at the window's start, with no warm-up call."""
    torch.set_num_threads(1)
    tmp = testroot.make_root(str(tmp_path_factory.mktemp("bench")))
    with open(os.path.join(REPO, "msmbench", "configs", f"{CONFIG}.json")) as f:
        conf = {**json.load(f), "name": "tiny2p16", "n": 4096}
    rel = "msmbench/configs/tiny2p16.json"
    with open(os.path.join(tmp, rel), "w") as f:
        json.dump(conf, f)
    with open(os.path.join(tmp, "msmbench", "traffic", "traced-once.json"), "w") as f:
        json.dump({"why": "a CPU test", "msms_per_call": 1, "vectors": 1, "warmup_calls": 0,
                   "trace_after_s": 0.0, "trace_msms": 1}, f)
    bench = spec.load_benchmark(tmp)
    bench["configs"].append({"name": "tiny2p16", "source": "test", "file": rel,
                             "reduced": ["n"], "why": "a CPU test"})
    bench["workloads"].append({"name": "tiny2p16", "config": "tiny2p16",
                               "traffic": "traced-once", "chips": 1, "why": "a CPU test"})
    with open(os.path.join(tmp, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f, indent=1)
    return tmp


def test_a_traced_run_reads_the_host_spans(root):
    res = harness.run(root, "tiny2p16", 2**33 + 3, 0.01, True, device="cpu")
    assert res["correct"], res["checks"]
    assert res["attempted"] == 1 and res["failed"] == 0
    got = {k: v["value"] for k, v in res["metrics"].items()}
    assert set(METRICS) <= set(got)
    # The guard, the two memory queries and the result, a MSM (c = 13: the
    # bucket pipeline).
    assert got["host_syncs_per_msm"] == 4
    assert got["host_issue_ms"] > 0 and got["host_wait_ms"] >= 0
    assert res["metrics"]["host_syncs_per_msm"]["unit"] == "waits/msm"


def test_the_control_is_not_correct(root):
    res = harness.run(root, "tiny2p16", 2**33 + 3, 0.2, False, device="cpu",
                      system_factory=control.ControlSystem)
    assert not res["correct"]
    assert res["checks"]["wrong_answers"]["value"] == res["attempted"] >= 1
