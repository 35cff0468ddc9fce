"""The port's benchmarks package on the CPU (device="cpu": the kernels'
plain versions): the table and median helpers, the CLI's subcommands
against the JAX package's (scaling's run on the CPU is in
test_torch_sharded.py), the fixture-first inputs, the regression gate
and its merged curve, one full.run on a 512-point fixture, and the
registry's MSMs at 512 points.  Results are exact (tolerance 0).
"""

import contextlib
import io
import os
import random

import numpy as np
import pytest
import torch

from webgpu_msm_twisted_edwards_tpu.benchmarks import __main__ as jax_cli
from webgpu_msm_twisted_edwards_tpu_torch.benchmarks import __main__ as cli
from webgpu_msm_twisted_edwards_tpu_torch.benchmarks import full
from webgpu_msm_twisted_edwards_tpu_torch.benchmarks.timing import Table, median
from webgpu_msm_twisted_edwards_tpu_torch.cpu.curve import GENERATOR, ExtPoint
from webgpu_msm_twisted_edwards_tpu_torch.cpu.mirrors import cuzk_serial_msm
from webgpu_msm_twisted_edwards_tpu_torch.models.baselines import ALL_MSM_FUNCTIONS
from webgpu_msm_twisted_edwards_tpu_torch.utils import oracle, test_data
from webgpu_msm_twisted_edwards_tpu_torch.utils.params import SUBGROUP_ORDER, MsmConfig

POWER = 9


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain versions run many small tensor ops; with several test
    workers sharing the cores, torch's intra-op threads would mostly wait on
    each other."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def case():
    """2^9 distinct subgroup points (an additive walk), scalars below 2^250
    as bench.py draws them, and their MSM by the python mirror."""
    r = random.Random(2023)
    pt = GENERATOR.mul(r.randrange(1, SUBGROUP_ORDER))
    step = GENERATOR.mul(r.randrange(1, SUBGROUP_ORDER))
    points = []
    for _ in range(1 << POWER):
        points.append(pt.to_affine())
        pt = pt.add(step)
    rng = np.random.default_rng(42)
    words = rng.integers(0, 1 << 62, size=(1 << POWER, 4), dtype=np.uint64)
    words[:, 3] &= (1 << 58) - 1
    scalars = [int(a) | int(b) << 64 | int(c) << 128 | int(d) << 192 for a, b, c, d in words]
    ext = [ExtPoint.from_affine(x, y) for x, y in points]
    expected = cuzk_serial_msm(ext, scalars, MsmConfig(chunk_size=8)).to_affine()
    return points, scalars, expected


@pytest.fixture
def fixture_dir(tmp_path, case):
    """The case as a fixture in the demox-labs format, with its answer in
    the sidecar file."""
    points, scalars, expected = case
    test_data.save_test_case(points, scalars, POWER, str(tmp_path))
    with open(os.path.join(tmp_path, f"{POWER}-power-expected.txt"), "w") as f:
        f.write(f"{expected[0]} {expected[1]}\n")
    return str(tmp_path)


def test_table_markdown_csv_and_median(tmp_path):
    t = Table(["n", "ms"])
    t.add("2^16", 5.25)
    t.add("2^20", [1, 2])
    assert t.markdown() == "| n | ms |\n|---|---|\n| 2^16 | 5.25 |\n| 2^20 | [1, 2] |"
    assert t.csv().splitlines() == ["n,ms", "2^16,5.25", '2^20,"[1, 2]"']
    path = tmp_path / "t.csv"
    t.save_csv(str(path))
    with open(path, newline="") as f:
        assert f.read() == t.csv()
    assert median([3.0, 1.0, 2.0]) == 2.0
    assert median([4.0, 1.0, 3.0, 2.0]) == 3.0


def _subcommands(main) -> set[str]:
    out = io.StringIO()
    with contextlib.redirect_stdout(out), pytest.raises(SystemExit):
        main(["--help"])
    choices = out.getvalue().split("{", 1)[1].split("}", 1)[0]
    return set(choices.split(","))


def test_cli_lists_every_jax_subcommand_but_scaling():
    """Every JAX subcommand, scaling too (the name is from before the
    scaling benchmark was ported)."""
    jax_cmds = _subcommands(jax_cli.main)
    assert "scaling" in jax_cmds and "dashboard" in jax_cmds
    assert _subcommands(cli.main) == jax_cmds
    args = cli.parser().parse_args(["scaling", "--power", "20", "--mode", "batch"])
    assert (args.power, args.mode, args.device) == (20, "batch", None)
    args = cli.parser().parse_args(["full", "--powers", "16", "20", "--device", "cpu"])
    assert (args.powers, args.device) == ([16, 20], "cpu")


def test_inputs_prefer_the_fixture(fixture_dir, case, monkeypatch):
    def no_oracle(*a):
        raise AssertionError("the fixture must be read, not generated inputs")

    monkeypatch.setattr(full, "_generated_inputs", no_oracle)
    coords, scalars, expected, src = full._inputs_for_power(POWER, base_dir=fixture_dir)
    points, want_scalars, want = case
    assert src == "fixture" and expected == want
    assert coords.shape == (1 << POWER, 2, 8) and coords.dtype == np.uint32
    x = sum(int(w) << (32 * i) for i, w in enumerate(coords[5, 0]))
    y = sum(int(w) << (32 * i) for i, w in enumerate(coords[5, 1]))
    assert (x, y) == points[5]
    assert sum(int(w) << (32 * i) for i, w in enumerate(scalars[7])) == want_scalars[7]


def test_regression_gate_and_merged_curve(tmp_path):
    path = str(tmp_path / "curve.json")
    assert full.check_regressions({16: 10.0}, "H100", path) == []     # nothing recorded
    full.save_curve_baseline({16: 5.0, 20: 17.0}, "H100", path)
    full.save_curve_baseline({20: 16.0}, "H100", path)                 # merged, not replaced
    assert full.load_curve_baseline(path) == {"device_kind": "H100",
                                              "curve": {"16": 5.0, "20": 16.0}}
    warn = full.check_regressions({16: 5.2, 20: 16.4}, "H100", path)
    assert len(warn) == 1 and warn[0].startswith("REGRESSION 2^16: 5.2 ms vs recorded 5.0")
    assert full.check_regressions({16: 50.0}, "cpu", path) == []       # another device kind
    full.save_curve_baseline({18: 9.0}, "cpu", path)                   # another kind: replaced
    assert full.load_curve_baseline(path)["curve"] == {"18": 9.0}


def test_full_run_on_a_fixture_is_correct(fixture_dir, tmp_path, monkeypatch):
    monkeypatch.setattr(full, "_CURVE_BASELINE", str(tmp_path / "none.json"))
    table = full.run(powers=(POWER,), runs=1, base_dir=fixture_dir, device="cpu")
    (row,) = table.rows
    assert row[0] == f"2^{POWER}" and row[1] == "fixture" and row[-1] == full.OK
    assert len(row[4]) == 1 and row[3] == row[4][0]


REGISTRY_CPU = [name for name in ALL_MSM_FUNCTIONS
                if "naive" not in name and "precomputed" not in name]


@pytest.mark.parametrize("name", REGISTRY_CPU)
def test_registry_entries_agree_on_the_cpu(case, name):
    """The naive MSM is held at a small size in test_torch_variants.py; the
    fixed-base entry's precompute pads to 4096 points, minutes of plain
    versions on the CPU (the dashboard skips it there too)."""
    if "oracle" in name and not oracle.available():
        pytest.skip("cpp/liboracle.so is not built (make -C cpp)")
    points, scalars, expected = case
    res = ALL_MSM_FUNCTIONS[name](points, scalars, device="cpu")
    assert (res["x"], res["y"]) == expected


def test_entry_points_need_a_card_or_the_cpu(monkeypatch):
    from webgpu_msm_twisted_edwards_tpu_torch.benchmarks import micro

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for fn in (lambda: full.run(powers=(POWER,)), lambda: micro.device_info_table(),
               lambda: ALL_MSM_FUNCTIONS["pippenger (torch ops)"]([(0, 1)], [1]),
               lambda: cli.main(["decompose"])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            fn()
