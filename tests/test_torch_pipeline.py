"""The port's MSM pipeline and entry point on the CPU (plain versions of the
kernels).

- Stage by stage against the JAX package at n=64/c=8, bit for bit
  (tolerance 0: integer arithmetic).  The JAX stages run once, eagerly, with
  their Pallas kernels in interpret mode (module-scoped fixture); their
  composition is the JAX msm_window_sums for one window group.
- The skew case and compute_msm against python-int reference sums.
- The entry point's gates, the CPU device defaults, and that the package
  imports no JAX.
"""

import ast
import os
import random
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import jax_kernel_cache
import pytest
import torch

from webgpu_msm_twisted_edwards_tpu.ops import convert as JCV
from webgpu_msm_twisted_edwards_tpu.ops import msm_pipeline as JMP
from webgpu_msm_twisted_edwards_tpu.ops.pallas import bpr as JPB
from webgpu_msm_twisted_edwards_tpu_torch import compute_msm
from webgpu_msm_twisted_edwards_tpu_torch.cpu.curve import GENERATOR, ExtPoint
from webgpu_msm_twisted_edwards_tpu_torch.models.cuzk import packed_rows_to_extpoints
from webgpu_msm_twisted_edwards_tpu_torch.ops import msm_pipeline as MP
from webgpu_msm_twisted_edwards_tpu_torch.ops.convert import decompose_scalars_signed
from webgpu_msm_twisted_edwards_tpu_torch.ops.kernels.bpr import bpr, horner_fold
from webgpu_msm_twisted_edwards_tpu_torch.utils import runtime
from webgpu_msm_twisted_edwards_tpu_torch.utils.interop import from_numpy_u32, to_numpy_u32
from webgpu_msm_twisted_edwards_tpu_torch.utils.limbs import ints_to_u32_words
from webgpu_msm_twisted_edwards_tpu_torch.utils.params import SUBGROUP_ORDER, MsmConfig

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = "webgpu_msm_twisted_edwards_tpu_torch"
CFG = MsmConfig(chunk_size=8)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain versions issue many small tensor ops; with several test
    workers sharing the cores, torch's intra-op threads would mostly wait on
    each other."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True, scope="module")
def _jax_kernels_compiled_once():
    """Repeated JAX kernel calls reuse one compile (tests/jax_kernel_cache.py)."""
    with jax_kernel_cache.cached():
        yield


def _points(n: int, seed: int) -> list[tuple[int, int]]:
    """n distinct affine subgroup points: an additive walk from a random
    multiple of the generator."""
    r = random.Random(seed)
    pt = GENERATOR.mul(r.randrange(1, SUBGROUP_ORDER))
    step = GENERATOR.mul(r.randrange(1, SUBGROUP_ORDER))
    out = []
    for _ in range(n):
        out.append(pt.to_affine())
        pt = pt.add(step)
    return out


def _scalars(n: int, seed: int) -> list[int]:
    r = random.Random(seed)
    return [r.randrange(0, SUBGROUP_ORDER) for _ in range(n)]


def _packed(points, scalars) -> tuple[np.ndarray, np.ndarray]:
    coords = np.stack([ints_to_u32_words([p[0] for p in points]),
                       ints_to_u32_words([p[1] for p in points])], axis=1)
    return coords, ints_to_u32_words(scalars)


def _reference_msm(points, scalars, c: int = 8) -> tuple[int, int]:
    """sum_i k_i * P_i by a plain bucket method over python ints."""
    pts = [ExtPoint.from_affine(x, y) for x, y in points]
    ks = [k % SUBGROUP_ORDER for k in scalars]
    total = ExtPoint.identity()
    for w in reversed(range(-(-256 // c))):
        for _ in range(c):
            total = total.double()
        buckets = [ExtPoint.identity() for _ in range(1 << c)]
        for p, k in zip(pts, ks):
            d = (k >> (c * w)) & ((1 << c) - 1)
            if d:
                buckets[d] = buckets[d].add(p)
        run = acc = ExtPoint.identity()
        for b in reversed(buckets[1:]):
            run = run.add(b)
            acc = acc.add(run)
        total = total.add(acc)
    return total.to_affine()


def _affine(rows: torch.Tensor) -> tuple[int, int]:
    return packed_rows_to_extpoints(to_numpy_u32(rows))[0].to_affine()


@pytest.fixture(scope="module")
def run():
    """One eager JAX run at n=64/c=8 (a zero scalar included, so zero digits
    reach the sentinel bucket), keeping every stage's output."""
    n = 64
    points = _points(n, 7)
    scalars = _scalars(n, 7)
    scalars[3] = 0
    coords, sc = _packed(points, scalars)
    table = JMP.build_full_table(jnp.asarray(coords), interpret=True)
    digits = JCV.decompose_scalars_signed(jnp.asarray(sc), CFG)
    buckets = JMP.window_group_bucket_sums(table, digits.T, CFG.num_buckets, interpret=True)
    sums = JPB.bpr(buckets, CFG.num_windows, interpret=True)
    total = JPB.horner_fold(sums, CFG.chunk_size, interpret=True)
    out = {k: np.array(v) for k, v in (("table", table), ("digits", digits),
                                       ("buckets", buckets), ("sums", sums), ("total", total))}
    out.update(points=points, scalars=scalars, coords=coords, sc=sc)
    return out


def _eq_u32(want: np.ndarray, got: torch.Tensor) -> None:
    np.testing.assert_array_equal(to_numpy_u32(got), want)


def test_table_and_digits_match_jax(run):
    _eq_u32(run["table"], MP.build_full_table(from_numpy_u32(run["coords"])))
    digits = decompose_scalars_signed(from_numpy_u32(run["sc"]), CFG)
    np.testing.assert_array_equal(digits.numpy(), run["digits"])


def test_window_group_bucket_sums_match_jax(run):
    """The JAX table and digits in; sort, histogram, scan, carries and
    extraction must give the JAX bucket rows."""
    digits_t = torch.from_numpy(np.ascontiguousarray(run["digits"].T))
    got = MP.window_group_bucket_sums(from_numpy_u32(run["table"]), digits_t, CFG.num_buckets)
    _eq_u32(run["buckets"], got)


def test_bpr_and_fold_match_jax(run):
    sums = bpr(from_numpy_u32(run["buckets"]), CFG.num_windows)
    _eq_u32(run["sums"], sums)
    _eq_u32(run["total"], horner_fold(from_numpy_u32(run["sums"]), CFG.chunk_size))


@pytest.mark.parametrize("window_group", [0, 8])
def test_msm_window_sums_end_to_end_matches_jax(run, window_group):
    """One group of all 32 windows (the default here) or four groups of 8:
    window sums do not depend on the grouping."""
    coords, sc = from_numpy_u32(run["coords"]), from_numpy_u32(run["sc"])
    sums = MP.msm_window_sums(coords, sc, CFG, window_group=window_group)
    _eq_u32(run["sums"], sums)
    total = horner_fold(sums, CFG.chunk_size)
    _eq_u32(run["total"], total)
    assert _affine(total) == _reference_msm(run["points"], run["scalars"])


def test_blocked_pipeline_adds_point_blocks(run):
    """Two point blocks of 64: their window sums are added row by row, then
    folded."""
    points = run["points"] + _points(64, 8)
    scalars = run["scalars"] + _scalars(64, 8)
    coords, sc = _packed(points, scalars)
    total = MP.msm_window_sums_blocked(from_numpy_u32(coords), from_numpy_u32(sc), CFG,
                                       block=64, fold=True)
    assert _affine(total) == _reference_msm(points, scalars)


def test_skew_all_equal_scalars():
    """Every (window, point) entry of a window lands in one bucket, so the
    bucket runs span fragments and the carry scan stitches them."""
    n = 64
    points = _points(n, 7)
    s = 0x0123456789ABCDEF0123456789ABCDEF0123456789ABCDEF0123456789ABCD
    coords, sc = _packed(points, [s] * n)
    total = MP.msm_window_sums_staged(from_numpy_u32(coords), from_numpy_u32(sc), CFG,
                                      fold=True)
    acc = ExtPoint.identity()
    for x, y in points:
        acc = acc.add(ExtPoint.from_affine(x, y))
    assert _affine(total) == acc.mul(s).to_affine()


def test_compute_msm_4100_points_window_13():
    """n = 4100 is padded to 8192 and takes c = 13 from the sizing rule."""
    n = 4100
    points, scalars = _points(n, 11), _scalars(n, 11)
    got = compute_msm(points, scalars, device="cpu")
    assert (got["x"], got["y"]) == _reference_msm(points, scalars)


def test_compute_msm_zero_scalars_give_identity():
    points = _points(512, 12)
    assert compute_msm(points, [0] * 512, chunk_size=8, device="cpu") == {"x": 0, "y": 1}


def test_compute_msm_duplicate_points_and_oversized_scalars():
    """Each point appears twice; some scalars are >= the subgroup order (they
    are reduced mod the order) and one is 2^256 - 1."""
    points = _points(256, 13) * 2
    scalars = _scalars(512, 13)
    scalars[0] = SUBGROUP_ORDER
    scalars[1] = SUBGROUP_ORDER + 12345
    scalars[2] = (1 << 256) - 1
    scalars[300] = 2 * SUBGROUP_ORDER - 1
    got = compute_msm(points, scalars, chunk_size=8, device="cpu")
    assert (got["x"], got["y"]) == _reference_msm(points, scalars)


@pytest.mark.parametrize("n,chunk_size", [(600, None), (256, 8), (4096, 6)])
def test_compute_msm_outside_the_bucket_pipeline_raises(n, chunk_size):
    """Inputs outside the bucket pipeline (n < 512 or c < 8; below 4096
    points the sizing rule picks c = 4) take the small-input path, which
    raises nothing and gives the python-int sum.  Random scalars: the
    layered accumulation runs as many rounds as the fullest bucket has
    entries."""
    points = _points(8, 14) * (n // 8)
    scalars = _scalars(n, 14)
    got = compute_msm(points, scalars, chunk_size=chunk_size, device="cpu")
    assert (got["x"], got["y"]) == _reference_msm(points, scalars)


def test_compute_msm_without_a_card_raises(monkeypatch):
    """device=None means the CUDA card; without one it raises rather than
    running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        compute_msm(_points(8, 15), [1] * 8)


def test_cpu_device_memory_default():
    """Without a card the sizing rules see a fixed 8 GiB, as the JAX
    package's do on the CPU."""
    assert runtime.device_memory_bytes("cpu") == runtime.CPU_MEMORY_BYTES
    assert MP.default_window_group(1 << 20, 16, "cpu") == JMP.default_window_group(1 << 20, 16) == 4
    assert MP.default_block_size(1 << 22, "cpu") == JMP.default_block_size(1 << 22) == 1 << 21


def test_package_imports_no_jax():
    code = ("import importlib, pkgutil, sys\n"
            f"import {PKG} as pkg\n"
            "for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.'):\n"
            "    importlib.import_module(m.name)\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'webgpu_msm_twisted_edwards_tpu'))\n"
            "assert not bad, bad\n"
            f"assert '{PKG}.benchmarks.micro' in sys.modules\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr


def test_no_module_imports_jax_or_the_jax_package():
    """AST scan of the package's sources (not its build/ outputs) and
    chip_smoke.py.  The package's name has the JAX package's as a prefix, so
    whole root names are compared."""
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, dirs, names in os.walk(os.path.join(REPO, PKG)):
        dirs[:] = [d for d in dirs if d != "build"]
        files += [os.path.join(root, f) for f in names if f.endswith(".py")]
    banned = {"jax", "jaxlib", "webgpu_msm_twisted_edwards_tpu"}
    found = []
    for path in files:
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                roots = [a.name.split(".")[0] for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                roots = [node.module.split(".")[0]]
            else:
                continue
            found += [(path, r) for r in roots if r in banned]
    assert len(files) > 20
    # The benchmarks and the modules they race are walked too.
    walked = {os.path.relpath(f, os.path.join(REPO, PKG)) for f in files}
    assert {"benchmarks/__main__.py", "benchmarks/full.py", "benchmarks/micro.py",
            "benchmarks/timing.py", "models/baselines.py", "ops/u256.py", "ops/smtvp.py",
            "ops/scalar_mul.py", "ops/montgomery_variants.py", "ops/barrett.py",
            "ops/barrett_domb.py", "cpu/barrett_domb.py", "utils/test_data.py"} <= walked
    assert not found, found
