"""The port's multi-device layer (parallel/sharded.py) on CPU meshes: k
entries of the CPU device (device="cpu"), where every kernel runs its plain
version.  All comparisons are exact (tolerance 0: integer arithmetic).

- sharded_msm_plan against the JAX sharded_msm_plan(..., backend="tpu")
  over a grid of sizes, the pipeline names mapped ("pallas" -> "kernels",
  "xla" -> "small").
- The kernels path at 4 shards (staged; the per-window reduce folds the
  shards) and at 3 shards (shard after shard; a chain of masked adds), 64
  points a shard, c = 8, fold=True, against a python-int bucket sum; each
  shard's window sums equal in the two orders; the fold against the JAX
  reduce_rows_per_window / masked_add_rows (interpret mode) on the same
  gathered rows.
- The small path's sharded_window_sums at n = 64, c = 4, 4 shards against
  the JAX sharded_window_sums on 4 virtual CPU devices, bit for bit, and
  compute_msm_sharded on it.
- compute_msm_batch_sharded (k = 5 on 4 shards, padded to 8), the refusals,
  and the scaling benchmark on the CPU.
No test needs the native oracle, and no JAX pipeline is compiled in
interpret mode (only the masked add, which the JAX fold is made of).
"""

import jax.numpy as jnp
import jax_kernel_cache
import numpy as np
import pytest
import torch
from test_torch_pipeline import _packed, _points, _reference_msm, _scalars

from webgpu_msm_twisted_edwards_tpu.ops.pallas.bpr import (
    reduce_rows_per_window as jax_reduce_rows_per_window,
)
from webgpu_msm_twisted_edwards_tpu.ops.pallas.ec import masked_add_rows as jax_masked_add_rows
from webgpu_msm_twisted_edwards_tpu.parallel import sharded as JS
from webgpu_msm_twisted_edwards_tpu_torch import compute_msm_batch_sharded, compute_msm_sharded
from webgpu_msm_twisted_edwards_tpu_torch.benchmarks import scaling
from webgpu_msm_twisted_edwards_tpu_torch.models import cuzk
from webgpu_msm_twisted_edwards_tpu_torch.parallel import sharded
from webgpu_msm_twisted_edwards_tpu_torch.utils import oracle
from webgpu_msm_twisted_edwards_tpu_torch.utils.interop import from_numpy_u32, to_numpy_u32
from webgpu_msm_twisted_edwards_tpu_torch.utils.params import MsmConfig

CFG = MsmConfig(chunk_size=8)
PER_SHARD = 64


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


def _inputs(n: int, seed: int):
    points, scalars = _points(n, seed), _scalars(n, seed)
    coords, sc = _packed(points, scalars)
    return points, scalars, from_numpy_u32(coords), from_numpy_u32(sc)


def _affine(rows: torch.Tensor) -> tuple[int, int]:
    return cuzk.packed_rows_to_extpoints(to_numpy_u32(rows))[0].to_affine()


@pytest.mark.parametrize("chunk_size", [None, 4, 8, 13, 16])
def test_plan_matches_jax(chunk_size):
    names = {"pallas": "kernels", "xla": "small"}
    for n in (256, 1000, 1 << 12, 1 << 13, 3 << 18, 1 << 20, 1 << 21, 1 << 23):
        for ndev in (1, 2, 3, 4, 8):
            cfg, pipe = sharded.sharded_msm_plan(n, ndev, chunk_size)
            jcfg, jpipe = JS.sharded_msm_plan(n, ndev, chunk_size=chunk_size, backend="tpu")
            assert (cfg.chunk_size, cfg.num_windows, pipe) == (
                jcfg.chunk_size, jcfg.num_windows, names[jpipe]), (n, ndev)


@pytest.fixture(scope="module")
def kernel_runs():
    """The kernels path, fold=True: 4 shards staged over 256 points and 3
    shards one after another over the first 192 of them (so shards 0-2 hold
    the same points in both), each with the gathered shard rows that its
    fold was given."""
    points, scalars, coords, sc = _inputs(4 * PER_SHARD, 11)
    scalars[5] = 0                                     # a zero scalar: the sentinel bucket
    sc[5] = 0
    seen, fold = [], sharded.fold_window_sums
    sharded.fold_window_sums = lambda rows: (seen.append(rows), fold(rows))[1]
    m3 = 3 * PER_SHARD
    try:
        total = {
            4: sharded.sharded_window_sums_staged(coords, sc, sharded.default_mesh(4, "cpu"),
                                                  CFG, fold=True),
            3: sharded.sharded_window_sums_kernels(coords[:m3], sc[:m3], ["cpu"] * 3, CFG,
                                                   fold=True),
        }
    finally:
        sharded.fold_window_sums = fold
    return {"points": points, "scalars": scalars, "total": total,
            "rows": {4: seen[0], 3: seen[1]}}


@pytest.mark.parametrize("ndev", [4, 3])
def test_kernels_path_matches_reference(kernel_runs, ndev):
    m = ndev * PER_SHARD
    total = kernel_runs["total"][ndev]
    assert total.shape == (1, 64)
    assert _affine(total) == _reference_msm(kernel_runs["points"][:m], kernel_runs["scalars"][:m])


def test_staged_and_shard_by_shard_give_the_same_bits(kernel_runs):
    staged, whole = kernel_runs["rows"][4], kernel_runs["rows"][3]
    assert len(staged) == 4 and len(whole) == 3
    for a, b in zip(staged, whole):
        assert a.shape == (CFG.num_windows, 64)
        assert torch.equal(a, b)


@pytest.mark.parametrize("ndev", [4, 3])
def test_fold_matches_jax(kernel_runs, ndev):
    rows = kernel_runs["rows"][ndev]
    w = CFG.num_windows
    g = np.stack([to_numpy_u32(r) for r in rows])                    # [D, W, TW]
    if ndev == 4:
        want = jax_reduce_rows_per_window(
            jnp.asarray(np.swapaxes(g, 0, 1).reshape(w * ndev, -1)), ndev, interpret=True)
    else:
        want = jnp.asarray(g[0])
        for i in range(1, ndev):
            want = jax_masked_add_rows(want, jnp.asarray(g[i]), jnp.ones((w,), jnp.int32),
                                       interpret=True)
    np.testing.assert_array_equal(np.asarray(want), to_numpy_u32(sharded.fold_window_sums(rows)))


def test_small_path_window_sums_match_jax(monkeypatch):
    """compute_msm_sharded on the small path, 4 shards: its window sums (kept
    by a spy) against the JAX package's, and its answer."""
    points, scalars, coords, sc = _inputs(64, 12)
    seen, sums = [], sharded.sharded_window_sums

    def spy(*args, **kwargs):
        seen.append(sums(*args, **kwargs))
        return seen[-1]

    monkeypatch.setattr(sharded, "sharded_window_sums", spy)
    res = compute_msm_sharded(points, scalars, mesh=["cpu"] * 4, chunk_size=4, bpr_chunks=4)
    assert (res["x"], res["y"]) == _reference_msm(points, scalars, c=4)
    jmesh = JS.default_mesh(4)
    want = JS._jitted_sharded(jmesh, 4, 4, jmesh.axis_names[0])(
        jnp.asarray(to_numpy_u32(coords)), jnp.asarray(to_numpy_u32(sc)))
    (got,) = seen
    for name in ("x", "y", "t", "z"):
        np.testing.assert_array_equal(np.asarray(getattr(want, name)).astype(np.int64),
                                      getattr(got, name).numpy())


def test_batch_sharded_pads_the_batch(monkeypatch):
    n, k = 32, 5
    points = _points(n, 13)
    vectors = [_scalars(n, 14 + i) for i in range(k)]
    vectors[2][0] = 2 ** 255 + 7                      # above the order: reduced
    calls, sums = [], sharded.sharded_msm_batch_sums

    def spy(coords, scalars_k, *args, **kwargs):
        calls.append(len(scalars_k))
        return sums(coords, scalars_k, *args, **kwargs)

    monkeypatch.setattr(sharded, "sharded_msm_batch_sums", spy)
    got = compute_msm_batch_sharded(points, vectors, mesh=sharded.default_mesh(4, "cpu"),
                                    chunk_size=4, bpr_chunks=4)
    assert calls == [8] and len(got) == k
    for res, v in zip(got, vectors):
        assert (res["x"], res["y"]) == _reference_msm(points, v, c=4)


def test_refusals():
    coords = torch.zeros((4 * 48, 2, 8), dtype=torch.int32)
    sc = torch.zeros((4 * 48, 8), dtype=torch.int32)
    mesh = sharded.default_mesh(4, "cpu")
    for fn in (sharded.sharded_window_sums_staged, sharded.sharded_window_sums_kernels):
        with pytest.raises(ValueError, match="multiple of 64"):
            fn(coords, sc, mesh, CFG)
    with pytest.raises(ValueError, match="divisible by the mesh size"):
        compute_msm_sharded([(0, 1)] * 6, [1] * 6, mesh=mesh)
    with pytest.raises(ValueError, match="batch size 3"):
        sharded.sharded_msm_batch_rows(coords[:64], [sc[:64]] * 3, mesh[:2], CFG)
    with pytest.raises(ValueError, match="pipeline"):
        sharded.sharded_msm_plan(1 << 12, 1, pipeline="pallas")
    with pytest.raises(ValueError, match="c >= 8"):
        sharded.sharded_msm_plan(1 << 12, 1, chunk_size=4, pipeline="kernels")


def test_default_mesh(monkeypatch):
    assert sharded.default_mesh(device="cpu") == [torch.device("cpu")]
    assert sharded.default_mesh(3, device="cpu") == [torch.device("cpu")] * 3
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sharded.default_mesh()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        compute_msm_sharded([(0, 1)], [1])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert sharded.default_mesh() == [torch.device("cuda", 0), torch.device("cuda", 1)]
    with pytest.raises(ValueError, match="this machine has 2"):
        sharded.default_mesh(4)


@pytest.mark.parametrize("mode", ["points", "batch"])
def test_scaling_on_the_cpu(mode, monkeypatch, capsys):
    """The scaling benchmark at 2^6 points on the CPU: one row (the CPU is
    one device), the small path.  The native walk is replaced by a python
    one, so that the oracle library is not built."""
    def walk(n, seed=1):
        coords, _ = _packed(_points(n, seed), [0] * n)
        return np.ascontiguousarray(coords).reshape(n, 16).view(np.uint64)

    monkeypatch.setattr(oracle, "gen_points", walk)
    table = scaling.run(log2n=6, runs=1, mode=mode, device="cpu")
    assert len(table.rows) == 1 and table.rows[0][0] == 1
    assert "small" in table.rows[0]
    assert "the k = 1 row only" in capsys.readouterr().out
