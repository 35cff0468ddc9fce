"""The port's batch of MSMs over one point set (compute_msm_batch,
msm_window_sums_batch) on the CPU, on the kernels' plain versions."""

import pytest
import torch
from test_torch_pipeline import _packed, _points, _reference_msm, _scalars

from webgpu_msm_twisted_edwards_tpu_torch import compute_msm_batch
from webgpu_msm_twisted_edwards_tpu_torch.ops import msm_pipeline as MP
from webgpu_msm_twisted_edwards_tpu_torch.utils.interop import from_numpy_u32
from webgpu_msm_twisted_edwards_tpu_torch.utils.params import SUBGROUP_ORDER, MsmConfig

CFG = MsmConfig(chunk_size=8)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain versions are many small tensor ops; with several test
    workers sharing the cores, torch's intra-op threads would mostly wait
    on each other."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_compute_msm_batch_bucket_pipeline():
    """k = 3 at n = 512, c = 8 (padded to 4096 once): random scalars, all
    zero, and all at or above the subgroup order (reduced by the one guard);
    each result is the python-int sum."""
    points = _points(512, 31)
    vectors = [_scalars(512, 31), [0] * 512, [s + SUBGROUP_ORDER for s in _scalars(512, 32)]]
    vectors[2][0] = SUBGROUP_ORDER
    vectors[2][1] = (1 << 256) - 1
    got = compute_msm_batch(points, vectors, chunk_size=8, device="cpu")
    assert got[1] == {"x": 0, "y": 1}
    for res, scalars in zip(got, vectors):
        assert (res["x"], res["y"]) == _reference_msm(points, scalars)


def _spy_tables(monkeypatch) -> list:
    calls = []
    stage = MP._stage_table
    monkeypatch.setattr(MP, "_stage_table", lambda coords: (calls.append(coords.shape[0]),
                                                            stage(coords))[1])
    return calls


@pytest.mark.parametrize("block", [64, 0])
def test_batch_builds_the_table_once_per_point_block(monkeypatch, block):
    """n = 128, k = 2: with block = 64 two point blocks, each table built
    once for both MSMs; with block = 0 one table.  Each MSM's window sums
    equal msm_window_sums_blocked's, bit for bit."""
    points = _points(128, 33)
    vectors = [_scalars(128, 33), _scalars(128, 34)]
    coords = from_numpy_u32(_packed(points, vectors[0])[0])
    scs = [from_numpy_u32(_packed(points, v)[1]) for v in vectors]
    calls = _spy_tables(monkeypatch)
    sums = MP.msm_window_sums_batch(coords, scs, CFG, block=block)
    assert calls == ([64, 64] if block else [128])
    for sc, rows in zip(scs, sums):
        assert torch.equal(rows, MP.msm_window_sums_blocked(coords, sc, CFG, block=block))


def test_compute_msm_batch_rejects_mismatched_vectors():
    with pytest.raises(ValueError, match="scalar vectors"):
        compute_msm_batch(_points(8, 35), [[1] * 8, [1] * 7], device="cpu")
    assert compute_msm_batch(_points(8, 35), [], device="cpu") == []
