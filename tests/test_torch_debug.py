"""The port's per-stage validator (ops/debug.py::validate_pipeline) on the
CPU: every stage "ok" on a correct pipeline, and the first stage that
differs named when one is corrupted; and the python mirrors it stands on
(cpu/mirrors.py, cpu/curve.py) against each other."""

import pytest
import torch
from test_torch_pipeline import _points, _scalars

from webgpu_msm_twisted_edwards_tpu_torch import validate_pipeline
from webgpu_msm_twisted_edwards_tpu_torch.cpu import mirrors as M
from webgpu_msm_twisted_edwards_tpu_torch.cpu.curve import ExtPoint, get_point_from_x, naive_msm
from webgpu_msm_twisted_edwards_tpu_torch.ops import convert as CV
from webgpu_msm_twisted_edwards_tpu_torch.ops import msm_pipeline as MP
from webgpu_msm_twisted_edwards_tpu_torch.ops.kernels.ec import identity_row
from webgpu_msm_twisted_edwards_tpu_torch.utils.params import MsmConfig

STAGES = ["decompose", "convert", "buckets (transpose+smvp)", "bpr + horner"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain versions are many small tensor ops; with several test
    workers sharing the cores, torch's intra-op threads would mostly wait
    on each other."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("n,chunk_size", [(512, 8), (512, 4), (64, 4), (64, 6)])
def test_validate_pipeline_passes(n, chunk_size):
    """c = 8 counts buckets on the histogram and, at n = 512, ends in the
    bucket pipeline; c = 4 (8 buckets) and c = 6 (32 buckets) count them by
    binary search and end in the small-input path.  At n = 512 the entries
    fill whole blocks of 128 fragments; at n = 64 (4096 and 2752 entries)
    sentinel entries pad them, so the padding, the carries and the
    extraction run on those bucket counts too."""
    status = validate_pipeline(_points(n, 41), _scalars(n, 41), chunk_size=chunk_size,
                               device="cpu")
    assert status == {stage: "ok" for stage in STAGES}


def _corrupt_digit(monkeypatch):
    decompose = CV.decompose_scalars_signed

    def corrupted(sc, cfg):
        d = decompose(sc, cfg).clone()
        d[3, 1] += 1
        return d
    monkeypatch.setattr(CV, "decompose_scalars_signed", corrupted)


def _corrupt_bucket_row(monkeypatch):
    sums = MP.window_group_bucket_sums

    def corrupted(*args, **kwargs):
        rows = sums(*args, **kwargs).clone()
        rows[3] = identity_row(rows.device)
        return rows
    monkeypatch.setattr(MP, "window_group_bucket_sums", corrupted)


@pytest.mark.parametrize("corrupt,stage", [(_corrupt_digit, "stage 1 decompose"),
                                           (_corrupt_bucket_row, "stage 2/3 bucket mismatch "
                                                                 "window 0 bucket 3")])
def test_validate_pipeline_names_the_stage_that_differs(monkeypatch, corrupt, stage):
    corrupt(monkeypatch)
    with pytest.raises(AssertionError, match=stage):
        validate_pipeline(_points(64, 42), _scalars(64, 42), chunk_size=4, device="cpu")


def test_mirrors_agree():
    """16 points, c = 4: the serial pipeline, classic Pippenger, and the
    chunked reduction of the signed buckets give the double-and-add sum;
    each chunked window sum equals the running sum's."""
    pts = [ExtPoint.from_affine(x, y) for x, y in _points(16, 43)]
    scalars = _scalars(16, 43)
    cfg = MsmConfig(chunk_size=4)
    want = naive_msm(pts, scalars).to_affine()
    assert M.cuzk_serial_msm(pts, scalars, cfg).to_affine() == want
    assert M.pippenger_msm(pts, scalars, window_bits=8).to_affine() == want
    digits = M.decompose_scalars_signed(scalars, cfg.num_windows, cfg.chunk_size)
    buckets = M.bucket_accumulation_signed(pts, digits, cfg.num_windows, cfg.chunk_size)
    sums = [M.parallel_bucket_reduction(b, num_threads=4) for b in buckets]
    assert [s.to_affine() for s in sums] == [M.running_sum_bucket_reduction(b).to_affine()
                                            for b in buckets]
    assert M.horner(sums, cfg.chunk_size).to_affine() == want
    with pytest.raises(ValueError, match="final carry"):
        M.decompose_scalars_signed([1 << 255], cfg.num_windows, cfg.chunk_size)


def test_point_from_x():
    """The subgroup point with a given x: its y of the two roots; an x off
    the curve raises."""
    x, y = _points(1, 44)[0]
    pt = get_point_from_x(x)
    pt.assert_on_curve()
    assert pt.to_affine() == (x, y)
    assert pt.add(pt.neg()).is_identity() and not pt.is_identity()
    with pytest.raises(ValueError, match="not on the curve"):
        get_point_from_x(3)
