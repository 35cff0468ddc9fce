"""`correct` comes out false when the timed path is broken, and true when it
is not: the harness's whole run on the CPU, at a size a test can hold, with
the port's plain versions under it (or the control in its place).

The faults are those the cells can have: a step that returns its state
unchanged (each MSM answers the identity), half of the work left out (the
MSM taken over half the points), and an answer altered where it is
produced.  No cell spans chips, so none can leave out an exchange between
chips."""

from __future__ import annotations

import pytest
import torch

from msmbench import control, harness, testroot
from msmbench.entries import PortSystem


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    torch.set_num_threads(1)
    return testroot.make_root(str(tmp_path_factory.mktemp("bench")), n=64)


def _run(root, cell, factory=PortSystem, seconds=0.5, seed=2**33 + 1):
    return harness.run(root, cell, seed, seconds, False, device="cpu", system_factory=factory)


class Identity(PortSystem):
    def call(self, ids):
        super().call(ids)
        return [{"x": 0, "y": 1} for _ in ids]


class HalfThePoints(PortSystem):
    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        half = self.coords.shape[0] // 2
        self.vectors = [torch.cat([v[:half], torch.zeros_like(v[half:])]) for v in self.vectors]


class AlteredAnswer(PortSystem):
    def call(self, ids):
        out = super().call(ids)
        out[-1] = {"x": out[-1]["x"] ^ 1, "y": out[-1]["y"]}
        return out


@pytest.mark.parametrize("cell", ["tiny", "tiny4"])
def test_a_sound_run_is_correct(root, cell):
    res = _run(root, cell)
    assert res["correct"], res["checks"]
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert list(res) == ["correct", "attempted", "failed", "metrics", "device", "power", "checks"]
    assert set(res["metrics"]) == {"msm_ms", "setup_s"}     # call_p95_ms: fixed base only
    assert res["checks"]["wrong_answers"]["value"] == 0


@pytest.mark.parametrize("fault", [Identity, HalfThePoints, AlteredAnswer])
@pytest.mark.parametrize("cell", ["tiny", "tiny4"])
def test_a_broken_path_is_not_correct(root, cell, fault):
    res = _run(root, cell, fault)
    assert not res["correct"]
    assert res["checks"]["wrong_answers"]["value"] >= 1


def test_a_call_that_raises_is_missing(root):
    class Raises(PortSystem):
        warm = False

        def call(self, ids):       # the warm-up call in set-up succeeds
            if self.warm:
                raise RuntimeError("out of memory")
            self.warm = True
            return super().call(ids)

    res = _run(root, "tiny", Raises, seconds=0.05)
    assert not res["correct"] and res["failed"] == res["attempted"] >= 1
    assert res["checks"]["missing_answers"]["value"] == res["attempted"]


@pytest.mark.parametrize("cell", ["tiny", "tiny4", "tinyfb"])
def test_the_control_is_not_correct(root, cell):
    res = _run(root, cell, control.ControlSystem, seconds=0.2)
    assert not res["correct"]
    # The top window dropped changes every answer, so all of them read wrong.
    assert res["checks"]["wrong_answers"]["value"] == res["attempted"] >= 1
