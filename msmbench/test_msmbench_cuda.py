"""A short run of each cell on the card, as the benchmark's command runs it.
Skips without a CUDA card (decided in the fixture, not at import)."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest

from msmbench import testroot

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.parametrize("cell,traced", [("oneshot-2p20", 0), ("fixedbase-2p20", 1),
                                         ("oneshot-2p20-batch4", 0)])
def test_a_short_run_prints_the_contract_line(card, cell, traced):
    out = subprocess.run([sys.executable, "-m", "msmbench", "--workload", cell, "--seed",
                          str(2**32 + 11), "--seconds", "3", "--trace", str(traced)],
                         cwd=testroot.REPO, capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-4000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["failed"] == 0, res["checks"]
    assert list(res)[-1] == "checks"
    assert res["device"]["platform"] == "gpu" and res["device"]["count"] == 1
    if traced:
        assert res["device"]["busy_s"] > 0 and "breakdown" in res
        assert "accum_roofline_pct" in res["metrics"]
        assert 0 < res["metrics"]["accum_roofline_pct"]["value"] <= 100
    else:
        assert set(res["metrics"]) >= {"msm_ms", "setup_s"}
