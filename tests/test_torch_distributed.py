"""The port's multi-process MSMs (parallel/distributed.py): a real
two-process torch.distributed job on the CPU over gloo (device="cpu"),
after the JAX package's tests/test_distributed.py.

Each process runs three cases, and both ranks must return the same points,
equal to a python-int bucket sum (tolerance 0):
- compute_msm_multihost over 256 points, 128 a rank, c = 8, on the kernels
  pipeline (forced; each rank pads to 4096 points), so that the window
  sums are gathered and folded;
- compute_msm_multihost over 250 points, 125 a rank, c = 4 (the small path,
  each rank padded to 128);
- compute_msm_batch_multihost over the first 64 points, c = 4, two scalar
  vectors a rank, each MSM whole on its rank.
Each rank waits at most 180 s, so that a hung job fails its tests.
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
from test_torch_pipeline import _packed, _points, _reference_msm, _scalars

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

N, SEED = 256, 80

_WORKER = r"""
import json, sys
import numpy as np
import torch
from webgpu_msm_twisted_edwards_tpu_torch.parallel import distributed as D

rank, port, inputs = int(sys.argv[1]), sys.argv[2], np.load(sys.argv[3])
torch.set_num_threads(1)
D.initialize(init_method="tcp://127.0.0.1:" + port, world_size=2, rank=rank, device="cpu")
assert D.global_mesh() == [0, 1]
coords, sc = inputs["coords"], inputs["sc"]

def show(tag, res):
    res = res if isinstance(res, list) else [res]
    print(tag + " " + json.dumps([[str(r["x"]), str(r["y"])] for r in res]), flush=True)

lo = 128 * rank
show("RESULT1", D.compute_msm_multihost(coords[lo:lo + 128], sc[lo:lo + 128], chunk_size=8,
                                        pipeline="kernels", device="cpu"))
lo = 125 * rank
show("RESULT2", D.compute_msm_multihost(coords[lo:lo + 125], sc[lo:lo + 125], chunk_size=4,
                                        device="cpu"))
mine = [sc[64 * (2 * rank + i):64 * (2 * rank + i + 1)] for i in range(2)]
show("RESULT3", D.compute_msm_batch_multihost(coords[:64], mine, chunk_size=4, device="cpu"))
torch.distributed.destroy_process_group()
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def job(tmp_path_factory):
    """Both ranks' output lines by tag; a rank that fails or runs past its
    timeout fails every test of the module."""
    tmp = tmp_path_factory.mktemp("dist")
    worker, inputs = tmp / "worker.py", tmp / "inputs.npz"
    worker.write_text(_WORKER)
    coords, sc = _packed(_points(N, SEED), _scalars(N, SEED))
    np.savez(inputs, coords=coords, sc=sc)
    port = str(_free_port())
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([REPO, env.get("PYTHONPATH", "")])
    env["GLOO_SOCKET_IFNAME"] = "lo"          # the loopback, whatever the hostname resolves to
    procs = [subprocess.Popen([sys.executable, str(worker), str(r), port, str(inputs)],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, env=env, cwd=REPO, text=True)
             for r in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=180)[0])
    finally:
        for p in procs:
            p.kill()
            p.wait()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-3000:]
    tags = {}
    for out in outs:
        for line in out.splitlines():
            if line.startswith("RESULT"):
                tag, payload = line.split(" ", 1)
                tags.setdefault(tag, []).append(
                    [(int(x), int(y)) for x, y in json.loads(payload)])
    return tags


def test_point_axis_kernels_pipeline(job):
    got = job["RESULT1"]
    assert len(got) == 2 and got[0] == got[1]
    assert got[0] == [_reference_msm(_points(N, SEED), _scalars(N, SEED))]


def test_point_axis_padded_shards(job):
    got = job["RESULT2"]
    assert len(got) == 2 and got[0] == got[1]
    assert got[0] == [_reference_msm(_points(N, SEED)[:250], _scalars(N, SEED)[:250])]


def test_batch_axis(job):
    got = job["RESULT3"]
    points, scalars = _points(N, SEED)[:64], _scalars(N, SEED)
    assert len(got) == 2 and all(len(g) == 2 for g in got)
    for i, res in enumerate(got[0] + got[1]):
        assert res == _reference_msm(points, scalars[64 * i:64 * (i + 1)]), f"batch MSM {i}"
