"""For the CPU tests: a copy of the benchmark's data files in a temporary
root, with small configurations and cells added to it."""

from __future__ import annotations

import json
import os
import shutil

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)


def make_root(tmp: str, n: int = 64) -> str:
    """A root holding BENCHMARK.json and msmbench/{traffic,metrics,configs}
    as committed, plus configurations tiny (n points, one-shot) and tinyfb
    (fixed base) and the cells tiny, tiny4 (batches of 4) and tinyfb."""
    for sub in ("traffic", "metrics", "configs"):
        shutil.copytree(os.path.join(HERE, sub), os.path.join(tmp, "msmbench", sub))
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        bench = json.load(f)
    with open(os.path.join(HERE, "configs", "zprize23-oneshot-2p20.json")) as f:
        base = json.load(f)
    for name, fixed in (("tiny", False), ("tinyfb", True)):
        conf = {**base, "name": name, "n": n, "fixed_base": fixed}
        rel = f"msmbench/configs/{name}.json"
        with open(os.path.join(tmp, rel), "w") as f:
            json.dump(conf, f)
        bench["configs"].append({"name": name, "source": "test", "file": rel,
                                 "reduced": ["n"], "why": "a CPU test"})
    for name, conf, mix in (("tiny", "tiny", "closed-single-v4"),
                            ("tiny4", "tiny", "closed-batch4-v4"),
                            ("tinyfb", "tinyfb", "closed-single-v4")):
        bench["workloads"].append({"name": name, "config": conf, "traffic": mix, "chips": 1,
                                   "why": "a CPU test"})
    for m in bench["per_layer"]:
        if "workloads" in m:
            m["workloads"] += ["tiny", "tiny4", "tinyfb"]
    with open(os.path.join(tmp, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f, indent=1)
    return tmp
