"""The control of `correct`: the reference put in the program's place with
one guarantee broken, which the check has to find.

Each configuration states that every scalar in [0, r) counts in full.  The
control computes each MSM by the reference with every scalar cut below
2^(c*(W-1)): the top window dropped, the step that would tempt a faster
program (the top window of a 251-bit scalar holds only 11 bits).

    python3 -m msmbench.control --workload <name> --seeds <a> <b> <c> --seconds <s>

runs the harness with the control for each seed at the cell's own size (the
inputs on the card when there is one) and prints one JSON line a seed with
the numbers compared.  The benchmark's own runs never run it.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

from . import reference
from .harness import run


def drop_top_window(scalars: np.ndarray, keep_bits: int) -> np.ndarray:
    """[n, 8] uint32 scalar words cut below 2^keep_bits."""
    out = scalars.copy()
    top, rest = divmod(keep_bits, 32)
    out[:, top + (rest > 0):] = 0
    if rest:
        out[:, top] &= np.uint32((1 << rest) - 1)
    return out


class ControlSystem:
    """The reference in the program's place, on the top window's loss."""

    def __init__(self, config, traffic, coords, vectors, device, host_inputs=None):
        self.inp = host_inputs
        self.keep_bits = int(config["window_bits"]) * (int(config["windows"]) - 1)
        self.answers: dict[int, dict] = {}

    def load_kernels(self) -> float:
        return 0.0

    def setup(self) -> dict:
        return {}

    def call(self, ids):
        for i in ids:
            if i not in self.answers:
                cut = drop_top_window(self.inp.vectors[i], self.keep_bits)
                x, y = reference.expected(cut, self.inp.alpha, self.inp.beta)
                self.answers[i] = {"x": x, "y": y}
        return [self.answers[i] for i in ids]

    def close(self) -> None:
        self.inp = None


def main() -> int:
    ap = argparse.ArgumentParser(prog="msmbench.control", description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--device", default=None, help="default: cuda when there is a card")
    args = ap.parse_args()
    import torch

    device = args.device or ("cuda" if torch.cuda.is_available() else "cpu")
    for seed in args.seeds:
        res = run(os.getcwd(), args.workload, seed, args.seconds, False, device=device,
                  system_factory=ControlSystem)
        print(json.dumps({"workload": args.workload, "seed": seed, "correct": res["correct"],
                          "checks": res["checks"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
