"""Timing helpers of the benchmarks: host clock around a call that ends in
a synchronize of its output's device, and a result table that prints as
Markdown or CSV.  Host<->device copies are timed on their own (micro.py
data_transfer)."""

from __future__ import annotations

import csv
import io
import time
from dataclasses import dataclass, field

import torch


def _first_tensor(out):
    if isinstance(out, torch.Tensor):
        return out
    items = out.values() if isinstance(out, dict) else out if isinstance(out, (tuple, list)) else ()
    for item in items:
        t = _first_tensor(item)
        if t is not None:
            return t
    return None


def force(out):
    """Wait until `out` is computed: synchronize the device of its first
    tensor (a tensor, or nested tuples, lists and dicts of them).  CPU ops
    finish before they return.  Returns `out`."""
    t = _first_tensor(out)
    if t is not None and t.device.type == "cuda":
        torch.cuda.synchronize(t.device)
    return out


def time_device(fn, *args, runs: int = 5):
    """(first_ms, [run_ms, ...]): host ms of fn(*args) up to force(), the
    first call (which includes loading the kernel library, and building it
    on a fresh tree) and then `runs` calls 100 ms apart."""
    t0 = time.time()
    force(fn(*args))
    first_ms = (time.time() - t0) * 1e3
    ts = []
    for _ in range(runs):
        t0 = time.time()
        force(fn(*args))
        ts.append((time.time() - t0) * 1e3)
        time.sleep(0.1)
    return first_ms, ts


@dataclass
class Table:
    """A result table: Markdown for the terminal, CSV for a file."""

    headers: list[str]
    rows: list[list] = field(default_factory=list)

    def add(self, *row):
        self.rows.append(list(row))

    def markdown(self) -> str:
        out = ["| " + " | ".join(self.headers) + " |",
               "|" + "|".join("---" for _ in self.headers) + "|"]
        for r in self.rows:
            out.append("| " + " | ".join(str(c) for c in r) + " |")
        return "\n".join(out)

    def csv(self) -> str:
        buf = io.StringIO()
        w = csv.writer(buf)
        w.writerow(self.headers)
        w.writerows(self.rows)
        return buf.getvalue()

    def save_csv(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.csv())


def median(xs):
    """The upper median (the middle element of the sorted list)."""
    return sorted(xs)[len(xs) // 2]
