"""python3 -m msmbench --workload <name> --seed <n> --seconds <s> --trace <0|1>

One run of one cell of BENCHMARK.json, from the root of a checkout: exits
with 1 and prints no result without a CUDA card (or with fewer cards than
the cell asks for), or if JAX or the JAX package was loaded.
"""

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(prog="msmbench", description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args()

    import torch

    from . import spec
    from .harness import forbidden_loaded, print_result, run

    root = os.getcwd()
    chips = spec.cell(root, args.workload).chips
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"msmbench: cell {args.workload} needs {chips} CUDA card(s), found {have}",
              file=sys.stderr)
        return 1
    result = run(root, args.workload, args.seed, args.seconds, bool(args.trace),
                 t_process=T_PROCESS)
    bad = forbidden_loaded()
    if bad:
        print(f"msmbench: the run loaded forbidden modules: {', '.join(bad)}", file=sys.stderr)
        return 1
    print_result(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
