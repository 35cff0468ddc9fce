"""The benchmark CLI: `python -m webgpu_msm_twisted_edwards_tpu_torch.benchmarks
<cmd> [--device cpu]`; main(argv) runs one subcommand and prints its table."""

from __future__ import annotations

import argparse
import sys

#: The micro-benchmark subcommands; scalar-mul and smtvp also take --runs,
#: smtvp --n (their defaults take minutes on a card: dispatch-bound loops).
MICRO = ("mont", "barrett", "barrett-domb", "convert", "decompose", "data-transfer",
         "add-points", "scalar-mul", "bucket-reduction", "horners-rule", "smtvp",
         "device-info")


def parser() -> argparse.ArgumentParser:
    common = argparse.ArgumentParser(add_help=False)
    common.add_argument("--device", default=None,
                        help="torch device (default: the CUDA card; 'cpu' runs the "
                             "kernels' plain versions)")
    ap = argparse.ArgumentParser(prog="webgpu_msm_twisted_edwards_tpu_torch.benchmarks")
    sub = ap.add_subparsers(dest="cmd", required=True)

    def add(name, help):
        return sub.add_parser(name, help=help, parents=[common])

    p_full = add("full", "end-to-end MSM latency over powers")
    p_full.add_argument("--powers", type=int, nargs="+", default=[16, 17, 18, 19, 20])
    p_full.add_argument("--runs", type=int, default=5)
    p_full.add_argument("--csv", type=str, default=None)
    p_full.add_argument("--save-baseline", action="store_true",
                        help="merge this run's steady medians into this device's "
                             "recorded curve, the reference of later runs")

    p_dash = add("dashboard", "race every MSM implementation at one size")
    p_dash.add_argument("--power", type=int, default=16)
    p_dash.add_argument("--runs", type=int, default=1,
                        help="steady runs a row after its first run (0: none)")

    p_batch = add("batch", "batch MSM (one point set, k scalar vectors) against one-shot")
    p_batch.add_argument("--power", type=int, default=18)
    p_batch.add_argument("--k", type=int, default=4)
    p_batch.add_argument("--precompute", action="store_true",
                         help="also run the fixed-base mode (merged single-window table)")
    p_batch.add_argument("--pre-chunk", type=int, default=None,
                         help="its window size c (default: fixed_base_config)")
    p_batch.add_argument("--resident", action="store_true",
                         help="stage the inputs on the device first (time the engine, "
                              "not the host copies)")

    p_sweep = add("sweep", "window-size (chunk_size) sweep of the bucket pipeline")
    p_sweep.add_argument("--powers", type=int, nargs="+", default=[18, 19, 20])
    p_sweep.add_argument("--chunks", type=int, nargs="+", default=[13, 14, 15, 16])
    p_sweep.add_argument("--runs", type=int, default=3)

    p_scale = add("scaling", "MSM time against the number of cards in the mesh")
    p_scale.add_argument("--power", type=int, default=18)
    p_scale.add_argument("--mode", choices=("points", "batch"), default="points",
                         help="split one MSM's points (latency) or a batch of MSMs over "
                              "one point set (throughput) over the cards")

    p_trace = add("trace", "write a torch.profiler trace of one MSM")
    p_trace.add_argument("--power", type=int, default=16)
    p_trace.add_argument("--log-dir", type=str, default=None,
                         help="directory of the trace (default: trace/ at the repository root)")

    p_stages = add("stages", "micro-benchmark: the bucket-sum stage's parts")
    p_stages.add_argument("--power", type=int, default=20)

    for name in MICRO:
        p = add(name, f"micro-benchmark: {name}")
        if name in ("scalar-mul", "smtvp"):
            p.add_argument("--runs", type=int, default=3)
        if name == "smtvp":
            p.add_argument("--n", type=int, default=1 << 12)
    return ap


def main(argv=None) -> int:
    args = parser().parse_args(argv)
    from . import full, micro

    dev = args.device
    if args.cmd == "full":
        table = full.run(powers=tuple(args.powers), runs=args.runs, csv_path=args.csv,
                         save_baseline=args.save_baseline, device=dev)
    elif args.cmd == "batch":
        table = full.run_batch(power=args.power, k=args.k, resident=args.resident,
                               precompute=args.precompute, pre_chunk=args.pre_chunk,
                               device=dev)
    elif args.cmd == "sweep":
        table = full.sweep(powers=tuple(args.powers), chunks=tuple(args.chunks),
                           runs=args.runs, device=dev)
    elif args.cmd == "dashboard":
        table = micro.dashboard(power=args.power, runs=args.runs, device=dev)
    elif args.cmd == "scaling":
        from . import scaling

        table = scaling.run(log2n=args.power, mode=args.mode, device=dev)
    elif args.cmd == "trace":
        table = micro.trace(power=args.power, device=dev,
                            **({"log_dir": args.log_dir} if args.log_dir else {}))
    elif args.cmd == "stages":
        table = micro.stages(power=args.power, device=dev)
    elif args.cmd == "device-info":
        table = micro.device_info_table(device=dev)
    elif args.cmd == "smtvp":
        table = micro.smtvp(n=args.n, runs=args.runs, device=dev)
    elif args.cmd == "scalar-mul":
        table = micro.scalar_mul(runs=args.runs, device=dev)
    else:
        fn = {
            "mont": micro.mont_mul,
            "barrett": micro.barrett_mul,
            "barrett-domb": micro.barrett_domb_mul,
            "convert": micro.convert_inputs,
            "decompose": micro.decompose_scalars,
            "data-transfer": micro.data_transfer,
            "add-points": micro.add_points,
            "bucket-reduction": micro.bucket_reduction,
            "horners-rule": micro.horners_rule,
        }[args.cmd]
        table = fn(device=dev)
    print()
    print(table.markdown())
    return 0


if __name__ == "__main__":
    sys.exit(main())
