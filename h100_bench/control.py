"""The readings that the correctness limits are set from.

    python3 h100_bench/control.py --workload <cell> --seeds 1,2,... \
        --control-seeds 7,8,9 [--seconds 5]

on a card.  For each seed of ``--seeds``, one run of the cell as the
benchmark runs it, with a shorter window of ``--seconds`` (every batch in
it runs to its end, and the check compares as many fits as a run does),
and for each
of ``--control-seeds`` the same run with the package's own float32 path
in its place: the cell's entry fed float32 tensors, the nearest precision
below the configuration's float64.  One JSON line per run on standard
output: the seed, the dtype and every number compared.  The benchmark's
own runs never run the control.
"""
import json
import os
import sys
import time

if __package__ in (None, ""):
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))


def readings(bench, cell, seeds, dtype, seconds):
    from h100_bench import harness
    for seed in seeds:
        t0 = time.perf_counter()
        line = harness.run_cell(bench, cell, seed, seconds, False, "cuda",
                                dtype=dtype, t_start=t0)
        yield {"seed": seed, "dtype": dtype, "correct": line["correct"],
               "failed": line["failed"],
               "checks": {k: v["value"] for k, v in line["checks"].items()},
               "seconds": time.perf_counter() - t0}


def main(argv=None):
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=5.0)
    args = ap.parse_args(argv)
    import torch

    from h100_bench import harness
    if not torch.cuda.is_available():
        harness.log("no CUDA device")
        return 2
    bench = harness.Bench()

    def ints(s):
        return [int(x) for x in s.split(",") if x]

    for dtype, seeds in (("float64", ints(args.seeds)),
                         ("float32", ints(args.control_seeds))):
        for r in readings(bench, args.workload, seeds, dtype, args.seconds):
            print(json.dumps(r), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
