"""Run one cell of the benchmark once.

    python3 h100_bench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout, on a machine with the cell's cards.  The last
line of standard output is the result (a JSON object); the numbers the
correctness check compared, each beside its limit, are the last lines of
standard error and the result's last key.
"""
import os
import sys
import time


def _process_age():
    """Seconds since this process started (0 where /proc cannot say)."""
    try:
        with open("/proc/self/stat") as f:
            start = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return max(0.0, up - start / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


T_START = time.perf_counter() - _process_age()

_HERE = os.path.dirname(os.path.abspath(__file__))
_REPO = os.path.dirname(_HERE)
if __package__ in (None, ""):
    sys.path.insert(0, _REPO)

import argparse  # noqa: E402
import json  # noqa: E402


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def caches():
    """Every build and kernel cache inside the checkout, at fixed paths
    (the package's nvcc build is gpyrn_tpu_torch/_build/ already)."""
    base = os.path.join(_REPO, ".h100_bench_cache")
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = os.path.join(base, sub)


def main(argv=None):
    args = parse(argv)
    caches()
    import torch

    from h100_bench import harness

    torch.set_num_threads(2)
    bench = harness.Bench()
    chips = next(w["chips"] for w in bench.spec["workloads"]
                 if w["name"] == args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        harness.log(f"the cell needs {chips} CUDA device(s); "
                    f"torch.cuda.is_available() is "
                    f"{torch.cuda.is_available()}, device_count "
                    f"{torch.cuda.device_count()}")
        return 2
    line = harness.run_cell(bench, args.workload, args.seed, args.seconds,
                            bool(args.trace), "cuda", t_start=T_START)
    found = harness.forbidden_modules()
    if found:
        harness.log(f"modules the benchmark may not load are loaded: {found}")
        return 3
    for k, v in line["checks"].items():
        harness.log(f"check {k}: {v['value']!r} (limit {v['limit']!r})")
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
