"""Run one cell of the H100 benchmark of the PyTorch port.

    python3 h100bench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Prints the set-up's parts, the window and the check on standard error
(the numbers compared, each with its limit, last) and one JSON result as
the last line of standard output.  Exits non-zero, printing no result,
without enough CUDA devices for the cell or if a JAX module was loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from h100bench import host
    host.one_thread()
    import torch
    from h100bench import harness

    spec = harness.load_cell(args.workload)
    chips = int(spec["cell"]["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        harness.log(f"{args.workload} needs {chips} CUDA device(s); "
                    f"found {torch.cuda.device_count()}: no result")
        return 2
    result = harness.run_cell(args.workload, args.seed, args.seconds,
                              bool(args.trace), t_start=T_START)
    # the window has closed: nothing of JAX may have been loaded
    bad = harness.forbidden_modules()
    if bad:
        harness.log("forbidden modules loaded: " + ", ".join(bad))
        return 3
    harness.log(f"run {time.perf_counter() - T_START:.1f} s")
    for name, c in result["checks"].items():
        harness.log(f"check {name} {c['value']!r} limit {c['limit']!r}")
    print(harness.result_line(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
