"""Readings that set the limits of ``correct``, on the card.

    python3 h100bench/calibrate.py --workload <cell> --seconds <s> \
        --seeds <n> [<n> ...] [--control 1]

Runs the cell once per seed in one process (weights, engine and window
anew for each; the kernels built once) and prints one JSON line per seed:
the program's numbers compared (``checks``) and its verdict
(``correct``), with ``--control 1`` the control's readings of the same
numbers (the reference in float8 e4m3 put in the program's place, read at
the same positions) and the verdict that the harness's comparison gives
them (``control_correct``, which has to be false), and the end-to-end
metrics.  The host runs as in ``run.py`` (:func:`host.one_thread`).  The
benchmark's own runs never run the control.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control", type=int, choices=(0, 1), default=1)
    args = ap.parse_args(argv)

    from h100bench import host
    host.one_thread()
    import torch
    from h100bench import harness

    if not torch.cuda.is_available():
        harness.log("no CUDA device")
        return 2
    t = T_START
    for seed in args.seeds:
        r = harness.run_cell(args.workload, seed, args.seconds, False,
                             t_start=t, control=bool(args.control))
        program = r["program"] if args.control else r["checks"]
        print(json.dumps({
            "seed": seed,
            "checks": {k: v["value"] for k, v in program.items()},
            "correct": r["program_correct"] if args.control
            else r["correct"],
            "control": ({k: v["value"] for k, v in r["checks"].items()}
                        if args.control else None),
            "control_correct": r["correct"] if args.control else None,
            "metrics": {k: v["value"] for k, v in r["metrics"].items()},
            "memory_peak_bytes": r["device"]["memory_peak_bytes"]}),
            flush=True)
        del r
        torch.cuda.empty_cache()
        t = None
    return 0


if __name__ == "__main__":
    sys.exit(main())
