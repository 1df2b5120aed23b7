"""The dry-run's records as PERF.md's table, and the checks the records
must pass.

    python3 tools/dryrun_table.py results/torch_dryrun.json [more.json ...]

Reads the records ``python -m repro_torch.launch.dryrun ... --json`` wrote
(several files are merged, later ones replacing a cell of earlier ones)
and prints, per (arch, shape): the 16x16 cell's per-device TFLOP, GB
moved, GB of collectives and GB peak live; its least time (``roofline``)
and what bounds it; the useful share of its flops; and the 2x16x16 cell's
flops, moved and argument bytes over the 16x16 cell's.  A cell whose counts
come from the sequence fit (``counted_seqs`` in its record) is marked
"fitted", and a fitted count below zero is printed as "flagged", not as a
number.  Then the status counts, the flagged cells and counts, the cells
whose 2x16x16 flops or argument bytes exceed 1.05x the 16x16 cell's, and
the sum of the cells' seconds.  Exits non-zero if a cell failed or a
ratio exceeds 1.05.  Needs no torch.
"""

import json
import sys

LIMIT = 1.05


def load(paths):
    cells = {}
    for path in paths:
        with open(path) as f:
            for rec in json.load(f):
                cells[(rec["arch"], rec["shape"], rec["multi_pod"])] = rec
    return cells


COUNTS = ("flops", "bytes", "collective_bytes")


def flagged(rec):
    """The counts of a fitted record that the fit took below zero."""
    if rec.get("status") != "ok" or "counted_seqs" not in rec:
        return []
    return [k for k in COUNTS if rec[k] < 0]


def main(argv):
    cells = load(argv)
    status, flags = {}, []
    for (arch, shape, mp), rec in sorted(cells.items()):
        status[rec["status"]] = status.get(rec["status"], 0) + 1
        for k in flagged(rec):
            flags.append(f"{arch} {shape} {'2x16x16' if mp else '16x16'}: "
                         f"{k} {rec[k]:.4g}")
    over, seconds = [], 0.0
    print("| cell | 16x16: TFLOP / GB moved / GB collectives / GB peak | "
          "bound by, ms | useful | 2x16x16 / 16x16: flops, moved, "
          "argument bytes |")
    print("|---|---|---|---|---|")
    for (arch, shape, mp), rec in sorted(cells.items()):
        seconds += rec.get("compile_s", 0.0)
        if mp:
            continue
        if rec["status"] != "ok":
            print(f"| {arch} {shape} | {rec['status']} | | | |")
            continue
        big = cells.get((arch, shape, True))
        ratio = ""
        if big is not None and big["status"] == "ok":
            r = (big["flops"] / rec["flops"], big["bytes"] / rec["bytes"],
                 big["memory"]["argument_bytes"]
                 / rec["memory"]["argument_bytes"])
            bad = set(flagged(big)) | set(flagged(rec))
            names = ("flops", "bytes", "argument_bytes")
            ratio = " / ".join("flagged" if k in bad else f"{x:.3f}"
                               for k, x in zip(names, r))
            if r[0] > LIMIT or r[2] > LIMIT:
                over.append((arch, shape, r))
        elif big is not None:
            ratio = big["status"]
        bad = flagged(rec)
        shown = ["flagged" if k in bad else f"{rec[k] / scale:.4g}"
                 for k, scale in zip(COUNTS, (1e12, 1e9, 1e9))]
        fitted = " (fitted)" if "counted_seqs" in rec else ""
        roof = rec.get("roofline", {})
        t = max(roof.get("t_compute_s", 0.0), roof.get("t_memory_s", 0.0),
                roof.get("t_collective_s", 0.0))
        print(f"| {arch} {shape}{fitted} | {' / '.join(shown)} / "
              f"{rec['memory']['peak_bytes'] / 1e9:.4g} | "
              f"{roof.get('dominant', '-')} {t * 1e3:.4g} | "
              f"{rec.get('useful_flops_frac', float('nan')):.3g} | "
              f"{ratio} |")
    print(f"\n{len(cells)} cells: " + ", ".join(
        f"{n} {k}" for k, n in sorted(status.items())))
    for line in flags:
        print(f"FLAGGED {line} (a fitted count below zero)")
    print(f"cells' seconds summed: {seconds:.0f}")
    for arch, shape, r in over:
        print(f"OVER {arch} {shape}: 2x16x16 / 16x16 flops {r[0]:.3f}, "
              f"argument bytes {r[2]:.3f}")
    return 1 if over or status.get("FAILED") else 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
