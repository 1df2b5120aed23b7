"""Per-device flops, bytes and collective bytes of one dry-run cell, each
attributed to the innermost frame of the port's model code (file:function
and the aten op; an op the autograd engine runs in a backward is
attributed to the step that called it), on the fake 512-rank group:

    python3 tools/dryrun_attrib.py <src root> <arch> <shape> [--multi-pod]

``<src root>`` is the ``src`` directory of the tree to count (this one,
or a parent unpacked beside it), so two trees compare line by line.
Prints one line ``ATTRIB {json}``: the totals and the twelve largest
lines of each count."""
import collections
import json
import sys
import traceback

sys.path.insert(0, sys.argv[1])
from repro_torch.launch import dryrun as D  # noqa: E402

COUNTS = ("flops", "bytes", "coll")


def where(func) -> str:
    frames = [f for f in traceback.extract_stack()
              if "repro_torch" in f.filename
              and "dryrun" not in f.filename]
    if not frames:
        return "? " + func._overloadpacket.__name__
    f = frames[-1]
    return (f"{f.filename.split('repro_torch/')[-1]}:{f.name} "
            f"{func._overloadpacket.__name__}")


def main():
    arch, shape = sys.argv[2], sys.argv[3]
    multi_pod = "--multi-pod" in sys.argv
    by = {k: collections.Counter() for k in COUNTS}
    counted = D.DeviceCounter.__torch_dispatch__

    def attributed(self, func, types, args=(), kwargs=None):
        before = (self.flops, self.bytes, sum(self.collectives.values()))
        out = counted(self, func, types, args, kwargs)
        if out is NotImplemented:
            return out
        after = (self.flops, self.bytes, sum(self.collectives.values()))
        line = None
        for k, b, a in zip(COUNTS, before, after):
            if a != b:
                line = line or where(func)
                by[k][line] += a - b
        return out

    D.DeviceCounter.__torch_dispatch__ = attributed
    with D.fake_world():
        rec = D.run_cell(arch, shape, multi_pod=multi_pod, roofline=False)
    print("ATTRIB", json.dumps({
        "cell": [arch, shape, multi_pod], "status": rec["status"],
        "total": {"flops": rec.get("flops"), "bytes": rec.get("bytes"),
                  "coll": rec.get("collective_bytes")},
        **{k: by[k].most_common(12) for k in COUNTS}}))


if __name__ == "__main__":
    main()
