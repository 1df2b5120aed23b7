"""Per-device flops, bytes and collective bytes of one dry-run cell, each
attributed to the innermost frame of the port's model code (file:function
and the aten op; an op the autograd engine runs in a backward is
attributed to the step that called it), on the fake 512-rank group:

    python3 tools/dryrun_attrib.py <src root> <arch> <shape> [--multi-pod]
        [--detail]

``<src root>`` is the ``src`` directory of the tree to count (this one,
or a parent unpacked beside it), so two trees compare line by line.
``--detail`` keys each line by file:line, the op and the local shapes of
its tensor arguments, and attributes an op of the backward to the
forward line whose autograd node runs it (``bwd <line> <node>``; anomaly
mode keeps the forward's stack: slower), which finds the op a layout
runs at full size.  Prints one line ``ATTRIB {json}``: the totals and
the twelve (``--detail``: thirty) largest lines of each count."""
import collections
import json
import sys
import traceback

sys.path.insert(0, sys.argv[1])
import torch  # noqa: E402

from repro_torch.launch import dryrun as D  # noqa: E402

COUNTS = ("flops", "bytes", "coll")
DETAIL = "--detail" in sys.argv


def _frame(frames, detail):
    f = frames[-1]
    path = f.filename.split("repro_torch/")[-1]
    return f"{path}:{f.lineno}" if detail else f"{path}:{f.name}"


def _node_line():
    """``bwd <forward line> <node>`` of the autograd node running now."""
    node = torch._C._current_autograd_node()
    if node is None:
        return None
    stack = node.metadata.get("traceback_") or []
    files = [line for line in "".join(stack).splitlines()
             if "repro_torch" in line and "File" in line
             and "dryrun" not in line]
    if not files:
        return f"bwd ? {node.name()}"
    last = files[-1].strip()
    path = last.split('"')[1].split("repro_torch/")[-1]
    lineno = last.split("line ")[1].split(",")[0]
    return f"bwd {path}:{lineno} {node.name()}"


def where(func, args) -> str:
    op = func._overloadpacket.__name__
    if DETAIL:
        shapes = ",".join("x".join(map(str, a.shape)) for a in args
                          if isinstance(a, torch.Tensor))
        op = f"{op} [{shapes}]"
        line = _node_line()
        if line:
            return f"{line} {op}"
    frames = [f for f in traceback.extract_stack()
              if "repro_torch" in f.filename
              and "dryrun" not in f.filename]
    if not frames:
        return "? " + op
    return f"{_frame(frames, DETAIL)} {op}"


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
                line = line or where(func, args)
                by[k][line] += a - b
        return out

    D.DeviceCounter.__torch_dispatch__ = attributed
    if DETAIL:
        torch.autograd.set_detect_anomaly(True, check_nan=False)
    with D.fake_world():
        rec = D.run_cell(arch, shape, multi_pod=multi_pod, roofline=False)
    print("ATTRIB", json.dumps({
        "cell": [arch, shape, multi_pod], "status": rec["status"],
        "torch": torch.__version__,
        "total": {"flops": rec.get("flops"), "bytes": rec.get("bytes"),
                  "coll": rec.get("collective_bytes")},
        **{k: by[k].most_common(30 if DETAIL else 12) for k in COUNTS}}))


if __name__ == "__main__":
    main()
