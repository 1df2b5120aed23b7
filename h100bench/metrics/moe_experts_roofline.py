"""moe_experts_roofline: the least time of the profiled slots'
``ops.moe_experts`` calls (``moe_work.experts_work`` and ``work.bound``
from each call's shapes and captured expert ids: the routed experts'
weights read once, bf16 tensor-core peak) over the device time inside the
harness's ``record_function`` range around that entry point, in %."""

from h100bench import moe_work, work

CAPTURE = ("repro_torch.kernels.ops", "moe_experts")


def read(rec):
    p = rec["profile"]
    r = p and p["ranges"].get(CAPTURE[1])
    if not r or not r["calls"] or r["device_s"] <= 0:
        return None
    least_ms = sum(work.bound(*moe_work.experts_work(a), a["x"].dtype)[0]
                   for a in r["calls"])
    return 100.0 * least_ms / 1e3 / r["device_s"]
