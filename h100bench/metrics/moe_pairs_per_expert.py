"""moe_pairs_per_expert: the mean over the profiled slots'
``ops.moe_experts`` calls of the routed (token, choice) pairs per expert
the call touches, from the captured expert ids: the batch each expert's
weights are read for."""

from h100bench import moe_work

CAPTURE = ("repro_torch.kernels.ops", "moe_experts")


def read(rec):
    p = rec["profile"]
    r = p and p["ranges"].get(CAPTURE[1])
    if not r or not r["calls"]:
        return None
    return (sum(moe_work.pairs_per_expert(a) for a in r["calls"])
            / len(r["calls"]))
