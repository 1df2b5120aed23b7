"""A kernel's share of its roofline in the profiled slots: the least time
of its calls (from each call's shapes) over the device time inside the
harness's range around its entry point."""

from h100bench import work

WORK = {"verify": work.verify_work, "decode": work.decode_work}


def share(rec, attr, kind):
    p = rec["profile"]
    r = p and p["ranges"].get(attr)
    if not r or not r["calls"] or r["device_s"] <= 0:
        return None
    least_ms = sum(work.bound(*WORK[kind](a), a["q"].dtype)[0]
                   for a in r["calls"])
    return 100.0 * least_ms / 1e3 / r["device_s"]
