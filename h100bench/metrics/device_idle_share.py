"""device_idle_share: 1 - (the device's busy seconds a slot / the
window's seconds a slot), in %.  The busy time is the union of the
device's activity over the traced run's idle slots, profiled for the
device alone, so that the host runs them as in the window; the slot's
seconds are the window's own (``slot_ms``), which no profiler slows."""


def read(rec):
    p, n = rec["idle"], len(rec["slots"])
    if not p or not n or p["busy_s"] <= 0 or not p["slots"]:
        return None
    return 100.0 * (1.0 - (p["busy_s"] / p["slots"]) / (rec["window_s"] / n))
