"""verify_ms_per_slot: time in ``SpinEngine._verify`` (the LLM's packed
verify, the greedy accept, the rollback and every SSM's catch-up; the
harness's span, synchronized) per slot of the traced run's span slots,
which follow its window, in ms."""


def read(rec):
    n = rec["span_slots"]
    if not n or not rec["spans"]:
        return None
    return rec["spans"]["verify"][0] / n * 1e3
