"""rows_per_slot: mean decode-ready rows (``slot_log["active"]``) over the
window's slots (the scheduler's batch)."""


def read(rec):
    rows = [s["active"] for s in rec["slots"]]
    return sum(rows) / len(rows) if rows else None
