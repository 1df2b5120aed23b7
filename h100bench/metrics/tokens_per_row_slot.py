"""tokens_per_row_slot: tokens committed over (active rows x slots) in the
window: 1 plus the accepted drafts per row and slot."""


def read(rec):
    rows = sum(s["active"] for s in rec["slots"])
    return sum(s["tokens"] for s in rec["slots"]) / rows if rows else None
