"""padding_share.train (%): padded encoder token slots over all slots of
the batches the window fed, counted by the harness from those batches."""


def read(record):
    c = record.get("counters", {})
    if not c.get("slots"):
        return None
    return 100.0 * (1.0 - c["valid_slots"] / c["slots"])
