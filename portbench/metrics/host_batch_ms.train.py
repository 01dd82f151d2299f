"""host_batch_ms.train (ms): host milliseconds a step in sampling,
bucketing and building the batch (``sample_batch``, ``bucket_slices``,
``make_seq_batch``), timed by the harness around those calls in the window."""


def read(record):
    c = record.get("counters", {})
    if not c.get("steps"):
        return None
    return 1e3 * c["host_batch_s"] / c["steps"]
