"""mla_device_ms.serve (ms): device ms a call under the port's ``mla.*``
spans (the latent attention at prefill and at the decode steps, their
projections included) in the profiled calls, from the trace merged with
the spans (``spans.merge``); None where the slice has no such span or its
clock check failed."""


def read(record):
    t = record.get("trace") or {}
    dev = (t.get("spans") or {}).get("device_ms") or {}
    names = [n for n in dev if n.startswith("mla.")]
    return sum(dev[n] for n in names) if names else None
