"""moe_device_ms.serve (ms): device ms a call under the port's ``moe.*``
spans (router and top-k, the routed experts, the shared experts) in the
profiled calls, from the trace merged with the spans (``spans.merge``);
None where the slice has no such span or its clock check failed."""


def read(record):
    t = record.get("trace") or {}
    dev = (t.get("spans") or {}).get("device_ms") or {}
    names = [n for n in dev if n.startswith("moe.")]
    return sum(dev[n] for n in names) if names else None
