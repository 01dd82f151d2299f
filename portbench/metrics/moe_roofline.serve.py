"""moe_roofline.serve (%): the routed experts' bound over their device
time in the profiled calls. The bound (``counts_lm.expert_bound_s``) is the
larger of 6 hidden F flops a computed pair at the bf16 peak and the
touched experts' weight bytes plus the pairs' input and output rows at the
bandwidth, from the slice's counters ``moe.pairs`` and
``moe.experts_touched``; the time is the device time under the
``moe.experts`` spans (the pairs' gather, both products, the activation
and the weighted sum)."""
from types import SimpleNamespace

from portbench import counts_lm


def read(record):
    t = record.get("trace") or {}
    c = t.get("counters") or {}
    ms = ((t.get("spans") or {}).get("device_ms") or {}).get("moe.experts")
    if not c.get("moe.pairs") or not ms:
        return None
    hidden, width = t["expert_dims"]
    bound = counts_lm.expert_bound_s(SimpleNamespace(hidden=hidden, expert_width=width),
                                     c["moe.pairs"], c["moe.experts_touched"])
    return 100.0 * bound / (1e-3 * ms * t["steps"])
