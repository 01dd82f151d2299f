"""attn_roofline.train (%): the summed bound of the profiled steps'
attention calls (``counts.bound_s`` over ``counts.train_attention_calls``)
over the summed device time of the attention kernels' launches in them,
matched by name: the port's flat, span and short flash kernels."""
import re

KERNELS = re.compile(r"\b(flash|small)_[a-z0-9_]*kernel")


def read(record):
    t = record.get("trace")
    if not t or not t.get("attn_bound_s"):
        return None
    spent = sum(dur for name, _, dur in t["kernels"] if KERNELS.search(name))
    if spent <= 0:
        return None
    return 100.0 * t["attn_bound_s"] / spent
