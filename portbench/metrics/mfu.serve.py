"""mfu.serve (%): model flops of the untraced window's beam searches
(``counts.search_flops``: the encoder over the valid tokens, each decode
step over its live beams) over the window's seconds, over the peak of the
configuration's precision (``counts.PEAK_FLOPS``)."""


def read(record):
    w = record.get("window", {})
    if not w.get("flops") or not w.get("seconds"):
        return None
    return 100.0 * w["flops"] / w["seconds"] / w["peak_flops"]
