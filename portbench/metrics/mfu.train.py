"""mfu.train (%): model flops of the valid tokens (forward and backward,
``counts.train_flops``) of the untraced window's steps over its seconds,
over the peak of the configuration's precision (``counts.PEAK_FLOPS``)."""


def read(record):
    w = record.get("window", {})
    if not w.get("flops") or not w.get("seconds"):
        return None
    return 100.0 * w["flops"] / w["seconds"] / w["peak_flops"]
