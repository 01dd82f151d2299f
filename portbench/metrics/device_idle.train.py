"""device_idle.train (%): the share of the profiled slice (a few steps
after the window) in which no kernel, copy or set ran on the card."""


def read(record):
    t = record.get("trace")
    if not t or not t["window_s"]:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
