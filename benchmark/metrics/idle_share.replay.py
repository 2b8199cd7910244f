"""The device's idle share of the traced window (%): one less the union
of its busy intervals over the window."""


def read(ctx):
    t = ctx.get("trace")
    if t is None or t["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
