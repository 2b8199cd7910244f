"""Device time per traced step (ms) outside the two CUDA kernels: every
device operation of the traced window (the epoch-end evaluation and the
metric fetches included) less what the gather and push entries
launched, over the window's steps."""


def read(ctx):
    t = ctx.get("trace")
    steps = ctx["traced"]["steps"]
    if t is None or steps <= 0 or set(t["entry_s"]) != {"gather", "push"}:
        return None
    return 1e3 * (t["device_s"] - sum(t["entry_s"].values())) / steps
