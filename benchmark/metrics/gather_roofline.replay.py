"""The pull kernel's share of its roofline (%): the bytes the traced
window's gathers need (each in-bounds slot id read, its row read and
written) over 3.35 TB/s, over the device time of what the
``gather_rows`` entry launched."""

from benchmark import yardstick as ys


def read(ctx):
    if not ys.on_chip(ctx["device"]):
        return None
    t = ctx.get("trace")
    if t is None or t["entry_s"].get("gather", 0.0) <= 0:
        return None
    rb = ys.row_bytes(ctx["conf"])
    need = sum(ys.gather_bytes(n, rb)
               for n in ctx["traced"]["calls"]["gather_real"])
    return ys.share(ys.least_seconds(0, need), t["entry_s"]["gather"],
                    ctx["device"])
