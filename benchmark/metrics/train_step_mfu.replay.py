"""The whole replayed step's share of the chip's peak (%): the least time
an epoch's steps could take at the published peaks (the larger of their
float32 operations over 67 TFLOP/s and their bytes over 3.35 TB/s,
counted by the yardstick from the epoch's tokens, rows and in-bounds
distinct slots), over the untraced window's measured time per epoch."""

from benchmark import yardstick as ys


def read(ctx):
    if not ys.on_chip(ctx["device"]):
        return None
    w, calls = ctx["window"], ctx["traced"]["calls"]
    epochs = ctx["traced"]["epochs"]
    if w.epochs <= 0 or epochs <= 0 or not calls["push_real"]:
        return None
    conf = ctx["conf"]
    k = int(conf["V_dim"])
    slots = sum(calls["push_real"]) / epochs
    active = sum(calls["push_vm"]) / epochs
    tokens, rows = ctx["epoch_tokens"], ctx["epoch_rows"]
    least = ys.least_seconds(
        ys.step_flops(tokens, rows, slots, active, k),
        ys.step_bytes(tokens, rows, slots, ys.row_bytes(conf)))
    return ys.share(least, w.seconds / w.epochs, ctx["device"])
