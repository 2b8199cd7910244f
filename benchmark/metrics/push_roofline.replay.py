"""The push kernel's share of its roofline, epilogue on (%): the bytes
the traced window's pushes need (each in-bounds slot's id, gathered row,
gw and mask read and its row written; gV read where the embedding is
active) over 3.35 TB/s, over the device time of what the
``fm_update_rows`` entry launched."""

from benchmark import yardstick as ys


def read(ctx):
    if not ys.on_chip(ctx["device"]):
        return None
    t = ctx.get("trace")
    if t is None or t["entry_s"].get("push", 0.0) <= 0:
        return None
    conf = ctx["conf"]
    rb, k = ys.row_bytes(conf), int(conf["V_dim"])
    calls = ctx["traced"]["calls"]
    need = sum(ys.push_bytes(n, a, k, rb)
               for n, a in zip(calls["push_real"], calls["push_vm"]))
    return ys.share(ys.least_seconds(0, need), t["entry_s"]["push"],
                    ctx["device"])
