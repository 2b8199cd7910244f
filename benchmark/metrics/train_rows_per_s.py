"""Rows trained per second: every row the window's replayed epochs
trained, over the window's seconds (from a synchronised device to a
synchronised device)."""


def read(ctx):
    w = ctx["window"]
    if w.seconds <= 0 or w.rows <= 0:
        return None
    return w.rows / w.seconds
