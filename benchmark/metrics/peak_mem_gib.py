"""The card's peak allocated memory over the window (GiB):
``torch.cuda.max_memory_allocated()`` after ``reset_peak_memory_stats()``
at the window's start."""


def read(ctx):
    peak = ctx["window"].peak_bytes
    return peak / 2 ** 30 if peak > 0 else None
