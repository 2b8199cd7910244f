"""Host time per replayed step (ms), from the learner's own
``train_step_seconds`` histogram over the untraced window: its sum over
its count."""


def read(ctx):
    w = ctx["window"]
    if w.dispatch_n <= 0:
        return None
    return 1e3 * w.dispatch_s / w.dispatch_n
