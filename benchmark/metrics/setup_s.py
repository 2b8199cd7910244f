"""Set-up seconds: from the process's start to the window's start (rows
generated and written, the learner and its table built on the card,
epoch 0 streamed and staged, epoch 1 replayed with its first steps
followed)."""


def read(ctx):
    return ctx["setup_s"]
