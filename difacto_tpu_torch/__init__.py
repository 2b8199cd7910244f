"""difacto_tpu_torch: the PyTorch + CUDA port of difacto_tpu.

The port keeps the JAX package's module layout (``updaters/sgd_updater.py``
here is the counterpart of ``difacto_tpu/updaters/sgd_updater.py``, and so
on) but imports nothing from it and nothing of jax: the host-only pieces it
needs (config, parsers, row blocks, checkpoint streams and manifests) are
kept as its own copies.

It serves (``task=pred``, ``task=serve``), trains with the SGD learner
(the fused-row gather and the FTRL/AdaGrad push as hand-written CUDA
kernels, ``ops/csrc/``) and with the batch learners, ``learner=bcd`` and
``learner=lbfgs`` (torch ops), converts and dumps. Entry points take an
explicit ``device=`` and run on ``cuda`` unless the caller asks for
``cpu``; without a visible GPU a ``cuda`` request raises instead of
falling back.
"""
