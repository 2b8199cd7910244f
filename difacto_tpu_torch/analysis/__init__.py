"""The port's difacto-lint: an AST-based project analyzer over
``difacto_tpu_torch/`` (the counterpart of difacto_tpu/analysis/).

Stdlib ``ast`` only: it imports neither torch nor jax nor anything of
the JAX package, so it runs wherever the port does, the card machine
included (``chip_smoke.py`` phase 22). ``python -m
difacto_tpu_torch.analysis`` takes the JAX CLI's flags and output
formats (text, json, github, sarif; ``--changed-only``, baselines).

Layout:

- :mod:`core`        — the rule framework (a copy): findings with
  line-number-free fingerprints, ``# lint: ok(rule-id)`` suppressions,
  baselines, output formats, exit codes; the project index, whose
  corpora are the README's port section and the port's docstrings.
- :mod:`localrules`  — single-file rules: thread lifecycle, lock
  release, resource close, the monotonic clock, broad excepts (copies),
  and ``torch-inplace``, ``torch-traced-capture``, ``torch-host-call``
  (the counterparts of JAX's three tracing rules).
- :mod:`crossrules`  — the registry-drift rules (a copy).
- :mod:`callgraph`   — the project-wide call graph (a copy).
- :mod:`concurrency` — lock order, blocking under a lock, Condition
  waits (a copy); it writes ``utils/lockorder.json``'s graph.
- :mod:`races`       — Eraser-style data races (a copy).
- :mod:`torchflow`   — the traced-program model (the counterpart of
  ``jaxflow``): ``torch-recompile``, ``torch-host-sync``,
  ``torch-inplace-flow``, ``torch-dtype64``; the static half of
  utils/devtrace.py, merged by ``tools/devmap.py``.
- :mod:`shardflow`   — the sharding-flow model: ``torch-shard-replicate``,
  ``torch-shard-kernel``, ``torch-shard-break``; the static half of
  utils/collscan.py, merged by ``tools/collmap.py``.
- :mod:`cli`         — ``python -m difacto_tpu_torch.analysis``.
"""

from .core import Finding, Project, all_rules, run_project  # noqa: F401
