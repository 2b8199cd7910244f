"""Command-line tools of the port, run as ``python -m
difacto_tpu_torch.tools.<name>``: ``fleet`` (rolling restarts, the
router, router groups, health and the autoscaler), ``takeover`` (one
replica's takeover) and ``loadgen`` (open-loop load generators)."""
