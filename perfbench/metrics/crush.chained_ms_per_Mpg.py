"""Device time of the chained choose steps (the union of every device
interval inside the ``crush_step`` spans that ran over a previous
step's output, which the traced run brackets with device syncs) per
million PGs mapped."""

from perfbench.metrics._spans import busy_ns


def read(run):
    spans = [(lo, hi) for lo, hi, chained in getattr(run, "step_spans", None) or () if chained]
    if not run.on_card or not spans or not getattr(run, "pgs_mapped", 0):
        return None
    return busy_ns(run, spans) / 1e6 / (run.pgs_mapped / 1e6)
