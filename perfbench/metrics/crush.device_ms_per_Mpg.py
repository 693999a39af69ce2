"""Device time of the CRUSH stage's kernels (the union of their
intervals inside the stage's calls, which the traced run brackets with
device syncs) per million PGs mapped."""

from perfbench.metrics._device import busy_ns


def read(run):
    spans = getattr(run, "crush_spans", None)
    if not run.on_card or not spans or not getattr(run, "pgs_mapped", 0):
        return None
    return busy_ns(run, False, spans) / 1e6 / (run.pgs_mapped / 1e6)
