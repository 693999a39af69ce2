"""Per cent of the time inside every ``crush_step`` span (each choose
step of the rule, bracketed with device syncs in the traced run) during
which the device runs nothing: where it is high, the steps are bound by
the host's launches and waits, not by the device."""

from perfbench import stats
from perfbench.metrics._spans import busy_ns


def read(run):
    lo, hi = run.window_ns
    spans = stats.clip([(s, e) for s, e, _c in getattr(run, "step_spans", None) or ()], lo, hi)
    if not run.on_card or not spans:
        return None
    return 100.0 * (1.0 - busy_ns(run, spans) / sum(e - s for s, e in spans))
