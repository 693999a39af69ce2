"""Failure shrinking — ddmin over the schedule's event list (the
delta-debugging minimizer QuickCheck/hypothesis apply to inputs,
applied to fault schedules).

A violating run hands us (events, run_fn) where ``run_fn(subset) ->
bool`` replays the SAME seed/workload under only ``subset`` of the
events and reports whether the violation still reproduces.  Because
every run is a pure function of (schedule subset, seed) and the
executor's epilogue makes any subset convergent, subsets are safe to
probe in any order.  Classic ddmin: try dropping large chunks first,
re-granulate on failure, stop when no single-chunk removal
reproduces — the result is 1-minimal (removing any one remaining
chunk of the final granularity loses the bug).

``write_repro`` emits the standalone artifact (``repro_<seed>.json``)
plus a ``build_process_report``-style summary so a violation reads
like any other crash in the fleet's telemetry.
"""

from __future__ import annotations

import json
import pathlib


def shrink_events(
    events: list,
    run_fn,
    perf=None,
    max_runs: int = 64,
):
    """ddmin: minimize ``events`` while ``run_fn(subset)`` stays
    True.  Returns (minimal_events, runs_used).  ``run_fn`` is only
    trusted, never inspected; a False on the full list returns it
    unshrunk (nothing to minimize against).  ``perf`` counts probes
    on ``l_thrash_shrink_steps``."""
    runs = 0

    def probe(subset) -> bool:
        nonlocal runs
        runs += 1
        if perf is not None:
            perf.inc("l_thrash_shrink_steps")
        return bool(run_fn(subset))

    current = list(events)
    if not current:
        return current, runs
    n = 2  # granularity: number of chunks
    while len(current) >= 2 and runs < max_runs:
        chunk = max(1, len(current) // n)
        reduced = False
        for start in range(0, len(current), chunk):
            if runs >= max_runs:
                break
            subset = current[:start] + current[start + chunk:]
            if not subset:
                continue
            if probe(subset):
                current = subset
                n = max(2, n - 1)
                reduced = True
                break
        if not reduced:
            if n >= len(current):
                break
            n = min(len(current), n * 2)
    # final pass: try every single-event removal once (1-minimality
    # at event granularity, bounded by max_runs)
    i = 0
    while i < len(current) and len(current) > 1 and runs < max_runs:
        subset = current[:i] + current[i + 1:]
        if probe(subset):
            current = subset
        else:
            i += 1
    return current, runs


def build_thrash_report(
    seed: int,
    violations: list,
    original_events: int,
    minimal_events: int,
    shrink_runs: int,
) -> dict:
    """The build_process_report-shaped summary: a thrash violation
    surfaces through the same telemetry vocabulary as a daemon
    death."""
    kinds = sorted({v["kind"] for v in violations})
    return {
        "role": "qa.thrasher",
        "reason": "ConsistencyViolation: " + ", ".join(kinds),
        "meta": {
            "seed": seed,
            "violations": len(violations),
            "schedule_events": original_events,
            "minimal_events": minimal_events,
            "shrink_runs": shrink_runs,
        },
    }


def write_repro(
    directory,
    schedule,
    minimal_events: list,
    violations: list,
    shrink_runs: int,
    mutation: str | None = None,
) -> pathlib.Path:
    """Emit ``repro_<seed>.json``: everything a later session needs
    to replay the violation — the full schedule, the minimal subset,
    the violations it produced, the mutation (if the run was a
    deliberate oracle proof), and the report summary."""
    directory = pathlib.Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    vio = [
        v.to_dict() if hasattr(v, "to_dict") else dict(v)
        for v in violations
    ]
    doc = {
        "schedule": schedule.to_dict(),
        "minimal_schedule": schedule.subset(
            minimal_events
        ).to_dict(),
        "violations": vio,
        "mutation": mutation,
        "report": build_thrash_report(
            schedule.seed,
            vio,
            len(schedule.events),
            len(minimal_events),
            shrink_runs,
        ),
    }
    path = directory / f"repro_{schedule.seed}.json"
    tmp = path.with_suffix(".tmp")
    tmp.write_text(
        json.dumps(doc, sort_keys=True, separators=(",", ":"))
    )
    tmp.replace(path)
    return path


def load_repro(path) -> dict:
    return json.loads(pathlib.Path(path).read_text())
