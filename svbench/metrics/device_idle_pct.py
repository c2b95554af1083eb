"""Percent of a sample's wall in which the card runs nothing: 100 x (1 -
the union of every worker's device events in the traced sample over the
median wall of the window's untraced samples). The traced sample's own
wall is longer by the traces' start-up, so it is not the base."""

import statistics

from svbench.intervals import union_s


def read(run):
    armed = run.get("armed")
    if not armed:
        return None
    events = [e for w in armed["workers"] for e in (w.get("events") or [])]
    walls = [s["wall_s"] for s in run["samples"] if not s["error"]]
    if not events or not walls:
        return None
    return 100.0 * (1.0 - union_s(events) / statistics.median(walls))
