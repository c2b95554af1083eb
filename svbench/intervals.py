"""Device time on the host's wall clock: the union of the workers'
device events and the idle gaps between them, cut and named by the
workflow phase the host was in."""

from __future__ import annotations


def merged(events) -> list[tuple[float, float]]:
    """The union of [name, start ns, duration ns] events as disjoint
    (start s, end s) intervals, in order."""
    spans = sorted((t / 1e9, (t + d) / 1e9) for _n, t, d in events)
    out: list[list[float]] = []
    for a, b in spans:
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def union_s(events) -> float:
    """Seconds in which some device event ran."""
    return sum(b - a for a, b in merged(events))


def phase_at(t: float, phases: dict) -> str:
    """The workflow phase at wall time ``t`` (``logs.phases`` marks)."""
    if phases.get("start") is None or t < phases["start"]:
        return "workflow start-up"
    if phases.get("phase2_start") is None or t < phases["phase2_start"]:
        return "phases 0-1: statistics and graph build"
    if phases.get("phase2_end") is None or t < phases["phase2_end"]:
        return "phase 2: candidates, assembly and scoring"
    return "final VCF sort and index"


def idle_gaps(events, start_s: float, end_s: float,
              phases: dict) -> list[tuple[str, float]]:
    """The gaps between device events over [start_s, end_s], cut at the
    workflow's phase marks, each piece named by its phase; longest
    first."""
    gaps = []
    at = start_s
    for a, b in merged(events):
        if a > at:
            gaps.append((at, a))
        at = max(at, b)
    if end_s > at:
        gaps.append((at, end_s))
    cuts = sorted(t for k in ("start", "phase2_start", "phase2_end")
                  if (t := phases.get(k)) is not None)
    named = []
    for a, b in gaps:
        edges = [a] + [c for c in cuts if a < c < b] + [b]
        named += [(phase_at((x + y) / 2, phases), y - x)
                  for x, y in zip(edges, edges[1:])]
    return sorted(named, key=lambda g: -g[1])
