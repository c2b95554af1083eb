"""The arithmetic of the program's own spans (``manta_tpu_torch.parallel.
worker_trace``) in the traced sample's records: which process recorded
what, each span's self time, the metrics' sums, and the idle gaps cut
and named by the spans open in them.

A span is [name, start ns, end ns, index of its parent in the same
process or None, attributes]. A record carries its own process's spans
and, as ``forked_from``, those of the process it was forked from as they
stood at the fork. A span's self time is its duration less the part of
it that its child spans cover."""

from __future__ import annotations

import bisect
from collections import Counter

from svbench import intervals

# fan-out spans: a workflow process in one of them only waits
FAN_OUT = ("phase1.segments", "phase2")
TRACE = ("trace.start", "trace.stop")


def records(run: dict) -> list[dict]:
    """The traced sample's records (the phase-2 workers' files), or []."""
    armed = run.get("armed")
    return list(armed["workers"]) if armed else []


def processes(recs: list[dict]) -> dict[int, dict]:
    """Each process of the records, by pid: {"role", "spans"}. A
    record's own spans stand for its process; a process known only as
    the one the others were forked from is taken from the fullest of
    their copies. Records without spans (a program before spans) give
    nothing."""
    out: dict[int, dict] = {}
    copies: dict[int, dict] = {}
    for r in recs:
        if r.get("spans") is None:
            continue
        out[r["pid"]] = {"role": r.get("role"), "spans": r["spans"]}
        parent = r.get("forked_from")
        if parent and len(parent["spans"]) > len(
                copies.get(parent["pid"], {"spans": ()})["spans"]):
            copies[parent["pid"]] = parent
    for pid, parent in copies.items():
        out.setdefault(pid, {"role": parent["role"],
                             "spans": parent["spans"]})
    return out


def _union_ns(pieces) -> int:
    total, end = 0, None
    for a, b in sorted(pieces):
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


def self_ns(spans: list) -> list[int | None]:
    """Each span's self time in ns (None for one left open): its
    duration less the union of its closed children, clipped to it."""
    children: dict[int, list] = {}
    for s in spans:
        if s[3] is not None and s[2] is not None:
            children.setdefault(s[3], []).append((s[1], s[2]))
    out = []
    for i, s in enumerate(spans):
        if s[2] is None:
            out.append(None)
            continue
        inner = [(max(a, s[1]), min(b, s[2]))
                 for a, b in children.get(i, ())
                 if min(b, s[2]) > max(a, s[1])]
        out.append(s[2] - s[1] - _union_ns(inner))
    return out


def self_s(procs: dict, name: str) -> tuple[float, int] | None:
    """The self time of every closed span ``name`` summed over the
    processes, in s, and their count; None where there is none."""
    total, n = 0, 0
    for p in procs.values():
        for s, own in zip(p["spans"], self_ns(p["spans"])):
            if s[0] == name and own is not None:
                total += own
                n += 1
    return (total / 1e9, n) if n else None


def workflow_s(procs: dict, names) -> float | None:
    """The summed durations of the workflow process's closed spans
    ``names``; None where it recorded none of them."""
    got = [s[2] - s[1] for p in procs.values() if p["role"] == "workflow"
           for s in p["spans"] if s[0] in names and s[2] is not None]
    return sum(got) / 1e9 if got else None


def _inside(spans: list, i: int) -> list[int]:
    """The indices of the spans under span ``i`` (its descendants)."""
    under, out = {i}, []
    for j, s in enumerate(spans):
        if s[3] in under:
            under.add(j)
            out.append(j)
    return out


def worker_s(spans: list) -> float | None:
    """A phase-2 worker's ``worker`` span in s less the trace's own
    start and stop inside it."""
    i = next((j for j, s in enumerate(spans)
              if s[0] == "worker" and s[2] is not None), None)
    if i is None:
        return None
    w = spans[i]
    trace = sum(spans[j][2] - spans[j][1] for j in _inside(spans, i)
                if spans[j][0] in TRACE and spans[j][2] is not None)
    return (w[2] - w[1] - trace) / 1e9


def worker_coverage(spans: list) -> float | None:
    """The share of a phase-2 worker's ``worker`` span that its stage
    spans (``worker.setup``, ``chunk.*``, ``worker.write``) and the
    device's own (``cuda.context``, ``trace.*``) cover."""
    i = next((j for j, s in enumerate(spans)
              if s[0] == "worker" and s[2] is not None), None)
    if i is None:
        return None
    w = spans[i]
    kinds = ("worker.setup", "worker.write", "cuda.context") + TRACE
    pieces = [(max(spans[j][1], w[1]), min(spans[j][2], w[2]))
              for j in _inside(spans, i) if spans[j][2] is not None
              and (spans[j][0] in kinds
                   or spans[j][0].startswith("chunk."))]
    return _union_ns([p for p in pieces if p[1] > p[0]]) / (w[2] - w[1])


def seam_coverage(record: dict, slack_ns: int = 100_000) -> tuple[int, int]:
    """(K1 and K3 kernel events of a phase-2 worker that begin inside one
    of its ``k1.dispatch`` or ``k3.route`` spans, give or take
    ``slack_ns``; all its K1 and K3 kernel events): whether the device
    events and the spans share a clock."""
    seams = sorted((s[1] - slack_ns, s[2] + slack_ns)
                   for s in record.get("spans") or ()
                   if s[0] in ("k1.dispatch", "k3.route")
                   and s[2] is not None)
    starts = [a for a, _b in seams]
    inside = total = 0
    for name, t, _d in record.get("events") or ():
        if "jump_systolic_kernel" not in name and \
                "split_score_kernel" not in name:
            continue
        total += 1
        k = bisect.bisect_right(starts, t) - 1
        inside += int(k >= 0 and seams[k][1] >= t)
    return inside, total


# ------------------------------------------------------------ idle gaps

def _labels(procs: dict) -> list[tuple[float, str | None]]:
    """(from s, label) steps: the innermost span open in the most
    processes from that moment to the next step (ties: the first by
    name; a workflow process whose innermost span is a fan-out span, or
    no process, gives no vote: None)."""
    edges = []
    for pid, p in procs.items():
        for i, s in enumerate(p["spans"]):
            if s[1] is None:
                continue
            end = s[2] if s[2] is not None else float("inf")
            edges.append((s[1], 1, pid, i))
            edges.append((end, 0, pid, i))
    edges.sort(key=lambda e: (e[0], e[1]))
    open_: dict[int, list[int]] = {pid: [] for pid in procs}
    out: list[tuple[float, str | None]] = []
    k = 0
    while k < len(edges):
        t = edges[k][0]
        while k < len(edges) and edges[k][0] == t:
            _t, kind, pid, i = edges[k]
            if kind:
                open_[pid].append(i)
            elif i in open_[pid]:
                open_[pid].remove(i)
            k += 1
        votes: Counter = Counter()
        for pid, stack in open_.items():
            if not stack:
                continue
            spans = procs[pid]["spans"]
            inner = spans[max(stack, key=lambda j: spans[j][1])][0]
            if procs[pid]["role"] == "workflow" and inner in FAN_OUT:
                continue
            votes[inner] += 1
        label = (min(n for n, c in votes.items()
                     if c == max(votes.values())) if votes else None)
        if t != float("inf"):
            out.append((t / 1e9, label))
    return out


def idle_gaps(events, start_s: float, end_s: float, phases: dict,
              procs: dict) -> list[tuple[str, float]]:
    """``intervals.idle_gaps`` with each piece cut further at the spans'
    boundaries and named "<phase> / <span>" by the innermost span open
    in the most processes (the phase alone where none votes); adjacent
    pieces of one name within a gap are one piece. Longest first."""
    if not procs:
        return intervals.idle_gaps(events, start_s, end_s, phases)
    gaps = []
    at = start_s
    for a, b in intervals.merged(events):
        if a > at:
            gaps.append((at, a))
        at = max(at, b)
    if end_s > at:
        gaps.append((at, end_s))
    steps = _labels(procs)
    times = [t for t, _l in steps]
    cuts = sorted(t for key in ("start", "phase2_start", "phase2_end")
                  if (t := phases.get(key)) is not None)
    named = []
    for a, b in gaps:
        edges = sorted({a, b, *[c for c in cuts if a < c < b],
                        *times[bisect.bisect_right(times, a):
                               bisect.bisect_left(times, b)]})
        pieces: list[list] = []
        for x, y in zip(edges, edges[1:]):
            mid = (x + y) / 2
            k = bisect.bisect_right(times, mid) - 1
            label = steps[k][1] if k >= 0 else None
            phase = intervals.phase_at(mid, phases)
            name = phase if label is None else f"{phase} / {label}"
            if pieces and pieces[-1][0] == name:
                pieces[-1][1] += y - x
            else:
                pieces.append([name, y - x])
        named += [(n, d) for n, d in pieces]
    return sorted(named, key=lambda g: -g[1])


def breakdown(armed: dict, recs: list[dict] | None = None) -> dict:
    """``svbench/run.py``'s ``breakdown`` of the traced sample with its
    idle gaps named by span (``idle_gaps``); ``recs``: the records that
    vote (by default the sample's phase-2 workers, their copies of the
    workflow process's spans included). Where no record has spans it
    returns what ``run.breakdown`` returns."""
    events = [e for w in armed["workers"] for e in (w.get("events") or [])]
    by_name: dict[str, float] = {}
    for name, _t, d in events:
        by_name[name] = by_name.get(name, 0.0) + d / 1e9
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    procs = processes(armed["workers"] if recs is None else recs)
    gaps = idle_gaps(events, armed["start_s"], armed["end_s"],
                     armed["phases"], procs)
    return {"device_ops": [[k, v] for k, v in ops],
            "idle_gaps": [[k, v] for k, v in gaps[:10]]}
