"""What the benchmark reads of a workflow run's own text: the phase stamps
of ``workspace/workflow_log.txt`` and the exit lines its processes print
on stderr. Frozen copies of the parsing in the port's
``tools/bench_wgs_at_scale.py`` (``log_phases``) and
``tools/device_counts.py`` (``parse_lines``)."""

from __future__ import annotations

import datetime
import re

# the workers' exit lines: K1's contig dispatcher and K3's split router
DISPATCH_LINE = re.compile(
    r"device-dispatch pid=\d+: (\d+) calls, (\d+) jobs, .*?, (\d+) kernel "
    r"launches")
SCAN_LINE = re.compile(
    r"split-scan pid=\d+: (\d+) calls .*?, (\d+) kernel launches")
STAMP = r"\[([0-9T:.-]+)\] "


def exit_lines(text: str) -> dict:
    """The sums over the exit lines in ``text``: calls, jobs and launches
    of K1's dispatcher, calls and launches of K3's router."""
    out = {"k1_calls": 0, "k1_jobs": 0, "k1_launches": 0, "k3_calls": 0,
           "k3_launches": 0}
    for calls, jobs, k1 in DISPATCH_LINE.findall(text):
        out["k1_calls"] += int(calls)
        out["k1_jobs"] += int(jobs)
        out["k1_launches"] += int(k1)
    for calls, k3 in SCAN_LINE.findall(text):
        out["k3_calls"] += int(calls)
        out["k3_launches"] += int(k3)
    return out


def _stamp(log: str, pattern: str, last: bool = False):
    hits = re.findall(STAMP + pattern, log)
    if not hits:
        return None
    return datetime.datetime.fromisoformat(hits[-1] if last else hits[0])


def phases(log: str) -> dict:
    """Wall-clock phase marks (seconds since the epoch, local time as the
    log writes it) and spans of one workflow run: ``start`` (the first
    stamp), ``phase2_start`` ("generating and scoring SV candidates"),
    ``phase2_end`` ("processed N graph edges"), ``end`` ("workflow
    complete"); ``graph_build_s`` (phases 0 and 1) and ``phase2_s``."""
    marks = {"start": _stamp(log, r""),
             "phase2_start": _stamp(log, r"generating and scoring SV "
                                         r"candidates"),
             "phase2_end": _stamp(log, r"processed \d+ graph edges"),
             "end": _stamp(log, r"workflow complete", last=True)}
    out = {k: (v.timestamp() if v else None) for k, v in marks.items()}
    out["graph_build_s"] = (out["phase2_start"] - out["start"]
                            if out["start"] and out["phase2_start"]
                            else None)
    out["phase2_s"] = (out["phase2_end"] - out["phase2_start"]
                       if out["phase2_start"] and out["phase2_end"]
                       else None)
    return out
