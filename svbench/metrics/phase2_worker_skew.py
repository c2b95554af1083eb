"""How far the slowest phase-2 worker holds phase 2 up in the traced
sample: its ``worker`` span over the median worker's, each less its
trace's own start and stop (``trace.start``, ``trace.stop``), as a
ratio (``svbench/spans.py``)."""

import statistics

from svbench import spans


def read(run):
    walls = [spans.worker_s(p["spans"])
             for p in spans.processes(spans.records(run)).values()
             if p["role"] == "phase2"]
    walls = [w for w in walls if w is not None]
    if not walls or statistics.median(walls) <= 0:
        return None
    return max(walls) / statistics.median(walls)
