"""Phase 2 (candidates, assembly, scoring in the forked edge-bin workers:
``candidates/``, ``assembly/``, ``scoring/``, ``parallel/forkpool``):
"generating and scoring SV candidates" to "processed N graph edges" in
the workflow log, median over the window's untraced samples."""

import statistics


def read(run):
    vals = [s["phases"].get("phase2_s") for s in run["samples"]]
    vals = [v for v in vals if v is not None]
    return statistics.median(vals) if vals else None
