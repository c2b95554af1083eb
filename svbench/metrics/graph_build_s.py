"""Phases 0 and 1 (fragment statistics, chromosome depth, breakend graph:
``core/fragstats``, ``scan/scanner``, ``graph/finder``,
``graph/native_set``): the workflow log's first stamp to "generating and
scoring SV candidates", median over the window's untraced samples."""

import statistics


def read(run):
    vals = [s["phases"].get("graph_build_s") for s in run["samples"]]
    vals = [v for v in vals if v is not None]
    return statistics.median(vals) if vals else None
