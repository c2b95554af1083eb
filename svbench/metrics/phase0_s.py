"""Phase 0 in the traced sample: the workflow process's
``phase0.fragstats`` and ``phase0.depth`` spans (fragment-size
statistics, ``core/fragstats``; chromosome depth, ``core/chromdepth``
and its forked workers), in s (``svbench/spans.py``)."""

from svbench import spans


def read(run):
    return spans.workflow_s(spans.processes(spans.records(run)),
                            ("phase0.fragstats", "phase0.depth"))
