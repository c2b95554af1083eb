"""Phase 1's fan-out in the traced sample: the workflow process's
``phase1.segments`` span, from the first segment worker's fork to the
last segment's result (``scan/scanner``, ``graph/finder`` in the
workers), in s (``svbench/spans.py``)."""

from svbench import spans


def read(run):
    return spans.workflow_s(spans.processes(spans.records(run)),
                            ("phase1.segments",))
