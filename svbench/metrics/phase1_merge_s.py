"""Phase 1 after its fan-out in the traced sample: the workflow
process's ``phase1.merge``, ``phase1.finalize``, ``phase1.save`` and
``phase1.load`` spans (the native merge of the segments' graphs, its
finalize and save, and the graph's load for phase 2: ``graph/
native_set``, ``graph/locusgraph``), in s (``svbench/spans.py``)."""

from svbench import spans

NAMES = ("phase1.merge", "phase1.finalize", "phase1.save", "phase1.load")


def read(run):
    return spans.workflow_s(spans.processes(spans.records(run)), NAMES)
