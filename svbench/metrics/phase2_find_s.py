"""Candidate finding in phase 2 of the traced sample: the self time of
the ``chunk.find`` spans (``candidates/svfinder`` and the multi-junction
grouping), summed over the phase-2 workers, in s (``svbench/
spans.py``)."""

from svbench import spans


def read(run):
    got = spans.self_s(spans.processes(spans.records(run)), "chunk.find")
    return None if got is None else got[0]
