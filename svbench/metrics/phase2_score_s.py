"""Scoring in phase 2 of the traced sample: the self time of the
``chunk.score`` spans (``finish_candidates``: ``scoring/scorer`` and the
VCF writers), without the split router's ``k3.route`` spans inside
them, summed over the phase-2 workers, in s (``svbench/spans.py``)."""

from svbench import spans


def read(run):
    got = spans.self_s(spans.processes(spans.records(run)), "chunk.score")
    return None if got is None else got[0]
