"""Assembly in phase 2 of the traced sample: the self time of the
``chunk.assemble`` spans (``prepare_candidates``: the breakend
assembler, ``assembly/``, with the contigs' alignment deferred), summed
over the phase-2 workers, in s (``svbench/spans.py``)."""

from svbench import spans


def read(run):
    got = spans.self_s(spans.processes(spans.records(run)),
                       "chunk.assemble")
    return None if got is None else got[0]
