"""The split router's host time a call in the traced sample: the self
time of the ``k3.route`` spans (``scoring/device_scan``: staging, the
launch through ``align/cuda_splitscore``, the copy back), without the
``cuda.context`` and ``trace.start`` spans of a worker's first call,
over their count, in ms (``svbench/spans.py``)."""

from svbench import spans


def read(run):
    got = spans.self_s(spans.processes(spans.records(run)), "k3.route")
    return None if got is None else 1e3 * got[0] / got[1]
