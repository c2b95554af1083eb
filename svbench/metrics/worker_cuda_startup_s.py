"""Host seconds a phase-2 worker's first CUDA call takes, which makes its
CUDA context: the median over the traced sample's workers
(``cuda_startup_s`` of ``parallel/worker_trace``)."""

import statistics


def read(run):
    armed = run.get("armed")
    if not armed:
        return None
    vals = [w["cuda_startup_s"] for w in armed["workers"]
            if w.get("cuda_startup_s") is not None]
    return statistics.median(vals) if vals else None
