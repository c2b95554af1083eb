"""CUDA contexts made in the traced sample: its records that carry a
``cuda_startup_s`` (``parallel/worker_trace``), the host seconds of a
process's first CUDA call, which makes its context. Eight where each of
-j 8's phase-2 workers makes its own; one where the run's device process
(``parallel/device_proc``) makes the run's only one. None where the
sample left no record."""


def read(run):
    armed = run.get("armed")
    if not armed or not armed["workers"]:
        return None
    return sum(1 for w in armed["workers"]
               if w.get("cuda_startup_s") is not None)
