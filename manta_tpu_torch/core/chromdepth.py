"""Chromosome depth estimate with the fork fan-out, without JAX.

Counterpart of ``manta_tpu/core/chromdepth.py:333-391``
(``estimate_chrom_depths``), same contract and the same fork fan-out.
That function receives its workers' results through
``manta_tpu.parallel.forkpool``, whose package ``__init__`` imports
JAX; this one uses the port's ``parallel.forkpool``. The per-chromosome
estimate itself (``read_chrom_depth``) and the depth file's reader and
writer are the JAX package's own, imported unchanged.
"""

from __future__ import annotations

from manta_tpu.core.chromdepth import (  # noqa: F401  (re-exported)
    parse_chrom_depth, read_chrom_depth, write_chrom_depth,
)
from manta_tpu.io.bam import open_alignment_reader

from ..parallel.forkpool import drain_fork_result


def estimate_chrom_depths(bam_paths: list[str],
                          reference: str | None = None,
                          n_jobs: int = 1) -> dict[str, float]:
    """Sum per-chromosome depths across BAMs
    (reference: libexec/mergeChromDepth.py). Per-(BAM, chrom) estimates
    are independent, so n_jobs > 1 fans them out over forked workers
    (reference: per-chrom-chunk GetChromDepth tasks,
    sharedWorkflow.py)."""
    jobs = []
    for path in bam_paths:
        reader = open_alignment_reader(path, reference)
        for tid, (name, size) in enumerate(zip(reader.header.ref_names,
                                               reader.header.ref_lengths)):
            jobs.append((path, tid, name, size))
    totals: dict[str, float] = {}
    if n_jobs > 1 and len(jobs) > 1:
        import multiprocessing as mp
        ctx = mp.get_context("fork")
        queue = ctx.SimpleQueue()
        readers = {p: open_alignment_reader(p, reference)
                   for p in bam_paths}

        def worker(ji, path, tid, size):
            from manta_tpu.io.bam import BamReader
            from manta_tpu.io.bgzf import set_worker_io_threads
            fanout = min(n_jobs, len(jobs))
            set_worker_io_threads(fanout)
            BamReader.set_worker_cache_budget(fanout)
            queue.put((ji, read_chrom_depth(readers[path], tid, size)))

        # in-flight scheduling: see drain_fork_result for why is_alive()
        # gating deadlocks
        results: dict[int, float] = {}
        procs: list = []
        nxt = 0
        in_flight = 0
        while len(results) < len(jobs):
            while nxt < len(jobs) and in_flight < n_jobs:
                path, tid, _name, size = jobs[nxt]
                pr = ctx.Process(target=worker,
                                 args=(nxt, path, tid, size))
                pr.start()
                procs.append(pr)
                in_flight += 1
                nxt += 1
            ji, d = drain_fork_result(queue, procs)
            in_flight -= 1
            results[ji] = d
        for pr in procs:
            pr.join()
        for ji, (path, tid, name, size) in enumerate(jobs):
            totals[name] = totals.get(name, 0.0) + results[ji]
        return totals
    readers = {p: open_alignment_reader(p, reference) for p in bam_paths}
    for (path, tid, name, size) in jobs:
        d = read_chrom_depth(readers[path], tid, size)
        totals[name] = totals.get(name, 0.0) + d
    return totals
