"""Fork-worker result draining shared by the phase fan-outs.

Counterpart of ``manta_tpu/parallel/forkpool.py``, which is JAX-free
itself but sits in a package whose ``__init__`` imports JAX. Host-side
process parallelism (no JAX, no torch): used by the phase-0 stats
fan-out, the phase-1 graph fan-out and the phase-2 edge bins.
"""

from __future__ import annotations


def drain_fork_result(queue, procs):
    """queue.get() that cannot deadlock on silently-dead workers.

    Never gate scheduling on Process.is_alive(): a worker stays alive
    for a moment after queue.put(), so two back-to-back results can
    leave a stale 'running' list full and the scheduler blocking on an
    empty queue with no producers left. Callers track an in-flight
    (spawned - received) count instead and call this to receive.
    Polls the queue's read pipe so a worker that died without
    reporting raises instead of hanging the workflow forever."""
    while True:
        # SimpleQueue has no get(timeout); its _reader Connection is a
        # stable CPython internal
        if queue._reader.poll(10.0):
            return queue.get()
        bad = next((pr for pr in procs
                    if pr.exitcode not in (None, 0)), None)
        if bad is not None:
            for pr in procs:
                if pr.is_alive():
                    pr.terminate()
            raise RuntimeError(
                f"forked phase worker (pid {bad.pid}) exited with code "
                f"{bad.exitcode} without reporting a result")
        if all(pr.exitcode is not None for pr in procs):
            raise RuntimeError(
                "forked phase workers all exited but a result is "
                "missing")
