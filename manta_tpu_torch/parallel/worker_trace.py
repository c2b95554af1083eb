"""The trace of an armed workflow run: each process's spans, and the
device events of its phase-2 workers, all on the host's wall clock.

Spans, by the process that records them (``SPANS``):

    process               spans
    ------------------    ----------------------------------------------
    workflow process      workflow; device_proc.start (the fork of
    (workflow/run.py)     the run's device process, where it has one);
                          phase0.fragstats, phase0.depth;
                          phase1.segments (the fan-out, from the first
                          fork to the last result), phase1.merge,
                          phase1.finalize, phase1.save, phase1.load;
                          phase2 (device_proc.ready, the wait for the
                          device process, before the partition, forks
                          and drain), phase2.merge_shards;
                          phase2.stats (after the phase's last log
                          stamp); device_proc.stop; final.sort_index
    phase-0 stats         phase0.bam (attributes: bam; chrom for a depth
    workers               job)
    phase-1 segment       phase1.segment (attribute: the group's regions)
    workers
    phase-2 workers       worker (attribute: bin), worker.setup; for each
                          edge of a chunk chunk.find, chunk.assemble and
                          chunk.score (attribute: samples), for the chunk
                          chunk.contig_align;
                          worker.write
    the device seams      k1.dispatch (each contig-scorer call), k3.route
                          (each split-router call; attribute: pairs);
                          cuda.context and trace.start inside the first
                          of them; trace.stop at exit
    the run's device      cuda.context at its start; trace.start when
    process               phase 2 begins; device_proc.k1, device_proc.k3
    (parallel/            (each request it serves); trace.stop at exit
    device_proc)

At -j 1 phase 2 runs in the workflow process: its stage spans nest under
``phase2``.

``arm(directory)`` before ``run_workflow`` arms the run: the process that
calls ``run_workflow`` becomes the run's workflow process, and each
phase-0, phase-1 and phase-2 worker it forks keeps a record of its own
(``enter_worker``, ``enter_phase2_worker``; the run's device process,
``enter_device_process``). A record holds
``role``, ``pid``, ``run`` (the workflow process's pid and start ns:
the identifier every process of the run shares), ``spans`` as [name,
start ns, end ns, index of the enclosing span of the same process or
None, attributes], both times from ``time.time_ns()``, and
``forked_from``: the spans of the process it was forked from as they
stood at the fork (an open span's end is None), so that any one record
places its process in the run. The workflow process writes
``directory/trace.<pid>.json`` when ``run_workflow`` returns, a phase-0
or phase-1 worker at exit; a phase-2 worker and the device process
write ``directory/device_trace.<pid>.json`` at exit, with besides:

- ``events``: its device events (kernels, copies, memsets) as [name,
  start ns, duration ns] on the same wall clock; None where it scored on
  the CPU or the run was armed with ``device=False``;
- ``counts``: its counts from the ledger (``parallel.counters``);
- ``cuda_startup_s``: the host seconds its CUDA context took to make
  (the ``cuda.context`` span);
- ``clock``: the clock the profiler's timestamps came on, and
  ``finished``: whether the worker's bin was written.

A phase-2 worker that scores in process starts its trace at its first
device call (``first_device_call``): its route (``parallel.device_proc``,
the one maker of a context outside a kernel call) makes its context,
timed, then ``start_profiler`` starts a ``torch.profiler``
window of CUDA activity only, so a worker that never reaches the device
makes no context, and the trace costs no host work a launch. A run's
device process makes the one context, at its start, and traces the card
from phase 2's start; its phase-2 workers make none.
``arm(directory, device=False)`` records the
spans only: no profiler, and no context made apart from the first
seam's call (no ``cuda.context`` or ``trace.*`` span, no
``cuda_startup_s``). Unarmed, ``span`` returns one shared no-op
object after a single test, and every other function here returns at
its first test: no clock, no record, no profiler, no file.
"""

from __future__ import annotations

import contextlib
import functools
import json
import os
import time

from . import counters
from .forkpool import at_process_exit

# the spans each process records, by its role
SPANS = {
    "workflow": ("workflow", "device_proc.start", "phase0.fragstats",
                 "phase0.depth", "phase1.segments", "phase1.merge",
                 "phase1.finalize", "phase1.save", "phase1.load", "phase2",
                 "device_proc.ready", "phase2.merge_shards", "phase2.stats",
                 "device_proc.stop", "final.sort_index"),
    "phase0": ("phase0.bam",),
    "phase1": ("phase1.segment",),
    "phase2": ("worker", "worker.setup", "chunk.find", "chunk.assemble",
               "chunk.contig_align", "chunk.score", "worker.write"),
    "device": ("k1.dispatch", "k3.route", "cuda.context", "trace.start",
               "trace.stop"),
    "device_proc": ("cuda.context", "trace.start", "device_proc.k1",
                    "device_proc.k3", "trace.stop"),
}
# the directory armed processes write into (None: unarmed), and whether
# phase-2 workers trace the device
_ARMED: dict = {"dir": None, "device": True}
# this process's record once it is part of an armed run
_REC: dict | None = None
# this process's device record once it is an armed phase-2 worker
_WORKER: dict | None = None


def arm(directory: str, device: bool = True) -> None:
    """Trace every workflow run started from now on into ``directory``;
    ``device=False``: the spans only, no profiler."""
    _ARMED["dir"] = directory
    _ARMED["device"] = device


def disarm() -> None:
    """Arm no further run; a process that armed itself as a phase-2
    worker (the timing tool's ``trace_span``) drops its record."""
    global _REC, _WORKER
    _ARMED["dir"] = None
    _REC = _WORKER = None


_NO_SPAN = contextlib.nullcontext()


class _Span:
    __slots__ = ("_rec", "_index")

    def __init__(self, rec: dict, name: str, attrs: dict):
        stack = rec["open"]
        self._rec = rec
        self._index = len(rec["spans"])
        rec["spans"].append([name, None, None, stack[-1] if stack else None,
                             attrs])

    def __enter__(self):
        self._rec["open"].append(self._index)
        self._rec["spans"][self._index][1] = time.time_ns()
        return self

    def __exit__(self, *exc):
        self._rec["spans"][self._index][2] = time.time_ns()
        self._rec["open"].remove(self._index)
        return False


def span(name: str, **attrs):
    """A context manager that records the span ``name`` in this
    process's record, under the span enclosing it; a shared no-op
    unarmed."""
    rec = _REC
    if rec is None:
        return _NO_SPAN
    return _Span(rec, name, attrs)


def _new_record(role: str, parent: dict | None) -> dict:
    """A record for this process; ``parent``: the record of the process
    it was forked from (its ``_REC`` as the fork left it), whose run it
    joins and whose spans it keeps as ``forked_from``."""
    pid = os.getpid()
    return {"role": role, "pid": pid, "dir": _ARMED["dir"],
            "run": parent["run"] if parent else [pid, time.time_ns()],
            "spans": [], "open": [], "written": False,
            "forked_from": ({"pid": parent["pid"], "role": parent["role"],
                             "spans": parent["spans"]}
                            if parent else None)}


def traced_workflow(run):
    """Decorates ``run_workflow``: armed, the process that calls it is
    the run's workflow process, records the ``workflow`` span around the
    call and writes its record when the call returns or raises."""
    @functools.wraps(run)
    def wrapper(*args, **kwargs):
        global _REC
        if _ARMED["dir"] is None:
            return run(*args, **kwargs)
        outer = _REC
        _REC = rec = _new_record("workflow", None)
        try:
            with span("workflow"):
                return run(*args, **kwargs)
        finally:
            _REC = outer
            _write_record(rec, f"trace.{rec['pid']}.json")
    return wrapper


def enter_worker(role: str) -> None:
    """Called first in a forked phase-0 or phase-1 worker: armed, this
    process keeps a record and writes it at exit."""
    global _REC
    if _ARMED["dir"] is None:
        return
    _REC = rec = _new_record(role, _REC)
    at_process_exit(lambda: _write_record(rec, f"trace.{rec['pid']}.json"))


def enter_phase2_worker(bin_index: int) -> None:
    """Called first in a phase-2 worker: armed, this process keeps a
    record, opens its ``worker`` span (closed at exit, after the trace
    stops) and writes its record at exit."""
    if _ARMED["dir"] is not None:
        _enter_device_record("phase2", bin_index)


def enter_device_process() -> bool:
    """Called first in the run's device process (``parallel.
    device_proc``): armed, this process keeps a record (role
    ``device_proc``) and writes ``device_trace.<pid>.json`` at exit.
    Returns whether it traces the card (armed with the profiler): then
    it times its context as a phase-2 worker does (``context_made``)
    and its profiler waits for ``start_profiler``."""
    return _ARMED["dir"] is not None and \
        _enter_device_record("device_proc", None)["device"]


def _enter_device_record(role: str, bin_index: int | None) -> dict:
    global _REC, _WORKER
    _REC = _new_record(role, _REC)
    worker = None
    if bin_index is not None:
        worker = span("worker", bin=bin_index)
        worker.__enter__()
    # "finished": the counts when the bin was written, else None
    _WORKER = {"bin": bin_index, "finished": None, "cuda_startup_s": None,
               "device": _ARMED["device"], "profiler": None,
               "touched": False, "span": worker}
    at_process_exit(_write)
    return _WORKER


def first_device_call() -> bool:
    """Called by the in-process route before each call: marks an armed
    phase-2 worker as one that scored. True at the first call of a
    worker armed with the profiler: its route then makes its context,
    timed, and starts the trace. Armed with the spans only, the first
    seam's call makes the context, as unarmed (made on its own, it cost
    phase 2 ~0.5 s on the card, PERF.md)."""
    w = _WORKER
    if w is None or w["touched"]:
        return False
    w["touched"] = True
    return w["device"]


def context_made(seconds: float) -> None:
    """The host seconds this process took to make its CUDA context
    (``cuda_startup_s``)."""
    if _WORKER is not None:
        _WORKER["cuda_startup_s"] = seconds


def start_profiler() -> None:
    """Start a ``torch.profiler`` window of CUDA activity only (the
    ``trace.start`` span), once, in a process armed with the profiler
    that made its context: a phase-2 worker at its first device call,
    the run's device process as phase 2 begins, before the workers are
    forked, so that the trace's own start, seconds long, runs before the
    first request and beside no phase's work."""
    w = _WORKER
    if w is None or w["cuda_startup_s"] is None or w["profiler"] is not None:
        return
    with span("trace.start"):
        from torch.profiler import ProfilerActivity, profile
        prof = profile(activities=[ProfilerActivity.CUDA])
        wall_ns, mono_ns = time.time_ns(), time.monotonic_ns()
        prof.start()
        w["profiler"] = (prof, wall_ns, mono_ns)


def bin_finished() -> None:
    """Called once the worker's bin is written (in the device process: at
    its stop): only finished workers count in the merge, with their
    counts as they stand here."""
    if _WORKER is not None:
        _WORKER["finished"] = counts()


def zero_counts() -> dict:
    """``counts()`` of a process that did nothing."""
    return counters.zeros(counts())


def counts() -> dict:
    """This process's host-side counts, from the ledger
    (``parallel.counters``): each kernel's launches and work, the calls
    and walls of the seams that reach it, the scorer's ``joint`` counts
    (``JOINT_STATS``) and the device process's route's (``device_proc``:
    ``DEVICE_PROC``); zeros for what it never ran."""
    return counters.counts()


def _device_events(prof, wall_ns: int, mono_ns: int):
    """The device events of a stopped profiler as [name, start ns on the
    wall clock, duration ns], and the clock its timestamps came on:
    "wall" when its trace starts near ``wall_ns`` (taken just before
    it started), else "monotonic", moved onto the wall clock by the
    offset taken then."""
    from torch.autograd import DeviceType
    result = prof.profiler.kineto_results
    start = (result.trace_start_ns() if hasattr(result, "trace_start_ns")
             else result.trace_start_us() * 1000)
    clock = ("wall" if abs(start - wall_ns) <= abs(start - mono_ns)
             else "monotonic")
    shift = 0 if clock == "wall" else wall_ns - mono_ns
    out = []
    for e in result.events():
        if e.device_type() != DeviceType.CUDA:
            continue
        if hasattr(e, "start_ns"):
            t, d = e.start_ns(), e.duration_ns()
        else:
            t, d = e.start_us() * 1000, e.duration_us() * 1000
        out.append([e.name(), int(t) + shift, int(d)])
    out.sort(key=lambda ev: ev[1])
    return out, clock


def _write_record(rec: dict, name: str, **fields) -> None:
    """Writes ``rec`` (once, and only from the process that made it) to
    ``name`` in the armed directory."""
    if rec["written"] or rec["pid"] != os.getpid():
        return
    rec["written"] = True
    record = {"role": rec["role"], "pid": rec["pid"], "run": rec["run"],
              **fields, "spans": rec["spans"],
              "forked_from": rec["forked_from"]}
    path = os.path.join(rec["dir"], name)
    with open(path + ".tmp", "w") as f:
        json.dump(record, f)
    os.replace(path + ".tmp", path)


def _write() -> None:
    w, rec = _WORKER, _REC
    if w is None or rec is None or rec["written"] \
            or rec["pid"] != os.getpid():
        return
    events = clock = None
    if w["profiler"] is not None:
        import torch
        prof, wall_ns, mono_ns = w["profiler"]
        with span("trace.stop"):
            torch.cuda.synchronize()
            prof.stop()
            events, clock = _device_events(prof, wall_ns, mono_ns)
    if w["span"] is not None:
        w["span"].__exit__(None, None, None)
    _write_record(rec, f"device_trace.{rec['pid']}.json", bin=w["bin"],
                  finished=bool(w["finished"]), touched=w["touched"],
                  cuda_startup_s=w["cuda_startup_s"], clock=clock,
                  events=events, counts=w["finished"] or counts())
