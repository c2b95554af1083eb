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
- ``counts``: its wrappers' launches, each kernel's work
  (``KERNEL_WORK``), the calls and walls of the seams that reach
  them (the contig dispatcher, the split router), and the scorer's
  junctions, samples, fragments and times (``joint``), and the device
  process's route (``device_proc``);
- ``cuda_startup_s``: the host seconds of its first CUDA call, which
  makes its CUDA context (the ``cuda.context`` span);
- ``clock``: the clock the profiler's timestamps came on, and
  ``finished``: whether the worker's bin was written.

A phase-2 worker starts its trace at its first device call
(``device_call``): it makes its CUDA context first and times it, then
starts a ``torch.profiler`` window of CUDA activity only, so a worker
that never reaches the device never makes a context, and the trace costs
no host work a launch. Where the run has a device process, it alone
makes a context, at its start, and traces the card, from phase 2's
start; the phase-2 workers forward their seam calls to it and make
none.
``arm(directory, device=False)`` records the
spans only: no profiler, and no context made apart from the first
seam's call (no ``cuda.context`` or ``trace.*`` span, no
``cuda_startup_s``). Unarmed, ``span`` returns one shared no-op
object after a single test, and every other function here returns at
its first test: no clock, no record, no profiler, no file.
"""

from __future__ import annotations

import functools
import json
import os
import sys
import time

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


class _NoSpan:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NO_SPAN = _NoSpan()


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
    from .forkpool import at_process_exit
    _REC = rec = _new_record(role, _REC)
    at_process_exit(lambda: _write_record(rec, f"trace.{rec['pid']}.json"))


def enter_phase2_worker(bin_index: int) -> None:
    """Called first in a phase-2 worker: armed, this process keeps a
    record, opens its ``worker`` span (closed at exit, after the trace
    stops) and writes its record at exit."""
    global _REC, _WORKER
    if _ARMED["dir"] is None:
        return
    from .forkpool import at_process_exit
    _REC = _new_record("phase2", _REC)
    worker = span("worker", bin=bin_index)
    worker.__enter__()
    # "finished": the counts when the bin was written, else None
    _WORKER = {"bin": bin_index, "finished": None, "cuda_startup_s": None,
               "device": _ARMED["device"], "profiler": None,
               "touched": False, "span": worker}
    at_process_exit(_write)


def enter_device_process(device) -> None:
    """Called first in the run's device process (``parallel.
    device_proc``): makes its CUDA context at once. Armed, this process
    keeps a record (role ``device_proc``) and writes
    ``device_trace.<pid>.json`` at exit; armed with the profiler, the
    context is made as a phase-2 worker makes its own (the
    ``cuda.context`` span, ``cuda_startup_s``) and the profiler waits
    for ``start_device_trace``; otherwise the context is made untimed."""
    global _REC, _WORKER
    import torch
    device = torch.device(device)
    if _ARMED["dir"] is not None:
        from .forkpool import at_process_exit
        _REC = _new_record("device_proc", _REC)
        _WORKER = {"bin": None, "finished": None, "cuda_startup_s": None,
                   "device": _ARMED["device"], "profiler": None,
                   "touched": False, "span": None}
        at_process_exit(_write)
    if device.type != "cuda":
        return
    if _WORKER is not None and _WORKER["device"]:
        _make_context(device)
    else:
        torch.empty(1, device=device)
        torch.cuda.synchronize(device)


def start_device_trace() -> None:
    """Called in the run's device process as phase 2 begins, before the
    workers are forked: armed with the profiler, starts it (the
    ``trace.start`` span), so that the trace's own start, seconds long,
    runs before the first request and beside no phase's work."""
    w = _WORKER
    if w is not None and w["cuda_startup_s"] is not None \
            and w["profiler"] is None:
        _start_profiler()


def bin_finished() -> None:
    """Called once the worker's bin is written (in the device process: at
    its stop): only finished workers count in the merge, with their
    counts as they stand here (the exit lines' report, which runs at
    exit too, zeroes the dispatcher's)."""
    if _WORKER is not None:
        _WORKER["finished"] = counts()


def device_call(device) -> None:
    """Called by the device seams before each call. In a worker armed
    with the profiler, the first call on a CUDA device makes the context,
    timed, and starts the trace; armed with the spans only, or on the
    CPU, it only marks the worker as one that scored (the context is
    then made inside the first seam's span, as in an unarmed run: made
    here on its own, it cost phase 2 ~0.5 s on the card, PERF.md)."""
    if _WORKER is None or _WORKER["touched"]:
        return
    _WORKER["touched"] = True
    import torch
    device = torch.device(device)
    if device.type != "cuda" or not _WORKER["device"]:
        return
    _make_context(device)
    _start_profiler()


def _make_context(device) -> None:
    """Make this process's CUDA context, timed (``cuda_startup_s``)."""
    import torch
    with span("cuda.context"):
        t0 = time.perf_counter()
        torch.empty(1, device=device)
        torch.cuda.synchronize(device)
        _WORKER["cuda_startup_s"] = time.perf_counter() - t0


def _start_profiler() -> None:
    """Start a ``torch.profiler`` window of CUDA activity only."""
    with span("trace.start"):
        from torch.profiler import ProfilerActivity, profile
        prof = profile(activities=[ProfilerActivity.CUDA])
        wall_ns, mono_ns = time.time_ns(), time.monotonic_ns()
        prof.start()
        _WORKER["profiler"] = (prof, wall_ns, mono_ns)


KERNELS = ("jump_score", "jump_score_bounded", "split_score")


def zero_counts() -> dict:
    """``counts()`` of a process that did nothing."""
    return {"launches": dict.fromkeys(KERNELS, 0),
            "work": {k: {"useful": 0, "padded": 0, "bytes": 0}
                     for k in KERNELS},
            "calls": dict.fromkeys(KERNELS, 0),
            "wall": dict.fromkeys(KERNELS, 0.0),
            "joint": {"junctions": 0, "sample_junctions": 0,
                      "fragments": [], "evidence_ns": 0, "genotype_ns": 0},
            "device_proc": {"contexts": 0, "k1_calls": 0, "k3_calls": 0,
                            "bytes_in": 0, "bytes_out": 0,
                            "ready_wait_s": 0.0, "round_trip_s": 0.0,
                            "service_s": 0.0}}


def counts() -> dict:
    """This process's host-side counts: each wrapper's launches, each
    kernel's work (``KERNEL_WORK``), the calls and walls of the seams
    that reach it (the contig dispatcher; the split router's exact scans
    and mxu fallbacks), and under ``joint`` the scorer's
    ``JOINT_STATS`` (junctions, sample-junctions, fragments per sample,
    ns in evidence and in the score models), and under ``device_proc``
    the run's device process's route (``DEVICE_PROC``: contexts made,
    calls forwarded, bytes each way, seconds waited), from the modules it
    imported: zeros for those it never imported."""
    cj = sys.modules.get("manta_tpu_torch.align.cuda_jumpscore")
    cs = sys.modules.get("manta_tpu_torch.align.cuda_splitscore")
    dj = sys.modules.get("manta_tpu_torch.align.device_jumpscore")
    ds = sys.modules.get("manta_tpu_torch.scoring.device_scan")
    sc = sys.modules.get("manta_tpu_torch.scoring.scorer")
    dp = sys.modules.get("manta_tpu_torch.parallel.device_proc")
    out = zero_counts()
    if dp is not None:
        out["device_proc"] = dict(dp.DEVICE_PROC)
    if sc is not None:
        out["joint"] = dict(sc.JOINT_STATS,
                            fragments=list(sc.JOINT_STATS["fragments"]))
    for mod in (cj, cs):
        if mod is not None:
            out["launches"].update(mod.KERNEL_LAUNCHES)
            out["work"].update({k: dict(v)
                                for k, v in mod.KERNEL_WORK.items()})
    if dj is not None:
        out["calls"]["jump_score"] = dj.DISPATCH_STATS["calls"]
        out["wall"]["jump_score"] = dj.DISPATCH_STATS["wall"]
    if ds is not None:
        scan = ds.SCAN_STATS
        out["calls"]["split_score"] = scan["exact"] + scan["fallback"]
        out["wall"]["split_score"] = scan["wall"]
    return out


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
