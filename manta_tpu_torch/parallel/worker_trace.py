"""Device traces of the phase-2 workers of a -j N run, for the timing tool.

At -j N a workflow scores its edge bins in forked workers
(``workflow/run.py`` ``_run_edges_parallel``), out of reach of a
profiler in the process that started the run. ``arm(directory)``, which
only ``tools/device_timing --kernel workflow --jobs N`` calls, makes
every phase-2 worker forked after it keep its own record and write it
at exit to ``directory/device_trace.<pid>.json``:

- ``events``: the worker's device events (kernels, copies, memsets) as
  [name, start ns, duration ns], the start on the host's wall clock
  (ns since the epoch), the clock every worker shares; None where the
  worker scored on the CPU;
- ``counts``: its wrappers' launches, each kernel's work
  (``KERNEL_WORK``) and the calls and walls of the seams that reach
  them (the contig dispatcher, the split router);
- ``cuda_startup_s``: the host seconds of its first CUDA call, which
  makes its CUDA context;
- ``clock``: the clock the profiler's timestamps came on, and
  ``finished``: whether the worker's bin was written;
- ``marks``: wall-clock seconds (since the epoch) at which the worker
  started, made its first device call, had its context, had its trace
  started, finished its bin, began to exit and had its trace stopped:
  where a worker's time goes, and what the trace costs.

A worker starts its trace at its first device call (``device_call``):
it makes its CUDA context first and times it, then starts a
``torch.profiler`` window of CUDA activity only, so a worker that never
reaches the device never makes a context, and the trace costs no host
work a launch. Unarmed, every function here returns at its first test:
no profiler, no file.
"""

from __future__ import annotations

import json
import os
import sys
import time

# the directory armed workers write into, or None
_ARMED: dict = {"dir": None}
# this process's record once it is an armed phase-2 worker
_WORKER: dict | None = None


def arm(directory: str) -> None:
    """Trace every phase-2 worker forked from now on into ``directory``."""
    _ARMED["dir"] = directory


def disarm() -> None:
    _ARMED["dir"] = None


def enter_phase2_worker(bin_index: int) -> None:
    """Called first in a phase-2 worker: if armed, this process keeps a
    record and writes it at exit."""
    global _WORKER
    if _ARMED["dir"] is None:
        return
    from .forkpool import at_process_exit
    # "finished": the counts when the bin was written, else None
    _WORKER = {"pid": os.getpid(), "bin": bin_index, "finished": None,
               "dir": _ARMED["dir"], "cuda_startup_s": None,
               "profiler": None, "touched": False,
               "written": False, "marks": {"entered": time.time()}}
    at_process_exit(_write)


def bin_finished() -> None:
    """Called once the worker's bin is written: only finished workers
    count in the merge, with their counts as they stand here (the exit
    lines' report, which runs at exit too, zeroes the dispatcher's)."""
    if _WORKER is not None:
        _WORKER["finished"] = counts()
        _WORKER["marks"]["bin_finished"] = time.time()


def device_call(device) -> None:
    """Called by the device seams before each call. In an armed worker,
    the first call on a CUDA device makes the context, timed, and starts
    the trace; on the CPU it only marks the worker as one that scored."""
    if _WORKER is None or _WORKER["touched"]:
        return
    _WORKER["touched"] = True
    marks = _WORKER["marks"]
    marks["first_device_call"] = time.time()
    import torch
    device = torch.device(device)
    if device.type != "cuda":
        return
    t0 = time.perf_counter()
    torch.empty(1, device=device)
    torch.cuda.synchronize(device)
    _WORKER["cuda_startup_s"] = time.perf_counter() - t0
    marks["context_made"] = time.time()
    from torch.profiler import ProfilerActivity, profile
    prof = profile(activities=[ProfilerActivity.CUDA])
    wall_ns, mono_ns = time.time_ns(), time.monotonic_ns()
    prof.start()
    _WORKER["profiler"] = (prof, wall_ns, mono_ns)
    marks["trace_started"] = time.time()


KERNELS = ("jump_score", "jump_score_bounded", "split_score")


def zero_counts() -> dict:
    """``counts()`` of a process that did nothing."""
    return {"launches": dict.fromkeys(KERNELS, 0),
            "work": {k: {"useful": 0, "padded": 0, "bytes": 0}
                     for k in KERNELS},
            "calls": dict.fromkeys(KERNELS, 0),
            "wall": dict.fromkeys(KERNELS, 0.0)}


def counts() -> dict:
    """This process's host-side counts: each wrapper's launches, each
    kernel's work (``KERNEL_WORK``), and the calls and walls of the
    seams that reach it (the contig dispatcher; the split router's exact
    scans and mxu fallbacks), from the modules it imported: zeros for
    those it never imported."""
    cj = sys.modules.get("manta_tpu_torch.align.cuda_jumpscore")
    cs = sys.modules.get("manta_tpu_torch.align.cuda_splitscore")
    dj = sys.modules.get("manta_tpu_torch.align.device_jumpscore")
    ds = sys.modules.get("manta_tpu_torch.scoring.device_scan")
    out = zero_counts()
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


def _write() -> None:
    w = _WORKER
    if w is None or w["written"] or w["pid"] != os.getpid():
        return
    w["written"] = True
    w["marks"]["exit"] = time.time()
    events = clock = None
    if w["profiler"] is not None:
        import torch
        prof, wall_ns, mono_ns = w["profiler"]
        torch.cuda.synchronize()
        prof.stop()
        events, clock = _device_events(prof, wall_ns, mono_ns)
        w["marks"]["trace_stopped"] = time.time()
    record = {"pid": w["pid"], "bin": w["bin"],
              "finished": bool(w["finished"]), "touched": w["touched"],
              "cuda_startup_s": w["cuda_startup_s"], "clock": clock,
              "marks": w["marks"], "events": events,
              "counts": w["finished"] or counts()}
    path = os.path.join(w["dir"], f"device_trace.{w['pid']}.json")
    with open(path + ".tmp", "w") as f:
        json.dump(record, f)
    os.replace(path + ".tmp", path)
