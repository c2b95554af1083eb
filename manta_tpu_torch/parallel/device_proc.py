"""The run's device process: one CUDA context for phase 2, not one a
worker.

A CUDA context a phase-2 worker cost 1.1-2.9 s of host time, eight a
sample, for under 20 ms of kernels (PERF.md section 5). So the workflow
process forks one device process at the start of phase 0 (``start``),
before any CUDA call anywhere, and makes none itself. The device
process makes the run's one context at once, beside phase 0's fragment
statistics, then waits in ``select``, using no CPU, until phase 2 calls
it; the workflow process waits on ``ready`` before it forks the
phase-2 workers.

This module owns the card. Each device seam, the contig scorer of
``align.device_jumpscore.make_bucketed_scorer`` (K1, ``k1.dispatch``)
and ``scoring.device_scan.DeviceScanContext.scan_multi`` (K3,
``k3.route``), makes one call, ``k1`` or ``k3``, on ``route(device)``:
an ``InProcess`` route, or a ``Client`` of the run's device process,
which writes the host arrays bound for the card into a shared-memory
buffer of its process's own (a ``memfd``, whose descriptor goes over
once) and sends a request on a ``SOCK_SEQPACKET`` Unix socket that says
what lies there. The device process runs them through an ``InProcess``
route of its own and writes the results back into the buffer; nothing
is pickled, and the results are bit for bit the in-process route's.
``make_context`` alone makes a CUDA context on its own: the device
process's at its start, a traced phase-2 worker's at its first call.

Each launch is counted once, by the process that launches it: the
device process counts the kernels and the seams (``parallel.counters``)
and prints their exit lines; armed (``parallel.worker_trace``), it
writes ``device_trace.<pid>.json`` (role ``device_proc``) with the spans
``cuda.context``, ``trace.start`` (at ``ready``: the trace's own start,
seconds long, overlaps no phase's work), ``device_proc.k1`` or
``device_proc.k3`` a request, and ``trace.stop``. ``DEVICE_PROC`` counts
the route itself.

``stop``, after phase 2's workers are reaped and before the final sort,
asks the device process to exit and joins it, so that its CPU time lands
in the workflow process's ``RUSAGE_CHILDREN``. A device process that
dies fails the next request it was to serve, and with it the run:
nothing falls back to the host. One whose workflow process is gone
exits within a second.

Which runs have one: ``engages``. Every other run keeps the in-process
route, on which each process that scores makes its own context.
"""

from __future__ import annotations

import functools
import mmap
import os
import selectors
import socket
import struct
import time
import traceback
from contextlib import nullcontext
from types import SimpleNamespace

import numpy as np

from . import counters, worker_trace

# the device types a run may give a device process; the tests widen it
# to run the route on the CPU, or empty it to keep a card run in process
DEVICE_TYPES = ("cuda",)
# the route in this process: in the device process the contexts it made;
# in a caller the calls it forwarded, the bytes it sent (inputs) and got
# back (results), the seconds it waited for the device process to be
# ready, and the seconds of its requests on its own clock (round_trip_s)
# and on the device process's (service_s)
DEVICE_PROC = {"contexts": 0, "k1_calls": 0, "k3_calls": 0, "bytes_in": 0,
               "bytes_out": 0, "ready_wait_s": 0.0, "round_trip_s": 0.0,
               "service_s": 0.0}
counters.register({"device_proc": DEVICE_PROC})

# a request: its kind, then the kind's integer fields
REQUEST = struct.Struct("<16q")
MAP, K1, K3, READY, STOP = 1, 2, 3, 4, 5
# a reply: failed (0 or 1), the device process's ns on the request; a
# failure's traceback follows
REPLY = struct.Struct("<2q")
REPLY_MAX = 1 << 16
LUT = 71                                # entries of each split-scan LUT
FIRST_BUFFER = 1 << 20
STOP_TIMEOUT_S = 600.0

# the run this process started (the workflow process): address, device,
# process; forked workers inherit it
_RUN: dict | None = None
# this process's client, made at its first forwarded call
_CLIENT: Client | None = None
# the in-process routes, by (process, device)
_LOCAL: dict = {}


def engages(device, n_jobs: int, jump_scorer, is_rna: bool,
            one_host: bool, phase2_to_run: bool) -> bool:
    """Whether a run gets a device process: device scoring on a device
    whose type is in ``DEVICE_TYPES``, phase 2 forks workers
    (``n_jobs`` > 1 on ``one_host``, not a bin range of a multi-host
    run), the contig scorer is the port's own (no caller's
    ``jump_scorer``), the mode is not RNA (where K1 never launches) and
    phase 2 is still to run."""
    return (device is not None and device.type in DEVICE_TYPES
            and n_jobs > 1 and jump_scorer is None and not is_rna
            and one_host and phase2_to_run)


def start(device, device_scoring: str) -> None:
    """Fork the run's device process for ``device``: from here on, every
    seam call of this process and of the processes it forks goes to it,
    until ``stop``."""
    global _RUN
    import multiprocessing as mp

    import torch
    device = torch.device(device)
    address = b"\0manta-tpu-torch-device-proc-%d-%d" % (os.getpid(),
                                                        time.time_ns())
    listener = socket.socket(socket.AF_UNIX, socket.SOCK_SEQPACKET)
    try:
        listener.bind(address)
        listener.listen(128)
        proc = mp.get_context("fork").Process(
            target=_serve, args=(listener, device, device_scoring,
                                 os.getpid()),
            name="device_proc", daemon=True)
        proc.start()
    finally:
        listener.close()
    _RUN = {"address": address, "device": device, "proc": proc,
            "pid": os.getpid()}


def _control(kind: int) -> None:
    """Send the device process this process started a request of
    ``kind`` on a connection of its own, and wait for the reply."""
    with socket.socket(socket.AF_UNIX, socket.SOCK_SEQPACKET) as sock:
        sock.settimeout(STOP_TIMEOUT_S)
        sock.connect(_RUN["address"])
        _reply(sock)                            # ready
        sock.send(REQUEST.pack(kind, *[0] * 15))
        _reply(sock)


def ready() -> None:
    """Called by the workflow process as phase 2 begins, before it forks
    the workers: returns once the device process serves requests, its
    context made and, armed with the profiler, its trace started, so
    that no worker's first call waits for either. Raises where it is
    gone."""
    if _RUN is None or _RUN["pid"] != os.getpid():
        return
    try:
        _control(READY)
    except OSError as e:
        raise RuntimeError("the run's device process is not running") \
            from e


def stop() -> int | None:
    """Ask the device process this process started to exit, and join it.
    Returns its exit code, None where this process started none; one
    that does not exit within ``STOP_TIMEOUT_S`` is terminated."""
    global _RUN, _CLIENT
    run = _RUN
    if run is None or run["pid"] != os.getpid():
        return None
    if _CLIENT is not None and _CLIENT.pid == os.getpid():
        _CLIENT.sock.close()
    _CLIENT = None
    proc = run["proc"]
    try:
        _control(STOP)
    except (OSError, RuntimeError):
        pass                                    # it is gone already
    finally:
        _RUN = None
    proc.join(STOP_TIMEOUT_S)
    if proc.exitcode is None:
        proc.terminate()
        proc.join()
    return proc.exitcode


def stopped_on_return(run):
    """Decorates ``run_workflow``: the device process the call started
    is stopped and joined however the call ends."""
    @functools.wraps(run)
    def wrapper(*args, **kwargs):
        try:
            return run(*args, **kwargs)
        finally:
            stop()
    return wrapper


def route(device) -> InProcess | Client:
    """This process's route for ``device``: its client of the run's
    device process where that serves ``device``, else its in-process
    route."""
    global _CLIENT
    run = _RUN
    if run is not None and run["device"] == device:
        if _CLIENT is None or _CLIENT.pid != os.getpid():
            _CLIENT = Client(run["address"])
        return _CLIENT
    key = (os.getpid(), device)
    hit = _LOCAL.get(key)
    if hit is None:
        hit = _LOCAL[key] = InProcess(device)
    return hit


def make_context(device, timed: bool) -> None:
    """Make this process's CUDA context on ``device``; ``timed``: in the
    ``cuda.context`` span, its seconds told to the run trace
    (``cuda_startup_s``)."""
    import torch
    with worker_trace.span("cuda.context") if timed else nullcontext():
        t0 = time.perf_counter()
        torch.empty(1, device=device)
        torch.cuda.synchronize(device)
        if timed:
            worker_trace.context_made(time.perf_counter() - t0)


# ------------------------------------------------------------ layouts

def _align(n: int) -> int:
    return (n + 63) & ~63


def k1_layout(Bp: int, nq: int, nr1: int, nr2: int):
    """The int32 arrays of a K1 request as ``pad_jobs`` makes them, by
    shape and byte offset, and the offset of the (B,) int32 scores."""
    shapes = [(Bp, nq), (Bp,), (Bp, nr1), (Bp,), (Bp, nr2), (Bp,)]
    out, off = [], 0
    for shape in shapes:
        out.append((shape, off))
        off += 4 * int(np.prod(shape))
    return out, _align(off)


def k3_layout(n: int, t: int, Lp: int, Tp: int):
    """The offsets of a K3 request's two float32 LUTs, after its staged
    inputs (``device_scan.staged_views``), and of its (n, t) float32
    best ln-likelihoods, followed by the int32 positions."""
    from ..scoring.device_scan import staged_bytes
    lut = staged_bytes(n, t, Lp, Tp)
    return lut, _align(lut + 2 * 4 * LUT)


def _reply(sock) -> int:
    """Read a reply: the device process's ns on the request; raises where
    the request failed or the device process is gone."""
    try:
        msg = sock.recv(REPLY_MAX)
    except ConnectionError:
        msg = b""
    if not msg:
        raise RuntimeError("the run's device process exited")
    failed, ns = REPLY.unpack_from(msg)
    if failed:
        raise RuntimeError("the run's device process failed a request:\n"
                           + msg[REPLY.size:].decode(errors="replace"))
    return ns


# ------------------------------------------------------------ caller

class Client:
    """One process's connection to the run's device process, with its
    shared-memory buffer."""

    def __init__(self, address: bytes):
        self.pid = os.getpid()
        self.sock = socket.socket(socket.AF_UNIX, socket.SOCK_SEQPACKET)
        self.mm = None
        t0 = time.perf_counter()
        try:
            self.sock.connect(address)
        except OSError as e:
            self.sock.close()
            raise RuntimeError("the run's device process is not running") \
                from e
        _reply(self.sock)
        DEVICE_PROC["ready_wait_s"] += time.perf_counter() - t0

    def _buffer(self, n_bytes: int):
        """The shared buffer, at least ``n_bytes`` long: a new one, made
        known to the device process, where the last is too short."""
        if self.mm is None or len(self.mm) < n_bytes:
            size = max(FIRST_BUFFER, 1 << (n_bytes - 1).bit_length())
            fd = os.memfd_create("manta-tpu-torch-device-proc",
                                 os.MFD_CLOEXEC)
            try:
                os.ftruncate(fd, size)
                mm = mmap.mmap(fd, size)
                self._send((MAP, size), [fd])
            finally:
                os.close(fd)
            _reply(self.sock)
            self.mm = mm
        return self.mm

    def _send(self, fields, fds=()) -> None:
        try:
            socket.send_fds(self.sock, [REQUEST.pack(
                *fields, *[0] * (16 - len(fields)))], list(fds))
        except OSError as e:
            raise RuntimeError("the run's device process exited") from e

    def _call(self, *fields) -> None:
        t0 = time.perf_counter()
        self._send(fields)
        ns = _reply(self.sock)
        DEVICE_PROC["round_trip_s"] += time.perf_counter() - t0
        DEVICE_PROC["service_s"] += ns / 1e9

    def k1(self, arrays, B: int, scores, jump_score: int):
        """``score_padded`` of ``pad_jobs``'s ``arrays`` in the device
        process: the scores of the first ``B`` rows, int32 (B,)."""
        Bp, nq = arrays[0].shape
        nr1, nr2 = arrays[2].shape[1], arrays[4].shape[1]
        layout, out = k1_layout(Bp, nq, nr1, nr2)
        mm = self._buffer(out + 4 * B)
        for a, (_shape, off) in zip(arrays, layout):
            np.frombuffer(mm, np.int32, a.size, off)[:] = a.ravel()
        self._call(K1, B, Bp, nq, nr1, nr2, scores.match, scores.mismatch,
                   scores.open, scores.extend, scores.off_edge, jump_score)
        DEVICE_PROC["k1_calls"] += 1
        DEVICE_PROC["bytes_in"] += sum(a.nbytes for a in arrays)
        DEVICE_PROC["bytes_out"] += 4 * B
        return np.frombuffer(mm, np.int32, B, out).copy()

    def k3(self, fill, n: int, t: int, Lp: int, Tp: int, flank: int,
           mxu: bool, lut_m, lut_x):
        """``scan_staged`` in the device process of the inputs that
        ``fill`` writes into a flat uint8 array (``fill_staged``), with
        the 71-entry LUTs ``lut_m``, ``lut_x``: the (n, t) float32 best
        ln-likelihoods and int32 positions."""
        lut, out = k3_layout(n, t, Lp, Tp)
        mm = self._buffer(out + 8 * n * t)
        fill(np.frombuffer(mm, np.uint8, lut))
        np.frombuffer(mm, np.float32, LUT, lut)[:] = lut_m
        np.frombuffer(mm, np.float32, LUT, lut + 4 * LUT)[:] = lut_x
        self._call(K3, n, t, Lp, Tp, flank, int(mxu))
        DEVICE_PROC["k3_calls"] += 1
        DEVICE_PROC["bytes_in"] += lut + 2 * 4 * LUT
        DEVICE_PROC["bytes_out"] += 8 * n * t
        best = np.frombuffer(mm, np.float32, n * t, out).reshape(n, t)
        pos = np.frombuffer(mm, np.int32, n * t, out + 4 * n * t)
        return best.copy(), pos.reshape(n, t).copy()


# ------------------------------------------------------------ in process

class InProcess:
    """The route of a process that runs its own kernels on ``device``;
    ``serving``: the device process's, whose context is made at its
    start."""

    def __init__(self, device, serving: bool = False):
        self.device = device
        self._serving = serving
        self._scans = {}

    def _enter(self) -> None:
        """Before each call: a traced phase-2 worker's first makes its
        context, timed, and starts the trace."""
        if self._serving or not worker_trace.first_device_call():
            return
        if self.device.type == "cuda":
            make_context(self.device, timed=True)
            worker_trace.start_profiler()

    def k1(self, arrays, B: int, scores, jump_score: int):
        """As ``Client.k1``, with ``score_padded`` in this process."""
        from ..align.device_jumpscore import score_padded
        self._enter()
        return score_padded(arrays, B, scores, jump_score, self.device,
                            time.perf_counter())

    def k3(self, fill, n: int, t: int, Lp: int, Tp: int, flank: int,
           mxu: bool, lut_m, lut_x):
        """As ``Client.k3``, with ``scan_staged`` in this process on the
        inputs ``fill`` writes into its staging buffer."""
        from ..scoring.device_scan import DeviceScanContext, staged_bytes
        self._enter()
        t0 = time.perf_counter()
        ctx = self._scans.get(mxu)
        if ctx is None:
            ctx = self._scans[mxu] = DeviceScanContext(mxu, self.device)
        host = ctx.staging.host(staged_bytes(n, t, Lp, Tp))
        fill(host.numpy())
        return ctx.scan_staged(host, n, t, Lp, Tp, flank,
                               *ctx.luts_of(lut_m, lut_x), t0)


# ------------------------------------------------------------ device

def _handle(served: InProcess, state: dict, fields, fds) -> None:
    """The device process's side of a request: a buffer to map, or a K1
    or K3 call whose arrays lie in the caller's buffer, run through the
    device process's route ``served``."""
    kind, mm = fields[0], state["mm"]
    if kind == MAP:
        try:
            state["mm"] = mmap.mmap(fds[0], fields[1])
        finally:
            for fd in fds:
                os.close(fd)
    elif kind == K1:
        with worker_trace.span("device_proc.k1"):
            B, Bp, nq, nr1, nr2 = fields[1:6]
            layout, out = k1_layout(Bp, nq, nr1, nr2)
            arrays = [np.frombuffer(mm, np.int32, int(np.prod(shape)),
                                    off).reshape(shape).copy()
                      for shape, off in layout]
            match, mismatch, open_, extend, off_edge, jump = fields[6:12]
            scores = SimpleNamespace(match=match, mismatch=mismatch,
                                     open=open_, extend=extend,
                                     off_edge=off_edge)
            np.frombuffer(mm, np.int32, B, out)[:] = served.k1(
                arrays, B, scores, jump)
    elif kind == K3:
        with worker_trace.span("device_proc.k3"):
            n, t, Lp, Tp, flank, mxu = fields[1:7]
            lut, out = k3_layout(n, t, Lp, Tp)

            def fill(flat):
                flat[:] = np.frombuffer(mm, np.uint8, lut)
            best, pos = served.k3(
                fill, n, t, Lp, Tp, flank, bool(mxu),
                np.frombuffer(mm, np.float32, LUT, lut).copy(),
                np.frombuffer(mm, np.float32, LUT, lut + 4 * LUT).copy())
            np.frombuffer(mm, np.float32, n * t, out)[:] = best.ravel()
            np.frombuffer(mm, np.int32, n * t, out + 4 * n * t)[:] = \
                pos.ravel()
    else:
        raise ValueError(f"unknown request {kind}")


def _serve(listener, device, device_scoring: str, parent: int) -> None:
    """The device process: make the context, then serve requests until
    ``STOP`` or until the workflow process ``parent`` is gone."""
    traced = worker_trace.enter_device_process()
    if device.type == "cpu":
        # the plain forms on the CPU (the tests' route): a forked child
        # cannot use the thread pool of a parent that ran torch ops
        import torch
        torch.set_num_threads(1)
    else:
        make_context(device, timed=traced)
        DEVICE_PROC["contexts"] += 1
        # the libraries the mode launches, loaded before they are needed
        from ..align import cuda_jumpscore, cuda_splitscore
        cuda_jumpscore._lib()
        if device_scoring in ("exact", "mxu"):
            cuda_splitscore._lib()
    served = InProcess(device, serving=True)
    sel = selectors.DefaultSelector()
    sel.register(listener, selectors.EVENT_READ)
    ready = REPLY.pack(0, 0)
    while True:
        events = sel.select(timeout=1.0)
        if os.getppid() != parent:
            return
        for key, _mask in events:
            if key.fileobj is listener:
                conn, _addr = listener.accept()
                try:
                    conn.send(ready)
                except OSError:
                    conn.close()
                    continue
                sel.register(conn, selectors.EVENT_READ, {"mm": None})
                continue
            conn = key.fileobj
            try:
                msg, fds, _flags, _addr = socket.recv_fds(
                    conn, REQUEST.size, 1)
            except ConnectionError:
                msg, fds = b"", []
            if not msg:
                sel.unregister(conn)
                conn.close()
                continue
            fields = REQUEST.unpack(msg)
            if fields[0] == STOP:
                worker_trace.bin_finished()
                conn.send(ready)
                return
            if fields[0] == READY:
                worker_trace.start_profiler()
                conn.send(ready)
                continue
            t0 = time.perf_counter_ns()
            try:
                _handle(served, key.data, fields, fds)
                reply = REPLY.pack(0, time.perf_counter_ns() - t0)
            except Exception:                   # the caller raises it
                text = traceback.format_exc()[-(REPLY_MAX // 2):]
                reply = REPLY.pack(1, 0) + text.encode(errors="replace")
            try:
                conn.send(reply)
            except OSError:                     # the caller is gone
                sel.unregister(conn)
                conn.close()
