"""Kernel timing on the card.

    python -m manta_tpu_torch.tools.device_timing --kernel all|<name>
        [--json FILE] [--device cuda|cpu] [--seed N]

Counterpart of benchmarks/device_timing.py, one bench per entry of its
``BENCHES``, at its shapes:

  matmul             bf16 2048^3 ``torch.matmul`` (a plain product
                     outside any kernel), against the card's published
                     dense bf16 peak: the anchor of the method
  jump               the plain PyTorch jump DP        B=64 q=400 refs 2x800
  jump_cuda          the CUDA jump kernel (exact insert chain), same shape
  jump_cuda_bounded  the CUDA bounded-chain kernel at prefix_rounds 3
                     and 5, same shape; ``n_flagged`` rows would rerun
  jumpalign          benchmarks/bench_jumpalign.py: contigs spanning a
                     junction of two references (B=512, q=200, refs
                     2x700, the refiner's spanning scores), the host's
                     full aligner (score and traceback) on 32 of them on
                     one core against the CUDA jump kernel on all of
                     them (the plain PyTorch form with --device cpu); the
                     32 host scores must equal the device's, and on the
                     card the kernel's all equal the plain form's
  jump_layouts       the CUDA jump kernels at the scorer's buckets, full
                     rows, at every choice of lanes per thread: the
                     exact kernel and the bounded one at prefix_rounds
                     3 and 5, with the polls the warps spent waiting
                     for one another; not part of ``all``
                     (``--layout-bucket B,Q,R``: one bucket only;
                     ``--layout-loops N``: timed loops a layout)
  split_exact        the plain PyTorch split scan     B=512 T=500 L=150
  split_cuda         the CUDA split-scan kernel, same shape, a row per
                     (read, target) pair
  split_cuda_factored  the same kernel on 256 reads x 2 targets, each
                     stored once (the router's layout)
  split_mxu          the matmul split scan            G=8 R=64 T=500 L=150
  split_mxu_k3       the library yardstick of the split kernel: the
                     matmul form (two ``torch.bmm``) on split_cuda_factored's
                     inputs, beside the kernel on them, and its largest
                     difference from the kernel
  trace_aging        the profiler's lost launches: traces of 12 router
                     calls (one split-kernel launch each), cold and warm,
                     every 40 s for ``--aging-s`` seconds (default 240)
                     after this process's first trace, beside a child
                     whose first trace comes that late; the launches
                     against the kernel records and the runtime's launch
                     calls each trace holds. Not part of ``all``
  trace_span         a phase-2 worker's trace (parallel/worker_trace) held
                     open for ``--span-s`` seconds (default 200, a whole-
                     genome worker's phase 2) around ``--span-calls``
                     router calls (default 8000) spread over it: the
                     launches against the trace's kernel records, by
                     tenth of the span. Not part of ``all``
  scan_router        a whole ``DeviceScanContext.scan_multi`` call (staging,
                     copies, kernel, results back on the host) on 47 reads
                     x 2 junction targets, a typical workflow call, on the
                     host clock, beside the native host scan of the same
  workflow           the kernels where a workflow launches them; not part
                     of ``all``:

      --kernel workflow --workload wgs|joint|tumor|high-span|rna
          --mode jump|exact [--prefix P] [--jobs N] [--run-dir D]

                     runs ``run_workflow`` in this process on P.bam and
                     P.fa (germline; joint germline on every P.s<k>.bam
                     of a ``tools.wgs_workload --samples K`` prefix;
                     tumor-only; tumor-only exome for high-span; RNA
                     fusion mode, by default on the demo tumor BAM), and
                     prints a line a kernel: its launches in the trace
                     and by its wrapper (they must be equal, or it exits
                     non-zero), device ms, useful and padded work, bytes,
                     bound and share of it, and its copies each way; then
                     a line with phase 2's wall, the device's busy time
                     (the union of every device event) and its share of
                     that wall. At -j 1 (the default) the run is inside a
                     torch.profiler (CUPTI) window of this process. At
                     --jobs N above 1 this process makes no CUDA context
                     (it forks the workers); each phase-2 worker traces
                     its own device work from its first device call
                     (parallel/worker_trace) and writes it to
                     D/workspace/device_trace.<pid>.json at exit, and the
                     lines hold their merge, the workers' launches on
                     their exit lines too (all three counts must be
                     equal), the workers traced and launching, their
                     CUDA start-ups (min, median, max) and the clock.
                     With --device cpu the plain forms score and the
                     device fields are null.

Each bench prints one JSON line (and appends it to ``--json``): the
reference's record (``kernel``, ``shape``, ``sec_per_iter`` and a rate),
with how it was timed (``timed_by``). For the CUDA kernels and the
anchor ``sec_per_iter`` is the device time from a ``torch.profiler``
(CUPTI) trace, and ``event_sec_per_iter`` beside it the CUDA-event time
around a loop of calls, which for a kernel of a few microseconds is the
wrapper's host work, not the kernel. A plain PyTorch form is thousands
of small kernels a call and bound by launching them: its
``sec_per_iter`` is the event time of a call, and
``device_busy_sec_per_iter`` the device time of its kernels. The last
line counts the kernel launches the run made. The TPU reference's
fetch-synchronised slope fit has no counterpart: here the device is
timed directly.

It runs on the card and exits non-zero without one. ``--device cpu``
runs the plain forms on the host clock at whatever shapes are passed
(the CUDA benches are then refused); such times are not device times,
and the records say so (``"device": "cpu"``). Inputs come from a numpy
generator seeded with ``--seed``.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import re
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

# dense bf16 tensor-core peak of one H100 SXM (NVIDIA's data sheet), at
# the full 700 W power limit
H100_PEAK_BF16_FLOPS = 989e12
JUMP_SCORES = (2, -8, -18, -1, -1)     # match, mismatch, open, extend, offEdge
JUMP = -100
# benchmarks/bench_jumpalign.py: the refiner's spanning scores, and the
# contigs the host aligner takes
JUMPALIGN_SCORES = (1, -9, -19, -1, -1)
JUMPALIGN_HOST_CONTIGS = 32
FLANK = 16
BOUNDED_ROUNDS = (3, 5)


class Timer:
    """Times one call of ``fn`` on ``device``; returns the time fields of
    a record.

    On the CPU: the host clock (``sec_per_iter``).

    On the card: the CUDA-event time around a loop of ``iters`` calls
    (``event_sec_per_iter``), and a ``torch.profiler`` (CUPTI) trace
    taken after a discarded warm-up cycle with the profiler already on.

    - ``kernel`` names a hand-written kernel: ``sec_per_iter`` is the
      mean device time of one launch of it, total over launches as the
      trace holds them (``profiled_launches``), so a trace that lost
      events still reads right.
    - no ``kernel`` and ``whole_call`` false (one library kernel a call,
      the matmul anchor): ``sec_per_iter`` is the device time of all
      kernels of the trace over ``iters``.
    - ``whole_call`` (a plain PyTorch form, thousands of small kernels a
      call, bound by their launches): ``sec_per_iter`` is the event time
      of a call, and ``device_busy_sec_per_iter`` the device time of
      its kernels from a trace of one call.

    A trace started cold misses its first kernels (the bf16 anchor read
    136% of the card's peak that way), and the user-annotation events of
    the profiler's own steps span the whole cycle: both are kept out.
    """

    def __init__(self, device, iters: int):
        self.device = device
        self.iters = iters

    def __call__(self, fn, kernel: str | None = None,
                 whole_call: bool = False) -> dict:
        import torch
        if self.device.type == "cpu":
            fn()
            t0 = time.perf_counter()
            for _ in range(self.iters):
                fn()
            return {"sec_per_iter": (time.perf_counter() - t0) / self.iters,
                    "timed_by": "host clock", "iters": self.iters}
        fn()                                           # warm-up, build
        torch.cuda.synchronize(self.device)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(self.iters):
            fn()
        b.record()
        torch.cuda.synchronize(self.device)
        event_s = a.elapsed_time(b) / self.iters / 1e3
        traced_calls = 1 if whole_call else self.iters
        total_us, launches = self._device_time(fn, kernel, traced_calls)
        if whole_call:
            return {"sec_per_iter": event_s, "timed_by": "cuda events",
                    "iters": self.iters,
                    "device_busy_sec_per_iter": total_us / 1e6}
        rec = {"timed_by": "torch.profiler", "iters": self.iters,
               "event_sec_per_iter": event_s}
        if kernel is None:
            rec["sec_per_iter"] = total_us / traced_calls / 1e6
        else:
            rec["sec_per_iter"] = total_us / launches / 1e6
            rec["profiled_launches"] = launches
        return rec

    def _device_time(self, fn, kernel, calls: int):
        """(microseconds, events) of the device-side events of ``calls``
        calls of ``fn``: those whose name holds ``kernel``, or all.

        The tracer can lose a whole trace (seen once on the card: the
        matmul split scan's trace, taken right after the split kernel's
        benches, held no device event), so an empty trace is taken again,
        up to three traces in all, before this raises."""
        for _ in range(3):
            total_us, launches = self._trace(fn, kernel, calls)
            if total_us > 0.0 and launches:
                return total_us, launches
        raise RuntimeError(
            "the profiler trace holds no device time (3 traces)"
            + (f" for a kernel named {kernel!r}" if kernel else ""))

    def _trace(self, fn, kernel, calls: int):
        """(microseconds, events) of one profiler trace of ``calls``
        calls of ``fn``; (0.0, 0) where the trace holds none."""
        import torch
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile, schedule
        traced = []
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1, repeat=1),
                     on_trace_ready=lambda p: traced.append(
                         p.key_averages())) as prof:
            fn()
            torch.cuda.synchronize(self.device)
            prof.step()
            for _ in range(calls):
                fn()
            torch.cuda.synchronize(self.device)
            prof.step()
        if len(traced) != 1:
            raise RuntimeError(f"{len(traced)} profiler traces, wanted 1")
        total_us, launches = 0.0, 0
        for e in traced[0]:
            # device-side events only (an operator's row repeats the
            # time of the kernels it launched), and no annotation
            if e.device_type != DeviceType.CUDA or \
                    getattr(e, "is_user_annotation", False) or \
                    e.key.startswith("ProfilerStep"):
                continue
            if kernel is not None and kernel not in e.key:
                continue
            total_us += _self_device_us(e)
            launches += e.count
        return total_us, launches


def _self_device_us(event) -> float:
    us = getattr(event, "self_device_time_total", None)
    if us is None:                      # older PyTorch
        us = event.self_cuda_time_total
    return float(us)


def _emit(rec, out):
    line = json.dumps(rec)
    print(line, flush=True)
    if out:
        out.write(line + "\n")
        out.flush()


def _record(ctx, kernel, shape, times, **rates):
    ctx.emit({"kernel": kernel, "shape": shape, "device": ctx.device_name,
              **times, **rates})


class Context:
    """What a bench runs with. ``emit`` takes each record: printed and
    appended to ``out`` by default; a caller that wants the records
    instead replaces it."""

    def __init__(self, args, device, device_name, out, iters):
        self.args = args
        self.device = device
        self.device_name = device_name
        self.out = out
        self.timer = Timer(device, iters)
        self.rng = np.random.default_rng(args.seed)
        self.emit = lambda rec: _emit(rec, out)


# ---------------------------------------------------------------- benches

def bench_matmul(ctx):
    """bf16 matmul, the anchor: its rate against the card's peak says
    whether the timing method sees the device."""
    import torch
    n = ctx.args.matmul_n
    x = torch.from_numpy(
        (ctx.rng.standard_normal((n, n)) * 0.01).astype(np.float32)
    ).to(ctx.device).to(torch.bfloat16)
    y = x.clone()
    times = ctx.timer(lambda: torch.matmul(x, y))
    flops = 2.0 * n ** 3
    sec = times["sec_per_iter"]
    rates = {"tflops": flops / sec / 1e12}
    if ctx.device.type == "cuda":
        rates["share_of_h100_bf16_peak"] = flops / sec / H100_PEAK_BF16_FLOPS
    _record(ctx, "matmul_bf16_ref", f"{n}x{n}x{n}", times, **rates)


def _jump_inputs(ctx):
    """Random full rows of ``--jump-shape``; where ``ctx.args`` sets
    ``jump_bucketed`` (``tools.bench``), in tensors as wide as the
    workflow scorer's buckets, the pad codes after each row (1 in the
    query, 2 in the references)."""
    from ..align.device_jumpscore import _bucket, from_reference_inputs
    B, nq, nr = ctx.args.jump_shape
    bucketed = getattr(ctx.args, "jump_bucketed", False)
    wq, wr = (_bucket(nq), _bucket(nr)) if bucketed else (nq, nr)
    bases = np.frombuffer(b"ACGT", np.uint8).astype(np.int32)
    q = np.full((B, wq), 1, np.int32)
    r1 = np.full((B, wr), 2, np.int32)
    r2 = np.full((B, wr), 2, np.int32)
    q[:, :nq] = bases[ctx.rng.integers(0, 4, (B, nq))]
    r1[:, :nr] = bases[ctx.rng.integers(0, 4, (B, nr))]
    r2[:, :nr] = bases[ctx.rng.integers(0, 4, (B, nr))]
    ql = np.full(B, nq, np.int32)
    rl = np.full(B, nr, np.int32)
    t = from_reference_inputs(q, ql, r1, rl, r2, rl, ctx.device)
    shape = f"B={B},q={nq},refs=2x{nr}" + (
        f",bucket=({B},{wq},{wr})" if bucketed else "")
    return t, shape, float(B) * nq * (2 * nr)


def _jump_rates(ctx, cells, sec):
    return {"gcells_per_s": cells / sec / 1e9,
            "contigs_per_s": ctx.args.jump_shape[0] / sec}


def bench_jump(ctx):
    """The plain PyTorch jump DP (device_jumpscore.batched_jump_score)."""
    from ..align.device_jumpscore import batched_jump_score
    t, shape, cells = _jump_inputs(ctx)
    nq, nr = t[0].shape[1], t[2].shape[1]
    times = ctx.timer(lambda: batched_jump_score(
        *t, *JUMP_SCORES, JUMP, nq, nr, nr), whole_call=True)
    _record(ctx, "jump_score_dp", shape, times,
            **_jump_rates(ctx, cells, times["sec_per_iter"]))


def bench_jump_cuda(ctx):
    """The CUDA jump kernel, exact insert chain (csrc/jump_score.cu)."""
    from ..align.cuda_jumpscore import jump_score_cuda
    t, shape, cells = _jump_inputs(ctx)
    times = ctx.timer(lambda: jump_score_cuda(*t, *JUMP_SCORES, JUMP),
                      "jump_systolic_kernel")
    _record(ctx, "jump_score_cuda", shape, times,
            **_jump_rates(ctx, cells, times["sec_per_iter"]))


def bench_jump_cuda_bounded(ctx):
    """The CUDA bounded-chain kernel (csrc/jump_score_bounded.cu) alone,
    as the reference times its fast path; ``n_flagged`` of the B rows
    would rerun through the exact kernel, and
    ``rerun_event_sec_per_iter`` is the event time of a call of the
    whole bounded form with that rerun (both kernels, the gathers
    between them and the wait for the flag count)."""
    from ..align.cuda_jumpscore import (
        jump_score_bounded_cuda, jump_score_flagged_cuda,
    )
    t, shape, cells = _jump_inputs(ctx)
    for rounds in BOUNDED_ROUNDS:
        _best, flag = jump_score_flagged_cuda(*t, *JUMP_SCORES, JUMP, rounds)
        n_flagged = int((flag != 0).sum())
        times = ctx.timer(lambda: jump_score_flagged_cuda(
            *t, *JUMP_SCORES, JUMP, rounds), "jump_systolic_kernel")
        rerun = ctx.timer(lambda: jump_score_bounded_cuda(
            *t, *JUMP_SCORES, JUMP, rounds), whole_call=True)
        _record(ctx, f"jump_score_cuda_bounded_k{rounds}", shape, times,
                n_flagged=n_flagged,
                rerun_event_sec_per_iter=rerun["sec_per_iter"],
                **_jump_rates(ctx, cells, times["sec_per_iter"]))


def jumpalign_inputs(rng, B, Lq, Lr):
    """``make_inputs`` of benchmarks/bench_jumpalign.py: (queries, ref1,
    ref2) as str lists, each query a prefix from its ref1 and a suffix
    from its ref2."""
    bases = np.frombuffer(b"ACGT", np.uint8)
    ref1 = ["".join(map(chr, bases[rng.integers(0, 4, Lr)]))
            for _ in range(B)]
    ref2 = ["".join(map(chr, bases[rng.integers(0, 4, Lr)]))
            for _ in range(B)]
    queries = []
    for b in range(B):
        # contig straddles the junction: prefix from ref1, suffix ref2
        k = int(rng.integers(Lq // 4, 3 * Lq // 4))
        p1 = int(rng.integers(0, Lr - k))
        p2 = int(rng.integers(0, Lr - (Lq - k)))
        queries.append(ref1[b][p1:p1 + k] + ref2[b][p2:p2 + Lq - k])
    return queries, ref1, ref2


def jumpalign_arrays(queries, ref1, ref2):
    """The padded int32 arrays of the kernel's layout (query pad 1,
    reference pad 2), as wide as the longest of each."""
    from ..align.device_jumpscore import _pad_to
    B = len(queries)
    out = []
    for seqs, fill in ((queries, 1), (ref1, 2), (ref2, 2)):
        out += _pad_to([s.encode() for s in seqs], B,
                       max(len(s) for s in seqs), fill)
    return tuple(out)


def bench_jumpalign(ctx):
    """benchmarks/bench_jumpalign.py: the host's full jump aligner
    (``GlobalJumpAligner.align``, score and traceback, as the refiner
    runs it) on the first 32 contigs on one core, against the CUDA jump
    kernel on all B of them (on the CPU the plain form), at the same
    scores. Every one of the 32 host scores must equal the device's; on
    the card all B kernel scores must also equal the plain form's there.
    Two records, the reference's metrics."""
    from .. import native_core
    from ..align import cuda_jumpscore as cj
    from ..align.aligners import AlignmentScores, GlobalJumpAligner
    from ..align.device_jumpscore import (
        batched_jump_score, from_reference_inputs,
    )
    native_core.load()
    B, Lq, Lr = ctx.args.jumpalign_shape
    sc = AlignmentScores(*JUMPALIGN_SCORES)
    queries, ref1, ref2 = jumpalign_inputs(np.random.default_rng(
        ctx.args.seed), B, Lq, Lr)
    n_host = min(JUMPALIGN_HOST_CONTIGS, B)
    host = GlobalJumpAligner(sc, JUMP)
    t0 = time.perf_counter()
    host_scores = [host.align(queries[i].encode(), ref1[i].encode(),
                              ref2[i].encode()).score for i in range(n_host)]
    host_dt = (time.perf_counter() - t0) / n_host
    arrays = jumpalign_arrays(queries, ref1, ref2)
    t = from_reference_inputs(*arrays, ctx.device)
    nq, nr1, nr2 = (arrays[i].shape[1] for i in (0, 2, 4))
    plain = lambda: batched_jump_score(*t, *JUMPALIGN_SCORES, JUMP, nq, nr1,
                                       nr2)
    extra = {}
    if ctx.device.type == "cuda":
        fn = lambda: cj.jump_score_cuda(*t, *JUMPALIGN_SCORES, JUMP)
        got = fn()
        cj.raise_on_kernel_error()
        want = plain()
        same = int((got == want).sum())
        if same != B:
            raise AssertionError(f"jumpalign: the kernel differs from the "
                                 f"plain form on {B - same} of {B} rows")
        extra = {"form": "jump_score_cuda (csrc/jump_score.cu)",
                 "plain_parity": f"{same}/{B}",
                 "layout": list(cj.kernel_layout(B, nq))}
        times = ctx.timer(fn, "jump_systolic_kernel")
    else:
        fn = plain
        got = fn()
        extra = {"form": "batched_jump_score (the plain PyTorch form)"}
        times = ctx.timer(fn, whole_call=True)
    dev_scores = got.cpu().numpy()
    same = sum(int(dev_scores[i]) == host_scores[i] for i in range(n_host))
    if same != n_host:
        raise AssertionError(f"jumpalign: device/host score mismatch on "
                             f"{n_host - same} of {n_host} contigs")
    cells = Lq * 2 * Lr
    dev_dt = times["sec_per_iter"] / B
    ctx.emit({"kernel": "jumpalign", "metric": "jump_align_throughput_host",
              "shape": f"B={n_host},q={Lq},refs=2x{Lr}", "device": "host",
              "form": "GlobalJumpAligner.align (score and traceback), one "
                      "core",
              "sec_per_iter": host_dt * n_host, "timed_by": "host clock",
              "contigs_per_s": 1.0 / host_dt,
              "gcells_per_s": cells / host_dt / 1e9, "batch": 1})
    ctx.emit({"kernel": "jumpalign", "metric": "jump_align_throughput_device",
              "shape": f"B={B},q={Lq},refs=2x{Lr}",
              "device": ctx.device_name, **extra, **times,
              "host_parity": f"{same}/{n_host}",
              "contigs_per_s": 1.0 / dev_dt,
              "gcells_per_s": cells / dev_dt / 1e9, "batch": B})


# (B, nq, nr): the bucket of the WGS-shaped workflow run, the bench
# bucket, a wide batch of short contigs, the last tier and the first
# beyond it
LAYOUT_BUCKETS = ((8, 256, 1024), (64, 512, 1024), (256, 128, 256),
                  (8, 4096, 4096), (8, 8192, 8192))


def _event_ms(fn, calls: int, repeats: int) -> dict:
    """CUDA-event time of one call over ``repeats`` loops of ``calls``
    calls after a warm-up call: the least (``ms``) and every loop's
    (``ms_loops``). Beside each loop, what tells a slow loop's cause:
    the host's time to enqueue its calls (``host_ms_loops``; near the
    event time where the host held the card back) and the polls a
    call's warps made while they waited for the warp below
    (``polls_loops``: boundary words, tails)."""
    import torch
    from ..align import cuda_jumpscore as cj
    fn()
    torch.cuda.synchronize()
    cj.raise_on_kernel_error()
    loops, host, polls = [], [], []
    for _ in range(repeats):
        before = dict(cj.WAIT_POLLS)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        host.append((time.perf_counter() - t0) * 1e3 / calls)
        b.record()
        torch.cuda.synchronize()
        loops.append(a.elapsed_time(b) / calls)
        cj.raise_on_kernel_error()
        polls.append([(cj.WAIT_POLLS[k] - before[k]) / calls
                      for k in ("boundary", "tail")])
    return {"ms": min(loops), "ms_loops": loops, "host_ms_loops": host,
            "polls_loops": polls}


def bench_jump_layouts(ctx):
    """Every layout of the CUDA jump kernels at the scorer's buckets, on
    rows of full length (the slowest a bucket can be), each checked
    against the kernel's own choice. One record per bucket: ``ms`` by
    lanes per thread (0: the kernel's choice) with the warps a row takes
    at it, for the exact kernel (``layouts``) and the bounded one at
    each of BOUNDED_ROUNDS (``bounded_k<K>``, with the shared memory a
    warp takes; layouts whose ring does not fit a block are left
    out). ``--layout-bucket`` keeps the sweep to one bucket and
    ``--layout-loops`` sets the timed loops a layout."""
    import torch
    from ..align import cuda_jumpscore as cj
    from ..align.device_jumpscore import from_reference_inputs
    bases = np.frombuffer(b"ACGT", np.uint8).astype(np.int32)
    loops = ctx.args.layout_loops
    for B, nq, nr in ([ctx.args.layout_bucket] if ctx.args.layout_bucket
                      else LAYOUT_BUCKETS):
        q = bases[ctx.rng.integers(0, 4, (B, nq))]
        r1 = bases[ctx.rng.integers(0, 4, (B, nr))]
        r2 = bases[ctx.rng.integers(0, 4, (B, nr))]
        ql = np.full(B, nq, np.int32)
        rl = np.full(B, nr, np.int32)
        t = from_reference_inputs(q, ql, r1, rl, r2, rl, ctx.device)
        calls = 3 if nq > 1024 else 10
        want = cj.jump_score_cuda(*t, *JUMP_SCORES, JUMP)
        fit = [x for x in cj.LANE_CHOICES
               if cj.kernel_layout(B, nq, x)[1] <= cj.max_strips()]
        rows = []
        # lanes per thread, 0: the kernel's own choice
        for lanes in (0, *fit):
            fn = lambda: cj.jump_score_cuda(*t, *JUMP_SCORES, JUMP,
                                            lanes=lanes)
            if not torch.equal(fn(), want):
                raise AssertionError(f"{lanes} lanes a thread differ at "
                                     f"{(B, nq, nr)}")
            rows.append({"lanes": lanes,
                         "warps_per_row": cj.kernel_layout(B, nq, lanes)[1],
                         **_event_ms(fn, calls, loops)})
        bounded = {}
        for rounds in BOUNDED_ROUNDS:
            want_b, want_f = cj.jump_score_flagged_cuda(
                *t, *JUMP_SCORES, JUMP, rounds)
            bounded[f"bounded_k{rounds}"] = brows = []
            for lanes in (0, *fit):
                L, warps, smem = cj.bounded_kernel_layout(B, nq, rounds,
                                                          lanes)
                if L == 0 or smem > cj.max_shared_bytes():
                    continue
                fn = lambda: cj.jump_score_flagged_cuda(
                    *t, *JUMP_SCORES, JUMP, rounds, lanes=lanes)
                got_b, got_f = fn()
                if not (torch.equal(got_b, want_b)
                        and torch.equal(got_f, want_f)):
                    raise AssertionError(
                        f"bounded, {lanes} lanes a thread differ at "
                        f"{(B, nq, nr)}, K={rounds}")
                brows.append({"lanes": lanes, "lanes_used": L,
                              "warps_per_row": warps, "shared_bytes": smem,
                              **_event_ms(fn, calls, loops)})
        cj.raise_on_kernel_error()
        _record(ctx, "jump_score_cuda_layouts", f"B={B},q={nq},refs=2x{nr}",
                {"timed_by": "cuda events", "iters": calls},
                auto_layout=list(cj.kernel_layout(B, nq)), layouts=rows,
                **bounded)


def _split_inputs(ctx):
    import torch
    from ..align.device_splitscore import make_luts
    B, T, L = ctx.args.split_shape
    rng = ctx.rng
    bases = np.frombuffer(b"ACGT", np.uint8)
    reads = bases[rng.integers(0, 4, (B, L))]
    quals = rng.integers(20, 40, (B, L)).astype(np.uint8)
    targets = bases[rng.integers(0, 4, (B, T))]
    bp_beg = np.full(B, T // 2 - 5, np.int32)
    bp_end = np.full(B, T // 2 + 5, np.int32)
    read_len = np.full(B, L, np.int32)
    target_len = np.full(B, T, np.int32)
    n_scan = int((bp_end - np.maximum(0, bp_beg - read_len + 2)).max()) + 1
    t = [torch.from_numpy(np.ascontiguousarray(a)).to(ctx.device)
         for a in (reads, quals, targets, bp_beg, bp_end, read_len,
                   target_len)]
    luts = [torch.from_numpy(a).to(ctx.device) for a in make_luts(0.0)]
    return (*t, FLANK, *luts, n_scan), \
        f"B={B},T={T},L={L},S={n_scan}", float(B) * n_scan * L


def _split_rates(rows, terms, sec):
    return {"gterms_per_s": terms / sec / 1e9,
            "split_scans_per_s": rows / sec}


def bench_split_exact(ctx):
    """The plain PyTorch exact split scan
    (device_splitscore.batched_split_score)."""
    from ..align.device_splitscore import batched_split_score
    args, shape, terms = _split_inputs(ctx)
    times = ctx.timer(lambda: batched_split_score(*args), whole_call=True)
    _record(ctx, "split_scan_exact", shape, times,
            **_split_rates(ctx.args.split_shape[0], terms,
                           times["sec_per_iter"]))


def bench_split_cuda(ctx):
    """The CUDA split-scan kernel (csrc/split_score.cu)."""
    from ..align.cuda_splitscore import split_score_cuda
    args, shape, terms = _split_inputs(ctx)
    times = ctx.timer(lambda: split_score_cuda(*args), "split_score_kernel")
    _record(ctx, "split_scan_cuda", shape, times,
            **_split_rates(ctx.args.split_shape[0], terms,
                           times["sec_per_iter"]))


def bench_split_cuda_factored(ctx):
    """The CUDA split-scan kernel on the factored layout: half as many
    reads as ``--split-shape`` has rows, each against the same two
    targets, so as many (read, target) pairs."""
    from ..align.cuda_splitscore import split_score_factored_cuda
    (reads, quals, targets, beg, end, rl, tl, flank, lm, lx, n_scan), \
        _shape, terms = _split_inputs(ctx)
    B, T, L = ctx.args.split_shape
    n = max(1, B // 2)
    t = targets[:2].shape[0]
    args = (reads[:n], quals[:n], rl[:n], targets[:t], beg[:t], end[:t],
            tl[:t], flank, lm, lx, n_scan)
    times = ctx.timer(lambda: split_score_factored_cuda(*args),
                      "split_score_kernel")
    _record(ctx, "split_scan_cuda_factored",
            f"n={n},t={t},T={T},L={L},S={n_scan}", times,
            **_split_rates(n * t, terms * n * t / B, times["sec_per_iter"]))


def _acgtn_pairs(reads, targets):
    """(n, t) bool: the (read, target) pairs whose bytes are all A, C,
    G, T, N or pad, the pairs the matmul form can encode."""
    import torch
    from ..scoring.device_scan import _ACGTN_PAD
    ok = torch.tensor(sorted(_ACGTN_PAD), dtype=reads.dtype,
                      device=reads.device)
    return (torch.isin(reads, ok).all(dim=1)[:, None]
            & torch.isin(targets, ok).all(dim=1)[None, :])


def mxu_on_k3_inputs(args):
    """K3's factored call ``args`` (``split_score_factored``'s arguments)
    through the matmul form (``device_splitscore_mxu``: two ``torch.bmm``
    a call) on the same tensors, every position of the targets' width
    scanned. Returns (a function that makes the call, a function from
    K3's (best, pos) to the largest absolute difference of the best
    scores over the pairs both forms score (finite in both, bytes the
    matmul form encodes) and the positions that differ there)."""
    import torch
    from ..align.device_splitscore_mxu import from_factored, junction_split_score
    reads, quals, read_len, targets, beg, end, tl, flank, lm, lx, _n = args
    mxu_args = (*from_factored(reads, quals, read_len, targets, beg, end, tl),
                flank, lm, lx, targets.shape[1])
    call = lambda: junction_split_score(*mxu_args)

    def diff(best, pos):
        mb, mp = (a.t() for a in call())
        both = (_acgtn_pairs(reads, targets) & torch.isfinite(best)
                & torch.isfinite(mb))
        err = float((mb - best).abs()[both].max()) if both.any() else 0.0
        return err, int((mp != pos)[both].sum()), int(both.sum())
    return call, diff


def bench_split_mxu_k3(ctx):
    """The library yardstick of the split kernel: the matmul form
    (``device_splitscore_mxu.junction_split_score``, two ``torch.bmm``)
    on the inputs of ``split_cuda_factored`` (half of ``--split-shape``'s
    rows as reads, each against the same two targets), beside K3 on
    them; profiler device time of each, and the matmul form's largest
    difference from K3. On the cpu both plain forms on the host clock."""
    from ..align.device_splitscore import split_score_factored
    (reads, quals, targets, beg, end, rl, tl, flank, lm, lx, n_scan), \
        _shape, terms = _split_inputs(ctx)
    B, T, L = ctx.args.split_shape
    n, t = max(1, B // 2), min(2, B)
    args = (reads[:n], quals[:n], rl[:n], targets[:t], beg[:t], end[:t],
            tl[:t], flank, lm, lx, n_scan)
    k3 = lambda: split_score_factored(*args)
    mxu, diff = mxu_on_k3_inputs(args)
    err, pos_differ, pairs = diff(*k3())
    cuda = ctx.device.type == "cuda"
    k3_times = ctx.timer(k3, "split_score_kernel" if cuda else None)
    times = ctx.timer(mxu)
    _record(ctx, "split_scan_mxu_on_k3_inputs",
            f"n={n},t={t},T={T},L={L},S={T}", times,
            k3_sec_per_iter=k3_times["sec_per_iter"],
            max_abs_diff_from_k3=err, positions_differ=pos_differ,
            pairs_compared=pairs,
            **_split_rates(n * t, terms * n * t / B, times["sec_per_iter"]))


def _router_inputs(ctx):
    """A typical call of the split router: ``--router-shape`` reads of
    101-150 bases against as many junction targets of 400 + 20k bases,
    from ``ctx.rng``: (batch, read indices, qscore converter, targets,
    breakpoint ranges)."""
    from types import SimpleNamespace

    from .. import native_core
    from ..scoring.evidence import QscoreSnp
    native_core.load()
    n, t = ctx.args.router_shape
    rng = ctx.rng
    bases = np.frombuffer(b"ACGT", np.uint8)
    lens = rng.integers(101, 151, n)
    off = np.zeros(n + 1, np.int64)
    off[1:] = np.cumsum(lens)
    batch = SimpleNamespace(
        seq=bases[rng.integers(0, 4, off[-1])],
        qual=rng.integers(2, 41, off[-1]).astype(np.uint8),
        seq_off=off, qual_off=off.copy(), n=n)
    targets = [bases[rng.integers(0, 4, 400 + 20 * k)] for k in range(t)]
    ranges = [(len(tg) // 2 - 3, len(tg) // 2 + 2) for tg in targets]
    return batch, np.arange(n, dtype=np.int64), QscoreSnp(1e-3), targets, \
        ranges


def bench_scan_router(ctx):
    """The exact route of the split-scan router as the scorer calls it:
    ``DeviceScanContext.scan_multi`` on one breakend's reads and junction
    targets, from numpy in to numpy out. Host clock, median of the timed
    calls; the native host scan of the same call beside it."""
    from ..scoring.device_scan import DeviceScanContext
    from ..scoring.evidence import split_read_scan_multi
    n, t = ctx.args.router_shape
    batch, idx, qconv, targets, ranges = _router_inputs(ctx)
    scan = DeviceScanContext(device=ctx.device)
    want = split_read_scan_multi(FLANK, batch, idx, qconv, targets, ranges)
    got = scan.scan_multi(FLANK, batch, idx, qconv, targets, ranges)
    if not (np.array_equal(got[0], want[0])
            and np.array_equal(got[1], want[1])):
        raise AssertionError("scan_multi != the native host scan")

    def median_s(fn):
        times = []
        for _ in range(10 * ctx.timer.iters):
            t0 = time.perf_counter()
            fn()
            times.append(time.perf_counter() - t0)
        return float(np.median(times))

    sec = median_s(lambda: scan.scan_multi(FLANK, batch, idx, qconv,
                                           targets, ranges))
    native = median_s(lambda: split_read_scan_multi(FLANK, batch, idx, qconv,
                                                    targets, ranges))
    _record(ctx, "scan_router_exact", f"n={n},t={t},L=101-150,T=400+",
            {"sec_per_iter": sec, "timed_by": "host clock",
             "iters": 10 * ctx.timer.iters},
            native_scan_sec_per_iter=native, split_scans_per_s=n * t / sec)


def _aging_trace(calls, warm: bool) -> dict:
    """One torch.profiler (CUPTI) trace of ``calls()``: the split
    kernel's launches by its wrapper, its kernel records in the trace,
    the runtime's launch calls recorded, and the earliest start of a
    kept kernel record less that of its own launch call (by correlation
    id; a kernel cannot start before it is launched). ``warm``: the
    window opens one profiler step after CUPTI was switched on, a kernel
    run and waited for in that step (the Timer's cure for a cold
    trace)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    from ..align import cuda_splitscore as cs
    before = cs.KERNEL_LAUNCHES["split_score"]
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    if warm:
        with profile(activities=acts, schedule=schedule(
                wait=0, warmup=1, active=1, repeat=1)) as prof:
            torch.ones(1, device="cuda").add_(1)
            torch.cuda.synchronize()
            prof.step()
            calls()
            torch.cuda.synchronize()
            prof.step()
    else:
        with profile(activities=acts) as prof:
            calls()
            torch.cuda.synchronize()
    events = prof.profiler.kineto_results.events()
    kernels = {e.correlation_id(): e for e in events
               if e.device_type() == DeviceType.CUDA
               and kernel_of(e.name()) == "split_score"}
    launch_calls = [e for e in events if e.device_type() == DeviceType.CPU
                    and "LaunchKernel" in e.name()]
    lead = [kernels[e.correlation_id()].start_ns() - e.start_ns()
            for e in launch_calls if e.correlation_id() in kernels]
    launches = cs.KERNEL_LAUNCHES["split_score"] - before
    return {"trace": "warm" if warm else "cold", "launches": launches,
            "kernel_records": len(kernels),
            "runtime_launch_calls": len(launch_calls),
            "lost": launches - len(kernels),
            "earliest_record_minus_its_call_us": (min(lead) / 1e3 if lead
                                                  else None)}


def bench_trace_aging(ctx):
    """The profiler's lost launches, reproduced: 12 calls of the split
    router (one split-kernel launch each) in a trace, cold and warm
    (``_aging_trace``), now and every 40 s until ``--aging-s`` seconds
    after this process's first trace. Beside it a child started at the
    same time (unless ``--aging-s`` is 0) whose first trace comes only
    after ``--aging-s`` seconds: as old a process, as young a trace. A
    record a trace, with its process and its seconds since that
    process's first trace."""
    import subprocess

    from ..scoring.device_scan import DeviceScanContext
    child = None
    if ctx.args.aging_s:
        child = subprocess.Popen(
            [sys.executable, "-m", "manta_tpu_torch.tools.device_timing",
             "--kernel", "trace_aging", "--aging-s", "0",
             "--first-trace-after-s", str(ctx.args.aging_s)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            cwd=REPO)
    batch, idx, qconv, targets, ranges = _router_inputs(ctx)
    scan = DeviceScanContext(device=ctx.device)

    def calls():
        for _ in range(12):
            scan.scan_multi(FLANK, batch, idx, qconv, targets, ranges)

    calls()
    delay = ctx.args.first_trace_after_s
    time.sleep(delay)
    first = time.time()
    age = 0
    while True:
        for warm in (False, True):
            rec = _aging_trace(calls, warm)
            ctx.emit({"kernel": "trace_aging", "device": ctx.device_name,
                      "process": (f"first trace {delay} s after its start"
                                  if delay else "this"),
                      "since_first_trace_s": round(time.time() - first, 1),
                      **rec})
        age += 40
        if age > ctx.args.aging_s:
            break
        time.sleep(max(0.0, first + age - time.time()))
    if child is not None:
        out, err = child.communicate()
        if child.returncode != 0:
            raise RuntimeError(f"the control child failed:\n{err}")
        for ln in out.splitlines():
            rec = json.loads(ln)
            if rec.get("kernel") == "trace_aging":
                ctx.emit(rec)


def bench_trace_span(ctx):
    """A phase-2 worker's trace (``parallel/worker_trace``) held open as
    long as a whole-genome worker's phase 2: this process arms itself as
    a worker and makes its first device call (its context, then the
    CUDA-only profiler, as in a worker), then calls the split router
    ``--span-calls`` times spread evenly over ``--span-s`` seconds and
    writes its trace as a worker does at exit. One router call before
    the span takes what a first call costs once (the kernel's module
    loaded into the context, the first copies), so that the span's first
    tenth holds calls like the others. The record: the wrapper's
    launches against the trace's kernel records, both by tenth of the
    span, so that records lost the later the more (``trace_aging``)
    show in the last tenths, and the launch and record before it."""
    import tempfile

    import torch

    from ..parallel import worker_trace
    from ..scoring.device_scan import DeviceScanContext
    batch, idx, qconv, targets, ranges = _router_inputs(ctx)
    n, span = ctx.args.span_calls, ctx.args.span_s
    launched = [0] * 10
    with tempfile.TemporaryDirectory() as d:
        worker_trace.arm(d)
        worker_trace.enter_phase2_worker(0)
        scan = DeviceScanContext(device=ctx.device)
        # the kernel built (a workflow's parent builds it before the
        # fork), the context made and the profiler started (seconds)
        # before the span: the router's first call finds them ready
        from ..align import cuda_splitscore
        cuda_splitscore._lib()
        worker_trace.device_call(ctx.device)
        scan.scan_multi(FLANK, batch, idx, qconv, targets, ranges)
        torch.cuda.synchronize(ctx.device)
        # a record is the call's before the span if it starts before
        # the middle of the 0.2 s between them: clock skews below 0.1 s
        # put no record on the wrong side
        boundary = time.time() + 0.1
        t0 = boundary + 0.1
        time.sleep(0.2)
        for i in range(n):
            time.sleep(max(0.0, t0 + span * i / n - time.time()))
            launched[min(9, int((time.time() - t0) / span * 10))] += 1
            scan.scan_multi(FLANK, batch, idx, qconv, targets, ranges)
        worker_trace.bin_finished()
        worker_trace._write()
        worker_trace.disarm()
        (trace,) = read_worker_traces(d)
    kept, before = [0] * 10, 0
    for name, start, _dur in trace["events"] or ():
        if kernel_of(name) != "split_score":
            continue
        if start / 1e9 < boundary:
            before += 1
        else:
            kept[min(9, max(0, int((start / 1e9 - t0) / span * 10)))] += 1
    launches = trace["counts"]["launches"]["split_score"]
    records = before + sum(kept)
    ctx.emit({"kernel": "trace_span", "device": ctx.device_name,
              "span_s": span, "launches": launches,
              "kernel_records": records, "lost": launches - records,
              "records_before_span": before,
              "launches_by_tenth": launched, "records_by_tenth": kept,
              "clock": trace["clock"],
              "trace_start_s": _span_s(trace, "trace.start")})
    if launches != records:
        raise AssertionError(f"the trace kept {records} of {launches} "
                             "launches")


def bench_split_mxu(ctx):
    """The matmul split scan over junction groups
    (device_splitscore_mxu.junction_split_score)."""
    import torch
    from ..align.device_splitscore import make_luts
    from ..align.device_splitscore_mxu import junction_split_score
    G, R, T, L = ctx.args.mxu_shape
    rng = ctx.rng
    bases = np.frombuffer(b"ACGT", np.uint8)
    reads = bases[rng.integers(0, 4, (G, R, L))]
    quals = rng.integers(20, 40, (G, R, L)).astype(np.uint8)
    targets = bases[rng.integers(0, 4, (G, T))]
    bp_beg = np.full(G, T // 2 - 5, np.int32)
    bp_end = np.full(G, T // 2 + 5, np.int32)
    read_len = np.full((G, R), L, np.int32)
    target_len = np.full(G, T, np.int32)
    s0 = np.maximum(0, bp_beg - L + 2).astype(np.int32)
    n_scan = int((np.minimum(bp_end, target_len - L) - s0).max()) + 1
    t = [torch.from_numpy(np.ascontiguousarray(a)).to(ctx.device)
         for a in (reads, quals, targets, s0, bp_beg, bp_end, read_len,
                   target_len)]
    luts = [torch.from_numpy(a).to(ctx.device) for a in make_luts(0.0)]
    times = ctx.timer(lambda: junction_split_score(*t, FLANK, *luts, n_scan),
                      whole_call=True)
    terms = float(G) * R * n_scan * L
    # two products (hi, lo) of (R x 5L) @ (5L x S) per group
    flops = 2 * 2.0 * G * R * 5 * L * n_scan
    sec = times["sec_per_iter"]
    _record(ctx, "split_scan_mxu", f"G={G},R={R},T={T},L={L},S={n_scan}",
            times, matmul_tflops=flops / sec / 1e12,
            **_split_rates(G * R, terms, sec))


# ------------------------------------------------------- workflow mode

# the card's published peaks (NVIDIA's data sheet, H100 SXM, 700 W):
# device memory rate and float32 outside the tensor cores; and its rate
# of int32 adds and maxima, 64 lanes a clock on each of 132 SMs at the
# 1.98 GHz boost clock (chip_smoke.py holds the same three)
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = 67e12
PEAK_INT32_OPS_PER_S = 132 * 64 * 1.98e9
# kernel -> (operations a useful unit, the unit): chip_smoke.py's counts,
# int32 operations a jump-DP cell (exact and bounded chain) and float32
# ones a split-scan term
KERNEL_OPS = {"jump_score": (20, "cells"), "jump_score_bounded": (29, "cells"),
              "split_score": (6, "terms")}
WORKLOADS = ("wgs", "high-span", "rna", "joint", "tumor")


def kernel_of(event_name: str) -> str | None:
    """The port's kernel a profiler event names, or None. Both jump
    kernels are instances of jump_systolic_kernel<L, kBounded, kW>, told
    apart by kBounded: "false"/"true" demangled, Lb0/Lb1 mangled."""
    if "split_score_kernel" in event_name:
        return "split_score"
    if "jump_systolic_kernel" not in event_name:
        return None
    m = re.search(r"jump_systolic_kernel<\s*\d+\s*,\s*(true|false)"
                  r"|jump_systolic_kernelILi\d+ELb([01])", event_name)
    bounded = m is not None and (m.group(1) == "true" or m.group(2) == "1")
    return "jump_score_bounded" if bounded else "jump_score"


def profile_workflow(run, device) -> dict:
    """Call ``run()``, a workflow at -j 1 in this process (forked
    workers would escape the trace), and return what the kernels did in
    it: the host-side counts as deltas over the run and, on a CUDA
    device, the device events of a torch.profiler (CUPTI) trace around
    the whole call as (name, start us, duration us), sorted by start;
    None on the cpu. Start CUDA and load the kernels before: their
    start-up would otherwise fall into the run's phase 2. A process
    whose first trace was minutes ago can lose launches from a trace
    (``--kernel trace_aging``): the launches in the trace are held
    against the wrapper's count, never assumed."""
    import torch

    from ..parallel.worker_trace import counts
    before = counts()
    events = None
    if torch.device(device).type == "cuda":
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            run()
            torch.cuda.synchronize()
        events = sorted(((e.name, e.time_range.start,
                          e.time_range.end - e.time_range.start)
                         for e in prof.events()
                         if e.device_type == DeviceType.CUDA),
                        key=lambda e: e[1])
    else:
        run()
    after = counts()

    def minus(a, b):
        if isinstance(a, dict):
            return {k: minus(a[k], b[k]) for k in a}
        if isinstance(a, list):         # per sample; b may list fewer
            return [x - (b[i] if i < len(b) else 0) for i, x in enumerate(a)]
        return a - b
    return {"counts": minus(after, before), "events": events}


def phase2_window(run_dir: str) -> tuple[float, float]:
    """Phase 2 (candidates, assembly, scoring) of the run's
    workspace/workflow_log.txt, from its first line to the line that
    counts the processed graph edges, as seconds since the epoch (the
    log's local wall-clock stamps, to the millisecond)."""
    import datetime
    at = {}
    with open(os.path.join(run_dir, "workspace", "workflow_log.txt")) as f:
        for ln in f:
            for key in ("generating and scoring", "processed "):
                if ln[26:].startswith(key) and key not in at:
                    at[key] = datetime.datetime.fromisoformat(
                        ln[1:24]).timestamp()
    return at["generating and scoring"], at["processed "]


def phase2_wall(run_dir: str) -> float:
    """Seconds of phase 2 from the run's workspace/workflow_log.txt."""
    start, end = phase2_window(run_dir)
    return round(end - start, 3)


def _copy_way(name: str) -> str | None:
    """"h2d" or "d2h" for a profiler event that copies that way."""
    low = name.lower()
    if "memcpy" not in low:
        return None
    return "h2d" if "htod" in low else "d2h" if "dtoh" in low else None


def _busy_us(events) -> float:
    """Time the device was busy: the union of the events' intervals."""
    busy, end = 0.0, float("-inf")
    for _name, start, dur, *_pid in events:
        stop = start + dur
        if stop > end:
            busy += stop - max(start, end)
            end = stop
    return busy


def workflow_records(reading: dict, phase2_s: float, device_name: str,
                     workload: str, mode: str) -> list[dict]:
    """One record a kernel and one for phase 2 from ``profile_workflow``'s
    ``reading`` (or ``merge_worker_traces``', whose events carry their
    process as a fourth item: copies are given to launches within a
    process, one stream each). A kernel's record: its launches by the
    wrapper and in the trace, the calls of the seam that reaches it and
    their wall, device ms in all and a launch, the work counters, the
    bound (the larger of the bytes over the memory rate and the useful
    work's operations over the float32 rate; for the jump kernels also
    over the int32 rate) and the share of it reached, and the copies on
    its side of the trace: host-to-device ones before each launch, the
    device-to-host one after. On the cpu the device fields are None.
    The phase-2 record: the wall, the device's busy time (the union of
    every device event: kernels, copies, memsets; phases 0 and 1 and
    the final sort put nothing on the device) and its share of the
    wall, and the events by name."""
    counts, events = reading["counts"], reading["events"]
    on_card = events is not None
    per = {k: {"ms": 0.0, "n": 0, "h2d": [0, 0.0], "d2h": [0, 0.0]}
           for k in KERNEL_OPS}
    by_name: dict[str, list] = {}
    # process -> (copies to the card waiting for a launch, last kernel)
    stream: dict = {}
    for name, start, dur, *pid in events or ():
        pending, last = stream.setdefault(tuple(pid), ([], [None]))
        entry = by_name.setdefault(name, [0, 0.0])
        entry[0] += 1
        entry[1] += dur / 1e3
        way, kernel = _copy_way(name), kernel_of(name)
        if kernel is not None:
            per[kernel]["ms"] += dur / 1e3
            per[kernel]["n"] += 1
            for d in pending:
                per[kernel]["h2d"][0] += 1
                per[kernel]["h2d"][1] += d / 1e3
            pending.clear()
            last[0] = kernel
        elif way == "h2d":
            pending.append(dur)
        elif way == "d2h" and last[0] is not None:
            per[last[0]]["d2h"][0] += 1
            per[last[0]]["d2h"][1] += dur / 1e3
    out = []
    for kernel, (ops_per_unit, unit) in KERNEL_OPS.items():
        work = counts["work"][kernel]
        p = per[kernel]
        t_bytes = work["bytes"] / PEAK_BYTES_PER_S * 1e3
        t_ops = ops_per_unit * work["useful"] / PEAK_OPS_PER_S * 1e3
        rec = {"kernel": kernel, "metric": "workflow_kernel",
               "workload": workload, "mode": mode, "device": device_name,
               "calls": counts["calls"][kernel],
               "launches_wrapper": counts["launches"][kernel],
               "launches_profiler": p["n"] if on_card else None,
               "path_wall_s": counts["wall"][kernel],
               "device_ms": p["ms"] if on_card else None,
               "device_ms_per_launch": (p["ms"] / p["n"] if on_card
                                        and p["n"] else None),
               "work_unit": unit, "useful_work": work["useful"],
               "padded_work": work["padded"], "bytes": work["bytes"],
               "ops": ops_per_unit * work["useful"],
               "bound_ms": max(t_bytes, t_ops),
               "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
        if kernel != "split_score":
            rec["bound_ms_int32"] = max(
                t_bytes, ops_per_unit * work["useful"]
                / PEAK_INT32_OPS_PER_S * 1e3)
        for key in [k for k in rec if k.startswith("bound_ms")]:
            share = key.replace("bound_ms", "share_of_bound")
            rec[share] = (rec[key] / p["ms"] if on_card and p["ms"]
                          else None)
        for way in ("h2d", "d2h"):
            rec[way] = {"count": p[way][0] if on_card else None,
                        "device_ms": p[way][1] if on_card else None}
        out.append(rec)
    busy_ms = _busy_us(events) / 1e3 if on_card else None
    out.append({"metric": "workflow_phase2", "workload": workload,
                "mode": mode, "device": device_name,
                "phase2_wall_s": phase2_s, "device_busy_ms": busy_ms,
                "busy_share": (busy_ms / (phase2_s * 1e3) if on_card
                               and phase2_s > 0 else None),
                "device_events": ({name: {"count": n, "device_ms": ms}
                                   for name, (n, ms) in sorted(
                                       by_name.items())}
                                  if on_card else None)})
    return out


def workflow_inputs(workload: str, prefix: str | None):
    """(normal BAMs, tumor BAMs, reference, run_workflow keywords) of a
    workload: germline on a WGS-shaped BAM (``wgs``, tools.wgs_workload),
    joint germline on every sample of a ``tools.wgs_workload --samples
    K`` prefix (``joint``: P.s0.bam, P.s1.bam, ...), tumor-only on a
    WGS-shaped BAM (``tumor``), a tumor-only exome run of the high-span
    BAM (``high-span``, tools.stress_workload) or RNA fusion mode on a
    tumor BAM (``rna``); ``prefix``.bam and ``prefix``.fa, for RNA by
    default the demo tumor BAM and the demo reference."""
    if prefix is None:
        if workload != "rna":
            raise ValueError(f"--workload {workload} needs --prefix")
        from .stress_workload import TUMOR, ensure_demo_fasta
        return [], [TUMOR], ensure_demo_fasta(), {"is_rna": True}
    bam, fa = prefix + ".bam", prefix + ".fa"
    if workload == "wgs":
        return [bam], [], fa, {}
    if workload == "joint":
        bams = []
        while os.path.exists(f"{prefix}.s{len(bams)}.bam"):
            bams.append(f"{prefix}.s{len(bams)}.bam")
        if not bams:
            raise FileNotFoundError(f"no {prefix}.s0.bam: --workload joint "
                                    "takes a tools.wgs_workload --samples "
                                    "K prefix")
        return bams, [], fa, {}
    if workload == "tumor":
        return [], [bam], fa, {}
    return [], [bam], fa, ({"is_exome": True} if workload == "high-span"
                           else {"is_rna": True})


def read_worker_traces(directory: str) -> list[dict]:
    """The phase-2 workers' trace files in ``directory``
    (``parallel/worker_trace``), in the order of their pids."""
    import glob
    paths = glob.glob(os.path.join(directory, "device_trace.*.json"))
    traces = []
    for path in paths:
        with open(path) as f:
            traces.append(json.load(f))
    return sorted(traces, key=lambda t: t["pid"])


# the phase-2 window's stamps are cut to the millisecond
WINDOW_SLACK_NS = 2_000_000


def merge_worker_traces(traces: list[dict],
                        window: tuple[float, float]) -> dict:
    """One reading for ``workflow_records`` from the trace files of a
    -j N run's phase-2 workers: the counts summed over the workers whose
    bin finished (a worker that died or was retried counts nowhere), and
    their device events (None when they scored on the cpu) as (name,
    start us after phase 2's start, duration us, pid), sorted by start,
    every worker on the host's wall clock. ``window`` is phase 2 as
    seconds since the epoch (``phase2_window``): events outside it are
    counted, not kept. Adds ``workers`` (finished files),
    ``worker_files``, ``workers_launched`` (a kernel launched),
    ``cuda_startup_s`` (the workers' context start-ups), ``clocks``,
    ``events_outside_phase2`` and ``overlapping_kernels`` (kernels of one
    process that overlap in time: one stream cannot, a clock can)."""
    from ..parallel.worker_trace import zero_counts
    t0 = int(round(window[0] * 1e3)) * 1_000_000
    t1 = int(round(window[1] * 1e3)) * 1_000_000
    done = [t for t in traces if t["finished"]]
    counts = zero_counts()
    for t in done:
        for key, per in t["counts"].items():
            for kernel, v in per.items():
                if isinstance(v, dict):
                    for k, n in v.items():
                        counts[key][kernel][k] += n
                elif isinstance(v, list):       # per sample
                    acc = counts[key][kernel]
                    acc.extend([0] * (len(v) - len(acc)))
                    for i, n in enumerate(v):
                        acc[i] += n
                else:
                    counts[key][kernel] += v
    on_card = any(t["events"] is not None for t in done)
    events, outside, overlaps = [], 0, 0
    for t in done:
        end = None
        for name, start, dur in t["events"] or ():
            if kernel_of(name) is not None:
                if end is not None and start < end:
                    overlaps += 1
                end = start + dur if end is None else max(end, start + dur)
            if start < t0 - WINDOW_SLACK_NS or \
                    start + dur > t1 + WINDOW_SLACK_NS:
                outside += 1
                continue
            events.append((name, (start - t0) / 1e3, dur / 1e3, t["pid"]))
    events.sort(key=lambda e: e[1])
    return {"counts": counts, "events": events if on_card else None,
            "workers": len(done), "worker_files": len(traces),
            "workers_launched": sum(
                1 for t in done if any(t["counts"]["launches"].values())),
            "cuda_startup_s": sorted(t["cuda_startup_s"] for t in done
                                     if t["cuda_startup_s"] is not None),
            "marks_s": _marks(done, window[0]),
            "clocks": sorted({t["clock"] for t in done if t["clock"]}),
            "events_outside_phase2": outside if on_card else None,
            "overlapping_kernels": overlaps if on_card else None}


def _first(trace: dict, names) -> list | None:
    """The first closed span of ``trace`` named one of ``names``."""
    return next((s for s in trace.get("spans") or ()
                 if s[0] in names and s[2] is not None), None)


def _span_s(trace: dict, name: str) -> float | None:
    """Seconds of the first span ``name`` of a worker's trace."""
    s = _first(trace, (name,))
    return None if s is None else (s[2] - s[1]) / 1e9


def _marks(traces: list[dict], start: float) -> dict:
    """The moments of the workers' lives, read from their spans
    (``parallel/worker_trace``), as seconds after phase 2's start, its
    minimum, median and maximum over the workers that have it, and the
    spans the trace itself costs: its start (the profiler's, after the
    context) and its stop. Entered and exit: the ``worker`` span; first
    device call: the first ``k1.dispatch`` or ``k3.route``; context made
    and trace started: the ends of ``cuda.context`` and ``trace.start``;
    bin finished: the end of ``worker.write``; trace stopped: the end of
    ``trace.stop``."""
    from statistics import median
    at = {"entered": (("worker",), 1), "exit": (("worker",), 2),
          "first_device_call": (("k1.dispatch", "k3.route"), 1),
          "context_made": (("cuda.context",), 2),
          "trace_started": (("trace.start",), 2),
          "bin_finished": (("worker.write",), 2),
          "trace_stopped": (("trace.stop",), 2)}
    per: dict[str, list] = {}
    for t in traces:
        for name, (spans, end) in at.items():
            s = _first(t, spans)
            if s is not None:
                per.setdefault(name, []).append(s[end] / 1e9 - start)
        for key, name in (("trace_start_s", "trace.start"),
                          ("trace_stop_s", "trace.stop")):
            s = _span_s(t, name)
            if s is not None:
                per.setdefault(key, []).append(s)
    return {name: {"min": min(v), "median": median(v), "max": max(v)}
            for name, v in per.items()}


# the kernels' launches as the workers' exit lines count them
# (tools/device_counts.parse_lines)
EXIT_LINE_LAUNCHES = {"jump_score": "k1_launches", "jump_score_bounded": None,
                      "split_score": "k3_launches"}


def _workers_records(reading: dict, lines: dict, records: list[dict],
                     jobs: int) -> list[str]:
    """Adds the -j N fields to ``records`` (``workflow_records`` of a
    merged reading; ``lines`` the exit lines' sums) and returns what
    disagrees: launches in the traces, by the wrappers and on the exit
    lines; the seams' calls and the work against the exit lines; events
    outside phase 2 or kernels overlapping in a process."""
    from statistics import median
    wrong = []
    exit_calls = {"jump_score": lines["dispatches"], "jump_score_bounded": 0,
                  "split_score": lines["split_scans"]}
    exit_work = {"jump_score": [lines[k] for k in (
                     "k1_useful_cells", "k1_padded_cells", "k1_bytes")],
                 "jump_score_bounded": [0, 0, 0],
                 "split_score": [lines[k] for k in (
                     "k3_useful_terms", "k3_padded_terms", "k3_bytes")]}
    for rec in records[:-1]:
        kernel = rec["kernel"]
        key = EXIT_LINE_LAUNCHES[kernel]
        rec["launches_exit_lines"] = lines[key] if key else 0
        launches = {rec["launches_wrapper"], rec["launches_exit_lines"]}
        if rec["launches_profiler"] is not None:
            launches.add(rec["launches_profiler"])
        if len(launches) > 1:
            wrong.append(f"{kernel}: launches in the traces "
                         f"{rec['launches_profiler']}, by the wrappers "
                         f"{rec['launches_wrapper']}, on the exit lines "
                         f"{rec['launches_exit_lines']}")
        got = [rec["useful_work"], rec["padded_work"], rec["bytes"]]
        if rec["calls"] != exit_calls[kernel] or got != exit_work[kernel]:
            wrong.append(f"{kernel}: {rec['calls']} calls and work {got} "
                         f"in the traces' counts, {exit_calls[kernel]} and "
                         f"{exit_work[kernel]} on the exit lines")
    startup = reading["cuda_startup_s"]
    records[-1].update(
        jobs=jobs, workers=reading["workers"],
        worker_files=reading["worker_files"],
        workers_launched=reading["workers_launched"],
        cuda_startup_s=({"min": startup[0], "median": median(startup),
                         "max": startup[-1], "workers": len(startup)}
                        if startup else None),
        clocks=reading["clocks"], worker_marks_s=reading["marks_s"],
        events_outside_phase2=reading["events_outside_phase2"],
        overlapping_kernels=reading["overlapping_kernels"])
    if not reading["workers"]:
        wrong.append("no phase-2 worker left a finished trace")
    if reading["events_outside_phase2"]:
        wrong.append(f"{reading['events_outside_phase2']} device events "
                     "outside phase 2's window")
    if reading["overlapping_kernels"]:
        wrong.append(f"{reading['overlapping_kernels']} kernels overlap "
                     "another of their process")
    return wrong


def _run_in_workers(run, run_dir: str):
    """``run()``, a workflow at -j N, with its phase-2 workers' device
    trace armed (``parallel/worker_trace``) and this process's file
    descriptor 2 teed for their exit lines: (merged reading, the
    ``WorkflowCounts`` that read them)."""
    from ..parallel import worker_trace
    from .device_counts import WorkflowCounts
    workspace = os.path.join(run_dir, "workspace")
    worker_trace.arm(workspace)
    try:
        with WorkflowCounts() as wc:
            run()
    finally:
        worker_trace.disarm()
    reading = merge_worker_traces(read_worker_traces(workspace),
                                  phase2_window(run_dir))
    return reading, wc


def bench_workflow(ctx):
    """The workflow mode: ``run_workflow`` (``--workload``, ``--mode``,
    ``--prefix``, ``--jobs``, ``--run-dir``, emptied first), then
    ``workflow_records``.

    At -j 1 the run is in this process, in a torch.profiler window on
    the card; each kernel's launches in the trace must equal its
    wrapper's count, and on the cpu no kernel may launch.

    At -j N this process forks the workers and touches no CUDA before
    they are gone (a CUDA context made before a fork breaks CUDA in the
    workers): each phase-2 worker traces itself (``_run_in_workers``),
    and the records carry the merge of their traces and the -j N
    fields (``_workers_records``); the launches in the traces, by the
    wrappers and on the exit lines must all be equal, and the seams'
    calls and work equal to the exit lines'.

    Each kernel's record also holds ``shapes``, the shapes it was
    launched at (``device_counts.parse_shapes``): K1's padded buckets
    and K3's tiers with the most reads and targets of a call."""
    import shutil

    import torch
    from .. import native_core
    from ..workflow.run import run_workflow
    args = ctx.args
    native_core.load()
    normal, tumor, fasta, kw = workflow_inputs(args.workload, args.prefix)
    run_dir = args.run_dir or os.path.join(
        REPO, "results_torch", f"workflow_{args.workload}_{args.mode}")
    shutil.rmtree(run_dir, ignore_errors=True)
    if ctx.device.type == "cuda" and args.jobs == 1:
        from ..align import cuda_jumpscore, cuda_splitscore
        cuda_jumpscore._lib()
        if args.mode == "exact":
            cuda_splitscore._lib()
        torch.zeros(1, device=ctx.device)
        torch.cuda.synchronize()

    def run():
        run_workflow(normal, tumor, fasta, run_dir, n_jobs=args.jobs,
                     use_device_scoring=args.mode, device=ctx.device,
                     verbose=False, **kw)

    if args.jobs == 1:
        from .device_counts import WorkflowCounts
        with WorkflowCounts() as wc:
            reading = profile_workflow(run, ctx.device)
    else:
        reading, wc = _run_in_workers(run, run_dir)
    device_name = (torch.cuda.get_device_name(ctx.device)
                   if ctx.device.type == "cuda" else ctx.device_name)
    records = workflow_records(reading, phase2_wall(run_dir), device_name,
                               args.workload, args.mode)
    if args.jobs == 1:
        wrong = [f"{r['kernel']}: {r['launches_profiler']} launches in the "
                 f"trace, {r['launches_wrapper']} by its wrapper"
                 for r in records[:-1]
                 if r["launches_profiler"] not in (None,
                                                   r["launches_wrapper"])]
    else:
        wrong = _workers_records(reading, wc.counts(), records, args.jobs)
    # the shapes each kernel was launched at, as the dispatcher and the
    # router counted them (at -j N on the workers' exit lines)
    shapes = wc.shapes()
    for rec in records[:-1]:
        rec["shapes"] = shapes.get(rec["kernel"], {})
    if ctx.device.type == "cpu":
        wrong += [f"{r['kernel']} launched on the cpu" for r in records[:-1]
                  if r["launches_wrapper"]]
    for rec in records:
        rec["run_dir"] = run_dir
        ctx.emit(rec)
    if wrong:
        raise AssertionError("; ".join(wrong))


# in the order "all" runs them: the anchor, the kernels, then the plain
# forms, whose traces of thousands of kernels come last
BENCHES = {
    "matmul": bench_matmul,
    "jump_cuda": bench_jump_cuda,
    "jump_cuda_bounded": bench_jump_cuda_bounded,
    "jumpalign": bench_jumpalign,
    "split_cuda": bench_split_cuda,
    "split_cuda_factored": bench_split_cuda_factored,
    "split_mxu": bench_split_mxu,
    "split_mxu_k3": bench_split_mxu_k3,
    "split_exact": bench_split_exact,
    "jump": bench_jump,
}
# on request only: some 25 timed layouts; and the router, which "all"
# runs on the card only (on the cpu its plain form takes ~0.15 s a call)
EXTRA_BENCHES = {"jump_layouts": bench_jump_layouts,
                 "scan_router": bench_scan_router,
                 "workflow": bench_workflow,
                 "trace_aging": bench_trace_aging,
                 "trace_span": bench_trace_span}
# the benches that launch a hand-written kernel: the card only
CUDA_ONLY = ("jump_cuda", "jump_cuda_bounded", "jump_layouts", "split_cuda",
             "split_cuda_factored", "trace_aging", "trace_span")


def _shape(n):
    def parse(text):
        vals = tuple(int(x) for x in text.split(","))
        if len(vals) != n or min(vals) < 1:
            raise argparse.ArgumentTypeError(
                f"expected {n} positive integers, got {text!r}")
        return vals
    return parse


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Time the port's kernels and their plain forms")
    ap.add_argument("--kernel", default="all",
                    choices=["all"] + sorted({**BENCHES, **EXTRA_BENCHES}))
    ap.add_argument("--json", default=None,
                    help="append the JSON lines to this file")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--iters", type=int, default=None,
                    help="timed calls per bench (default 20; 2 for the "
                         "plain jump DP, whose call launches some 50,000 "
                         "kernels, and 3 on the cpu)")
    ap.add_argument("--jump-shape", type=_shape(3), default=(64, 400, 800),
                    metavar="B,Q,R")
    ap.add_argument("--jumpalign-shape", type=_shape(3),
                    default=(512, 200, 700), metavar="B,Q,R")
    ap.add_argument("--split-shape", type=_shape(3), default=(512, 500, 150),
                    metavar="B,T,L")
    ap.add_argument("--mxu-shape", type=_shape(4), default=(8, 64, 500, 150),
                    metavar="G,R,T,L")
    ap.add_argument("--router-shape", type=_shape(2), default=(47, 2),
                    metavar="N,T")
    ap.add_argument("--matmul-n", type=int, default=2048)
    ap.add_argument("--layout-bucket", type=_shape(3), default=None,
                    metavar="B,Q,R", help="jump_layouts: this bucket only")
    ap.add_argument("--layout-loops", type=int, default=3,
                    help="jump_layouts: timed loops a layout")
    ap.add_argument("--workload", default="wgs", choices=WORKLOADS,
                    help="workflow: germline on PREFIX.bam (wgs), joint "
                         "germline on PREFIX.s<k>.bam (joint), tumor-only "
                         "(tumor), tumor-only exome (high-span) or RNA "
                         "fusion mode (rna; the demo tumor BAM without "
                         "--prefix)")
    ap.add_argument("--mode", default="jump", choices=("jump", "exact"),
                    help="workflow: the device scoring mode")
    ap.add_argument("--prefix", default=None,
                    help="workflow: the workload's PREFIX.bam and PREFIX.fa")
    ap.add_argument("--run-dir", default=None,
                    help="workflow: the run directory, emptied first "
                         "(default results_torch/workflow_<workload>_<mode>)")
    ap.add_argument("--aging-s", type=int, default=240,
                    help="trace_aging: seconds after this process's first "
                         "trace to keep tracing")
    ap.add_argument("--first-trace-after-s", type=int, default=0,
                    help="trace_aging: seconds this process waits before "
                         "its first trace")
    ap.add_argument("--span-s", type=int, default=200,
                    help="trace_span: seconds the worker's trace lasts")
    ap.add_argument("--span-calls", type=int, default=8000,
                    help="trace_span: router calls spread over the span")
    ap.add_argument("--jobs", type=int, default=1,
                    help="workflow: the run's -j; above 1 each phase-2 "
                         "worker traces its own device work")
    args = ap.parse_args(argv)
    if args.jobs < 1:
        ap.error("--jobs must be at least 1")

    import torch
    device = torch.device(args.device)
    # the workflow at -j N forks after this: the probe asks NVML
    # (device_count) and makes no CUDA context, and the name is read
    # after the run
    forks = args.kernel == "workflow" and args.jobs > 1
    if device.type == "cuda":
        if torch.cuda.device_count() == 0:
            print(json.dumps({"error": "no CUDA device; pass --device cpu to "
                                       "time the plain forms on the host"}))
            return 1
        device_name = None if forks else torch.cuda.get_device_name(0)
    else:
        device_name = "cpu"
    names = list(BENCHES) if args.kernel == "all" else [args.kernel]
    if args.kernel == "all" and device.type == "cuda":
        names.insert(names.index("split_mxu") + 1, "scan_router")
    if device.type == "cpu":
        if args.kernel in CUDA_ONLY:
            print(json.dumps({"error": f"{args.kernel} launches a CUDA "
                                       "kernel; it has no cpu form"}))
            return 1
        names = [n for n in names if n not in CUDA_ONLY]
    failed = 0
    with (open(args.json, "a") if args.json
          else contextlib.nullcontext()) as out:
        for name in names:
            iters = args.iters if args.iters is not None else (
                3 if device.type == "cpu" else 2 if name == "jump" else 20)
            ctx = Context(args, device, device_name, out, iters)
            try:
                {**BENCHES, **EXTRA_BENCHES}[name](ctx)
            except Exception as e:  # keep going; report the failure
                failed += 1
                _emit({"kernel": name,
                       "error": f"{type(e).__name__}: {e}"}, out)
        from ..align import cuda_jumpscore, cuda_splitscore
        _emit({"kernel_launches": {**cuda_jumpscore.KERNEL_LAUNCHES,
                                   **cuda_splitscore.KERNEL_LAUNCHES}}, out)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
