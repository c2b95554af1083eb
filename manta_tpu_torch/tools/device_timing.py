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
  jump_layouts       the CUDA jump kernel at the scorer's buckets, full
                     rows, at every choice of lanes per thread, beside
                     the block-barrier kernel it replaced
                     (reached through the bounded entry with a window
                     over every lane); not part of ``all``
  split_exact        the plain PyTorch split scan     B=512 T=500 L=150
  split_cuda         the CUDA split-scan kernel, same shape, a row per
                     (read, target) pair
  split_cuda_factored  the same kernel on 256 reads x 2 targets, each
                     stored once (the router's layout)
  split_mxu          the matmul split scan            G=8 R=64 T=500 L=150
  scan_router        a whole ``DeviceScanContext.scan_multi`` call (staging,
                     copies, kernel, results back on the host) on 47 reads
                     x 2 junction targets, a typical workflow call, on the
                     host clock, beside the native host scan of the same

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
import sys
import time

import numpy as np

# dense bf16 tensor-core peak of one H100 SXM (NVIDIA's data sheet), at
# the full 700 W power limit
H100_PEAK_BF16_FLOPS = 989e12
JUMP_SCORES = (2, -8, -18, -1, -1)     # match, mismatch, open, extend, offEdge
JUMP = -100
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
        calls of ``fn``: those whose name holds ``kernel``, or all."""
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
        if total_us <= 0.0 or launches == 0:
            raise RuntimeError(
                "the profiler trace holds no device time"
                + (f" for a kernel named {kernel!r}" if kernel else ""))
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
    _emit({"kernel": kernel, "shape": shape, "device": ctx.device_name,
           **times, **rates}, ctx.out)


class Context:
    def __init__(self, args, device, device_name, out, iters):
        self.args = args
        self.device = device
        self.device_name = device_name
        self.out = out
        self.timer = Timer(device, iters)
        self.rng = np.random.default_rng(args.seed)


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
    from ..align.device_jumpscore import from_reference_inputs
    B, nq, nr = ctx.args.jump_shape
    bases = np.frombuffer(b"ACGT", np.uint8).astype(np.int32)
    q = bases[ctx.rng.integers(0, 4, (B, nq))]
    r1 = bases[ctx.rng.integers(0, 4, (B, nr))]
    r2 = bases[ctx.rng.integers(0, 4, (B, nr))]
    ql = np.full(B, nq, np.int32)
    rl = np.full(B, nr, np.int32)
    t = from_reference_inputs(q, ql, r1, rl, r2, rl, ctx.device)
    return t, f"B={B},q={nq},refs=2x{nr}", float(B) * nq * (2 * nr)


def _jump_rates(ctx, cells, sec):
    return {"gcells_per_s": cells / sec / 1e9,
            "contigs_per_s": ctx.args.jump_shape[0] / sec}


def bench_jump(ctx):
    """The plain PyTorch jump DP (device_jumpscore.batched_jump_score)."""
    from ..align.device_jumpscore import batched_jump_score
    t, shape, cells = _jump_inputs(ctx)
    _B, nq, nr = ctx.args.jump_shape
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
            *t, *JUMP_SCORES, JUMP, rounds), "jump_score_kernel")
        rerun = ctx.timer(lambda: jump_score_bounded_cuda(
            *t, *JUMP_SCORES, JUMP, rounds), whole_call=True)
        _record(ctx, f"jump_score_cuda_bounded_k{rounds}", shape, times,
                n_flagged=n_flagged,
                rerun_event_sec_per_iter=rerun["sec_per_iter"],
                **_jump_rates(ctx, cells, times["sec_per_iter"]))


# (B, nq, nr): the bucket of the WGS-shaped workflow run, the bench
# bucket, a wide batch of short contigs, the last tier and the first
# beyond it
LAYOUT_BUCKETS = ((8, 256, 1024), (64, 512, 1024), (256, 128, 256),
                  (8, 4096, 4096), (8, 8192, 8192))


def _event_ms(fn, calls: int, repeats: int = 3) -> float:
    """Least CUDA-event time of one call over ``repeats`` loops of
    ``calls`` calls, in ms, after a warm-up call."""
    import torch
    fn()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(repeats):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(calls):
            fn()
        b.record()
        torch.cuda.synchronize()
        best = min(best, a.elapsed_time(b) / calls)
    return best


def bench_jump_layouts(ctx):
    """Every layout of the CUDA jump kernel at the scorer's buckets, on
    rows of full length (the slowest a bucket can be), each checked
    against the kernel's own choice; the block-barrier kernel beside
    them. One record per bucket: ``ms`` by lanes per thread (0: the
    kernel's choice) with the warps a row takes at it."""
    import torch
    from ..align import cuda_jumpscore as cj
    from ..align.device_jumpscore import from_reference_inputs
    bases = np.frombuffer(b"ACGT", np.uint8).astype(np.int32)
    for B, nq, nr in LAYOUT_BUCKETS:
        q = bases[ctx.rng.integers(0, 4, (B, nq))]
        r1 = bases[ctx.rng.integers(0, 4, (B, nr))]
        r2 = bases[ctx.rng.integers(0, 4, (B, nr))]
        ql = np.full(B, nq, np.int32)
        rl = np.full(B, nr, np.int32)
        t = from_reference_inputs(q, ql, r1, rl, r2, rl, ctx.device)
        calls = 3 if nq > 1024 else 10
        want = cj.jump_score_cuda(*t, *JUMP_SCORES, JUMP)
        auto = cj.kernel_layout(B, nq)
        rows = []
        # lanes per thread, 0: the kernel's own choice
        for lanes in (0, *(x for x in cj.LANE_CHOICES
                           if cj.kernel_layout(B, nq, x)[1] <= 64)):
            fn = lambda: cj.jump_score_cuda(*t, *JUMP_SCORES, JUMP,
                                            lanes=lanes)
            if not torch.equal(fn(), want):
                raise AssertionError(f"{lanes} lanes a thread differ at "
                                     f"{(B, nq, nr)}")
            rows.append({"lanes": lanes,
                         "warps_per_row": cj.kernel_layout(B, nq, lanes)[1],
                         "ms": _event_ms(fn, calls)})
        cj.raise_on_kernel_error()
        old = lambda: cj.jump_score_flagged_cuda(*t, *JUMP_SCORES, JUMP, 30)
        if not torch.equal(old()[0], want):
            raise AssertionError(f"block-barrier kernel differs at "
                                 f"{(B, nq, nr)}")
        _record(ctx, "jump_score_cuda_layouts", f"B={B},q={nq},refs=2x{nr}",
                {"timed_by": "cuda events", "iters": calls},
                auto_layout=list(auto), layouts=rows,
                block_barrier_ms=_event_ms(old, calls))


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


def bench_scan_router(ctx):
    """The exact route of the split-scan router as the scorer calls it:
    ``DeviceScanContext.scan_multi`` on one breakend's reads and junction
    targets, from numpy in to numpy out. Host clock, median of the timed
    calls; the native host scan of the same call beside it."""
    from types import SimpleNamespace

    from .. import native_core
    from ..scoring.device_scan import DeviceScanContext
    from ..scoring.evidence import QscoreSnp, split_read_scan_multi
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
    idx = np.arange(n, dtype=np.int64)
    qconv = QscoreSnp(1e-3)
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


# in the order "all" runs them: the anchor, the kernels, then the plain
# forms, whose traces of thousands of kernels come last
BENCHES = {
    "matmul": bench_matmul,
    "jump_cuda": bench_jump_cuda,
    "jump_cuda_bounded": bench_jump_cuda_bounded,
    "split_cuda": bench_split_cuda,
    "split_cuda_factored": bench_split_cuda_factored,
    "split_mxu": bench_split_mxu,
    "split_exact": bench_split_exact,
    "jump": bench_jump,
}
# on request only: some 25 timed layouts; and the router, which "all"
# runs on the card only (on the cpu its plain form takes ~0.15 s a call)
EXTRA_BENCHES = {"jump_layouts": bench_jump_layouts,
                 "scan_router": bench_scan_router}
# the benches that launch a hand-written kernel: the card only
CUDA_ONLY = ("jump_cuda", "jump_cuda_bounded", "jump_layouts", "split_cuda",
             "split_cuda_factored")


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
    ap.add_argument("--split-shape", type=_shape(3), default=(512, 500, 150),
                    metavar="B,T,L")
    ap.add_argument("--mxu-shape", type=_shape(4), default=(8, 64, 500, 150),
                    metavar="G,R,T,L")
    ap.add_argument("--router-shape", type=_shape(2), default=(47, 2),
                    metavar="N,T")
    ap.add_argument("--matmul-n", type=int, default=2048)
    args = ap.parse_args(argv)

    import torch
    device = torch.device(args.device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            print(json.dumps({"error": "no CUDA device; pass --device cpu to "
                                       "time the plain forms on the host"}))
            return 1
        device_name = torch.cuda.get_device_name(0)
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
