#!/usr/bin/env python3
"""Smoke run of manta_tpu_torch on one CUDA GPU (Hopper, sm_90a).

    python3 chip_smoke.py

Run from the root of a checkout. It drives the port's main paths,
contig jump scoring (--device-scoring jump), the device split-read scan
(--device-scoring exact, and mxu) and the kernel-timing entry point
(python -m manta_tpu_torch.tools.device_timing):

1. environment: torch and CUDA versions, the card's name and power
   limit, the native core, and no JAX anywhere in the process;
2. build: nvcc builds the jump-DP, the bounded jump-DP and the
   split-scan kernels from manta_tpu_torch/csrc/, one process each,
   started together;
3. kernel (jump): the CUDA kernel, the plain PyTorch form on the card
   and the native score batch give identical int32 scores at the
   scorer's bucket shapes, the main path's bucket among them; kernel,
   the block-barrier kernel it replaced and the plain form are timed
   with CUDA events; then, untimed, widths at a warp's edge (nq + 1 =
   32 x lanes and one more), a row far shorter than its bucket, and
   every layout (one warp a row, several) against the plain form;
3b. kernel (bounded jump): at the same shapes and prefix_rounds 3 and
   5, on random jobs mixed with a long junction insertion (flags) and a
   short query (cannot flag): score and flag of the CUDA kernel equal
   the plain flagged form on every row, and the bounded form with its
   rerun equals the exact kernel and the exact plain form; timed in
   turns with the exact kernel;
4. kernel (split scan): the CUDA kernel, through the call with a row
   per (read, target) pair and through the factored call (each read
   and target once), and the plain PyTorch forms on the card give
   bit-equal float32 scores and equal positions at the bucketed shapes
   the device scan context gives the kernel, and all equal the native
   host scan on real demo reads; kernel, plain form and native scan are
   timed; then the router itself (DeviceScanContext.scan_multi) on a
   typical call: equal to the native scan, one host-to-device and one
   device-to-host copy a call in the profiler's trace, ms a call;
5. demo: the tumor/normal demo through the port's workflow with
   scoring off, jump, exact and mxu on CUDA; the somatic VCF body
   equals the oracle's (byte for byte; mxu at call level);
6. WGS-shaped: a seeded germline workload (benchmarks/wgs_workload.py,
   in a subprocess) through the port's workflow with scoring off, jump,
   exact and mxu; the diploid VCF bodies of off, jump and exact are
   identical and each device path launched its kernels; then exact at
   -j 2 through the CLI, whose body and chromosome depths equal the
   -j 1 runs'; the real contig jobs of the jump run go through the
   bounded kernel once more, for their flag count;
7. the timing entry point, python -m manta_tpu_torch.tools.device_timing
   --kernel all --json, in a subprocess: its records, and its launch
   counts (all three kernels launched).

Neither JAX nor the JAX package manta_tpu is imported anywhere. The
line before the card's holds, for every kernel, its launches on its
path, its times and its bound: the least time the card could take, the
larger of the bytes (each input once, each output once) over 3.35 TB/s
and the int32/float32 operations of the rows' own lengths over 67 Top/s
(NVIDIA's H100 SXM data sheet), computed from the timed inputs.

The last line is {"ok": true, "device": {...}}. Any failure raises, so
the exit code is non-zero and that line is not printed. Without a CUDA
device it exits non-zero before any result.
"""

from __future__ import annotations

import gzip
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import tarfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))
DEMO = os.path.join(REPO, "tests", "data", "demo")
WORK = os.path.join(REPO, ".testdata")           # git-ignored
FASTA_NAME = "Homo_sapiens_assembly19.COST16011_region.fa"
TUMOR_BAM = "G15512.HCC1954.1.COST16011_region.bam"
NORMAL_BAM = "HCC1954.NORMAL.30x.compare.COST16011_region.bam"
# name -> (source, the TPU kernel it replaces)
KERNELS = {
    "jump_score": ("manta_tpu_torch/csrc/jump_score.cu",
                   "manta_tpu/align/pallas_jumpscore.py:79"),
    # pallas_jump_score_flagged: _kernel with prefix_rounds and flag_ref
    "jump_score_bounded": ("manta_tpu_torch/csrc/jump_score_bounded.cu",
                           "manta_tpu/align/pallas_jumpscore.py:242"),
    "split_score": ("manta_tpu_torch/csrc/split_score.cu",
                    "manta_tpu/align/pallas_splitscore.py:50"),
}
# (B, longest query, longest reference): the bench shape (bench.py:158,
# bucketed to 512/1024), a wide batch of short contigs, the last tier,
# and one query beyond it (bucketed to 8192). References are at least
# as long as queries, as around a real contig: the native score batch
# departs from the full traceback aligner on some queries longer than
# both references together (ROADMAP.md Queue 3)
KERNEL_SHAPES = ((64, 400, 800), (8, 250, 1000), (256, 128, 256),
                 (8, 4096, 4096), (8, 6000, 6000))
# the bucket of the WGS-shaped workflow run's dispatches (B, nq, nr1, nr2)
MAIN_PATH_BUCKET = (8, 256, 1024, 1024)
# (rows B = reads x 2 targets, read tier Lp, scan tier Tp): the shapes
# DeviceScanContext gives the split kernel; demo reads are 101 bp (Lp
# 256), three joined make ~300 bp (Lp 512). The second is the shape of
# manta_tpu/align/pallas_splitscore.py:19-21 (B=512, T=500, L=150)
SPLIT_SHAPES = ((64, 256, 512), (512, 256, 512), (2048, 256, 1024),
                (64, 512, 2048), (94, 256, 512))
SPLIT_TYPICAL = 4            # a typical workflow call: ~93 pairs
SPLIT_REPORTED = 1           # the index of the shape in the kernels line
FLANK = 50
# germline WGS-shaped workload: 2 x 8 Mb at 35x, about 5.6 M reads
WGS_ARGS = ("--chroms", "2", "--mb", "8", "--depth", "35", "--seed", "7")
TIMED_RUNS = 5
BOUNDED_ROUNDS = (3, 5)      # benchmarks/device_timing.py:359
# the card's published peaks (NVIDIA's data sheet, H100 SXM, 700 W):
# device memory rate, and float32 outside the tensor cores, which is
# also what int32 adds and maxes are held against
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = 67e12
# int32 operations one DP cell (one query lane in one reference column)
# needs. Exact chain: substitution 2 (compare, select), M 1, diagonal
# 2-3, D 4, insert source 1-2, its offset and floor 3, prefix max 1, I 3,
# J 4 in the ref1 phase: 21 there, 19 in the ref2 phase. Bounded chain:
# two sliding maxima at 3 each for the one prefix max, and 4 for the
# detection value and its compare.
JUMP_OPS_PER_CELL = 20
BOUNDED_OPS_PER_CELL = 29
# operations per useful term of the split scan: base compare, two N
# tests, two selects, add
SPLIT_OPS_PER_TERM = 6


def phase(name: str) -> None:
    print(f"\n== {name}", flush=True)


def environment() -> str:
    phase("environment")
    import torch
    print(f"python {sys.version.split()[0]}  torch {torch.__version__}  "
          f"cuda {torch.version.cuda}", flush=True)
    if not torch.cuda.is_available():
        sys.exit("chip_smoke.py: no CUDA device (torch.cuda.is_available() "
                 "is false)")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    from manta_tpu_torch import native_core
    compat = native_core.ensure_libdeflate()
    native_core.load()
    print("native core loaded"
          + (f" (libdeflate.so.0 built from csrc/deflate_compat.c: {compat})"
             if compat else ""), flush=True)
    return card


def build() -> None:
    """Build every kernel library from source, one nvcc process per
    source, all started together; print registers and spills."""
    phase("build")
    from concurrent.futures import ThreadPoolExecutor

    from manta_tpu_torch import _build
    from manta_tpu_torch.align import cuda_jumpscore, cuda_splitscore
    with ThreadPoolExecutor(len(KERNELS)) as pool:
        list(pool.map(_build.build, KERNELS))
    cuda_jumpscore.max_query_width()          # loads
    cuda_jumpscore._bounded_lib()
    cuda_splitscore._lib()
    for name, (source, _replaces) in KERNELS.items():
        secs = _build.BUILD_SECONDS.get(name)
        print(f"{source} -> manta_tpu_torch/build/lib{name}.so "
              f"({' '.join(_build.NVCC_FLAGS[:2])}): "
              + (f"built in {secs:.2f} s" if secs is not None
                 else "up to date, not rebuilt"), flush=True)
        log = os.path.join(_build.BUILD_DIR, f"lib{name}.so.log")
        with open(log) as f:
            for line in f:
                # the mangled name holds the kernel and its template
                # arguments: ...jump_systolic_kernelILi33EE... is <33>
                m = re.search(r"Function properties for \S*?\d+"
                              r"([a-z_]+_kernel)(?:I([A-Za-z0-9]+?)EE)?", line)
                if m:
                    targs = re.findall(r"L[ib](\d+)", m.group(2) or "")
                    print(f"  {m.group(1)}"
                          + (f"<{', '.join(targs)}>" if targs else ""))
                elif "registers" in line or "spill" in line:
                    print("    " + line.strip().replace("ptxas info    : ", ""))


def _jobs(rng, B, nq_max, nr_max):
    """Seeded (query, ref1, ref2) jobs: random contigs spanning a
    junction (first half from ref1, second half into ref2), some with a
    long untemplated insertion at the junction."""
    bases = b"ACGT"

    def seq(n):
        return bytes(bases[i] for i in rng.integers(0, 4, n))

    jobs = []
    for i in range(B):
        nq = int(rng.integers(max(1, nq_max // 2), nq_max + 1))
        n1 = int(rng.integers(max(1, nr_max // 2), nr_max + 1))
        n2 = int(rng.integers(max(1, nr_max // 2), nr_max + 1))
        ins = int(rng.integers(20, 120)) if i % 4 == 1 else 0
        half = max(0, (nq - ins) // 2)
        left, right = seq(half), seq(max(0, nq - ins - half))
        r1 = seq(n1)
        r2 = seq(n2)
        p1 = int(rng.integers(0, max(1, n1 - len(left))))
        p2 = int(rng.integers(0, max(1, n2 - len(right))))
        r1 = (r1[:p1] + left + r1[p1 + len(left):])[:n1]
        r2 = (r2[:p2] + right + r2[p2 + len(right):])[:n2]
        jobs.append((left + seq(ins) + right, r1, r2))
    return jobs


def _time_ms(fn, runs=TIMED_RUNS, calls=1):
    """Median over ``runs`` of the CUDA-event time of one call, each
    taken around ``calls`` calls in a row: with several, the host's
    work for the next call hides behind the device's on the last (a
    single call of a kernel under ~0.1 ms times the wrapper)."""
    import torch
    fn()                                          # warm-up
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(calls):
            fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b) / calls)
    return statistics.median(times)


def _device_ms(fn, kernel: str, runs: int = 50):
    """Mean device time of one launch of the CUDA kernel whose name
    contains ``kernel``, from a torch.profiler (CUPTI) trace of ``runs``
    calls of ``fn``; None when the trace holds no such kernel. At a few
    microseconds a launch, CUDA events around a call time the wrapper's
    host work, not the kernel."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
    for e in prof.key_averages():
        if kernel in e.key and e.count:
            total = getattr(e, "device_time_total", None)
            if total is None:
                total = e.cuda_time_total
            return total / e.count / 1e3
    return None


def _bound(n_bytes: int, n_ops: int) -> dict:
    """The least time the card could take: the larger of the bytes over
    the memory rate and the operations over the peak rate."""
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = n_ops / PEAK_OPS_PER_S * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": None}


def _jump_bound(arrays, ops_per_cell: int, n_out: int) -> dict:
    """Bound of one jump-DP call on the padded numpy inputs: every code
    and length read once, ``n_out`` int32 written per row; the cells are
    those of the rows' own lengths, (qlen + 1) lanes by r1len + r2len
    columns."""
    q, ql, r1, r1l, r2, r2l = arrays
    n_bytes = 4 * (q.size + r1.size + r2.size + (3 + n_out) * len(ql))
    cells = int(((ql.astype("int64") + 1)
                 * (r1l.astype("int64") + r2l)).sum())
    return _bound(n_bytes, ops_per_cell * cells)


def check_jump_kernel() -> dict:
    """Kernel vs plain form (on the card) vs native score batch, at the
    bucketed shapes the scorer gives the kernel. Returns the bench
    shape's numbers."""
    phase("kernel: CUDA jump DP vs plain PyTorch vs native")
    import numpy as np
    import torch
    from manta_tpu_torch.align.aligners import jump_score_batch
    from manta_tpu_torch.candidates.refiner import RefinerOptions
    from manta_tpu_torch.align import cuda_jumpscore
    from manta_tpu_torch.align import device_jumpscore as dj

    opt = RefinerOptions()
    scores, jump = opt.spanning_scores, opt.jump_score
    args = (scores.match, scores.mismatch, scores.open, scores.extend,
            scores.off_edge, jump)
    rng = np.random.default_rng(20261016)
    bench = None
    max_err = 0
    shapes_seen = set()
    for B, nq_max, nr_max in KERNEL_SHAPES:
        # two pad rows of length 1, as the bucketed scorer adds them
        jobs = _jobs(rng, B - 2, nq_max, nr_max)
        q, ql, r1, r1l, r2, r2l = dj.pad_jobs(jobs, B)
        nq, nr1, nr2 = q.shape[1], r1.shape[1], r2.shape[1]
        t = dj.from_reference_inputs(q, ql, r1, r1l, r2, r2l, "cuda")
        kern = cuda_jumpscore.jump_score_cuda(*t, *args)
        plain = dj.batched_jump_score(*t, *args, nq, nr1, nr2)
        torch.cuda.synchronize()
        kern = kern.cpu().numpy()
        plain = plain.cpu().numpy()
        native = jump_score_batch(jobs, scores, jump)
        err = int(np.abs(kern.astype(np.int64)
                         - plain.astype(np.int64)).max())
        if not (np.array_equal(kern, plain)
                and np.array_equal(kern[:B - 2], native)):
            bad = np.flatnonzero((kern != plain)
                                 | (kern != np.r_[native, kern[B - 2:]]))
            raise AssertionError(
                f"jump kernel disagrees at B={B} nq={nq} nr={nr1}: rows "
                f"{bad[:8].tolist()} kernel {kern[bad[:8]].tolist()} "
                f"plain {plain[bad[:8]].tolist()} native "
                f"{np.r_[native, kern[B - 2:]][bad[:8]].tolist()}")
        max_err = max(max_err, err)
        cuda_jumpscore.raise_on_kernel_error()
        # the block-barrier kernel this one replaced still runs the
        # exact chain where the bounded entry's window covers every lane
        old = cuda_jumpscore.jump_score_flagged_cuda(*t, *args, 30)[0]
        if not np.array_equal(old.cpu().numpy(), kern):
            raise AssertionError(f"block-barrier kernel disagrees at B={B} "
                                 f"nq={nq}")
        # in turns: old, new, new, old
        o_ms = [_time_ms(lambda: cuda_jumpscore.jump_score_flagged_cuda(
            *t, *args, 30), calls=5)]
        k_ms = _time_ms(lambda: cuda_jumpscore.jump_score_cuda(*t, *args),
                        runs=2 * TIMED_RUNS, calls=5)
        o_ms.append(_time_ms(lambda: cuda_jumpscore.jump_score_flagged_cuda(
            *t, *args, 30), calls=5))
        p_ms = _time_ms(lambda: dj.batched_jump_score(*t, *args, nq, nr1,
                                                     nr2), runs=1)
        lanes, warps = cuda_jumpscore.kernel_layout(B, nq)
        cells = B * nq * (nr1 + nr2)
        bound = _jump_bound((q, ql, r1, r1l, r2, r2l), JUMP_OPS_PER_CELL, 1)
        print(f"B={B} nq={nq} nr1={nr1} nr2={nr2}"
              + (" (the main path's bucket)"
                 if (B, nq, nr1, nr2) == MAIN_PATH_BUCKET else "")
              + f": kernel == plain == native on {B} rows (tolerance: "
              f"exact); {lanes} lanes a thread, {warps} warp(s) a row; "
              f"kernel {k_ms:.4f} ms ({cells / k_ms / 1e6:.2f} Gcells/s; "
              f"CUDA events around 5 calls), "
              f"block-barrier kernel before and after {o_ms[0]:.4f}, "
              f"{o_ms[1]:.4f} ms, plain {p_ms:.2f} ms "
              f"({cells / p_ms / 1e6:.4f} Gcells/s); bound "
              f"{bound['bound_ms']:.5f} ms by {bound['bound_by']} "
              f"({bound['bound_ms'] / k_ms:.2%} reached), dependent chain "
              f"{int((r1l + r2l).max())} columns", flush=True)
        shapes_seen.add((B, nq, nr1, nr2))
        if bench is None:
            bench = {"ms": k_ms, "plain_ms": p_ms, **bound}
    if MAIN_PATH_BUCKET not in shapes_seen:
        raise AssertionError(f"the main path's bucket {MAIN_PATH_BUCKET} "
                             f"was not among {sorted(shapes_seen)}")
    bench["max_abs_err"] = max_err
    _check_jump_layouts(rng, scores, jump, args)
    return bench


def _check_jump_layouts(rng, scores, jump, args) -> None:
    """Untimed: widths at a warp's edge (nq + 1 = 32 x lanes, and one
    lane more) with a 3-base row among full ones, in the kernel's own
    layout and with the lanes named; then one width in every layout,
    from one warp a row to many. Each against the plain form and the
    native score batch, exact."""
    import numpy as np
    import torch
    from manta_tpu_torch.align import cuda_jumpscore as cj
    from manta_tpu_torch.align import device_jumpscore as dj
    from manta_tpu_torch.align.aligners import jump_score_batch

    def padded(jobs, nq, nr):
        # a junction insertion can make a query longer than asked for
        q, ql = dj._pad_to([j[0][:nq] for j in jobs], len(jobs), nq, 1)
        r1, r1l = dj._pad_to([j[1] for j in jobs], len(jobs), nr, 2)
        r2, r2l = dj._pad_to([j[2] for j in jobs], len(jobs), nr, 2)
        return dj.from_reference_inputs(q, ql, r1, r1l, r2, r2l, "cuda")

    seen = set()
    for lanes in cj.LANE_CHOICES:
        for over in (0, 1):
            nq = 32 * lanes - 1 + over
            jobs = _jobs(rng, 6, nq, 2 * nq)
            jobs.append((jobs[0][0][:3], jobs[0][1], jobs[0][2]))
            t = padded(jobs, nq, 2 * nq)
            plain = dj.batched_jump_score(*t, *args, nq, 2 * nq, 2 * nq)
            native = jump_score_batch([(j[0][:nq], j[1], j[2]) for j in jobs],
                                      scores, jump)
            for named in (0, lanes):
                kern = cj.jump_score_cuda(*t, *args, lanes=named)
                if not (torch.equal(kern, plain) and np.array_equal(
                        kern.cpu().numpy(), native)):
                    raise AssertionError(
                        f"jump kernel disagrees at nq={nq}, lanes={named}")
                seen.add(cj.kernel_layout(len(jobs), nq, named))
    nq, nr = 700, 900
    jobs = _jobs(rng, 20, nq, nr) + _jobs(rng, 6, 60, nr)
    t = padded(jobs, nq, nr)
    plain = dj.batched_jump_score(*t, *args, nq, nr, nr)
    for lanes in cj.LANE_CHOICES:
        kern = cj.jump_score_cuda(*t, *args, lanes=lanes)
        if not torch.equal(kern, plain):
            raise AssertionError(f"jump kernel disagrees at nq={nq}, "
                                 f"lanes={lanes}")
        seen.add(cj.kernel_layout(len(jobs), nq, lanes))
    cj.raise_on_kernel_error()
    one = sorted(x for x in seen if x[1] == 1)
    many = sorted(x for x in seen if x[1] > 1)
    if not one or not many:
        raise AssertionError(f"layouts checked: {sorted(seen)}")
    print(f"widths nq + 1 = 32 x lanes and one more (lanes "
          f"{list(cj.LANE_CHOICES)}), a 3-base row in each, and nq={nq} in "
          f"every layout: kernel == plain == native (tolerance: exact); "
          f"(lanes, warps a row) one warp {one}, several {many}",
          flush=True)


def check_bounded_kernel() -> dict:
    """The bounded-chain kernel vs its plain form (score and flag on
    every row), and the bounded form with its rerun vs the exact kernel
    and the exact plain form, at the scorer's bucket shapes and both
    prefix_rounds. Returns the bench shape's numbers at the first
    prefix_rounds."""
    phase("kernel: CUDA bounded jump DP vs plain PyTorch vs the exact kernel")
    import numpy as np
    import torch
    from manta_tpu_torch.candidates.refiner import RefinerOptions
    from manta_tpu_torch.align import cuda_jumpscore as cj
    from manta_tpu_torch.align import device_jumpscore as dj

    opt = RefinerOptions()
    scores, jump = opt.spanning_scores, opt.jump_score
    args = (scores.match, scores.mismatch, scores.open, scores.extend,
            scores.off_edge, jump)
    rng = np.random.default_rng(20261017)

    def seq(n):
        return bytes(b"ACGT"[i] for i in rng.integers(0, 4, n))

    bench = None
    for B, nq_max, nr_max in KERNEL_SHAPES:
        # random jobs, a junction insertion longer than 2^(K+1) lanes
        # for every K (as tests/test_pallas_jumpscore.py:70 makes them),
        # a query shorter than 2^K lanes for every K, two pad rows
        ins = (2 << max(BOUNDED_ROUNDS)) + 26
        half = (min(nq_max, 190) - ins) // 2
        left, right = seq(half), seq(half)
        jobs = _jobs(rng, B - 4, nq_max, nr_max) + [
            (left + seq(ins) + right, seq(30) + left, right + seq(30)),
            (seq((1 << min(BOUNDED_ROUNDS)) - 1), seq(nr_max // 2),
             seq(nr_max // 2))]
        arrays = dj.pad_jobs(jobs, B)
        nq, nr1, nr2 = (arrays[i].shape[1] for i in (0, 2, 4))
        t = dj.from_reference_inputs(*arrays, "cuda")
        exact = cj.jump_score_cuda(*t, *args)
        p_exact = dj.batched_jump_score(*t, *args, nq, nr1, nr2)
        if not torch.equal(exact, p_exact):
            raise AssertionError(f"exact kernel != plain at B={B} nq={nq}")
        exact_ms = [_time_ms(lambda: cj.jump_score_cuda(*t, *args))]
        for rounds in BOUNDED_ROUNDS:
            best, flag = cj.jump_score_flagged_cuda(*t, *args, rounds)
            p_best, p_flag = dj.batched_jump_score_flagged(
                *t, *args, nq, nr1, nr2, rounds)
            fixed, n_flagged = cj.jump_score_bounded_cuda(*t, *args, rounds)
            torch.cuda.synchronize()
            if not (torch.equal(best, p_best) and torch.equal(flag, p_flag)):
                bad = torch.nonzero((best != p_best) | (flag != p_flag))
                raise AssertionError(
                    f"bounded kernel != plain at B={B} nq={nq} K={rounds}: "
                    f"rows {bad[:8, 0].tolist()}")
            if not torch.equal(fixed, exact):
                raise AssertionError(
                    f"bounded + rerun != exact at B={B} nq={nq} K={rounds}")
            if not 0 < n_flagged < B or n_flagged != int((flag != 0).sum()):
                raise AssertionError(
                    f"B={B} nq={nq} K={rounds}: {n_flagged} of {B} rows "
                    "flagged; wanted flagged and unflagged rows")
            if not flag[B - 4] or flag[B - 3:].any():
                raise AssertionError(
                    f"B={B} nq={nq} K={rounds}: the long insertion must "
                    "flag; the short query and the pad rows must not")
            differ = int((best != exact).sum())
            k_ms = _time_ms(lambda: cj.jump_score_flagged_cuda(*t, *args,
                                                               rounds))
            d_ms = _device_ms(lambda: cj.jump_score_flagged_cuda(
                *t, *args, rounds), "jump_score_kernel", runs=10)
            r_ms = _time_ms(lambda: cj.jump_score_bounded_cuda(*t, *args,
                                                               rounds))
            exact_ms.append(_time_ms(lambda: cj.jump_score_cuda(*t, *args)))
            bound = _jump_bound(arrays, BOUNDED_OPS_PER_CELL, 2)
            print(f"B={B} nq={nq} nr1={nr1} nr2={nr2} K={rounds}: kernel "
                  f"(best, flag) == plain on {B} rows, bounded + rerun == "
                  f"exact kernel == exact plain (tolerance: exact); "
                  f"{n_flagged} rows flagged, {differ} bounded scores "
                  f"differ; kernel {k_ms:.4f} ms (events), "
                  f"{'not measured' if d_ms is None else f'{d_ms:.4f} ms'} "
                  f"(profiler), with rerun {r_ms:.4f} ms; exact kernel "
                  f"before {exact_ms[-2]:.4f} ms, after {exact_ms[-1]:.4f} "
                  f"ms; bound {bound['bound_ms']:.5f} ms by "
                  f"{bound['bound_by']} ({bound['bound_ms'] / k_ms:.2%} "
                  "reached)", flush=True)
            if bench is None:
                p_ms = _time_ms(lambda: dj.batched_jump_score_flagged(
                    *t, *args, nq, nr1, nr2, rounds), runs=3)
                print(f"    plain flagged form {p_ms:.2f} ms", flush=True)
                bench = {"ms": k_ms, "plain_ms": p_ms, "max_abs_err": 0,
                         **bound}
    return bench


def _split_inputs(batch, n_reads, per_read, Tp):
    """A batch of ``n_reads`` reads made from real demo reads (each
    ``per_read`` consecutive reads joined), some with an IUPAC byte and
    some cut to one base (no valid scan position), and two junction
    targets spliced from other demo reads, whose tier is Tp; the second
    holds an IUPAC byte. Returns (batch, read_idx, targets, bp_ranges,
    valid): ``valid`` are the reads with a scan position on both
    targets, the ones the native scan takes."""
    from types import SimpleNamespace

    import numpy as np

    def read(i):
        a, b = int(batch.seq_off[i]), int(batch.seq_off[i + 1])
        c, d = int(batch.qual_off[i]), int(batch.qual_off[i + 1])
        return batch.seq[a:b], batch.qual[c:d]

    seqs, quals = [], []
    for r in range(n_reads):
        parts = [read((r * per_read + p) % batch.n) for p in range(per_read)]
        sq = np.concatenate([p[0] for p in parts])
        ql = np.concatenate([p[1] for p in parts])
        if r % 16 == 3:
            sq[7] = ord("R")
        if r % 64 == 5:
            sq, ql = sq[:1], ql[:1]
        seqs.append(sq)
        quals.append(ql)
    off = np.zeros(n_reads + 1, np.int64)
    off[1:] = np.cumsum([len(x) for x in seqs])
    synth = SimpleNamespace(seq=np.concatenate(seqs), qual=np.concatenate(quals),
                            seq_off=off, qual_off=off.copy(), n=n_reads)
    targets, bp_ranges = [], []
    for k, length in enumerate((Tp - 8, Tp * 3 // 4)):
        # the reads k, k+2, ... lie in this target as they are
        parts, i = [], k
        while sum(len(p) for p in parts) < length:
            parts.append(read(i)[0])
            i += 2
        tg = np.concatenate(parts)[:length].copy()
        if k == 1:
            tg[length // 3] = ord("M")
        targets.append(tg)
        # a breakend without microhomology on the first target: a
        # one-base read has no scan position there
        bp_ranges.append((length // 2, length // 2) if k == 0
                         else (length // 2 - 3, length // 2 + 2))
    lens = np.diff(off)
    valid = np.flatnonzero(lens > 1).astype(np.int64)
    return (synth, np.arange(n_reads, dtype=np.int64), targets, bp_ranges,
            valid)


def check_split_kernel(card: str) -> dict:
    """Split-scan kernel vs plain form (on the card) vs the native host
    scan, at the bucketed shapes the device scan context gives the
    kernel. Returns the reported shape's numbers and the largest error."""
    phase("kernel: CUDA split scan vs plain PyTorch vs native")
    import numpy as np
    import torch
    from manta_tpu_torch.io.bam import BamReader
    from manta_tpu_torch.scoring.evidence import (
        QscoreSnp, split_read_scan_multi,
    )
    from manta_tpu_torch.align import cuda_splitscore
    from manta_tpu_torch.align import device_splitscore as ds
    from manta_tpu_torch.scoring import device_scan

    demo = BamReader(os.path.join(DEMO, TUMOR_BAM)).fetch(
        "8", 107652000, 107655000)
    qconv = QscoreSnp(1e-3)
    m, x = qconv.lut256()
    luts = [torch.from_numpy(np.ascontiguousarray(a[:71])).cuda()
            for a in (m, x)]
    print(f"{card}; demo tumor reads 8:107652000-107655000: {demo.n}; "
          "Gterms counts useful terms, sum over rows of n_k * read_len "
          "(n_k = valid scan positions)", flush=True)
    reported, max_err = None, 0.0
    for si, (B, Lp, Tp) in enumerate(SPLIT_SHAPES):
        batch, idx, targets, ranges, valid = _split_inputs(
            demo, B // 2, 1 if Lp == 256 else 3, Tp)
        reads, quals, rlens = device_scan.stage_reads(batch, idx)
        arrays = device_scan.stage_exact(reads, quals, rlens, targets,
                                         ranges, device_scan._bucket(
                                             max(map(len, targets)) + 1))
        shape = (arrays[0].shape[0], arrays[0].shape[1], arrays[2].shape[1])
        if shape != (B, Lp, Tp):
            raise AssertionError(f"staged shape {shape}, wanted {(B, Lp, Tp)}")
        t = [torch.from_numpy(a).cuda() for a in arrays]
        args = (*t, FLANK, *luts, Tp)
        kb, kp = cuda_splitscore.split_score_cuda(*args)
        pb, pp = ds.batched_split_score(*args)
        torch.cuda.synchronize()
        kb, kp, pb, pp = (a.cpu().numpy() for a in (kb, kp, pb, pp))
        native_b, native_p = split_read_scan_multi(
            FLANK, batch, valid, qconv, targets, ranges)
        rows = (valid[:, None] * 2 + np.arange(2)).ravel()
        no_pos = int(np.isneginf(kb).sum())
        if not (np.array_equal(kb, pb) and np.array_equal(kp, pp)):
            bad = np.flatnonzero((kb != pb) | (kp != pp))[:8]
            raise AssertionError(
                f"split kernel != plain at B={B} Lp={Lp} Tp={Tp}: rows "
                f"{bad.tolist()} kernel {kb[bad].tolist()} {kp[bad].tolist()}"
                f" plain {pb[bad].tolist()} {pp[bad].tolist()}")
        if not (np.array_equal(kb[rows], native_b.ravel())
                and np.array_equal(kp[rows], native_p.ravel())):
            bad = np.flatnonzero((kb[rows] != native_b.ravel())
                                 | (kp[rows] != native_p.ravel()))[:8]
            raise AssertionError(
                f"split kernel != native at B={B} Lp={Lp} Tp={Tp}: rows "
                f"{rows[bad].tolist()}")
        if no_pos == 0 or not (arrays[0] == ord("R")).any() \
                or not (arrays[2] == ord("M")).any():
            raise AssertionError("inputs lack no-position or IUPAC rows")
        # the factored call: each read and each target once
        f = ds.factored_from_replicated(*arrays, 2, "cuda")
        fargs = (*f, FLANK, *luts, Tp)
        fb, fp = cuda_splitscore.split_score_factored_cuda(*fargs)
        qb, qp = ds.batched_split_score_factored(*fargs)
        torch.cuda.synchronize()
        if not (torch.equal(fb, qb) and torch.equal(fp, qp)
                and np.array_equal(fb.cpu().numpy().ravel(), kb)
                and np.array_equal(fp.cpu().numpy().ravel(), kp)):
            raise AssertionError(
                f"factored split kernel != its plain form or the "
                f"replicated call at B={B} Lp={Lp} Tp={Tp}")
        f_ms = _device_ms(
            lambda: cuda_splitscore.split_score_factored_cuda(*fargs),
            "split_score_kernel")
        fin = np.isfinite(kb)
        max_err = max(max_err, float(np.abs(kb[fin] - pb[fin]).max()))
        # useful terms: n_k valid positions x read_len bases per row
        rl = arrays[5].astype(np.int64)
        start = np.maximum(0, arrays[3] - rl + 2)
        end = np.maximum(0, np.minimum(arrays[4], arrays[6] - rl))
        terms = int((np.clip(end - start + 1, 0, Tp) * rl).sum())
        k_ms = _time_ms(lambda: cuda_splitscore.split_score_cuda(*args))
        d_ms = _device_ms(lambda: cuda_splitscore.split_score_cuda(*args),
                          "split_score_kernel")
        p_ms = _time_ms(lambda: ds.batched_split_score(*args), runs=3)
        nat = []
        for _ in range(3):
            t0 = time.perf_counter()
            split_read_scan_multi(FLANK, batch, valid, qconv, targets, ranges)
            nat.append(time.perf_counter() - t0)
        n_ms = statistics.median(nat) * 1e3
        device = ("not measured" if d_ms is None else
                  f"{d_ms:.5f} ms ({B / d_ms * 1e3:.0f} rows/s, "
                  f"{terms / d_ms / 1e6:.3f} Gterms/s)")
        factored = ("not measured" if f_ms is None else f"{f_ms:.5f} ms")
        print(f"B={B} Lp={Lp} Tp={Tp}: kernel == plain on {B} rows "
              f"({no_pos} with no scan position; tolerance: bit-equal), "
              f"== native on {len(rows)} rows; factored call ({B // 2} "
              f"reads x 2 targets) == its plain form == the same rows; "
              f"kernel call {k_ms:.4f} ms "
              f"(CUDA events; {B / k_ms * 1e3:.0f} rows/s), kernel device "
              f"time {device} (profiler), factored {factored}, "
              f"plain {p_ms:.3f} ms "
              f"({B / p_ms * 1e3:.0f} rows/s, {terms / p_ms / 1e6:.4f} "
              f"Gterms/s), native one host core {n_ms:.3f} ms for "
              f"{len(rows)} rows ({len(rows) / n_ms * 1e3:.0f} rows/s)",
              flush=True)
        if si == SPLIT_REPORTED:
            # reads, quals, targets, four int32 per row, both LUTs in;
            # a float32 and an int32 per row out
            n_bytes = sum(a.nbytes for a in arrays) + 2 * 71 * 4 + 8 * B
            bound = _bound(n_bytes, SPLIT_OPS_PER_TERM * terms)
            print(f"    bound {bound['bound_ms']:.6f} ms by "
                  f"{bound['bound_by']}", flush=True)
            reported = {"ms": k_ms, "plain_ms": p_ms, **bound}
        if si == SPLIT_TYPICAL:
            _check_scan_router(batch, idx, valid, qconv, targets, ranges)
    reported["max_abs_err"] = max_err
    return reported


def _check_scan_router(batch, idx, valid, qconv, targets, ranges) -> None:
    """DeviceScanContext.scan_multi on the card, on a typical call: equal
    to the native host scan bit for bit; one host-to-device and one
    device-to-host copy a call, counted in a profiler trace; host-clock
    ms a call beside the native scan's."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from manta_tpu_torch.scoring import device_scan
    from manta_tpu_torch.scoring.evidence import split_read_scan_multi

    ctx = device_scan.DeviceScanContext(device="cuda")
    for k in device_scan.EXACT_COPIES:
        device_scan.EXACT_COPIES[k] = 0
    call = lambda i=idx: ctx.scan_multi(FLANK, batch, i, qconv, targets,
                                        ranges)
    best, pos = call()                  # the LUTs go over here, once
    native_b, native_p = split_read_scan_multi(FLANK, batch, valid, qconv,
                                               targets, ranges)
    if not (np.array_equal(best[valid], native_b)
            and np.array_equal(pos[valid], native_p)):
        raise AssertionError("scan_multi on the card != the native scan")
    n_calls = 20
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n_calls):
            call()
        torch.cuda.synchronize()
    copies = {"HtoD": 0, "DtoH": 0}
    for e in prof.key_averages():
        for kind in copies:
            if "memcpy" in e.key.lower() and kind.lower() in e.key.lower():
                copies[kind] += e.count
    counted = dict(device_scan.EXACT_COPIES)
    # a trace can lose events (it never invents one): no more than one
    # copy each way a call in the trace, exactly one by the router's
    # own count
    if not all(n_calls // 2 <= n <= n_calls for n in copies.values()) \
            or counted != {"h2d": n_calls + 1, "d2h": n_calls + 1}:
        raise AssertionError(f"{n_calls} scan_multi calls made {copies} "
                             f"copies in the trace, {counted} by the "
                             "router's count (one call more); wanted one "
                             "each way a call")
    times = {"router": [], "native": []}
    for _ in range(n_calls):
        t0 = time.perf_counter()
        call()
        times["router"].append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        split_read_scan_multi(FLANK, batch, valid, qconv, targets, ranges)
        times["native"].append(time.perf_counter() - t0)
    print(f"router: scan_multi on the card, {len(idx)} reads x "
          f"{len(targets)} targets == native scan (bit-equal); "
          f"{copies['HtoD']} host-to-device and {copies['DtoH']} "
          f"device-to-host copies in the profiler's trace of {n_calls} "
          f"calls, {n_calls} each by the router's count; "
          f"{statistics.median(times['router']) * 1e3:.4f} ms a call "
          f"(host clock, median of {n_calls}), native scan of the "
          f"{len(valid)} valid reads "
          f"{statistics.median(times['native']) * 1e3:.4f} ms", flush=True)


def _records(path):
    with gzip.open(path, "rt") as f:
        return [ln for ln in f if not ln.startswith("#")]


def _calls(line):
    """The call-level fields of a VCF record: CHROM POS REF ALT FILTER,
    SOMATICSCORE and every sample's GT."""
    f = line.rstrip("\n").split("\t")
    info = dict(kv.partition("=")[::2] for kv in f[7].split(";"))
    return (f[0], f[1], f[3], f[4], f[6], info.get("SOMATICSCORE"),
            [smp.split(":")[0] for smp in f[9:]])


def _format_diffs(got, want):
    """The FORMAT fields that differ, record by record."""
    out = []
    for g, w in zip(got, want):
        gf, wf = g.rstrip("\n").split("\t"), w.rstrip("\n").split("\t")
        keys = gf[8].split(":")
        for si, (gs, ws) in enumerate(zip(gf[9:], wf[9:])):
            for key, a, b in zip(keys, gs.split(":"), ws.split(":")):
                if a != b:
                    out.append(f"{gf[0]}:{gf[1]} sample {si} {key} {a} "
                               f"(oracle {b})")
    return out


def _reset_counts():
    from manta_tpu_torch.align import cuda_jumpscore, cuda_splitscore
    from manta_tpu_torch.align import device_jumpscore as dj
    from manta_tpu_torch.align import device_splitscore as ds
    from manta_tpu_torch.scoring.device_scan import EXACT_COPIES, SCAN_STATS
    for launches in (cuda_jumpscore.KERNEL_LAUNCHES,
                     cuda_splitscore.KERNEL_LAUNCHES):
        for k in launches:
            launches[k] = 0
    dj.PLAIN_CALLS["cuda"] = 0
    ds.PLAIN_CALLS["cuda"] = 0
    for stats in (dj.DISPATCH_STATS, SCAN_STATS, EXACT_COPIES):
        for k in stats:
            stats[k] = 0.0 if k in ("wall", "first_wall") else 0


def _counts():
    from manta_tpu_torch.align import cuda_jumpscore, cuda_splitscore
    from manta_tpu_torch.align import device_jumpscore as dj
    from manta_tpu_torch.align import device_splitscore as ds
    from manta_tpu_torch.scoring.device_scan import EXACT_COPIES, SCAN_STATS
    return {"copies": dict(EXACT_COPIES), "jump": cuda_jumpscore.KERNEL_LAUNCHES["jump_score"],
            "bounded": cuda_jumpscore.KERNEL_LAUNCHES["jump_score_bounded"],
            "split": cuda_splitscore.KERNEL_LAUNCHES["split_score"],
            "plain_jump": dj.PLAIN_CALLS["cuda"],
            "plain_split": ds.PLAIN_CALLS["cuda"],
            "dispatch": dict(dj.DISPATCH_STATS), "scan": dict(SCAN_STATS)}


def _check_counts(what, mode, c):
    """The device paths of ``mode`` ran through their kernels only: K1
    for every contig dispatch, K3 for every exact scan and mxu fallback,
    no plain form on CUDA, and nothing on the device for 'off'."""
    scan = c["scan"]
    if c["plain_jump"] or c["plain_split"]:
        raise AssertionError(f"{what} ({mode}): plain-form calls on CUDA: "
                             f"{c['plain_jump']} jump, {c['plain_split']} "
                             "split")
    if c["bounded"]:
        raise AssertionError(f"{what} ({mode}): {c['bounded']} bounded jump "
                             "launches; the workflow scores on the exact "
                             "kernel")
    if c["jump"] != c["dispatch"]["calls"]:
        raise AssertionError(f"{what} ({mode}): {c['jump']} jump launches "
                             f"for {c['dispatch']['calls']} dispatches")
    if c["split"] != scan["exact"] + scan["fallback"]:
        raise AssertionError(f"{what} ({mode}): {c['split']} split launches "
                             f"for {scan['exact']} exact scans and "
                             f"{scan['fallback']} fallbacks")
    if set(c["copies"].values()) != {c["split"]}:
        raise AssertionError(f"{what} ({mode}): {c['split']} split launches "
                             f"with {c['copies']} copies; wanted one each "
                             "way a launch")
    if mode == "off" and (c["jump"] or scan["exact"] + scan["mxu"]):
        raise AssertionError(f"{what} (off) used the device")
    if mode == "jump" and scan["exact"] + scan["mxu"]:
        raise AssertionError(f"{what} (jump) ran device split scans")
    if mode == "exact" and (scan["mxu"] or not c["split"]):
        raise AssertionError(f"{what} (exact): {c['split']} split launches,"
                             f" {scan['mxu']} mxu scans")
    if mode == "mxu" and (scan["exact"] or not scan["mxu"]):
        raise AssertionError(f"{what} (mxu): {scan['mxu']} mxu scans, "
                             f"{scan['exact']} exact scans")


def _describe(c):
    scan = c["scan"]
    n_scans = scan["exact"] + scan["mxu"] + scan["fallback"]
    return (f"{c['dispatch']['jobs']} contig jobs in {c['dispatch']['calls']}"
            f" dispatches ({c['dispatch']['wall']:.3f} s), {c['jump']} jump "
            f"launches; split scans exact {scan['exact']}, mxu {scan['mxu']},"
            f" fallback {scan['fallback']} ({scan['rows']} rows, "
            f"{scan['wall']:.3f} s"
            + (f", {scan['wall'] / n_scans * 1e3:.4f} ms a scan_multi call"
               if n_scans else "")
            + f"), {c['split']} split launches, {c['copies']['h2d']} "
            f"host-to-device and {c['copies']['d2h']} device-to-host "
            "copies; 0 plain-form calls on CUDA")


def demo_fasta() -> str:
    """The demo reference, extracted once into the git-ignored work
    directory (as tests/conftest.py does)."""
    fa = os.path.join(WORK, FASTA_NAME)
    if not os.path.exists(fa):
        os.makedirs(WORK, exist_ok=True)
        with tarfile.open(os.path.join(DEMO, FASTA_NAME + ".tar.bz2")) as tf:
            tf.extractall(WORK, filter="data")
        if not os.path.exists(fa):
            for root, _dirs, files in os.walk(WORK):
                if FASTA_NAME in files:
                    os.rename(os.path.join(root, FASTA_NAME), fa)
                    break
    if not os.path.exists(fa + ".fai"):
        shutil.copy(os.path.join(DEMO, FASTA_NAME + ".fai"), fa + ".fai")
    return fa


def demo_workflow(device: str = "cuda") -> None:
    phase("demo workflow: tumor/normal, scoring off, jump, exact, mxu, -j 1")
    from manta_tpu_torch.workflow.run import run_workflow
    fasta = demo_fasta()
    want = _records(os.path.join(DEMO, "expectedResults",
                                 "somaticSV.vcf.gz"))
    for mode in ("off", "jump", "exact", "mxu"):
        run_dir = os.path.join(WORK, "chip_smoke", f"demo_{mode}")
        shutil.rmtree(run_dir, ignore_errors=True)
        _reset_counts()
        t0 = time.perf_counter()
        run_workflow([os.path.join(DEMO, NORMAL_BAM)],
                     [os.path.join(DEMO, TUMOR_BAM)], fasta, run_dir,
                     is_exome=True, use_device_scoring=mode, device=device,
                     n_jobs=1, verbose=False)
        wall = time.perf_counter() - t0
        c = _counts()
        got = _records(os.path.join(run_dir, "results", "variants",
                                    "somaticSV.vcf.gz"))
        _check_counts("demo", mode, c)
        if mode == "mxu":
            # ~1e-6 relative score error: the calls must be the oracle's
            if [_calls(ln) for ln in got] != [_calls(ln) for ln in want]:
                raise AssertionError("demo (mxu): somaticSV calls differ "
                                     "from the oracle")
            diffs = _format_diffs(got, want)
            match = (f"calls == oracle ({len(got)} records), FORMAT fields "
                     f"that differ: {diffs if diffs else 'none'}")
        elif got != want:
            raise AssertionError(f"demo ({mode}): somaticSV.vcf.gz body "
                                 "differs from the oracle")
        else:
            match = f"somaticSV body == oracle ({len(got)} records)"
        print(f"{mode:>5}: {match}; {_describe(c)}; wall {wall:.2f} s",
              flush=True)


def _phase_walls(run_dir: str) -> str:
    """Seconds from each phase's first log line to the next phase's:
    phase 0 (stats, depth), phase 1 (graph), phase 2 (candidates) and
    the final sort, from the run's workspace/workflow_log.txt."""
    import datetime
    marks = (("phase 0", "estimating fragment-size"),
             ("phase 1", "building breakend graph"),
             ("phase 2", "generating and scoring"),
             ("sort+index", "processed "), ("end", "workflow complete"))
    with open(os.path.join(run_dir, "workspace", "workflow_log.txt")) as f:
        stamps = [(datetime.datetime.fromisoformat(ln[1:24]), ln[26:])
                  for ln in f]
    at = [next(t for t, msg in stamps if msg.startswith(key))
          for _name, key in marks]
    return ", ".join(f"{marks[i][0]} {(at[i + 1] - at[i]).total_seconds():.2f} s"
                     for i in range(len(marks) - 1))


def wgs_workload(device: str = "cuda", wgs_args=WGS_ARGS) -> dict:
    """Returns the kernel launches of the main paths: jump_score from
    the 'jump' run, split_score from the 'exact' run."""
    phase("WGS-shaped germline workload: scoring off, jump, exact, mxu")
    from manta_tpu_torch.workflow.run import run_workflow
    work = os.path.join(WORK, "chip_smoke", "wgs")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    prefix = os.path.join(work, "w")
    t0 = time.perf_counter()
    # a subprocess: the generator never shares a process that touched
    # CUDA; it inherits the native core's library path
    gen = subprocess.run(
        [sys.executable, os.path.join(REPO, "benchmarks", "wgs_workload.py"),
         "--out", prefix, *wgs_args], capture_output=True, text=True,
        cwd=REPO)
    if gen.returncode != 0:
        raise RuntimeError(f"workload generation failed:\n{gen.stdout}\n"
                           f"{gen.stderr}")
    reads = next(ln for ln in gen.stdout.splitlines() if " wrote " in ln)
    print(f"generated in {time.perf_counter() - t0:.1f} s: "
          f"{reads.split('] ', 1)[1]}", flush=True)

    # the jump run's dispatches, as the scorer hands them to the
    # kernel: kept for the bounded kernel's flag count below
    from manta_tpu_torch.align import device_jumpscore as dj
    dispatches = []
    score = dj._score

    def keeping_score(*a):
        dispatches.append(a)
        return score(*a)

    bodies, counted = {}, {}
    for mode in ("off", "jump", "exact", "mxu"):
        run_dir = os.path.join(work, f"run_{mode}")
        # each path's counts are set to 0 just before it and read just
        # after
        _reset_counts()
        if mode == "jump":
            dj._score = keeping_score
        t0 = time.perf_counter()
        try:
            run_workflow([prefix + ".bam"], [], prefix + ".fa", run_dir,
                         use_device_scoring=mode, device=device, n_jobs=1,
                         verbose=False)
        finally:
            dj._score = score
        wall = time.perf_counter() - t0
        c = counted[mode] = _counts()
        _check_counts("WGS-shaped", mode, c)
        bodies[mode] = _records(os.path.join(
            run_dir, "results", "variants", "diploidSV.vcf.gz"))
        with open(os.path.join(run_dir, "workspace",
                               "workflow_log.txt")) as f:
            edges = [ln.split("processed ")[1].split()[0] for ln in f
                     if "graph edges" in ln and "processed " in ln]
        print(f"{mode:>5} -j 1: wall {wall:.2f} s, {edges[-1]} graph "
              f"edges, {len(bodies[mode])} diploid records; {_describe(c)}",
              flush=True)
        print(f"           {_phase_walls(run_dir)}", flush=True)
    for mode in ("jump", "exact"):
        if bodies[mode] != bodies["off"]:
            raise AssertionError("diploidSV.vcf.gz bodies differ between "
                                 f"native and {mode} scoring")
        if counted[mode]["jump"] == 0:
            raise AssertionError(f"{mode}: no jump kernel launch")
    off_calls = [_calls(ln) for ln in bodies["off"]]
    mxu_calls = [_calls(ln) for ln in bodies["mxu"]]
    differ = sum(a != b for a, b in zip(off_calls, mxu_calls)) \
        + abs(len(off_calls) - len(mxu_calls))
    print(f"mxu: {differ} diploid records differ from off at call level "
          f"({len(mxu_calls)} vs {len(off_calls)} records); "
          f"{counted['mxu']['split']} split-kernel fallback launches",
          flush=True)

    # -j 2 through the command line, in a fresh process: phases 0 and 2
    # fork workers; each phase-2 worker initialises CUDA and launches
    # both kernels
    run_dir = os.path.join(work, "run_cli_j2")
    t0 = time.perf_counter()
    cli = subprocess.run(
        [sys.executable, "-m", "manta_tpu_torch.workflow.run", "--bam",
         prefix + ".bam", "--reference", prefix + ".fa", "--run-dir",
         run_dir, "-j", "2", "--device-scoring", "exact"],
        capture_output=True, text=True, cwd=REPO)
    wall = time.perf_counter() - t0
    if cli.returncode != 0:
        raise RuntimeError(f"workflow CLI -j 2 failed:\n{cli.stderr}")
    jump = re.findall(r"device-dispatch pid=(\d+): .* (\d+) kernel launches",
                      cli.stderr)
    split = re.findall(r"split-scan pid=(\d+): .* (\d+) kernel launches",
                       cli.stderr)
    body = _records(os.path.join(run_dir, "results", "variants",
                                 "diploidSV.vcf.gz"))
    depth = {}
    for name in ("run_off", "run_cli_j2"):
        with open(os.path.join(work, name, "workspace",
                               "chromDepth.txt")) as f:
            depth[name] = f.read()
    print(f"exact -j 2 (python -m manta_tpu_torch.workflow.run): wall "
          f"{wall:.2f} s, {len(body)} diploid records; jump launches per "
          f"worker pid {dict(jump)}, split launches per worker pid "
          f"{dict(split)}; chromDepth.txt "
          f"{depth['run_cli_j2'].split()}", flush=True)
    if body != bodies["off"]:
        raise AssertionError("the -j 2 exact run differs from the native run")
    if not sum(int(n) for _p, n in jump) or \
            not sum(int(n) for _p, n in split):
        raise AssertionError("the -j 2 exact run launched no jump or no "
                             "split kernel")
    if depth["run_cli_j2"] != depth["run_off"]:
        raise AssertionError("-j 2 chromDepth.txt differs from -j 1's")
    print("diploidSV body identical: off, jump and exact at -j 1, exact at "
          "-j 2; -j 2 chromDepth.txt == -j 1's", flush=True)
    _flag_real_jobs(dispatches, counted["jump"]["dispatch"]["jobs"])
    return {"jump_score": counted["jump"]["jump"],
            "split_score": counted["exact"]["split"]}


def _flag_real_jobs(dispatches, n_jobs: int) -> None:
    """The contig jobs of the WGS-shaped jump run through the bounded
    kernel: how many rows flag, and that its rerun gives the exact
    kernel's scores. The workflow itself never runs the bounded kernel."""
    import torch
    from manta_tpu_torch.align import cuda_jumpscore as cj
    if len(dispatches) == 0:
        raise AssertionError("the jump run kept no dispatch")
    for rounds in BOUNDED_ROUNDS:
        rows = flagged = 0
        for (*t, scores, jump) in dispatches:
            args = (scores.match, scores.mismatch, scores.open,
                    scores.extend, scores.off_edge, jump)
            fixed, n = cj.jump_score_bounded_cuda(*t, *args, rounds)
            if not torch.equal(fixed, cj.jump_score_cuda(*t, *args)):
                raise AssertionError("bounded + rerun != exact kernel on "
                                     f"real contig jobs, K={rounds}")
            rows += t[0].shape[0]
            flagged += n
        shapes = sorted({(t[0].shape[0], t[0].shape[1], t[2].shape[1],
                          t[4].shape[1]) for (*t, _s, _j) in dispatches})
        print(f"bounded kernel on the jump run's {len(dispatches)} "
              f"dispatches, K={rounds}: {flagged} rows flagged of {rows} "
              f"padded rows ({n_jobs} contig jobs; pad rows never flag); "
              f"bounded + rerun == exact kernel; shapes (B, nq, nr1, nr2) "
              f"{shapes}", flush=True)


def device_timing() -> dict:
    """The timing entry point as a user runs it, in a process of its
    own: prints its records; returns its kernel launch counts, each of
    which must be positive."""
    phase("timing entry point: python -m manta_tpu_torch.tools.device_timing")
    out = os.path.join(WORK, "chip_smoke", "device_timing.jsonl")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    if os.path.exists(out):
        os.remove(out)
    t0 = time.perf_counter()
    run = subprocess.run(
        [sys.executable, "-m", "manta_tpu_torch.tools.device_timing",
         "--kernel", "all", "--json", out],
        capture_output=True, text=True, cwd=REPO)
    if run.returncode != 0:
        raise RuntimeError(f"device_timing failed ({run.returncode}):\n"
                           f"{run.stdout}\n{run.stderr[-3000:]}")
    with open(out) as f:
        records = [json.loads(ln) for ln in f]
    for rec in records:
        print(json.dumps(rec), flush=True)
    if any("error" in rec for rec in records):
        raise AssertionError("a bench of the timing entry point failed")
    names = {rec.get("kernel") for rec in records}
    want = {"matmul_bf16_ref", "jump_score_dp", "jump_score_cuda",
            "split_scan_exact", "split_scan_cuda",
            "split_scan_cuda_factored", "split_scan_mxu",
            "scan_router_exact"} | {
        f"jump_score_cuda_bounded_k{k}" for k in BOUNDED_ROUNDS}
    if not want <= names:
        raise AssertionError(f"missing records: {sorted(want - names)}")
    counts = records[-1]["kernel_launches"]
    if min(counts[k] for k in KERNELS) <= 0:
        raise AssertionError(f"the timing path left a kernel unlaunched: "
                             f"{counts}")
    print(f"launches of the timing path {counts}; "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return counts


def main() -> None:
    if not os.path.isdir(os.path.join(REPO, "manta_tpu_torch")):
        sys.exit("chip_smoke.py: run it from the root of a checkout "
                 "(manta_tpu_torch/ not found beside it)")
    sys.path.insert(0, REPO)
    t_start = time.perf_counter()
    card = environment()
    build()
    measured = {"jump_score": check_jump_kernel(),
                "jump_score_bounded": check_bounded_kernel(),
                "split_score": check_split_kernel(card)}
    demo_workflow()
    launches = wgs_workload()
    launches["jump_score_bounded"] = device_timing()["jump_score_bounded"]
    foreign = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "manta_tpu"))
    if foreign:
        raise AssertionError(f"JAX or the JAX package was imported: "
                             f"{foreign[:8]}")
    import torch
    print(f"\nno jax, jaxlib or manta_tpu module imported; total "
          f"{time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": [{
        "name": name, "route": "cuda", "source": source,
        "replaces": replaces, "launches": launches[name],
        **{key: measured[name][key] for key in (
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")}}
        for name, (source, replaces) in KERNELS.items()]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
