#!/usr/bin/env python3
"""Smoke run of manta_tpu_torch on one CUDA GPU (Hopper, sm_90a).

    python3 chip_smoke.py

Run from the root of a checkout. It drives the port's main paths,
contig jump scoring (--device-scoring jump) and the device split-read
scan (--device-scoring exact, and mxu):

1. environment: torch and CUDA versions, the card's name and power
   limit, the native core, and no JAX anywhere in the process;
2. build: nvcc builds the jump-DP and the split-scan kernels from
   manta_tpu_torch/csrc/, one process each, started together;
3. kernel (jump): the CUDA kernel, the plain PyTorch form on the card
   and the native score batch give identical int32 scores at the
   scorer's bucket shapes; kernel and plain form are timed with CUDA
   events;
4. kernel (split scan): the CUDA kernel and the plain PyTorch form on
   the card give bit-equal float32 scores and equal positions at the
   bucketed shapes the device scan context gives the kernel, and both
   equal the native host scan on real demo reads; kernel, plain form
   and native scan are timed;
5. demo: the tumor/normal demo through the port's workflow with
   scoring off, jump, exact and mxu on CUDA; the somatic VCF body
   equals the oracle's (byte for byte; mxu at call level);
6. WGS-shaped: a seeded germline workload (benchmarks/wgs_workload.py,
   in a subprocess) through the port's workflow with scoring off, jump,
   exact and mxu; the diploid VCF bodies of off, jump and exact are
   identical and each device path launched its kernels; then exact at
   -j 2 through the CLI, whose body and chromosome depths equal the
   -j 1 runs'.

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
    "split_score": ("manta_tpu_torch/csrc/split_score.cu",
                    "manta_tpu/align/pallas_splitscore.py:50"),
}
# (B, longest query, longest reference): the bench shape (bench.py:158,
# bucketed to 512/1024), a wide batch of short contigs, the last tier,
# and one query beyond it (bucketed to 8192). References are at least
# as long as queries, as around a real contig: the native score batch
# departs from the full traceback aligner on some queries longer than
# both references together (ROADMAP.md Queue 3)
KERNEL_SHAPES = ((64, 400, 800), (256, 128, 256), (8, 4096, 4096),
                 (8, 6000, 6000))
# (rows B = reads x 2 targets, read tier Lp, scan tier Tp): the shapes
# DeviceScanContext gives the split kernel; demo reads are 101 bp (Lp
# 256), three joined make ~300 bp (Lp 512). The second is the shape of
# manta_tpu/align/pallas_splitscore.py:19-21 (B=512, T=500, L=150)
SPLIT_SHAPES = ((64, 256, 512), (512, 256, 512), (2048, 256, 1024),
                (64, 512, 2048))
SPLIT_REPORTED = 1           # the index of the shape in the kernels line
FLANK = 50
# germline WGS-shaped workload: 2 x 8 Mb at 35x, about 5.6 M reads
WGS_ARGS = ("--chroms", "2", "--mb", "8", "--depth", "35", "--seed", "7")
TIMED_RUNS = 5


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
                if "registers" in line or "spill" in line:
                    print("  " + line.strip())


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


def _time_ms(fn, runs=TIMED_RUNS):
    import torch
    fn()                                          # warm-up
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
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


def check_jump_kernel() -> dict:
    """Kernel vs plain form (on the card) vs native score batch, at the
    bucketed shapes the scorer gives the kernel. Returns the bench
    shape's numbers."""
    phase("kernel: CUDA jump DP vs plain PyTorch vs native")
    import numpy as np
    import torch
    from manta_tpu.align.aligners import jump_score_batch
    from manta_tpu.candidates.refiner import RefinerOptions
    from manta_tpu_torch.align import cuda_jumpscore
    from manta_tpu_torch.align import device_jumpscore as dj

    opt = RefinerOptions()
    scores, jump = opt.spanning_scores, opt.jump_score
    args = (scores.match, scores.mismatch, scores.open, scores.extend,
            scores.off_edge, jump)
    rng = np.random.default_rng(20261016)
    bench = None
    max_err = 0
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
        k_ms = _time_ms(lambda: cuda_jumpscore.jump_score_cuda(*t, *args))
        p_ms = _time_ms(lambda: dj.batched_jump_score(*t, *args, nq, nr1,
                                                     nr2), runs=3)
        cells = B * nq * (nr1 + nr2)
        print(f"B={B} nq={nq} nr1={nr1} nr2={nr2}: kernel == plain == "
              f"native on {B} rows (tolerance: exact); kernel "
              f"{k_ms:.4f} ms ({cells / k_ms / 1e6:.2f} Gcells/s), plain "
              f"{p_ms:.2f} ms ({cells / p_ms / 1e6:.4f} Gcells/s)",
              flush=True)
        if bench is None:
            bench = {"ms": k_ms, "plain_ms": p_ms}
    bench["max_abs_err"] = max_err
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
    from manta_tpu.io.bam import BamReader
    from manta_tpu.scoring.evidence import QscoreSnp, split_read_scan_multi
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
        print(f"B={B} Lp={Lp} Tp={Tp}: kernel == plain on {B} rows "
              f"({no_pos} with no scan position; tolerance: bit-equal), "
              f"== native on {len(rows)} rows; kernel call {k_ms:.4f} ms "
              f"(CUDA events; {B / k_ms * 1e3:.0f} rows/s), kernel device "
              f"time {device} (profiler), plain {p_ms:.3f} ms "
              f"({B / p_ms * 1e3:.0f} rows/s, {terms / p_ms / 1e6:.4f} "
              f"Gterms/s), native one host core {n_ms:.3f} ms for "
              f"{len(rows)} rows ({len(rows) / n_ms * 1e3:.0f} rows/s)",
              flush=True)
        if si == SPLIT_REPORTED:
            reported = {"ms": k_ms, "plain_ms": p_ms}
    reported["max_abs_err"] = max_err
    return reported


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
    from manta_tpu_torch.scoring.device_scan import SCAN_STATS
    cuda_jumpscore.KERNEL_LAUNCHES["jump_score"] = 0
    cuda_splitscore.KERNEL_LAUNCHES["split_score"] = 0
    dj.PLAIN_CALLS["cuda"] = 0
    ds.PLAIN_CALLS["cuda"] = 0
    for stats in (dj.DISPATCH_STATS, SCAN_STATS):
        for k in stats:
            stats[k] = 0.0 if k in ("wall", "first_wall") else 0


def _counts():
    from manta_tpu_torch.align import cuda_jumpscore, cuda_splitscore
    from manta_tpu_torch.align import device_jumpscore as dj
    from manta_tpu_torch.align import device_splitscore as ds
    from manta_tpu_torch.scoring.device_scan import SCAN_STATS
    return {"jump": cuda_jumpscore.KERNEL_LAUNCHES["jump_score"],
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
    if c["jump"] != c["dispatch"]["calls"]:
        raise AssertionError(f"{what} ({mode}): {c['jump']} jump launches "
                             f"for {c['dispatch']['calls']} dispatches")
    if c["split"] != scan["exact"] + scan["fallback"]:
        raise AssertionError(f"{what} ({mode}): {c['split']} split launches "
                             f"for {scan['exact']} exact scans and "
                             f"{scan['fallback']} fallbacks")
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
    return (f"{c['dispatch']['jobs']} contig jobs in {c['dispatch']['calls']}"
            f" dispatches ({c['dispatch']['wall']:.3f} s), {c['jump']} jump "
            f"launches; split scans exact {scan['exact']}, mxu {scan['mxu']},"
            f" fallback {scan['fallback']} ({scan['rows']} rows, "
            f"{scan['wall']:.3f} s), {c['split']} split launches; 0 "
            "plain-form calls on CUDA")


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

    bodies, counted = {}, {}
    for mode in ("off", "jump", "exact", "mxu"):
        run_dir = os.path.join(work, f"run_{mode}")
        # each path's counts are set to 0 just before it and read just
        # after
        _reset_counts()
        t0 = time.perf_counter()
        run_workflow([prefix + ".bam"], [], prefix + ".fa", run_dir,
                     use_device_scoring=mode, device=device, n_jobs=1,
                     verbose=False)
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
    return {"jump_score": counted["jump"]["jump"],
            "split_score": counted["exact"]["split"]}


def main() -> None:
    if not os.path.isdir(os.path.join(REPO, "manta_tpu_torch")):
        sys.exit("chip_smoke.py: run it from the root of a checkout "
                 "(manta_tpu_torch/ not found beside it)")
    sys.path.insert(0, REPO)
    t_start = time.perf_counter()
    card = environment()
    build()
    measured = {"jump_score": check_jump_kernel(),
                "split_score": check_split_kernel(card)}
    demo_workflow()
    launches = wgs_workload()
    if "jax" in sys.modules or "jaxlib" in sys.modules:
        raise AssertionError("JAX was imported")
    import torch
    print(f"\nno JAX imported; total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": [{
        "name": name, "route": "cuda", "source": source,
        "replaces": replaces, "launches": launches[name],
        "max_abs_err": measured[name]["max_abs_err"],
        "ms": measured[name]["ms"], "plain_ms": measured[name]["plain_ms"]}
        for name, (source, replaces) in KERNELS.items()]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
