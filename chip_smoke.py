#!/usr/bin/env python3
"""Smoke run of manta_tpu_torch on one CUDA GPU (Hopper, sm_90a).

    python3 chip_smoke.py

Run from the root of a checkout. It drives the port's main path:

1. environment: torch and CUDA versions, the card's name and power
   limit, the native core, and no JAX anywhere in the process;
2. build: nvcc builds the jump-DP kernel from manta_tpu_torch/csrc/;
3. kernel: the CUDA kernel, the plain PyTorch form on the card and the
   native score batch give identical int32 scores at the scorer's
   bucket shapes; kernel and plain form are timed with CUDA events;
4. demo: the tumor/normal demo through the port's workflow with device
   jump scoring on CUDA; the somatic VCF body equals the oracle's;
5. WGS-shaped: a seeded germline workload (benchmarks/wgs_workload.py,
   in a subprocess) through the port's workflow with native and with
   CUDA jump scoring; the diploid VCF bodies are identical and the
   kernel was launched.

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
KERNEL_SOURCE = "manta_tpu_torch/csrc/jump_score.cu"
REPLACES = "manta_tpu/align/pallas_jumpscore.py:79"
# (B, longest query, longest reference): the bench shape (bench.py:158,
# bucketed to 512/1024), a wide batch of short contigs, the last tier,
# and one query beyond it (bucketed to 8192). References are at least
# as long as queries, as around a real contig: the native score batch
# departs from the full traceback aligner on some queries longer than
# both references together (ROADMAP.md Queue 3)
KERNEL_SHAPES = ((64, 400, 800), (256, 128, 256), (8, 4096, 4096),
                 (8, 6000, 6000))
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
    phase("build")
    from manta_tpu_torch import _build
    from manta_tpu_torch.align import cuda_jumpscore
    cuda_jumpscore.max_query_width()          # builds and loads
    secs = _build.BUILD_SECONDS.get("jump_score")
    print(f"{KERNEL_SOURCE} -> manta_tpu_torch/build/libjump_score.so "
          f"({' '.join(_build.NVCC_FLAGS[:2])}): "
          + (f"built in {secs:.2f} s" if secs is not None
             else "up to date, not rebuilt"), flush=True)
    log = os.path.join(_build.BUILD_DIR, "libjump_score.so.log")
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


def check_kernel() -> dict:
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


def _records(path):
    with gzip.open(path, "rt") as f:
        return [ln for ln in f if not ln.startswith("#")]


def _reset_counts():
    from manta_tpu_torch.align import cuda_jumpscore
    from manta_tpu_torch.align import device_jumpscore as dj
    cuda_jumpscore.KERNEL_LAUNCHES["jump_score"] = 0
    dj.PLAIN_CALLS["cuda"] = 0
    for k in dj.DISPATCH_STATS:
        dj.DISPATCH_STATS[k] = 0 if k in ("calls", "jobs", "rows") else 0.0


def _counts():
    from manta_tpu_torch.align import cuda_jumpscore
    from manta_tpu_torch.align import device_jumpscore as dj
    return (cuda_jumpscore.KERNEL_LAUNCHES["jump_score"],
            dj.PLAIN_CALLS["cuda"], dict(dj.DISPATCH_STATS))


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
    phase("demo workflow: tumor/normal, native vs device jump scoring, -j 1")
    from manta_tpu_torch.workflow.run import run_workflow
    fasta = demo_fasta()
    want = _records(os.path.join(DEMO, "expectedResults",
                                 "somaticSV.vcf.gz"))
    for mode in ("off", "jump"):
        run_dir = os.path.join(WORK, "chip_smoke", f"demo_{mode}")
        shutil.rmtree(run_dir, ignore_errors=True)
        _reset_counts()
        t0 = time.perf_counter()
        run_workflow([os.path.join(DEMO, NORMAL_BAM)],
                     [os.path.join(DEMO, TUMOR_BAM)], fasta, run_dir,
                     is_exome=True, use_device_scoring=mode, device=device,
                     n_jobs=1, verbose=False)
        wall = time.perf_counter() - t0
        launches, plain_cuda, stats = _counts()
        got = _records(os.path.join(run_dir, "results", "variants",
                                    "somaticSV.vcf.gz"))
        if got != want:
            raise AssertionError(f"demo ({mode}): somaticSV.vcf.gz body "
                                 "differs from the oracle")
        if plain_cuda or launches != stats["calls"]:
            raise AssertionError(f"demo: {launches} kernel launches for "
                                 f"{stats['calls']} dispatches, "
                                 f"{plain_cuda} plain-form calls on CUDA")
        print(f"{mode:>4}: somaticSV body == oracle ({len(got)} records); "
              f"{stats['jobs']} contig jobs in {stats['calls']} "
              f"dispatches, {launches} kernel launches, 0 plain-form calls "
              f"on CUDA; wall {wall:.2f} s", flush=True)


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


def wgs_workload(device: str = "cuda", wgs_args=WGS_ARGS) -> int:
    """Returns the kernel launches of the device run."""
    phase("WGS-shaped germline workload: native vs CUDA jump scoring")
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

    bodies, walls, counted = {}, {}, {}
    for mode in ("off", "jump"):
        run_dir = os.path.join(work, f"run_{mode}")
        _reset_counts()
        t0 = time.perf_counter()
        run_workflow([prefix + ".bam"], [], prefix + ".fa", run_dir,
                     use_device_scoring=mode, device=device, n_jobs=1,
                     verbose=False)
        walls[mode] = time.perf_counter() - t0
        launches, plain_cuda, stats = counted[mode] = _counts()
        bodies[mode] = _records(os.path.join(
            run_dir, "results", "variants", "diploidSV.vcf.gz"))
        with open(os.path.join(run_dir, "workspace",
                               "workflow_log.txt")) as f:
            edges = [ln.split("processed ")[1].split()[0] for ln in f
                     if "graph edges" in ln and "processed " in ln]
        print(f"{mode:>4} -j 1: wall {walls[mode]:.2f} s, {edges[-1]} graph "
              f"edges, {len(bodies[mode])} diploid records, {stats['jobs']} "
              f"contig jobs in {stats['calls']} dispatches "
              f"({stats['wall']:.3f} s), {launches} kernel launches, "
              f"{plain_cuda} plain-form calls on CUDA", flush=True)
        print(f"          {_phase_walls(run_dir)}", flush=True)
    launches, plain_cuda, _stats = counted["jump"]
    if bodies["off"] != bodies["jump"]:
        raise AssertionError("diploidSV.vcf.gz bodies differ between "
                             "native and CUDA jump scoring")
    if launches == 0 or plain_cuda:
        raise AssertionError(f"CUDA run: {launches} kernel launches, "
                             f"{plain_cuda} plain-form calls on CUDA")

    # -j 2 through the command line, in a fresh process: phase 2 forks
    # workers, and each one initialises CUDA and launches the kernel
    run_dir = os.path.join(work, "run_cli_j2")
    t0 = time.perf_counter()
    cli = subprocess.run(
        [sys.executable, "-m", "manta_tpu_torch.workflow.run", "--bam",
         prefix + ".bam", "--reference", prefix + ".fa", "--run-dir",
         run_dir, "-j", "2", "--device-scoring", "jump"],
        capture_output=True, text=True, cwd=REPO)
    wall = time.perf_counter() - t0
    if cli.returncode != 0:
        raise RuntimeError(f"workflow CLI -j 2 failed:\n{cli.stderr}")
    worker_launches = [int(n) for n in re.findall(
        r"device-dispatch pid=\d+: .* (\d+) kernel launches", cli.stderr)]
    body = _records(os.path.join(run_dir, "results", "variants",
                                 "diploidSV.vcf.gz"))
    print(f"jump -j 2 (python -m manta_tpu_torch.workflow.run): wall "
          f"{wall:.2f} s, {len(body)} diploid records, kernel launches per "
          f"process {worker_launches}", flush=True)
    if body != bodies["off"] or sum(worker_launches) == 0:
        raise AssertionError("the -j 2 CUDA run differs from the native "
                             "run or launched no kernel")
    print("diploidSV body identical: native -j 1, CUDA -j 1, CUDA -j 2",
          flush=True)
    return launches


def main() -> None:
    if not os.path.isdir(os.path.join(REPO, "manta_tpu_torch")):
        sys.exit("chip_smoke.py: run it from the root of a checkout "
                 "(manta_tpu_torch/ not found beside it)")
    sys.path.insert(0, REPO)
    t_start = time.perf_counter()
    card = environment()
    build()
    bench = check_kernel()
    demo_workflow()
    launches = wgs_workload()
    if "jax" in sys.modules or "jaxlib" in sys.modules:
        raise AssertionError("JAX was imported")
    import torch
    print(f"\nno JAX imported; total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": [{
        "name": "jump_score", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": REPLACES, "launches": launches,
        "max_abs_err": bench["max_abs_err"], "ms": bench["ms"],
        "plain_ms": bench["plain_ms"]}]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
