#!/usr/bin/env python3
"""Smoke run of manta_tpu_torch on one CUDA GPU (Hopper, sm_90a).

    python3 chip_smoke.py

Run from the root of a checkout. It drives the port's main paths,
contig jump scoring (--device-scoring jump), the device split-read scan
(--device-scoring exact, and mxu), the measurement entry points
(tools.bench_wgs_at_scale, the truth checker of tools.wgs_workload,
tools.bench), the benchmark twins (tools.bench_edges, bench_graphbuild,
soak_graph, bench_reduce, bench_repeats), the kernel-timing entry point
(python -m manta_tpu_torch.tools.device_timing), the multi-device dry
run (manta_tpu_torch.graft_entry.dryrun_multichip) and the calling modes
beyond germline and somatic DNA (RNA, joint germline at ten samples,
tumor-only, --rescore):

1. environment: torch and CUDA versions, the card's name and power
   limit, the native core, and no JAX anywhere in the process;
2. build: nvcc builds the jump-DP, the bounded jump-DP and the
   split-scan kernels from manta_tpu_torch/csrc/, one process each,
   started together;
3. kernel (jump): the CUDA kernel, the plain PyTorch form on the card
   and the native score batch give identical int32 scores at the
   scorer's bucket shapes, the main path's bucket among them; kernel
   and plain form are timed with CUDA events; then, untimed, widths at
   a warp's edge (nq + 1 =
   32 x lanes and one more), a row far shorter than its bucket, and
   every layout (one warp a row, several) against the plain form;
3b. kernel (bounded jump): at the same shapes and prefix_rounds 3 and
   5, on random jobs mixed with a long junction insertion (flags) and a
   short query (cannot flag): score and flag of the CUDA kernel equal
   the plain flagged form on every row, and the bounded form with its
   rerun equals the exact kernel and the exact plain form; timed in
   turns with the exact kernel; then, untimed, widths at a warp's edge
   and every layout against the plain flagged form;
4. kernel (split scan): the CUDA kernel, through the call with a row
   per (read, target) pair and through the factored call (each read
   and target once), and the plain PyTorch forms on the card give
   bit-equal float32 scores and equal positions at the bucketed shapes
   the device scan context gives the kernel, and all equal the native
   host scan on real demo reads; kernel, plain form and native scan are
   timed; at 512 pairs K3's library yardstick, the port's matmul form
   (device_splitscore_mxu, two torch.bmm) on the same tensors, by
   profiler device time, with its largest difference from K3; then the
   router itself (DeviceScanContext.scan_multi) on a
   typical call: equal to the native scan, one host-to-device and one
   device-to-host copy a call in the profiler's trace, ms a call;
5. demo: the tumor/normal demo through the port's workflow with
   scoring off, jump, exact and mxu on CUDA; the somatic VCF body
   equals the oracle's (byte for byte; mxu at call level);
6. WGS-shaped: a seeded germline workload (python -m
   manta_tpu_torch.tools.wgs_workload, in a subprocess started in the
   background after phase 1, as are the generators of 6b and 6d)
   through the port's workflow with scoring off, jump,
   exact and mxu, jump and exact each inside the timing tool's profiler
   window (tools.device_timing's workflow mode, 6e); the diploid VCF
   bodies of off, jump and exact are
   identical and each device path launched its kernels; then exact at
   -j 2 through the CLI, whose body and chromosome depths equal the
   -j 1 runs'; the real contig jobs of the jump run go through the
   bounded kernel once more, for their flag count;
6a. measurement entry points, each a child process, on that workload:
   python -m manta_tpu_torch.tools.bench_wgs_at_scale with jump at -j 2
   (its diploid body equals the 'off' run's; K1 launched in its workers,
   by their device-dispatch exit lines and by the artifact's own
   count), the truth checker (tools.wgs_workload --check --run-dir) on
   the 'off' run and on the at-scale run (both resume; the lines are
   equal but for wall, peak RSS and run directory; recall above 0), and
   python -m manta_tpu_torch.tools.bench (its own 32-tile stress
   workload through the workflow at all cores, mode resolved to jump,
   every dispatch through K1; K1's rate at the reference's shape);
6b. high-span contigs: the demo junction tiled 512 times at a fifth of
   its depth with split-read evidence stripped (python -m
   manta_tpu_torch.tools.stress_workload, in a subprocess: 1,157,120
   reads, about three contigs a junction) through the workflow's command
   line with scoring off, jump at the default edge chunk and jump at
   MANTA_TPU_EDGE_CHUNK=256, the three at once (one host core each; the
   default chunk's jump run through python -m
   manta_tpu_torch.tools.device_timing --kernel workflow --workload
   high-span, the same run_workflow at -j 1 in a profiler window);
   the tumor VCF bodies are identical, each
   jump run scored at least 1,000 contig jobs, every one of its
   dispatches through the jump kernel by the child's own count; and a
   child that only imports torch and makes a CUDA context, for the
   start-up a device run pays and 'off' does not;
6c. the benchmark twins (python -m manta_tpu_torch.tools.<name>), each a
   child process: bench_edges with jump at -j 1 on the high-span BAM
   (the off run's 2,048 edges, K1 a dispatch by its own count and by its
   exit line), bench_graphbuild at -j 1 and -j 2 on that BAM (reads,
   loci, nodes and edges equal), soak_graph at 60,000 loci on 6
   chromosomes (deterministic, round-trips, under 2 GB), bench_reduce
   twice (equal node counts), and bench_repeats on one seed of the
   WGS-shaped size with 40 repeat anchors, jump then exact on the same
   workload (records identical but for walls and device work; K1
   launched in jump, K3 in exact);
6d. calling modes, after the benchmark twins: RNA fusion mode (--rna)
   on the demo tumor BAM through run_workflow with scoring off, jump and
   exact (identical rnaSV bodies; K1 launched in no mode, since RNA mode
   never defers the spanning path; K3 at RNA's ~50 kb targets, scan tier
   57,344, and at the widest such call K3 against its plain form on the
   card, in chunks of reads, and the native scan, bit for bit, with its
   device time, bound, the router's wall and the matmul form on the same
   tensors; the exact run inside the profiler window); ten-sample joint
   germline
   (python -m manta_tpu_torch.tools.wgs_workload --samples 10) at -j 8
   with off through the command line, jump and exact through the timing
   tool's command line (python -m manta_tpu_torch.tools.device_timing
   --kernel workflow --workload joint --jobs 8: the same run_workflow,
   each phase-2 worker tracing itself, 6f), then the truth
   checker resumed on the three run directories at once (identical diploid
   bodies and check lines; K1 launched in jump and K3 in exact, counted
   in the workers' exit lines); tumor-only on the WGS-shaped BAM with
   off and jump through the command line and exact through the timing
   tool (--workload tumor --jobs 8), checked in tumor mode; and
   --rescore of the
   exact ten-sample run (the graph untouched, the candidates rewritten,
   the same body, K3 launched); walls, phase walls and peak memory of
   every run;
6e. kernels on the main paths: for the profiled runs (WGS-shaped jump
   and exact, high-span jump, RNA exact), each kernel's launches in the
   trace and by its wrapper, equal to each other and to the calls of
   the seam that reaches it (the contig dispatcher, the split router),
   its device time in all and a launch, no more than that seam's wall,
   its useful and padded work, bound and share of it, and its copies
   each way; phase 2's wall and the device's busy share of it (a run
   whose trace in this process lost a launch is made again in a child
   through the tool, its body held against this run's);
6f. kernels in the workers: for the calling modes' runs at -j 8 made
   through the timing tool (ten-sample joint jump and exact, tumor-only
   exact), each kernel's launches in the workers' traces, by their
   wrappers and on their exit lines, all equal, its device time no more
   than its seam's wall summed over the workers, the card's busy time
   (the union over the workers) no more than phase 2's wall, no event
   outside phase 2 and no two kernels of a worker overlapping; the
   workers traced and launching, their CUDA start-ups and where their
   time went in phase 2;
7. the timing entry point, python -m manta_tpu_torch.tools.device_timing
   --kernel all --json, in a subprocess: its records, and its launch
   counts (all three kernels launched); jumpalign's two records, the
   host's full aligner equal to the kernel on 32 of 32 contigs and the
   kernel to the plain form on 512 of 512;
8. dry run: entry() once on the card against its plain form, then
   python -c "...graft_entry.dryrun_multichip(1)" in a subprocess: all
   seven stages on a mesh of one CUDA device, the jump kernel launched
   in stages 2 and 5 and the split kernel in stages 1 and 4 by the
   wrappers' own counts.

Neither JAX nor the JAX package manta_tpu is imported anywhere: not in
this process (checked at the end), and not in a child process, each of
which starts behind a guard on sys.meta_path that refuses jax, jaxlib
and manta_tpu before anything else is imported. The
line before the card's holds, for every kernel, its launches on its
path, its times and its bound: the least time the card could take, the
larger of the bytes (each input once, each output once) over 3.35 TB/s
and the int32/float32 operations of the rows' own lengths over 67 Top/s
(NVIDIA's H100 SXM data sheet), computed from the timed inputs; the
jump kernels' rows also hold the bound at the card's real rate of int32
maxima (bound_ms_int32), and its readings on each main path
(main_paths: launches, device ms, bound, share, copies and the busy
share of phase 2, at -j 1 and in the -j 8 workers).

The last line is {"ok": true, "device": {...}}. Any failure raises, so
the exit code is non-zero and that line is not printed. Without a CUDA
device it exits non-zero before any result.

    python3 chip_smoke.py --genome [--chroms 24|12|6] [--reason TEXT]
        [--steps gen,off,jump,exact,auto,check,armed,shapes]

runs, instead of the phases above, the whole-genome phase: the JAX
package's full-size germline workload (24 chromosomes x 100 Mb at 35x,
seed 7: 838,874,597 reads) through the port's main path at -j 8, one
JSON line a step, printed as it ends and appended to
results_torch/genome/steps.jsonl (--out-dir, beside the runs'
artifacts) so that a cut run keeps what it measured:

a. gen: the host's cores, memory and free disk, then the port's
   generator (python -m manta_tpu_torch.tools.wgs_workload) in a child
   under the memory sampler, beside the kernels' build: its walls
   (simulation, external merge), peak memory, BAM size and read count
   (at full size the JAX package's); it refuses to start when the disk
   cannot hold the merge's runs;
b. off, jump, exact, auto: python -m manta_tpu_torch.tools.
   bench_wgs_at_scale --jobs 8 in a child, unarmed: wall, phase walls,
   serial tail, CPU seconds, the process tree's peak memory (the parent
   and the workers apart), edges, the device work on the workers' exit
   lines, the resolved mode (auto resolves to jump on the card);
c. check: the truth checker resumed on each run at once; the lines
   equal, the diploid bodies byte-identical, and at full size the off
   run's line equal to the JAX package's round-5 line (R05_TRUTH);
d. armed: jump and exact through python -m manta_tpu_torch.tools.
   device_timing --kernel workflow --jobs 8, each phase-2 worker tracing
   itself: launches (traces = wrappers = exit lines = the seams' calls),
   device ms, the shapes launched, work, bound, copies, the busy share
   of phase 2, the workers' CUDA start-ups, no event outside phase 2;
e. shapes: every K1 bucket and K3 tier the armed runs launched at, one
   launch each on seeded inputs of that shape against the plain form on
   the card (bit-equal), with its device time and bound.

--chroms cuts the chromosome count (24, 12, 6 in that order; printed
under "reduced" with --reason); depth, length, seed and -j 8 stay. The
phase ends with the card's line and the same last line.
"""

from __future__ import annotations

import glob
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
# germline WGS-shaped workload: 2 x 4 Mb at 35x, 2,803,936 reads (cut
# from 2 x 8 Mb by genome size, depth kept, to leave room for the
# high-span phase)
WGS_ARGS = ("--chroms", "2", "--mb", "4", "--depth", "35", "--seed", "7")
TIMED_RUNS = 5
# high-span contigs: the shape and size of the JAX package's record
# (benchmarks/results/tpu_e2e_r05.json: 512 tiles, 1,157,120 reads, 2,048
# graph edges, 1,024 contig jobs); (scoring, MANTA_TPU_EDGE_CHUNK) a run,
# None for the workflow's default (24 with device scoring)
HIGH_SPAN_TILES = 512
HIGH_SPAN_READS = 1_157_120
HIGH_SPAN_MIN_JOBS = 1000
HIGH_SPAN_RUNS = (("off", None), ("jump", None), ("jump", 256))
# the benchmark twins' phase: the soak at the size of the JAX package's
# soak test (tests/test_graph_soak.py), the reduce at an eighth of its
# default size (seconds), and one repeats seed at the WGS-shaped size
# above at the host's 8 cores; 40 anchors fit in 2 x 4 Mb (40 truth SVs
# in repeats)
SOAK_ARGS = ("--loci", "60000", "--chroms", "6")
REDUCE_ARGS = ("--loci", "60000", "--chroms", "24")
REPEATS_ARGS = ("--seeds", "3", "--chroms", "2", "--mb", "4", "--anchors",
                "40", "--jobs", "8")
GRAPH_COUNTS = ("reads", "loci", "nodes", "edges")
BOUNDED_ROUNDS = (3, 5)      # benchmarks/device_timing.py:359
# the calling-modes phase: RNA on the demo tumor BAM, ten-sample joint
# germline from the port's generator (WGS_ARGS a sample, about 2.8 M
# reads; at 2 x 2 Mb no candidate of the ten samples assembles two
# contigs and K1 never launches), tumor-only on the WGS-shaped BAM, and
# a rescore; the command-line runs at the card host's 8 cores
CALLING_MODES = ("off", "jump", "exact")
JOINT_SAMPLES = 10
JOINT_ARGS = ("--samples", str(JOINT_SAMPLES), "--chroms", "2", "--mb", "4",
              "--depth", "35", "--seed", "7")
HOST_JOBS = "8"
# RNA mode widens reference windows by 25,000 bases a side
# (candidates/refiner.py:769): its split scans reach scan tier 57,344
RNA_MIN_TP = 50_000
RNA_PLAIN_CHUNK = 64         # reads a call of the plain form in the hold
# the timing tool's jumpalign shape (benchmarks/bench_jumpalign.py:51)
JUMPALIGN_SHAPE = (512, 200, 700)
# the card's published peaks (NVIDIA's data sheet, H100 SXM, 700 W):
# device memory rate, and float32 outside the tensor cores, which is
# also what int32 adds and maxes are held against
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = 67e12
# the card's rate of int32 adds and maxima: 64 lanes a clock on each of
# 132 SMs at the 1.98 GHz boost clock. The 67 Top/s above is float32's
# (128 lanes, two operations a fused multiply-add), so a share of that
# bound understates an int32 kernel by 4x
PEAK_INT32_OPS_PER_S = 132 * 64 * 1.98e9
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


# prepended to every child process's code: jax, jaxlib and manta_tpu
# cannot be imported there, so a child that reaches them fails
_GUARD = """\
import sys


class _RefuseJax:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "manta_tpu"):
            raise ModuleNotFoundError(f"refused in a chip_smoke.py child: {name}")


sys.meta_path.insert(0, _RefuseJax())
"""
CHILDREN = []                # the argv of every child process started
BACKGROUND = []              # the children started in the background
T_START = time.perf_counter()


def _child_cmd(argv) -> list:
    """``python -c`` running ``argv`` (``-m module args`` or ``-c code
    args``) behind the guard."""
    kind, what, *rest = argv
    if kind == "-m":
        code = (_GUARD + "import runpy\n"
                f"runpy.run_module({what!r}, run_name='__main__', "
                "alter_sys=True)\n")
    elif kind == "-c":
        code = _GUARD + what
    else:
        raise ValueError(f"run_child takes -m or -c, not {kind!r}")
    CHILDREN.append(argv)
    return [sys.executable, "-c", code, *rest]


def run_child(argv, env=None) -> subprocess.CompletedProcess:
    """Run ``python <argv>`` (``-m module args`` or ``-c code args``)
    from the checkout's root behind the guard, its output captured."""
    return subprocess.run(_child_cmd(argv), capture_output=True, text=True,
                          cwd=REPO, env=env)


def start_child(argv, log: str, env=None) -> subprocess.Popen:
    """``run_child``'s child started in the background, its stdout and
    stderr to ``log`` and ``log``.err; ``main`` stops it if it is still
    running when the smoke ends."""
    os.makedirs(os.path.dirname(log), exist_ok=True)
    with open(log, "w") as out, open(log + ".err", "w") as err:
        proc = subprocess.Popen(_child_cmd(argv), stdout=out, stderr=err,
                                cwd=REPO, env=env, text=True)
    proc.log = log
    proc.started = time.perf_counter()
    BACKGROUND.append(proc)
    return proc


def wait_child(proc: subprocess.Popen, what: str) -> str:
    """Wait for a ``start_child`` child; its stdout, or raise with its
    output if it failed."""
    rc = proc.wait()
    with open(proc.log) as f:
        out = f.read()
    if rc != 0:
        with open(proc.log + ".err") as f:
            raise RuntimeError(f"{what} failed ({rc}):\n{out[-2000:]}\n"
                               f"{f.read()[-3000:]}")
    return out


def phase(name: str) -> None:
    print(f"\n== {name} (at {time.perf_counter() - T_START:.1f} s)",
          flush=True)


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


def build(names=tuple(KERNELS)) -> None:
    """Build the kernel libraries ``names`` (every one by default) from
    source, one nvcc process per source, all started together; print
    registers and spills, and fail if any kernel spills."""
    phase("build")
    from concurrent.futures import ThreadPoolExecutor

    from manta_tpu_torch import _build
    from manta_tpu_torch.align import cuda_jumpscore, cuda_splitscore
    with ThreadPoolExecutor(len(names)) as pool:
        list(pool.map(_build.build, names))
    loads = {"jump_score": cuda_jumpscore.max_query_width,
             "jump_score_bounded": cuda_jumpscore._bounded_lib,
             "split_score": cuda_splitscore._lib}
    for name in names:
        loads[name]()
    spilled = []
    for name in names:
        source = KERNELS[name][0]
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
                    if "spill" in line and not re.search(
                            r"\b0 bytes spill stores, 0 bytes spill loads",
                            line):
                        spilled.append(f"{name}: {line.strip()}")
    if spilled:
        raise AssertionError("a kernel spills registers:\n"
                             + "\n".join(spilled))


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
    """``_jump_cells_bound`` plus ``bound_ms_int32``: the same
    operations over the card's rate of int32 maxima."""
    bound, n_bytes, n_ops = _jump_cells_bound(arrays, ops_per_cell, n_out)
    bound["bound_ms_int32"] = max(n_bytes / PEAK_BYTES_PER_S,
                                  n_ops / PEAK_INT32_OPS_PER_S) * 1e3
    return bound


def _jump_cells_bound(arrays, ops_per_cell: int, n_out: int) -> dict:
    """Bound of one jump-DP call on the padded numpy inputs: every code
    and length read once, ``n_out`` int32 written per row; the cells are
    those of the rows' own lengths, (qlen + 1) lanes by r1len + r2len
    columns."""
    q, ql, r1, r1l, r2, r2l = arrays
    n_bytes = 4 * (q.size + r1.size + r2.size + (3 + n_out) * len(ql))
    cells = int(((ql.astype("int64") + 1)
                 * (r1l.astype("int64") + r2l)).sum())
    return _bound(n_bytes, ops_per_cell * cells), n_bytes, \
        ops_per_cell * cells


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
        k_ms = _time_ms(lambda: cuda_jumpscore.jump_score_cuda(*t, *args),
                        runs=2 * TIMED_RUNS, calls=5)
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
              f"CUDA events around 5 calls), plain {p_ms:.2f} ms "
              f"({cells / p_ms / 1e6:.4f} Gcells/s); bound "
              f"{bound['bound_ms']:.5f} ms by {bound['bound_by']} "
              f"({bound['bound_ms'] / k_ms:.2%} reached; at the int32 "
              f"rate {bound['bound_ms_int32']:.5f} ms, "
              f"{bound['bound_ms_int32'] / k_ms:.2%}), dependent chain "
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
                *t, *args, rounds), "jump_systolic_kernel", runs=10)
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
                  f"ms; {'%d lanes a thread, %d warp(s) a row' % cj.bounded_kernel_layout(B, nq, rounds)[:2]}; "
                  f"bound {bound['bound_ms']:.5f} ms by "
                  f"{bound['bound_by']} ({bound['bound_ms'] / k_ms:.2%} "
                  f"reached; at the int32 rate "
                  f"{bound['bound_ms_int32']:.5f} ms, "
                  f"{bound['bound_ms_int32'] / k_ms:.2%})", flush=True)
            if bench is None:
                p_ms = _time_ms(lambda: dj.batched_jump_score_flagged(
                    *t, *args, nq, nr1, nr2, rounds), runs=3)
                print(f"    plain flagged form {p_ms:.2f} ms", flush=True)
                bench = {"ms": k_ms, "plain_ms": p_ms, "max_abs_err": 0,
                         **bound}
    cj.raise_on_kernel_error()
    _check_bounded_layouts(rng, args)
    return bench


def _check_bounded_layouts(rng, args) -> None:
    """Untimed, the bounded kernel against the plain flagged form in
    score and flag: widths at a warp's edge (nq + 1 = 32 x lanes, and
    one lane more, whose only lane in the second warp takes its whole
    window from the strip below) in the kernel's own layout and with
    the lanes named; then one width in every layout, from one warp a row
    to many, at windows from shorter than a thread's lanes to longer
    than a strip. Rows that flag (a junction insertion longer than both
    windows) and rows that cannot (a 3-base query) in each."""
    import torch
    from manta_tpu_torch.align import cuda_jumpscore as cj
    from manta_tpu_torch.align import device_jumpscore as dj

    def seq(n):
        return bytes(b"ACGT"[i] for i in rng.integers(0, 4, n))

    def padded(jobs, nq, nr):
        q, ql = dj._pad_to([j[0][:nq] for j in jobs], len(jobs), nq, 1)
        r1, r1l = dj._pad_to([j[1] for j in jobs], len(jobs), nr, 2)
        r2, r2l = dj._pad_to([j[2] for j in jobs], len(jobs), nr, 2)
        return dj.from_reference_inputs(q, ql, r1, r1l, r2, r2l, "cuda")

    def crafted(nq, rounds):
        half = max(2, min(40, (nq - (2 << rounds) - 9) // 2))
        left, right = seq(half), seq(half)
        ins = seq(min((2 << rounds) + 8, max(0, nq - 2 * half)))
        return [(left + ins + right, seq(30) + left, right + seq(30)),
                (seq(3), seq(40), seq(40))]

    def plain(t, nq, nr, rounds):
        return dj.batched_jump_score_flagged(*t, *args, nq, nr, nr, rounds)

    def check(t, nq, rounds, lanes, want):
        """The kernel in the layout of ``lanes`` against ``want``, the
        plain form's (best, flag) on ``t``."""
        best, flag = cj.jump_score_flagged_cuda(*t, *args, rounds,
                                                lanes=lanes)
        p_best, p_flag = want
        if not (torch.equal(best, p_best) and torch.equal(flag, p_flag)):
            raise AssertionError(f"bounded kernel != plain at nq={nq}, "
                                 f"K={rounds}, lanes={lanes}")
        if flag[-1] or not flag.any():
            raise AssertionError(f"nq={nq}, K={rounds}: wanted flagged rows "
                                 "and an unflagged 3-base row")
        return cj.bounded_kernel_layout(t[0].shape[0], nq, rounds, lanes)[:2]

    seen = set()
    for rounds in BOUNDED_ROUNDS:
        for lanes in cj.LANE_CHOICES:
            for over in (0, 1):
                nq = 32 * lanes - 1 + over
                jobs = _jobs(rng, 4, nq, 2 * nq) + crafted(nq, rounds)
                t = padded(jobs, nq, 2 * nq)
                want = plain(t, nq, 2 * nq, rounds)
                for named in (0, lanes):
                    seen.add(check(t, nq, rounds, named, want))
    nq, nr = 700, 600
    for rounds in (2, *BOUNDED_ROUNDS, 7):
        jobs = _jobs(rng, 12, nq, nr) + _jobs(rng, 4, 60, nr) \
            + crafted(nq, rounds)
        t = padded(jobs, nq, nr)
        want = plain(t, nq, nr, rounds)
        for lanes in cj.LANE_CHOICES:
            seen.add(check(t, nq, rounds, lanes, want))
    cj.raise_on_kernel_error()
    one = sorted(x for x in seen if x[1] == 1)
    many = sorted(x for x in seen if x[1] > 1)
    if not one or not many:
        raise AssertionError(f"layouts checked: {sorted(seen)}")
    print(f"widths nq + 1 = 32 x lanes and one more (lanes "
          f"{list(cj.LANE_CHOICES)}, K {list(BOUNDED_ROUNDS)}) and nq={nq} "
          f"in every layout at K 2, {list(BOUNDED_ROUNDS)}, 7: bounded kernel "
          f"(best, flag) == plain (tolerance: exact); (lanes, warps a row) "
          f"one warp {one}, several {many}", flush=True)


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
        terms = device_scan.useful_terms(arrays[5], arrays[3], arrays[4],
                                         arrays[6])
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
            reported = {"ms": k_ms, "plain_ms": p_ms, **bound,
                        **_library_yardstick(fargs, fb, fp, f_ms)}
        if si == SPLIT_TYPICAL:
            _check_scan_router(batch, idx, valid, qconv, targets, ranges)
    reported["max_abs_err"] = max_err
    return reported


def _library_yardstick(args, best, pos, k3_ms) -> dict:
    """K3's library yardstick: the port's matmul form of the split scan
    (device_splitscore_mxu, two torch.bmm a call) on K3's factored call
    ``args``, the same tensors, timed by profiler device time (all its
    kernels, over a call); its largest difference from K3's ``best``
    over the pairs both score. A call that does not fit in device memory
    is recorded as such, with what it asked for."""
    import torch
    from manta_tpu_torch.tools import device_timing as dt
    call, diff = dt.mxu_on_k3_inputs(args)
    try:
        err, pos_differ, pairs = diff(best, pos)
        times = dt.Timer(args[0].device, 10)(call)
    except torch.cuda.OutOfMemoryError as e:
        torch.cuda.empty_cache()
        print(f"    library yardstick (matmul form): does not fit: {e}",
              flush=True)
        return {"library_ms": None, "library_fit": str(e).split("\n")[0]}
    ms = times["sec_per_iter"] * 1e3
    print(f"    library yardstick, the matmul form (two torch.bmm) on the "
          f"same tensors: {ms:.5f} ms a call ({times['timed_by']}: all "
          f"its kernels' device time on the card; "
          f"{times.get('event_sec_per_iter', 0) * 1e3:.4f} ms by CUDA "
          "events), K3 "
          + ("not measured" if k3_ms is None else f"{k3_ms:.5f} ms")
          + f"; largest |difference| from K3 {err:.3g} over {pairs} pairs "
          f"(finite in both, A/C/G/T/N only), {pos_differ} positions "
          "differ", flush=True)
    return {"library_ms": ms, "library_max_abs_diff": err}


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
    from manta_tpu_torch.scoring.device_scan import (
        EXACT_COPIES, SCAN_STATS, SCAN_TIERS,
    )
    for launches in (cuda_jumpscore.KERNEL_LAUNCHES,
                     cuda_splitscore.KERNEL_LAUNCHES):
        for k in launches:
            launches[k] = 0
    for work in (*cuda_jumpscore.KERNEL_WORK.values(),
                 *cuda_splitscore.KERNEL_WORK.values()):
        for k in work:
            work[k] = 0
    dj.PLAIN_CALLS["cuda"] = 0
    ds.PLAIN_CALLS["cuda"] = 0
    dj.DISPATCH_BUCKETS.clear()
    SCAN_TIERS.clear()
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


# the kernels where the workflows launch them: path -> the timing tool's
# workflow records of its run (a line a kernel, then phase 2's)
MAIN_PATHS = {}
# path -> the kernel the path is there for
MAIN_PATH_KERNELS = {"wgs_jump": "jump_score",
                     "high_span_jump": "jump_score",
                     "wgs_exact": "split_score", "rna_exact": "split_score"}


# the VCF a workload's run writes
VCF_OF = {"wgs": "diploidSV", "high-span": "tumorSV", "rna": "rnaSV"}


def _tool_records(stdout: str) -> list:
    """The records of a workflow-mode run of the timing tool, from its
    output: a line a kernel, then phase 2's (the launch counts dropped)."""
    return [json.loads(ln) for ln in stdout.splitlines()
            if ln.startswith('{"') and "kernel_launches" not in ln]


def _profiled(path: str, workload: str, mode: str, run_dir: str, run,
              device: str, card: str, prefix: str | None = None) -> None:
    """``run()``, a workflow at -j 1 in this process, inside the timing
    tool's profiler window (tools.device_timing --kernel workflow); its
    records kept under ``path`` in MAIN_PATHS. The profiler of a
    long-lived process loses launches: the longer after the process's
    first trace, the more of a trace's first kernel records go missing
    while the runtime still records their launch calls, and a fresh
    process loses none (python -m manta_tpu_torch.tools.device_timing
    --kernel trace_aging; seen here as no event of the RNA run late in
    the smoke). The cause lies in the profiler (Kineto/CUPTI), not in
    the port, so where this trace lost a launch the same run is made
    again in a child through the tool's workflow mode, whose first
    trace holds them, and its body must equal this run's."""
    from manta_tpu_torch.tools import device_timing as dt
    reading = dt.profile_workflow(run, device)
    records = dt.workflow_records(
        reading, dt.phase2_wall(run_dir), card if device == "cuda" else "cpu",
        workload, mode)
    lost = [r["kernel"] for r in records[:-1]
            if r["launches_profiler"] not in (None, r["launches_wrapper"])]
    if lost:
        child_dir = run_dir + "_profiled"
        print(f"{path}: this process's trace lost launches of {lost}; the "
              "same run in a child: python -m manta_tpu_torch.tools."
              "device_timing --kernel workflow", flush=True)
        run = run_child(["-m", "manta_tpu_torch.tools.device_timing",
                         "--kernel", "workflow", "--workload", workload,
                         "--mode", mode, "--run-dir", child_dir]
                        + (["--prefix", prefix] if prefix else []))
        if run.returncode != 0:
            raise RuntimeError(f"device_timing --kernel workflow ({path}) "
                               f"failed:\n{run.stdout[-2000:]}\n"
                               f"{run.stderr[-3000:]}")
        records = _tool_records(run.stdout)
        vcf = os.path.join("results", "variants", VCF_OF[workload] + ".vcf.gz")
        if _records(os.path.join(child_dir, vcf)) != \
                _records(os.path.join(run_dir, vcf)):
            raise AssertionError(f"{path}: the child's body differs")
    MAIN_PATHS[path] = records


WGS_WORK = os.path.join(WORK, "chip_smoke", "wgs")


def start_wgs_generation(wgs_args=WGS_ARGS) -> subprocess.Popen:
    """The WGS-shaped workload's generator in the background (a child:
    the generator never shares a process that touched CUDA; it inherits
    the native core's library path)."""
    shutil.rmtree(WGS_WORK, ignore_errors=True)
    os.makedirs(WGS_WORK)
    return start_child(["-m", "manta_tpu_torch.tools.wgs_workload", "--out",
                        os.path.join(WGS_WORK, "w"), *wgs_args],
                       os.path.join(WGS_WORK, "gen.log"))


def wgs_workload(gen: subprocess.Popen, card: str, device: str = "cuda"):
    """The WGS-shaped workload (``gen``, the background child of
    ``start_wgs_generation``) through the workflow. Returns the kernel
    launches of the main paths (jump_score from the 'jump' run,
    split_score from the 'exact' run) and what the measurement phase
    reuses: the workload's prefix, its reads and the 'off' run's
    directory."""
    phase("WGS-shaped germline workload: scoring off, jump, exact, mxu")
    from manta_tpu_torch.workflow.run import run_workflow
    work = WGS_WORK
    prefix = os.path.join(work, "w")
    t0 = time.perf_counter()
    out = wait_child(gen, "workload generation")
    reads = next(ln for ln in out.splitlines() if " wrote " in ln)
    print(f"generated in the background: {reads.split('] ', 1)[1]} in "
          f"{reads.split(']')[0][1:].strip()} by the generator's clock; "
          f"waited {time.perf_counter() - t0:.1f} s for it here",
          flush=True)
    n_reads = int(re.search(r"\((\d+) reads", reads).group(1))

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
        run = lambda m=mode, d=run_dir: run_workflow(
            [prefix + ".bam"], [], prefix + ".fa", d, use_device_scoring=m,
            device=device, n_jobs=1, verbose=False)
        t0 = time.perf_counter()
        try:
            if mode in ("jump", "exact"):
                # the kernels' device time where this run launches them
                _profiled(f"wgs_{mode}", "wgs", mode, run_dir, run, device,
                          card, prefix)
            else:
                run()
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
    cli = run_child(
        ["-m", "manta_tpu_torch.workflow.run", "--bam", prefix + ".bam",
         "--reference", prefix + ".fa", "--run-dir", run_dir, "-j", "2",
         "--device-scoring", "exact"])
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
    return ({"jump_score": counted["jump"]["jump"],
             "split_score": counted["exact"]["split"]},
            {"prefix": prefix, "reads": n_reads,
             "run_off": os.path.join(work, "run_off")})


_STARTUP = """\
import time
t0 = time.perf_counter()
import torch
t1 = time.perf_counter()
torch.zeros(1, device="cuda")
torch.cuda.synchronize()
print(f"{t1 - t0:.3f} {time.perf_counter() - t1:.3f}")
"""
_DISPATCH_LINE = re.compile(
    r"device-dispatch pid=\d+: (\d+) calls, (\d+) jobs, (\d+) padded rows, "
    r"([0-9.]+)s total, first ([0-9.]+)s \(incl\. kernel build\), (\d+) "
    r"kernel launches; calls by bucket \(B, nq, nr1, nr2\): (\{.*\})")


HIGH_WORK = os.path.join(WORK, "chip_smoke", "high_span")


def start_high_span_generation() -> subprocess.Popen:
    """The high-span workload's generator in the background."""
    shutil.rmtree(HIGH_WORK, ignore_errors=True)
    os.makedirs(HIGH_WORK)
    return start_child(["-m", "manta_tpu_torch.tools.stress_workload",
                        "--tiles", str(HIGH_SPAN_TILES), "--out",
                        os.path.join(HIGH_WORK, "h"), "--depth-frac", "0.2",
                        "--strip-sa", "--demo-fasta", demo_fasta()],
                       os.path.join(HIGH_WORK, "gen.log"))


def _wait_all(procs: dict) -> dict:
    """Wait for every ``start_child`` child of ``procs`` (name -> child);
    returns name -> seconds from its start to its end."""
    walls = {}
    while len(walls) < len(procs):
        for name, proc in procs.items():
            if name not in walls and proc.poll() is not None:
                walls[name] = time.perf_counter() - proc.started
        time.sleep(0.1)
    return walls


def high_span(card: str, gen: subprocess.Popen) -> tuple[dict, dict]:
    """The high-spanning-contig shape (``gen``, the background child of
    ``start_high_span_generation``) through the workflow's command line:
    scoring off, jump at the default edge chunk and jump at 256, the
    three children at once (each is one process on one host core). The
    default chunk's jump run goes through the timing tool's workflow
    mode, the same run_workflow at -j 1 in a profiler window.
    Returns the jump kernel's launches in each jump run, by the child's
    own count (its device-dispatch exit line), and what the benchmark
    twins' phase reuses: the workload's prefix and the 'off' run's graph
    edges."""
    phase(f"high-span contigs: {HIGH_SPAN_TILES} demo tiles, depth 0.2, "
          "no split-read evidence; scoring off, jump, jump at chunk 256, "
          "at once")
    work = HIGH_WORK
    prefix = os.path.join(work, "h")
    t0 = time.perf_counter()
    out = wait_child(gen, "high-span generation")
    reads = int(re.search(r": (\d+) reads across", out).group(1))
    if reads != HIGH_SPAN_READS:
        raise AssertionError(f"{reads} reads generated, wanted "
                             f"{HIGH_SPAN_READS}")
    print(f"{out.strip()} (in the background; waited "
          f"{time.perf_counter() - t0:.1f} s for it here)", flush=True)
    bodies, launches, procs = {}, {}, {}
    for mode, chunk in HIGH_SPAN_RUNS:
        name = f"{mode}" + (f"_chunk{chunk}" if chunk else "")
        env = dict(os.environ)
        env.pop("MANTA_TPU_EDGE_CHUNK", None)
        if chunk:
            env["MANTA_TPU_EDGE_CHUNK"] = str(chunk)
        run_dir = os.path.join(work, f"run_{name}")
        if name == "jump":
            # the same run_workflow at -j 1 as the command line's, through
            # the timing tool's workflow mode: in a profiler window
            argv = ["-m", "manta_tpu_torch.tools.device_timing", "--kernel",
                    "workflow", "--workload", "high-span", "--mode", mode,
                    "--prefix", prefix, "--run-dir", run_dir]
        else:
            argv = ["-m", "manta_tpu_torch.workflow.run", "--tumor-bam",
                    prefix + ".bam", "--reference", prefix + ".fa",
                    "--run-dir", run_dir, "--exome", "-j", "1",
                    "--device-scoring", mode]
        procs[name] = start_child(argv, os.path.join(work, f"run_{name}.log"),
                                  env=env)
    walls = _wait_all(procs)
    for mode, chunk in HIGH_SPAN_RUNS:
        name = f"{mode}" + (f"_chunk{chunk}" if chunk else "")
        run_dir = os.path.join(work, f"run_{name}")
        wall = walls[name]
        out = wait_child(procs[name], f"high-span {name}")
        if name == "jump":
            MAIN_PATHS["high_span_jump"] = _tool_records(out)
        with open(procs[name].log + ".err") as f:
            stderr = f.read()
        bodies[name] = _records(os.path.join(run_dir, "results", "variants",
                                             "tumorSV.vcf.gz"))
        with open(os.path.join(run_dir, "workspace",
                               "workflow_log.txt")) as f:
            edges = re.findall(r"processed (\d+) graph edges", f.read())
        dispatch = _DISPATCH_LINE.findall(stderr)
        line = (f"{name:>13} -j 1: wall {wall:.2f} s, {edges[-1]} graph "
                f"edges, {len(bodies[name])} tumor records; "
                f"{_phase_walls(run_dir)}")
        if mode == "off":
            if dispatch or "split-scan pid=" in stderr:
                raise AssertionError("high-span off used the device")
            print(f"{line}; no device work", flush=True)
            edges_off = int(edges[-1])
            continue
        if len(dispatch) != 1:
            raise AssertionError(f"high-span {name}: {len(dispatch)} "
                                 "device-dispatch lines, wanted 1:\n"
                                 f"{stderr[-3000:]}")
        calls, jobs, rows, d_wall, first, k1, buckets = dispatch[0]
        launches[name] = int(k1)
        print(f"{line}; {calls} dispatches, {jobs} contig jobs, {rows} "
              f"padded rows, dispatch wall {d_wall} s (first {first} s), "
              f"{k1} jump kernel launches; dispatches by bucket "
              f"(B, nq, nr1, nr2): {buckets}", flush=True)
        if int(jobs) < HIGH_SPAN_MIN_JOBS:
            raise AssertionError(f"high-span {name}: {jobs} contig jobs, "
                                 f"wanted at least {HIGH_SPAN_MIN_JOBS}")
        if int(k1) <= 0 or int(k1) != int(calls):
            raise AssertionError(f"high-span {name}: {k1} jump kernel "
                                 f"launches for {calls} dispatches")
    # what a jump run pays outside the workflow's logged phases: 'off'
    # never imports torch
    t0 = time.perf_counter()
    start = run_child(["-c", _STARTUP])
    if start.returncode != 0:
        raise RuntimeError(f"start-up child failed:\n{start.stderr[-3000:]}")
    imp, ctx = start.stdout.split()
    print(f"a child that imports torch and makes a CUDA context: import "
          f"{imp} s, context {ctx} s, the child's wall "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    first = bodies["off"]
    for name, body in bodies.items():
        if body != first:
            differ = sum(a != b for a, b in zip(body, first)) \
                + abs(len(body) - len(first))
            raise AssertionError(f"high-span: the tumorSV body of {name} "
                                 f"differs from off's in {differ} records")
    print(f"{card}; tumorSV body identical: {', '.join(bodies)} "
          f"({len(first)} records)", flush=True)
    return launches, {"prefix": prefix, "edges_off": edges_off}


def main_paths(card: str) -> dict:
    """The kernels where the workflows launch them, from the records the
    profiled runs left in MAIN_PATHS (the WGS-shaped jump and exact runs
    and RNA exact in this process, the high-span jump run in its child):
    on each run every kernel's launches in the trace equal its wrapper's
    count and the calls of the seam that reaches it, its device time is
    no more than that seam's wall (the dispatcher's, the router's), and
    the kernel the path is there for launched; each run's body equals
    its 'off' run's (held where the run was made). Returns kernel ->
    path -> the readings the kernels line carries."""
    phase("kernels on the main paths: device time, launches and bound "
          "where the workflows launch them (tools.device_timing --kernel "
          "workflow)")
    out = {name: {} for name in KERNELS}
    for path, kernel in MAIN_PATH_KERNELS.items():
        records = MAIN_PATHS[path]
        for rec in records:
            rec.pop("run_dir", None)
            print(json.dumps(rec), flush=True)
        phase2 = records[-1]
        for rec in records[:-1]:
            name = rec["kernel"]
            if rec["device_ms"] is None:        # a rehearsal on the cpu
                continue
            if rec["launches_wrapper"] != rec["calls"]:
                raise AssertionError(f"{path}: {name} {rec['calls']} calls, "
                                     f"{rec['launches_wrapper']} launches")
            if rec["launches_profiler"] != rec["launches_wrapper"]:
                raise AssertionError(
                    f"{path}: {name} {rec['launches_profiler']} launches in "
                    f"the trace, {rec['launches_wrapper']} by its wrapper")
            if rec["device_ms"] > rec["path_wall_s"] * 1e3:
                raise AssertionError(
                    f"{path}: {name} {rec['device_ms']} device ms over its "
                    f"seam's wall {rec['path_wall_s']} s")
            out[name][path] = {key: rec[key] for key in (
                "launches_wrapper", "device_ms", "device_ms_per_launch",
                "bound_ms", "share_of_bound", "h2d", "d2h")}
            out[name][path]["busy_share"] = phase2["busy_share"]
        rec = next(r for r in records[:-1] if r["kernel"] == kernel)
        if not rec["calls"]:
            raise AssertionError(f"{path}: {kernel} never called")
        ms = rec["device_ms"]
        print(f"{card}; {path}: {kernel} {rec['launches_wrapper']} launches "
              f"(trace {rec['launches_profiler']}), device "
              + ("not measured" if ms is None else
                 f"{ms:.4f} ms ({rec['device_ms_per_launch']:.5f} a launch)")
              + f", bound {rec['bound_ms']:.6f} ms by {rec['bound_by']}"
              + ("" if ms is None else
                 f" ({rec['share_of_bound']:.2%} reached)")
              + f"; its seam's wall {rec['path_wall_s']:.4f} s; phase 2 "
              f"{phase2['phase2_wall_s']:.2f} s, device busy "
              + ("not measured" if ms is None else
                 f"{phase2['device_busy_ms']:.3f} ms "
                 f"({phase2['busy_share']:.4%})")
              + "; body == off's", flush=True)
    return out


def worker_paths(card: str) -> dict:
    """The kernels in the -j 8 workers, from the records the calling
    modes' timing-tool runs left in WORKER_PATHS (ten-sample joint
    germline in jump and exact, tumor-only exact; each phase-2 worker
    traced itself, parallel/worker_trace): on each run every kernel's
    launches in the workers' traces equal their wrappers' sum and their
    exit lines', its device time is no more than its seam's wall summed
    over the workers, the busy union of the card is no more than phase
    2's wall, no event fell outside phase 2 and no two kernels of a
    worker overlap; the kernel the path is there for launched (each
    run's body equals its 'off' run's, held in the calling modes).
    Returns kernel -> path -> the readings the kernels line carries."""
    phase("kernels in the workers: device time, launches and bound in the "
          f"-j {HOST_JOBS} phase-2 workers (tools.device_timing --kernel "
          f"workflow --jobs {HOST_JOBS})")
    out = {name: {} for name in KERNELS}
    for path, kernel in WORKER_PATH_KERNELS.items():
        records = WORKER_PATHS[path]
        for rec in records:
            rec.pop("run_dir", None)
            print(json.dumps(rec), flush=True)
        phase2 = records[-1]
        on_card = phase2["device_busy_ms"] is not None
        for rec in records[:-1]:
            name = rec["kernel"]
            counted = {rec["launches_wrapper"], rec["launches_exit_lines"],
                       rec["calls"]}
            if on_card:
                counted.add(rec["launches_profiler"])
            if len(counted) != 1:
                raise AssertionError(
                    f"{path}: {name} {rec['launches_profiler']} launches in "
                    f"the traces, {rec['launches_wrapper']} by the wrappers, "
                    f"{rec['launches_exit_lines']} on the exit lines, "
                    f"{rec['calls']} calls")
            if on_card and rec["device_ms"] > rec["path_wall_s"] * 1e3:
                raise AssertionError(
                    f"{path}: {name} {rec['device_ms']} device ms over its "
                    f"seam's summed wall {rec['path_wall_s']} s")
            out[name][path] = {key: rec[key] for key in (
                "launches_wrapper", "device_ms", "device_ms_per_launch",
                "bound_ms", "share_of_bound", "h2d", "d2h")}
            out[name][path].update({key: phase2[key] for key in (
                "busy_share", "jobs", "workers", "workers_launched",
                "cuda_startup_s")})
        if on_card and (
                phase2["device_busy_ms"] > phase2["phase2_wall_s"] * 1e3
                or phase2["events_outside_phase2"]
                or phase2["overlapping_kernels"]):
            raise AssertionError(f"{path}: {phase2}")
        rec = next(r for r in records[:-1] if r["kernel"] == kernel)
        if not rec["calls"]:
            raise AssertionError(f"{path}: {kernel} never called")
        ms, up = rec["device_ms"], phase2["cuda_startup_s"]
        print(f"{card}; {path}: {kernel} {rec['launches_wrapper']} launches "
              f"(traces {rec['launches_profiler']}, exit lines "
              f"{rec['launches_exit_lines']}) in {phase2['workers_launched']}"
              f" of {phase2['workers']} workers, device "
              + ("not measured" if ms is None else
                 f"{ms:.4f} ms ({rec['device_ms_per_launch']:.5f} a launch)")
              + f", bound {rec['bound_ms']:.6f} ms by {rec['bound_by']}"
              + ("" if ms is None else
                 f" ({rec['share_of_bound']:.2%} reached)")
              + f"; its seam's summed wall {rec['path_wall_s']:.4f} s; "
              f"phase 2 {phase2['phase2_wall_s']:.2f} s, card busy "
              + ("not measured" if ms is None else
                 f"{phase2['device_busy_ms']:.3f} ms "
                 f"({phase2['busy_share']:.4%}), clock {phase2['clocks']}")
              + ("" if up is None else
                 f"; the workers' CUDA start-up {up['min']:.3f} / "
                 f"{up['median']:.3f} / {up['max']:.3f} s (min / median / "
                 "max)")
              + "".join(f"; {mark} {v['min']:.2f} / {v['median']:.2f} / "
                        f"{v['max']:.2f} s" for mark, v in
                        phase2["worker_marks_s"].items()
                        if mark in ("first_device_call", "trace_start_s"))
              + "; body == off's", flush=True)
    return out


# a small process that starts the code of its first argument in a child
# of its own: a process's ru_maxrss carries the high-water mark of the
# process that started it (fork, then exec), and this one is small
_RELAUNCH = """
import subprocess
sys.exit(subprocess.run([sys.executable, "-c", *sys.argv[1:]]).returncode)
"""


def _twin(name: str, *args, relaunch: bool = False) -> tuple[dict, str]:
    """``python -m manta_tpu_torch.tools.<name> args`` in a child: its
    last JSON line and its stderr. With ``relaunch`` the child starts it
    from a small process, for a peak RSS of its own."""
    t0 = time.perf_counter()
    if relaunch:
        code = (_GUARD + "import runpy\n"
                f"runpy.run_module('manta_tpu_torch.tools.{name}', "
                "run_name='__main__', alter_sys=True)\n")
        run = run_child(["-c", _RELAUNCH, code, *args])
    else:
        run = run_child(["-m", f"manta_tpu_torch.tools.{name}", *args])
    if run.returncode != 0:
        raise RuntimeError(f"tools.{name} {' '.join(args)} failed "
                           f"({run.returncode}):\n{run.stdout[-3000:]}\n"
                           f"{run.stderr[-3000:]}")
    line = _last_json(run.stdout)
    print(f"tools.{name} ({time.perf_counter() - t0:.1f} s in the child): "
          f"{json.dumps(line)}", flush=True)
    return line, run.stderr


def bench_scripts(card: str, high: dict) -> dict:
    """The twins of the JAX-free benchmark scripts as a user runs them,
    each a child process: bench_edges with jump at -j 1 and
    bench_graphbuild at -j 1 and -j 2 on the high-span BAM, the graph
    soak, the reduce profile twice, and one repeats seed in jump and in
    exact on one workload. Returns K1's launches in bench_edges and in
    the jump seed, and K3's in the exact seed, each counted in the
    processes that ran them."""
    phase("benchmark twins: bench_edges (jump, -j 1), bench_graphbuild "
          "(-j 1, -j 2), soak_graph, bench_reduce (twice), bench_repeats "
          "(jump, exact)")
    from manta_tpu_torch.tools.bench_repeats import DEVICE_KEYS, RUN_KEYS
    work = os.path.join(WORK, "chip_smoke", "bench_scripts")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    bam, fa = high["prefix"] + ".bam", high["prefix"] + ".fa"

    line, err = _twin("bench_edges", "--bam", bam, "--fasta", fa, "-j", "1",
                      "--device-scoring", "jump", "--work-dir", work)
    k1 = sum(int(x[5]) for x in _DISPATCH_LINE.findall(err))
    if line["edges"] != high["edges_off"] or line["device"] != card or \
            line["device_scoring_resolved"] != "jump":
        raise AssertionError(f"bench_edges: {line['edges']} edges (the "
                             f"high-span off run: {high['edges_off']}), "
                             f"{line['device']!r}, "
                             f"{line['device_scoring_resolved']!r}")
    if not line["k1_launches"] >= 1 or line["k1_launches"] != k1 or \
            line["k1_launches"] != line["dispatches"]:
        raise AssertionError(f"bench_edges: {line['k1_launches']} K1 "
                             f"launches, {k1} in its exit line, "
                             f"{line['dispatches']} dispatches")
    print(f"bench_edges: {line['edges']} edges == the high-span off run's; "
          f"{line['contig_jobs']} contig jobs in {line['dispatches']} "
          f"dispatches, {k1} K1 launches", flush=True)

    counts = {}
    for jobs in (1, 2):
        got, _ = _twin("bench_graphbuild", "--bam", bam, "--fasta", fa,
                       "-j", str(jobs), "--work-dir", work)
        counts[jobs] = {k: got[k] for k in GRAPH_COUNTS}
    if counts[1] != counts[2] or not counts[1]["edges"] > 0:
        raise AssertionError(f"bench_graphbuild -j 1 vs -j 2: {counts}")
    print(f"bench_graphbuild: {counts[1]} at -j 1 and -j 2", flush=True)

    soak, _ = _twin("soak_graph", *SOAK_ARGS, relaunch=True)
    if not (soak["build_deterministic"] and soak["serialize_roundtrip"]
            and soak["rss_under_2gb"]):
        raise AssertionError(f"soak_graph: {soak}")

    reduced = [_twin("bench_reduce", *REDUCE_ARGS, "--work-dir", work)[0]
               for _ in range(2)]
    nodes = [(r["nodes"], r["nodes_presplit"]) for r in reduced]
    if nodes[0] != nodes[1] or not min(nodes[0]) > 0:
        raise AssertionError(f"bench_reduce (nodes, nodes_presplit): {nodes}")
    print(f"bench_reduce twice: (nodes, nodes_presplit) {nodes[0]}; serial "
          f"tail {[r['serial_tail_s'] for r in reduced]} s", flush=True)

    records = {}
    for mode in ("jump", "exact"):
        _agg, err = _twin("bench_repeats", *REPEATS_ARGS, "--device-scoring",
                          mode, "--work-dir", os.path.join(work, "repeats"),
                          "--results-dir", os.path.join(work, "results"),
                          "--tag", mode, "--keep", "--reuse")
        with open(os.path.join(work, "results",
                               f"repeats_check_{mode}.json")) as f:
            records[mode] = json.load(f)["per_seed"][0]
        print(f"bench_repeats seed record ({mode}): "
              f"{json.dumps(records[mode])}", flush=True)
        print("\n".join(ln for ln in err.splitlines()
                        if ln.startswith("[bench_repeats]")), flush=True)
    jump, exact = records["jump"], records["exact"]
    skip = RUN_KEYS + DEVICE_KEYS
    if {k: v for k, v in jump.items() if k not in skip} != \
            {k: v for k, v in exact.items() if k not in skip}:
        raise AssertionError("bench_repeats: the jump and exact records "
                             "differ beyond walls and device work")
    if not jump["truth_in_repeat"] > 0:
        raise AssertionError("bench_repeats: no truth SV in a repeat")
    # K1 a dispatch; a seed whose workflow makes no contig job would show
    # none, and the assertion is then the one launch a dispatch alone
    if jump["k1_launches"] != jump["dispatches"] or \
            (jump["contig_jobs"] and not jump["k1_launches"] >= 1):
        raise AssertionError(f"bench_repeats jump: {jump['k1_launches']} K1 "
                             f"launches for {jump['dispatches']} dispatches "
                             f"and {jump['contig_jobs']} contig jobs")
    if not exact["k3_launches"] >= 1 or \
            exact["k3_launches"] != exact["split_scans"]:
        raise AssertionError(f"bench_repeats exact: {exact['k3_launches']} "
                             f"K3 launches for {exact['split_scans']} split "
                             "scans")
    print(f"{card}; bench_repeats seed 3: jump and exact records identical "
          f"but for {list(skip)}; truth {jump['truth_n']} "
          f"({jump['truth_in_repeat']} in repeats), recall {jump['recall']}; "
          f"jump {jump['contig_jobs']} contig jobs in {jump['dispatches']} "
          f"dispatches, {jump['k1_launches']} K1 launches; exact "
          f"{exact['split_scans']} split scans, {exact['k3_launches']} K3 "
          "launches", flush=True)
    return {"bench_edges": line["k1_launches"],
            "repeats": jump["k1_launches"],
            "repeats_exact": exact["k3_launches"]}


# the child that runs the workflow's command line and samples its
# process tree's memory (tools.bench_wgs_at_scale's sampler): its last
# stdout line is the peaks, its stderr the workflow's and the workers'
# (sampled, not ru_maxrss, which a child inherits from the smoke's own
# process)
_CLI_MEASURED = """
import json
import sys

from manta_tpu_torch.tools import device_timing
from manta_tpu_torch.tools.bench_wgs_at_scale import RssSampler
from manta_tpu_torch.workflow import run

with RssSampler(interval=1.0) as rss:
    if sys.argv[1] == "--kernel":
        rc = device_timing.main(sys.argv[1:])
    else:
        rc = run.main(sys.argv[1:])
if rc:
    sys.exit(rc)
anon = "rss_anon" in rss.sources
print(json.dumps({
    "peak_tree_rss_gb": round(rss.peak_total / 1e9, 2),
    "peak_tree_anon_gb": round(rss.peak_anon / 1e9, 2) if anon else None,
    "peak_process_anon_gb": (round(rss.peak_proc_anon / 1e9, 2) if anon
                             else None)}))
"""


def _cli(what: str, args: list) -> dict:
    """The workflow's command line with ``args`` in a child: its wall,
    phase walls (of a run that did phases 0-2), peak memory and device
    work (every process's exit line, tools/device_counts.py). ``args``
    starting with ``--kernel`` run the timing tool's command line
    instead (``--kernel workflow ... --jobs N``: the same run_workflow at
    -j N, its phase-2 workers tracing themselves); its records are kept
    under "records"."""
    from manta_tpu_torch.tools.device_counts import parse_lines
    t0 = time.perf_counter()
    run = run_child(["-c", _CLI_MEASURED, *args])
    wall = time.perf_counter() - t0
    if run.returncode != 0:
        raise RuntimeError(f"{what} failed ({run.returncode}):\n"
                           f"{run.stdout[-2000:]}\n{run.stderr[-3000:]}")
    run_dir = args[args.index("--run-dir") + 1]
    return {"wall": wall, "stderr": run.stderr, "run_dir": run_dir,
            "memory": _last_json(run.stdout), "work": parse_lines(run.stderr),
            "records": _tool_records(run.stdout)[:-1],
            "phases": ("phases 0 and 1 reused" if "--rescore" in args
                       else _phase_walls(run_dir))}


# the runs of the calling modes made through the timing tool at -j 8
# (the kernels in the workers): path -> its records (a line a kernel,
# then phase 2's)
WORKER_PATHS = {}
# path -> the kernel the path is there for
WORKER_PATH_KERNELS = {"joint10_jump": "jump_score",
                       "joint10_exact": "split_score",
                       "tumor_only_exact": "split_score"}


def _mode_args(path: str, mode: str, cli: list, tool: list) -> list:
    """The command line of a calling mode's run: the timing tool's
    workflow mode at -j 8 where the run is one of WORKER_PATHS, else
    the workflow's."""
    if path in WORKER_PATH_KERNELS:
        return ["--kernel", "workflow", *tool, "--mode", mode, "--jobs",
                HOST_JOBS]
    return [*cli, "--device-scoring", mode, "-j", HOST_JOBS]


def _check_work(what: str, mode: str, work: dict) -> None:
    """Every contig dispatch through K1 and every split scan through K3,
    counted in the processes that made them; nothing on the device with
    scoring off, no split scan on it with jump."""
    if work["k1_launches"] != work["dispatches"] or \
            work["k3_launches"] != work["split_scans"]:
        raise AssertionError(f"{what} ({mode}): {work['k1_launches']} K1 "
                             f"launches for {work['dispatches']} dispatches,"
                             f" {work['k3_launches']} K3 launches for "
                             f"{work['split_scans']} split scans")
    if mode == "off" and (work["dispatches"] or work["split_scans"]):
        raise AssertionError(f"{what} (off) used the device: {work}")
    if mode == "jump" and work["split_scans"]:
        raise AssertionError(f"{what} (jump) ran device split scans")
    if mode == "exact" and not work["k3_launches"] > 0:
        raise AssertionError(f"{what} (exact): no K3 launch")


def _describe_cli(mode: str, res: dict, records: int, kind: str) -> str:
    w, m = res["work"], res["memory"]
    return (f"{mode:>5}: wall {res['wall']:.2f} s, {records} {kind} "
            f"records; {res['phases']}; peak memory: process tree RSS "
            f"{m['peak_tree_rss_gb']} GB (file pages included), anonymous "
            f"{m['peak_tree_anon_gb']} GB, anonymous of the largest process "
            f"{m['peak_process_anon_gb']} GB; {w['device_processes']} "
            f"device processes, {w['contig_jobs']} contig jobs in "
            f"{w['dispatches']} dispatches, {w['k1_launches']} K1 launches, "
            f"{w['split_scans']} split scans, {w['k3_launches']} K3 "
            "launches")


def _truth_checks(prefix: str, runs: dict, *extra) -> dict:
    """The truth checker resumed on each finished run directory of
    ``runs`` (name -> run directory), the children at once: name -> its
    JSON line."""
    procs = {name: start_child(
        ["-m", "manta_tpu_torch.tools.wgs_workload", "--out", prefix,
         "--check", "--run-dir", run_dir, *extra], run_dir + ".check.log")
        for name, run_dir in runs.items()}
    walls = _wait_all(procs)
    lines = {}
    for name, proc in procs.items():
        out = wait_child(proc, f"truth check of {name}")
        with open(proc.log + ".err") as f:
            if "resume: reusing candidate generation" not in f.read():
                raise AssertionError(f"the truth check of {name} did not "
                                     "resume")
        lines[name] = _last_json(out)
        print(f"truth check of {name} ({walls[name]:.1f} s, resumed, "
              f"{len(runs)} at once): {json.dumps(lines[name])}",
              flush=True)
    return lines


def _same_checks(what: str, lines: dict) -> dict:
    """The check lines of every mode equal but for the run's own wall,
    memory and directory; returns the first without those."""
    kept = {mode: {k: v for k, v in line.items()
                   if k not in TRUTH_UNCOMPARED}
            for mode, line in lines.items()}
    first = next(iter(kept.values()))
    if any(v != first for v in kept.values()) or not first["recall"] > 0:
        raise AssertionError(f"{what}: the truth checks differ or score no "
                             f"recall: {kept}")
    return first


def rna_mode(card: str, device: str = "cuda") -> dict:
    """RNA fusion mode on the demo tumor BAM through run_workflow, scoring
    off, jump and exact: identical rnaSV bodies, no K1 launch in any mode,
    K3 at the RNA scan tier in exact; then K3 at one captured RNA call
    against its plain form on the card and the native scan. Returns the
    launches and the captured call's numbers."""
    phase("calling modes (a): RNA on the demo tumor BAM, scoring off, jump, "
          "exact")
    from manta_tpu_torch.scoring import device_scan
    from manta_tpu_torch.workflow.run import run_workflow
    fasta = demo_fasta()
    calls = []
    scan_multi = device_scan.DeviceScanContext.scan_multi

    def keeping(self, *a):
        calls.append(a)
        return scan_multi(self, *a)

    bodies, counted = {}, {}
    for mode in CALLING_MODES:
        run_dir = os.path.join(WORK, "chip_smoke", f"rna_{mode}")
        shutil.rmtree(run_dir, ignore_errors=True)
        _reset_counts()
        if mode == "exact":
            device_scan.DeviceScanContext.scan_multi = keeping
        run = lambda m=mode, d=run_dir: run_workflow(
            [os.path.join(DEMO, TUMOR_BAM)], [], fasta, d, is_rna=True,
            use_device_scoring=m, device=device, n_jobs=1, verbose=False)
        t0 = time.perf_counter()
        try:
            if mode == "exact":
                _profiled("rna_exact", "rna", mode, run_dir, run, device,
                          card)
            else:
                run()
        finally:
            device_scan.DeviceScanContext.scan_multi = scan_multi
        wall = time.perf_counter() - t0
        c = counted[mode] = _counts()
        _check_counts("RNA", mode, c)
        bodies[mode] = _records(os.path.join(run_dir, "results", "variants",
                                             "rnaSV.vcf.gz"))
        print(f"{mode:>5}: wall {wall:.2f} s, {len(bodies[mode])} rnaSV "
              f"records; {_describe(c)}", flush=True)
    for mode, body in bodies.items():
        if body != bodies["off"] or len(body) < 4:
            raise AssertionError(f"RNA: the rnaSV body of {mode} differs "
                                 f"from off's or has under 4 records")
    k1 = sum(c["jump"] + c["dispatch"]["calls"] for c in counted.values())
    if k1:
        raise AssertionError(f"RNA: {k1} K1 launches and dispatches; RNA "
                             "mode never defers the spanning path")
    tiers = [device_scan._bucket(max(map(len, a[4])) + 1) for a in calls]
    if len(calls) != counted["exact"]["split"] or max(tiers) < RNA_MIN_TP:
        raise AssertionError(f"RNA exact: {len(calls)} scans kept for "
                             f"{counted['exact']['split']} K3 launches, "
                             f"largest scan tier {max(tiers)}")
    print(f"{card}; rnaSV body identical in off, jump and exact "
          f"({len(bodies['off'])} records); K1 launches 0 in every mode: RNA "
          "mode never defers the spanning path to the contig scorer "
          "(manta_tpu_torch/candidates/refiner.py:727); exact: "
          f"{len(calls)} split scans, {counted['exact']['split']} K3 "
          f"launches, scan tiers {sorted(set(tiers))}, largest Tp "
          f"{max(tiers)}", flush=True)
    held = _hold_rna_call(card, calls, device)
    return {"rna": k1, "rna_exact": counted["exact"]["split"], **held}


def _hold_rna_call(card: str, calls: list, device: str) -> dict:
    """K3 at the widest captured RNA call against its plain form on the
    card (in chunks of reads, so that its (reads, n_scan) planes fit)
    and the native host scan; its profiler device time, bound and the
    router's wall for the call."""
    import numpy as np
    import torch
    from manta_tpu_torch.align import device_splitscore as ds
    from manta_tpu_torch.scoring import device_scan
    from manta_tpu_torch.scoring.evidence import split_read_scan_multi
    flank, batch, read_idx, qconv, targets, ranges = max(
        calls, key=lambda a: (max(map(len, a[4])), len(a[2])))
    read_idx = np.asarray(read_idx, np.int64)
    Tp = device_scan._bucket(max(map(len, targets)) + 1)
    n, t = len(read_idx), len(targets)
    reads, quals, rlens = device_scan.stage_reads(batch, read_idx)
    tgts = np.full((t, Tp), ord("N"), np.uint8)
    for k, tg in enumerate(targets):
        tgts[k, :len(tg)] = tg
    beg = np.array([b for b, _e in ranges], np.int32)
    end = np.array([e for _b, e in ranges], np.int32)
    tlen = np.array([len(tg) for tg in targets], np.int32)
    m, x = qconv.lut256()
    r, q, rl, tg, b, e, tl, lm, lx = (
        torch.from_numpy(np.ascontiguousarray(a)).to(device)
        for a in (reads, quals, rlens, tgts, beg, end, tlen, m[:71], x[:71]))
    args = (r, q, rl, tg, b, e, tl, flank, lm, lx, Tp)

    def plain():
        parts = [ds.batched_split_score_factored(
            r[s:s + RNA_PLAIN_CHUNK], q[s:s + RNA_PLAIN_CHUNK],
            rl[s:s + RNA_PLAIN_CHUNK], tg, b, e, tl, flank, lm, lx, Tp)
            for s in range(0, n, RNA_PLAIN_CHUNK)]
        return (torch.cat([p[0] for p in parts]),
                torch.cat([p[1] for p in parts]))

    kb, kp = ds.split_score_factored(*args)
    pb, pp = plain()
    nb, np_ = split_read_scan_multi(flank, batch, read_idx, qconv, targets,
                                    ranges)
    if not (torch.equal(kb, pb) and torch.equal(kp, pp)):
        bad = torch.nonzero((kb != pb) | (kp != pp))[:8].tolist()
        raise AssertionError(f"RNA call: K3 != plain at {bad}")
    if not (np.array_equal(kb.cpu().numpy(), nb)
            and np.array_equal(kp.cpu().numpy(), np_)):
        raise AssertionError("RNA call: K3 != the native scan")
    d_ms = _device_ms(lambda: ds.split_score_factored(*args),
                      "split_score_kernel")
    p_ms = _time_ms(plain, runs=1)
    print(f"RNA call ({n} reads x {t} targets, scan tier {Tp}):",
          flush=True)
    library = _library_yardstick(args, kb, kp, d_ms)
    ctx = device_scan.DeviceScanContext(device=device)
    rb, rp = ctx.scan_multi(flank, batch, read_idx, qconv, targets, ranges)
    if not (np.array_equal(rb, nb) and np.array_equal(rp, np_)):
        raise AssertionError("RNA call: the router != the native scan")
    walls = []
    for _ in range(5):
        t0 = time.perf_counter()
        ctx.scan_multi(flank, batch, read_idx, qconv, targets, ranges)
        walls.append(time.perf_counter() - t0)
    router_ms = statistics.median(walls) * 1e3
    terms = device_scan.useful_terms(rlens[:, None], beg, end, tlen)
    n_bytes = (reads.nbytes + quals.nbytes + tgts.nbytes
               + 4 * (n + 3 * t) + 2 * 71 * 4 + 8 * n * t)
    bound = _bound(n_bytes, SPLIT_OPS_PER_TERM * terms)
    device_ms = "not measured" if d_ms is None else f"{d_ms:.5f} ms"
    print(f"{card}; RNA call held ({n} reads x {t} targets of "
          f"{tlen.tolist()} bases, read tier {reads.shape[1]}, scan tier "
          f"{Tp}, {terms} useful terms): K3 == plain form on the card "
          f"(in chunks of {RNA_PLAIN_CHUNK} reads) == native scan "
          f"(tolerance: bit-equal); K3 device time {device_ms} (profiler), "
          f"plain form {p_ms:.3f} ms (CUDA events), bound "
          f"{bound['bound_ms']:.6f} ms by {bound['bound_by']}; the router's "
          f"scan_multi {router_ms:.4f} ms a call (host clock, median of 5)",
          flush=True)
    return {"rna_tp": Tp, "rna_reads": n, "rna_ms": d_ms,
            "rna_plain_ms": p_ms, "rna_bound_ms": bound["bound_ms"],
            "rna_router_ms": router_ms,
            **{f"rna_{k}": v for k, v in library.items()}}


JOINT_WORK = os.path.join(WORK, "chip_smoke", "joint10")


def start_joint_generation() -> subprocess.Popen:
    """The ten-sample workload's generator, started in the background at
    the beginning of the smoke: it simulates the samples one after the
    other on one core (about 11 s a million reads on the card's host),
    beside the phases before the calling modes."""
    shutil.rmtree(JOINT_WORK, ignore_errors=True)
    os.makedirs(JOINT_WORK)
    return start_child(["-m", "manta_tpu_torch.tools.wgs_workload", "--out",
                        os.path.join(JOINT_WORK, "j"), *JOINT_ARGS],
                       os.path.join(JOINT_WORK, "gen.log"))


def joint_germline(card: str, gen: subprocess.Popen) -> dict:
    """Ten-sample joint germline from the port's generator (``gen``, the
    background child of ``start_joint_generation``) through the command
    line at -j 8, scoring off, jump and exact, each truth-checked
    (resumed): identical diploid bodies and check lines, K1 launched in
    jump and K3 in exact, counted in the workers. Returns the launches
    and what the rescore reuses."""
    phase(f"calling modes (b): {JOINT_SAMPLES}-sample joint germline "
          f"(tools.wgs_workload {' '.join(JOINT_ARGS)}), -j {HOST_JOBS}, "
          "scoring off, jump, exact; truth checks")
    prefix = os.path.join(JOINT_WORK, "j")
    t0 = time.perf_counter()
    rc = gen.wait()
    done = time.perf_counter()
    with open(gen.log) as f:
        out = f.read()
    if rc != 0:
        with open(gen.log + ".err") as f:
            raise RuntimeError(f"joint generation failed ({rc}):\n{out}\n"
                               f"{f.read()[-3000:]}")
    per_sample = [int(n) for n in re.findall(r" wrote \S+ \((\d+) reads",
                                             out)]
    if len(per_sample) != JOINT_SAMPLES:
        raise AssertionError(f"{len(per_sample)} BAMs generated")
    took = re.findall(r"\[\s*([0-9.]+)s\] wrote", out)[-1]
    print(f"generated {JOINT_SAMPLES} BAMs in the background: "
          f"{sum(per_sample)} reads ({min(per_sample)}-{max(per_sample)} a "
          f"sample) in {took} s by the generator's clock; waited "
          f"{done - t0:.1f} s for it here", flush=True)
    bams = []
    for k in range(JOINT_SAMPLES):
        bams += ["--bam", f"{prefix}.s{k}.bam"]
    base = [*bams, "--reference", prefix + ".fa", "-j", HOST_JOBS]
    runs, bodies = {}, {}
    for mode in CALLING_MODES:
        run_dir = os.path.join(JOINT_WORK, f"run_{mode}")
        path = f"joint10_{mode}"
        res = runs[mode] = _cli(f"joint {mode}", [
            *_mode_args(path, mode, [*bams, "--reference", prefix + ".fa"],
                        ["--workload", "joint", "--prefix", prefix]),
            "--run-dir", run_dir])
        if path in WORKER_PATH_KERNELS:
            WORKER_PATHS[path] = res["records"]
        _check_work("joint", mode, res["work"])
        vcf = os.path.join(run_dir, "results", "variants", "diploidSV.vcf.gz")
        bodies[mode] = _records(vcf)
        with gzip.open(vcf, "rt") as f:
            columns = next(ln for ln in f if ln.startswith("#CHROM"))
        if len(columns.split("\t")[9:]) != JOINT_SAMPLES:
            raise AssertionError(f"joint {mode}: sample columns {columns}")
        print(_describe_cli(mode, res, len(bodies[mode]), "diploid"),
              flush=True)
    checks = _truth_checks(
        prefix, {f"joint {mode}": runs[mode]["run_dir"]
                 for mode in CALLING_MODES},
        "--samples", str(JOINT_SAMPLES), "--jobs", HOST_JOBS)
    for mode, body in bodies.items():
        if body != bodies["off"]:
            raise AssertionError(f"joint: the diploidSV body of {mode} "
                                 "differs from off's")
    first = _same_checks("joint", checks)
    k1 = runs["jump"]["work"]["k1_launches"]
    k3 = runs["exact"]["work"]["k3_launches"]
    if not k1 > 0 or not k3 > 0:
        raise AssertionError(f"joint: {k1} K1 launches in jump, {k3} K3 "
                             "launches in exact")
    print(f"{card}; joint germline, {JOINT_SAMPLES} samples: diploidSV "
          f"body identical in off, jump and exact ({len(bodies['off'])} "
          f"records); truth checks equal in every key but "
          f"{list(TRUTH_UNCOMPARED)}: recall {first['recall']}, gt_acc "
          f"{first['gt_acc']}, fp_records {first['fp_records']}, by_type "
          f"{first['by_type']}; K1 {k1} launches (jump), K3 {k3} (exact)",
          flush=True)
    return {"joint10_jump": k1, "joint10_exact": k3, "base": base,
            "run_exact": runs["exact"]["run_dir"],
            "body": bodies["exact"]}


def tumor_only(card: str, wgs: dict) -> dict:
    """Tumor-only calling of the WGS-shaped BAM through the command line
    at -j 8, scoring off, jump and exact, each truth-checked in tumor mode
    (resumed): identical tumor bodies and check lines. Returns K1's
    launches in jump and K3's in exact."""
    phase(f"calling modes (c): tumor-only, the WGS-shaped BAM, -j "
          f"{HOST_JOBS}, scoring off, jump, exact; truth checks (tumor)")
    work = os.path.join(WORK, "chip_smoke", "tumor_only")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    prefix = wgs["prefix"]
    runs, bodies = {}, {}
    for mode in CALLING_MODES:
        run_dir = os.path.join(work, f"run_{mode}")
        path = f"tumor_only_{mode}"
        res = runs[mode] = _cli(f"tumor-only {mode}", [
            *_mode_args(path, mode, ["--tumor-bam", prefix + ".bam",
                                     "--reference", prefix + ".fa"],
                        ["--workload", "tumor", "--prefix", prefix]),
            "--run-dir", run_dir])
        if path in WORKER_PATH_KERNELS:
            WORKER_PATHS[path] = res["records"]
        _check_work("tumor-only", mode, res["work"])
        bodies[mode] = _records(os.path.join(run_dir, "results", "variants",
                                             "tumorSV.vcf.gz"))
        print(_describe_cli(mode, res, len(bodies[mode]), "tumor"),
              flush=True)
    checks = _truth_checks(
        prefix, {f"tumor-only {mode}": runs[mode]["run_dir"]
                 for mode in CALLING_MODES},
        "--mode", "tumor", "--jobs", HOST_JOBS)
    for mode, body in bodies.items():
        if body != bodies["off"]:
            raise AssertionError(f"tumor-only: the tumorSV body of {mode} "
                                 "differs from off's")
    first = _same_checks("tumor-only", checks)
    k1 = runs["jump"]["work"]["k1_launches"]
    k3 = runs["exact"]["work"]["k3_launches"]
    print(f"{card}; tumor-only: tumorSV body identical in off, jump and "
          f"exact ({len(bodies['off'])} records); truth checks (tumor) "
          f"equal but for {list(TRUTH_UNCOMPARED)}: recall "
          f"{first['recall']}, fp_records {first['fp_records']}, by_type "
          f"{first['by_type']}; K1 {k1} launches (jump), K3 {k3} (exact)",
          flush=True)
    return {"tumor_only_jump": k1, "tumor_only_exact": k3}


def rescore(card: str, joint: dict) -> dict:
    """--rescore of the exact ten-sample run directory with exact:
    phase 1's graph untouched, the candidates written again, the bodies
    the first run's, K3 launched. Returns the rescore's launches."""
    phase("calling modes (d): --rescore of the ten-sample exact run")
    run_dir = joint["run_exact"]
    ws = os.path.join(run_dir, "workspace")
    graph = os.path.join(ws, "svLocusGraph.npz")
    cand = os.path.join(ws, "candidateSV.vcf")
    graph_before, cand_before = os.stat(graph).st_mtime_ns, \
        os.stat(cand).st_mtime_ns
    res = _cli("rescore", [*joint["base"], "--run-dir", run_dir,
                           "--device-scoring", "exact", "--rescore"])
    _check_work("rescore", "exact", res["work"])
    body = _records(os.path.join(run_dir, "results", "variants",
                                 "diploidSV.vcf.gz"))
    print(_describe_cli("exact", res, len(body), "diploid"), flush=True)
    if os.stat(graph).st_mtime_ns != graph_before:
        raise AssertionError("rescore: svLocusGraph.npz was rewritten")
    if os.stat(cand).st_mtime_ns == cand_before:
        raise AssertionError("rescore: candidateSV.vcf was not rewritten")
    if body != joint["body"]:
        raise AssertionError("rescore: the diploidSV body differs from the "
                             "first exact run's")
    print(f"{card}; rescore: svLocusGraph.npz untouched (mtime), "
          f"candidateSV.vcf rewritten, diploidSV body == the first run's "
          f"({len(body)} records); K1 {res['work']['k1_launches']}, K3 "
          f"{res['work']['k3_launches']} launches", flush=True)
    return {"rescore_k1": res["work"]["k1_launches"],
            "rescore_k3": res["work"]["k3_launches"]}


def calling_modes(card: str, wgs: dict, joint_gen: subprocess.Popen) -> dict:
    """The calling modes the main path has not run: RNA, ten-sample joint
    germline (its workload from ``joint_gen``), tumor-only and --rescore.
    Returns every launch count and the RNA call's numbers."""
    t0 = time.perf_counter()
    out = rna_mode(card)
    joint = joint_germline(card, joint_gen)
    out.update(joint10_jump=joint["joint10_jump"],
               joint10_exact=joint["joint10_exact"])
    out.update(tumor_only(card, wgs))
    out.update(rescore(card, joint))
    print(f"calling modes: {time.perf_counter() - t0:.1f} s", flush=True)
    return out

# the truth checker's keys that are not the calls: the run's own wall,
# memory and directory
TRUTH_UNCOMPARED = ("wall_s", "peak_rss_gb", "run_dir")


def _last_json(text: str) -> dict:
    return json.loads(next(ln for ln in reversed(text.splitlines())
                           if ln.startswith("{")))


def measurement_entry_points(card: str, wgs: dict) -> dict:
    """The measurement and validation entry points as a user runs them,
    each a child process, on the WGS-shaped workload of the phase
    before: the at-scale twin with jump scoring at -j 2 (its body equals
    the 'off' run's, K1 launched in its workers), the truth checker on
    the 'off' run and on the at-scale run (both resume; equal lines,
    recall above 0), and the bench twin (its own stress workload, its
    device rate, the resolved mode). Returns K1's launches in the
    at-scale run and in the bench twin's run."""
    phase("measurement entry points: tools.bench_wgs_at_scale (jump, -j 2), "
          "the truth checker, tools.bench")
    work = os.path.join(WORK, "chip_smoke", "measure")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    prefix, run_off = wgs["prefix"], wgs["run_off"]
    run_dir = os.path.join(work, "run_at_scale_jump")
    t0 = time.perf_counter()
    at = run_child(["-m", "manta_tpu_torch.tools.bench_wgs_at_scale",
                    "--workload", prefix, "--reads-m", str(wgs["reads"] / 1e6),
                    "--device-scoring", "jump", "--jobs", "2",
                    "--results-dir", os.path.join(work, "results_at_scale"),
                    "--run-dir", run_dir, "--keep"])
    if at.returncode != 0:
        raise RuntimeError(f"bench_wgs_at_scale failed:\n{at.stderr[-3000:]}")
    art = _last_json(at.stdout)
    print(json.dumps(art), flush=True)
    lines = _DISPATCH_LINE.findall(at.stderr)
    k1 = sum(int(line[5]) for line in lines)
    body = _records(os.path.join(run_dir, "results", "variants",
                                 "diploidSV.vcf.gz"))
    want = _records(os.path.join(run_off, "results", "variants",
                                 "diploidSV.vcf.gz"))
    print(f"at-scale twin, jump, -j 2: {time.perf_counter() - t0:.1f} s in "
          f"the child; {len(lines)} worker device-dispatch lines, "
          f"{sum(int(line[1]) for line in lines)} contig jobs, {k1} K1 "
          f"launches; diploidSV body == off's ({len(body)} records)",
          flush=True)
    if body != want:
        raise AssertionError("the at-scale twin's jump body differs from "
                             "the off run's")
    if k1 <= 0 or art["k1_launches"] != k1:
        raise AssertionError(f"at-scale twin: {k1} K1 launches in its "
                             f"workers' lines, {art['k1_launches']} in its "
                             "artifact; wanted the same, above 0")
    if art["device_scoring_resolved"] != "jump" or art["device"] != card:
        raise AssertionError(f"at-scale artifact: {art['device']!r}, "
                             f"{art['device_scoring_resolved']!r}")

    a = _same_checks("the truth checks", _truth_checks(
        prefix, {"off": run_off, "at_scale_jump": run_dir}))
    print(f"truth checks equal in every key but {list(TRUTH_UNCOMPARED)}; "
          f"recall {a['recall']}, gt_acc {a['gt_acc']}, fp_records "
          f"{a['fp_records']}", flush=True)

    results = os.path.join(work, "results_bench")
    os.makedirs(results)
    t0 = time.perf_counter()
    run = run_child(["-m", "manta_tpu_torch.tools.bench", "--results-dir",
                     results, "--work-dir", os.path.join(work, "bench")])
    if run.returncode != 0:
        raise RuntimeError(f"tools.bench failed:\n{run.stderr[-3000:]}")
    line = _last_json(run.stdout)
    print(json.dumps(line), flush=True)
    lines = _DISPATCH_LINE.findall(run.stderr)
    in_lines = sum(int(x[5]) for x in lines)
    print(f"bench twin: {time.perf_counter() - t0:.1f} s in the child; "
          f"{line['metric']} {line['value']} min; resolved mode "
          f"{line['device_scoring_resolved']}; workflow: "
          f"{line['workflow_contig_jobs']} contig jobs in "
          f"{line['workflow_dispatches']} dispatches, "
          f"{line['workflow_k1_launches']} K1 launches; device rate "
          f"{line['device_contigs_per_s']:.1f} contigs/s "
          f"({line['device_timed_by']}, {line['device_k1_launches']} K1 "
          "launches)", flush=True)
    if line["metric"] != "wgs_20core_projection" or \
            line["device_scoring_resolved"] != "jump" or \
            not line["device_contigs_per_s"] > 0 or \
            line["device_k1_launches"] <= 0:
        raise AssertionError(f"tools.bench line: {line}")
    # every dispatch of its workflow went through K1, by the workers' own
    # exit lines and by the tool's count of them
    if not (line["workflow_k1_launches"] == line["workflow_dispatches"]
            == in_lines):
        raise AssertionError(f"tools.bench workflow: "
                             f"{line['workflow_k1_launches']} K1 launches, "
                             f"{line['workflow_dispatches']} dispatches, "
                             f"{in_lines} in the workers' lines")
    return {"at_scale": k1,
            "bench": line["workflow_k1_launches"]
            + line["device_k1_launches"],
            "bench_workflow": line["workflow_k1_launches"]}


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
    run = run_child(["-m", "manta_tpu_torch.tools.device_timing",
                     "--kernel", "all", "--json", out])
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
            "split_scan_mxu_on_k3_inputs", "scan_router_exact",
            "jumpalign"} | {
        f"jump_score_cuda_bounded_k{k}" for k in BOUNDED_ROUNDS}
    if not want <= names:
        raise AssertionError(f"missing records: {sorted(want - names)}")
    align = {rec["metric"]: rec for rec in records
             if rec.get("kernel") == "jumpalign"}
    device = align.get("jump_align_throughput_device", {})
    if "jump_align_throughput_host" not in align or \
            device.get("host_parity") != "32/32" or \
            device.get("plain_parity") != f"{JUMPALIGN_SHAPE[0]}/" \
            f"{JUMPALIGN_SHAPE[0]}" or \
            device.get("shape") != "B={},q={},refs=2x{}".format(
                *JUMPALIGN_SHAPE):
        raise AssertionError(f"jumpalign records: {align}")
    # every row at its full lengths: query int32 (B, q), two references
    # (B, r), three lengths in, a score out; cells (q + 1) x 2r a row
    B, q, r = JUMPALIGN_SHAPE
    ms = device["sec_per_iter"] * 1e3
    n_ops = JUMP_OPS_PER_CELL * B * (q + 1) * 2 * r
    bound = _bound(4 * B * (q + 2 * r + 4), n_ops)
    int32_ms = n_ops / PEAK_INT32_OPS_PER_S * 1e3
    print(f"jumpalign (B={B}, q={q}, refs 2x{r}): host == kernel on 32 of "
          f"32 contigs, kernel == plain on {B} of {B}; kernel {ms:.4f} ms a "
          f"launch (profiler), {device['contigs_per_s']:.0f} contigs/s, "
          f"layout (lanes, warps a row) {device['layout']}; bound "
          f"{bound['bound_ms']:.5f} ms by {bound['bound_by']} "
          f"({bound['bound_ms'] / ms:.2%} reached; at the int32 rate "
          f"{int32_ms:.5f} ms, {int32_ms / ms:.2%}); the host's full "
          f"aligner on one core "
          f"{align['jump_align_throughput_host']['contigs_per_s']:.1f} "
          "contigs/s", flush=True)
    counts = records[-1]["kernel_launches"]
    if min(counts[k] for k in KERNELS) <= 0:
        raise AssertionError(f"the timing path left a kernel unlaunched: "
                             f"{counts}")
    print(f"launches of the timing path {counts}; "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return counts


def dry_run() -> dict:
    """entry() on the card against its plain form, then the dry run on a
    mesh of one CUDA device as a user runs it, in a process of its own:
    all seven stages, with the kernel launches of each stage from the
    wrappers' own counts. Returns the dry run's launches by kernel."""
    phase("dry run: python -c graft_entry.dryrun_multichip(1) on the card")
    import torch
    from manta_tpu_torch import graft_entry
    from manta_tpu_torch.align import cuda_splitscore
    from manta_tpu_torch.align import device_splitscore as ds
    fn, example = graft_entry.entry()
    before = cuda_splitscore.KERNEL_LAUNCHES["split_score"]
    best, pos = fn(*example)
    launched = cuda_splitscore.KERNEL_LAUNCHES["split_score"] - before
    lut_m, lut_x = (torch.from_numpy(a).cuda() for a in ds.make_luts(0.0))
    p_best, p_pos = ds.batched_split_score(*example, 50, lut_m, lut_x,
                                           example[2].shape[1])
    torch.cuda.synchronize()
    if launched != 1 or not (torch.equal(best, p_best)
                             and torch.equal(pos, p_pos)):
        raise AssertionError(f"entry(): {launched} split launches; kernel "
                             "== plain: "
                             f"{torch.equal(best, p_best)}, "
                             f"{torch.equal(pos, p_pos)}")
    print(f"entry(): the split kernel on {tuple(example[0].shape)} reads x "
          f"{tuple(example[2].shape)} targets on {best.device} == plain "
          "form (tolerance: bit-equal), 1 launch", flush=True)
    t0 = time.perf_counter()
    run = run_child(["-c",
                     "from manta_tpu_torch.graft_entry import "
                     "dryrun_multichip\ndryrun_multichip(1)\n"])
    if run.returncode != 0:
        raise RuntimeError(f"dryrun_multichip(1) failed ({run.returncode}):\n"
                           f"{run.stdout}\n{run.stderr[-3000:]}")
    lines = run.stdout.splitlines()
    ok = [ln for ln in lines if ln.startswith("dryrun_multichip ok: ")]
    counted = [ln for ln in lines
               if ln.startswith("dryrun_multichip launches: ")]
    if len(ok) != 1 or len(counted) != 1:
        raise AssertionError(f"dry run output:\n{run.stdout}")
    stages = json.loads(counted[0].split(": ", 1)[1])
    print(counted[0], flush=True)
    print(ok[0], flush=True)
    by_number = {name.split()[0]: c for name, c in stages.items()}
    if sorted(by_number) != [str(i) for i in range(1, 8)]:
        raise AssertionError(f"stages {sorted(stages)}")
    for stage, kernel in (("2", "jump_score"), ("5", "jump_score"),
                          ("1", "split_score"), ("4", "split_score")):
        if by_number[stage][kernel] <= 0:
            raise AssertionError(f"stage {stage} launched no {kernel} "
                                 f"kernel: {stages}")
    print(f"all seven stages on one CUDA device; "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return {kernel: sum(c[kernel] for c in stages.values())
            for kernel in KERNELS}


# ------------------------------------------------------------ --genome
# the opt-in whole-genome phase: the JAX package's full-size germline
# workload (docs/PERF_r05.md section 5), 24 chromosomes x 100 Mb at 35x,
# seed 7, 838,874,597 reads, through the port's main path at -j 8
GENOME = {"chroms": 24, "mb": 100, "depth": 35, "seed": 7}
GENOME_READS = 838_874_597
# the workload's read length (tools/wgs_workload.READ_LEN)
READ_LEN_WGS = 100
GENOME_JOBS = 8
# the chromosome counts a cut may take, in this order; depth, chromosome
# length, seed and -j 8 are never cut
GENOME_CUTS = (24, 12, 6)
GENOME_STEPS = ("gen", "off", "jump", "exact", "auto", "check", "armed",
                "shapes")
GENOME_ARMED = ("jump", "exact")
GENOME_WORK = os.path.join(WORK, "genome")
GENOME_OUT = os.path.join(REPO, "results_torch", "genome")
# the JAX package's truth line for its off run on that workload, as
# benchmarks/results/wgs840_truthcheck_r05.json records it (the port
# reads no file of the JAX package; tests/test_torch_genome_scale.py
# holds this copy equal to the file)
R05_TRUTH = {"mode": "germline", "truth_n": 23681, "recall": 0.9948,
             "gt_acc": 0.988, "fp_records": 0,
             "by_type": {"DEL": "8467/8468", "INV": "4671/4673",
                         "INS": "5881/5940", "DUP": "4536/4598",
                         "BND": "2/2"}}


def parse_args(argv=None):
    """The smoke's options: none for the default phases; ``--genome``
    and its options for the whole-genome phase."""
    import argparse
    ap = argparse.ArgumentParser(
        description="Smoke run of manta_tpu_torch on one CUDA GPU; "
                    "--genome runs the whole-genome phase instead")
    ap.add_argument("--genome", action="store_true",
                    help="the whole-genome phase: generate the 24 x 100 "
                         "Mb, 35x, seed 7 workload and run the main path "
                         "on it (not part of the default smoke)")
    ap.add_argument("--chroms", type=int, default=None,
                    help=f"cut the chromosome count ({GENOME_CUTS} in "
                         "that order); printed under 'reduced'")
    ap.add_argument("--mb", type=int, default=None,
                    help="chromosome length in Mb (a rehearsal only; "
                         "the phase itself is never cut in length)")
    ap.add_argument("--jobs", type=int, default=None,
                    help=f"workers a run (default {GENOME_JOBS}; other "
                         "counts only in a rehearsal)")
    ap.add_argument("--reason", default=None,
                    help="why the run was cut, printed under 'reduced'")
    ap.add_argument("--steps", default=",".join(GENOME_STEPS),
                    help=f"the steps to run, of {','.join(GENOME_STEPS)}")
    ap.add_argument("--work-dir", default=GENOME_WORK)
    ap.add_argument("--out-dir", default=GENOME_OUT,
                    help="where each step's JSON line is also appended "
                         "(steps.jsonl) beside the runs' artifacts")
    args = ap.parse_args(argv)
    given = [opt for opt in ("chroms", "mb", "jobs", "reason")
             if getattr(args, opt) is not None]
    if not args.genome and (given or args.steps != ap.get_default("steps")):
        ap.error("--chroms, --mb, --jobs, --reason and --steps go with "
                 "--genome")
    steps = args.steps.split(",")
    unknown = sorted(set(steps) - set(GENOME_STEPS))
    if unknown:
        ap.error(f"unknown steps {unknown}; choose from {GENOME_STEPS}")
    args.steps = tuple(s for s in GENOME_STEPS if s in steps)
    args.chroms = GENOME["chroms"] if args.chroms is None else args.chroms
    args.mb = GENOME["mb"] if args.mb is None else args.mb
    args.jobs = GENOME_JOBS if args.jobs is None else args.jobs
    return args


def genome_reduced(args) -> dict | None:
    """What the run cuts from the full workload, with its reason; None
    at full size."""
    cut = {key: [full, got] for key, full, got in (
        ("chroms", GENOME["chroms"], args.chroms),
        ("mb", GENOME["mb"], args.mb), ("jobs", GENOME_JOBS, args.jobs))
        if got != full}
    if not cut:
        return None
    cut["reason"] = args.reason or "not given"
    return cut


def _emit(args, record: dict) -> dict:
    """Print one step's JSON line at once and append it to
    ``out_dir``/steps.jsonl, so a cut run keeps what it measured."""
    line = json.dumps(record)
    print(line, flush=True)
    os.makedirs(args.out_dir, exist_ok=True)
    with open(os.path.join(args.out_dir, "steps.jsonl"), "a") as f:
        f.write(line + "\n")
    return record


def host_check(work_dir: str) -> dict:
    """The host's cores, memory (``free -g``) and the free disk under
    the run directory."""
    os.makedirs(work_dir, exist_ok=True)
    free = subprocess.run(["free", "-g"], capture_output=True, text=True)
    disk = shutil.disk_usage(work_dir)
    return {"nproc": os.cpu_count(), "free_g": free.stdout.strip(),
            "disk_free_gb": round(disk.free / 1e9, 1),
            "disk_total_gb": round(disk.total / 1e9, 1)}


# the generator in a child under the sampler of bench_wgs_at_scale: the
# peak memory of its process tree (the merge's threads included)
_GEN_MEASURED = """
import json

from manta_tpu_torch.tools import wgs_workload
from manta_tpu_torch.tools.bench_wgs_at_scale import RssSampler

with RssSampler(interval=2.0) as rss:
    wgs_workload.main(sys.argv[1:])
print(json.dumps({
    "peak_pss_anon_gb": round(rss.peak_pss_anon / 1e9, 2),
    "peak_anon_gb": round(rss.peak_anon / 1e9, 2),
    "peak_tree_rss_gb": round(rss.peak_total / 1e9, 2),
    "memory_sources": rss.sources}))
"""


def gen_log_figures(log: str) -> dict:
    """Walls and read count from the generator's log: the simulation
    up to the external merge (or the in-memory sort), the merge, and
    the reads written."""
    stamps = [(float(t), msg) for t, msg in
              re.findall(r"^\[\s*([0-9.]+)s\] (.*)$", log, re.M)]
    at = {key: next((t for t, msg in stamps if msg.startswith(key)), None)
          for key in ("merging", "encoding + sorting", "wrote")}
    reads = re.findall(r"wrote .* \((\d+) reads", log)
    sim_end = at["merging"] or at["encoding + sorting"]
    return {"reads": int(reads[-1]) if reads else None,
            "simulation_s": sim_end,
            "merge_s": (at["wrote"] - at["merging"]
                        if at["merging"] is not None and at["wrote"]
                        else None),
            "generation_s": at["wrote"]}


def _gen_args(args, prefix: str) -> list:
    return ["--out", prefix, "--chroms", str(args.chroms), "--mb",
            str(args.mb), "--depth", str(GENOME["depth"]), "--seed",
            str(GENOME["seed"])]


# disk the generation takes a read at its peak: the external merge's
# level-1 BGZF runs (io/bamwriter.spill_run) and their sidecar columns
# beside the reference and the BAM it writes. Measured by DiskUse on an
# H100's host: 34.756 GB at 419,508,317 reads (12 x 100 Mb at 35x)
GEN_DISK_BYTES_PER_READ = 83
# the one directory under --work-dir that the phase owns: it empties
# this directory, and nothing else, before it generates
GENOME_RUN = "genome_run"


def expected_reads(args) -> int:
    """The generator's nominal read count (tools/wgs_workload.py)."""
    return GENOME["depth"] * args.chroms * args.mb * 1_000_000 // READ_LEN_WGS


def genome_prefix(args) -> str:
    """The workload's path prefix, in the phase's own directory."""
    return os.path.join(args.work_dir, GENOME_RUN, "g")


class DiskUse:
    """The disk a directory's files take (their allocated blocks),
    sampled every ``interval`` seconds in a thread while it runs:
    ``step()`` gives the most it held since the last ``step()`` and
    what it holds now, in GB."""

    def __init__(self, path: str, interval: float = 2.0):
        import threading
        self.path, self.interval = path, interval
        self.peak = 0
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)

    def held(self) -> int:
        total = 0
        for root, _dirs, files in os.walk(self.path):
            for name in files:
                try:
                    total += os.lstat(os.path.join(root, name)).st_blocks
                except FileNotFoundError:      # removed while walked
                    pass
        return total * 512

    def _sample(self) -> int:
        now = self.held()
        with self._lock:
            self.peak = max(self.peak, now)
        return now

    def _run(self) -> None:
        while not self._stop.wait(self.interval):
            self._sample()

    def start(self) -> "DiskUse":
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        self._thread.join()

    def step(self) -> dict:
        now = self._sample()
        with self._lock:
            peak, self.peak = self.peak, now
        return {"peak_gb": round(peak / 1e9, 3), "now_gb": round(now / 1e9, 3)}


def start_genome_generation(args) -> subprocess.Popen:
    """Step a, started: the workload from the seed, the port's generator
    in a child (one core) under the memory sampler, into the phase's
    own directory, emptied first. Fails first when the disk under the
    run directory cannot hold the generation at its peak."""
    prefix = genome_prefix(args)
    own = os.path.dirname(prefix)
    need = expected_reads(args) * GEN_DISK_BYTES_PER_READ
    os.makedirs(args.work_dir, exist_ok=True)
    free = shutil.disk_usage(args.work_dir).free
    if os.path.isdir(own):
        free += DiskUse(own).held()
    if need > free:
        raise RuntimeError(f"the generation needs ~{need / 1e9:.0f} GB of "
                           f"disk, {free / 1e9:.0f} GB are free under "
                           f"{args.work_dir}: cut --chroms ({GENOME_CUTS})")
    shutil.rmtree(own, ignore_errors=True)
    os.makedirs(own)
    return start_child(["-c", _GEN_MEASURED, *_gen_args(args, prefix)],
                       prefix + ".gen.log")


def genome_generate(args, proc: subprocess.Popen) -> dict:
    """Step a, ended: the generator's (``proc``, from
    ``start_genome_generation``) walls, peak memory, BAM size and read
    count, which at full size must be the JAX package's 838,874,597."""
    prefix = genome_prefix(args)
    out = wait_child(proc, "the generator")
    wall = time.perf_counter() - proc.started
    rec = {"step": "gen", "argv": "python -m manta_tpu_torch.tools."
           "wgs_workload " + " ".join(_gen_args(args, prefix)),
           "wall_s": round(wall, 2), **gen_log_figures(out),
           "memory": _last_json(out),
           "bam_gb": round(os.path.getsize(prefix + ".bam") / 1e9, 3),
           "disk_need_gb": round(expected_reads(args)
                                 * GEN_DISK_BYTES_PER_READ / 1e9, 1)}
    if genome_reduced(args) is None and rec["reads"] != GENOME_READS:
        raise AssertionError(f"{rec['reads']} reads generated, the JAX "
                             f"package's run had {GENOME_READS}")
    return rec


def _body_digest(run_dir: str) -> str:
    import hashlib
    body = "".join(_records(os.path.join(run_dir, "results", "variants",
                                         "diploidSV.vcf.gz")))
    return hashlib.sha256(body.encode()).hexdigest()


def genome_run(args, prefix: str, mode: str, device: str = "cuda") -> dict:
    """Step b: one unarmed run through python -m manta_tpu_torch.tools.
    bench_wgs_at_scale at -j 8 in a child: its artifact (wall, phases,
    CPU seconds, the process tree's peak memory and its sources, the
    parent and the workers apart, edges, the device work of every
    process from the exit lines, the resolved mode), the phase walls
    and the body's digest. Every contig dispatch went through K1 and
    every split scan through K3; auto resolves to jump on a card."""
    run_dir = f"{prefix}.run_{mode}"
    shutil.rmtree(run_dir, ignore_errors=True)
    proc = start_child(
        ["-m", "manta_tpu_torch.tools.bench_wgs_at_scale", "--workload",
         prefix, "--jobs", str(args.jobs), "--device-scoring", mode,
         "--run-dir", run_dir, "--keep", "--results-dir", args.out_dir,
         "--tag", f"genome_{mode}", "--device", device],
        run_dir + ".log")
    art = _last_json(wait_child(proc, f"the {mode} run"))
    resolved = art["device_scoring_resolved"]
    want = ("jump" if device == "cuda" else "off") if mode == "auto" \
        else mode
    if resolved != want:
        raise AssertionError(f"{mode} resolved to {resolved}, not {want}")
    if device == "cpu":
        if art["k1_launches"] or art["k3_launches"]:
            raise AssertionError(f"{mode}: a kernel launched on the cpu")
    else:
        _check_work(f"genome {mode}", resolved, art)
    if resolved == "jump" and device == "cuda" and not art["k1_launches"]:
        raise AssertionError(f"{mode}: no K1 launch")
    return {"step": mode, **art, "phases": _phase_walls(run_dir),
            "body_sha256": _body_digest(run_dir)}


def compare_truth(line: dict, want: dict) -> list:
    """The fields of a truth check's line that differ from ``want``'s,
    ``by_type`` type by type: [(field, got, wanted)]."""
    out = []
    for key, value in want.items():
        if key == "by_type":
            got = line.get(key, {})
            for typ in sorted(set(value) | set(got)):
                if got.get(typ) != value.get(typ):
                    out.append((f"by_type.{typ}", got.get(typ),
                                value.get(typ)))
        elif line.get(key) != value:
            out.append((key, line.get(key), value))
    return out


def genome_check(args, prefix: str, runs: dict) -> dict:
    """Step c: the truth checker resumed on every unarmed run at once
    (germline); their lines equal but for wall, memory and directory,
    their diploid bodies byte-identical; at full size the off run's line
    equal to the JAX package's (R05_TRUTH), every differing field
    printed before it fails. A cut run is compared with the JAX
    package's host path at a small size by tests/test_torch_genome_scale
    .py instead."""
    dirs = {mode: rec["run_dir"] for mode, rec in runs.items()}
    lines = _truth_checks(prefix, dirs, "--mode", "germline", "--jobs",
                          str(args.jobs))
    bodies = {mode: _records(os.path.join(d, "results", "variants",
                                          "diploidSV.vcf.gz"))
              for mode, d in dirs.items()}
    first = next(iter(bodies))
    differ = [m for m, b in bodies.items() if b != bodies[first]]
    if differ:
        raise AssertionError(f"diploid bodies of {differ} differ from "
                             f"{first}'s")
    line = _same_checks("genome", lines)
    rec = {"step": "check", "modes": list(lines), "line": line,
           "records": len(bodies[first]),
           "body_sha256": _body_digest(dirs[first]),
           "check_wall_s": {m: ln["wall_s"] for m, ln in lines.items()}}
    if genome_reduced(args) is not None or "off" not in lines:
        rec["r05"] = ("not compared: " + ("the run is cut, "
                      f"{genome_reduced(args)}" if genome_reduced(args)
                      else "no off run in this call"))
        return rec
    diffs = compare_truth(lines["off"], R05_TRUTH)
    rec["r05"] = "equal" if not diffs else [list(d) for d in diffs]
    if diffs:
        _emit(args, rec)
        raise AssertionError(f"off's truth line differs from the JAX "
                             f"package's round-5 line: {diffs}")
    return rec


def genome_armed(args, prefix: str, mode: str, device: str = "cuda",
                 body: str | None = None) -> dict:
    """Step d: the same workload through the timing tool's workflow mode
    at -j 8 (python -m manta_tpu_torch.tools.device_timing --kernel
    workflow --workload wgs --jobs 8), each phase-2 worker tracing
    itself: per kernel its launches in the traces, by the wrappers, on
    the exit lines and the seams' calls, all equal; device ms, shapes,
    work, bound and share, copies; phase 2's busy union and share, the
    workers' CUDA start-ups, no event outside phase 2, no overlap. The
    tool exits 1 when they disagree: its records are kept and printed
    first. ``body``: the unarmed runs' digest, which this run's must
    equal."""
    run_dir = f"{prefix}.armed_{mode}"
    json_path = os.path.join(args.out_dir, f"armed_{mode}.jsonl")
    os.makedirs(args.out_dir, exist_ok=True)
    if os.path.exists(json_path):
        os.remove(json_path)
    t0 = time.perf_counter()
    proc = start_child(
        ["-m", "manta_tpu_torch.tools.device_timing", "--kernel",
         "workflow", "--workload", "wgs", "--prefix", prefix, "--mode",
         mode, "--jobs", str(args.jobs), "--run-dir", run_dir, "--json",
         json_path, "--device", device], run_dir + ".log")
    rc = proc.wait()
    wall = time.perf_counter() - t0
    with open(proc.log) as f:
        records = _tool_records(f.read())
    kernels, phase2 = records[:-1], records[-1] if records else {}
    rec = {"step": f"armed_{mode}", "wall_s": round(wall, 2), "rc": rc,
           "kernels": {r["kernel"]: {k: r[k] for k in (
               "calls", "launches_wrapper", "launches_profiler",
               "launches_exit_lines", "device_ms", "device_ms_per_launch",
               "path_wall_s", "useful_work", "padded_work", "bytes",
               "bound_ms", "bound_by", "bound_ms_int32", "share_of_bound",
               "share_of_bound_int32", "h2d", "d2h", "shapes") if k in r}
               for r in kernels},
           "phase2": {k: phase2.get(k) for k in (
               "phase2_wall_s", "device_busy_ms", "busy_share", "workers",
               "workers_launched", "cuda_startup_s", "clocks",
               "events_outside_phase2", "overlapping_kernels",
               "worker_marks_s")}}
    if rc != 0:
        with open(proc.log + ".err") as f:
            rec["error"] = f.read()[-3000:]
        _emit(args, rec)
        raise RuntimeError(f"device_timing --kernel workflow ({mode}) "
                           f"failed ({rc}): {rec['error'][-1500:]}")
    for name, k in rec["kernels"].items():
        counted = {k["calls"], k["launches_wrapper"],
                   k["launches_exit_lines"]}
        if device == "cuda":
            counted.add(k["launches_profiler"])
        elif k["launches_wrapper"]:
            raise AssertionError(f"{name} launched on the cpu")
        if device == "cuda" and len(counted) > 1:
            raise AssertionError(f"armed {mode}: {name}'s launches "
                                 f"disagree: {k}")
    if device == "cuda" and (phase2["events_outside_phase2"]
                             or phase2["overlapping_kernels"]):
        raise AssertionError(f"armed {mode}: {rec['phase2']}")
    rec["body_sha256"] = _body_digest(run_dir)
    if body is not None and rec["body_sha256"] != body:
        raise AssertionError(f"armed {mode}: the body differs from the "
                             "unarmed runs'")
    return rec


def _bucket_jobs(rng, B: int, nq: int, nr1: int, nr2: int) -> list:
    """Seeded jump jobs that the dispatcher pads to bucket (B, nq, nr1,
    nr2): B - 2 jobs (two pad rows, as the dispatcher adds them), the
    first as long as the bucket."""
    jobs = [(q, r1[:nr1], r2[:nr2])
            for q, r1, r2 in _jobs(rng, max(1, B - 2), nq, max(nr1, nr2))]
    q, r1, r2 = jobs[0]
    jobs[0] = (q.ljust(nq, b"A")[:nq], r1.ljust(nr1, b"C")[:nr1],
               r2.ljust(nr2, b"G")[:nr2])
    return jobs


def _tier_inputs(rng, n: int, t: int, Lp: int, Tp: int):
    """A seeded exact scan at tier (Lp, Tp): ``n`` reads (100 bases at
    Lp 256, as the workload's reads, else up to Lp) taken from the first
    target with one substitution in ten, random quals, and ``t``
    targets, the first as long as the tier allows. Returns (batch,
    read_idx, targets, bp_ranges) as the router receives them."""
    from types import SimpleNamespace

    import numpy as np
    bases = np.frombuffer(b"ACGT", np.uint8)
    lengths = [Tp - 8] + [int(rng.integers(Tp // 2 + 8, Tp - 7))
                          for _ in range(t - 1)]
    targets = [bases[rng.integers(0, 4, L)] for L in lengths]
    bp_ranges = [(L // 2 - 2, L // 2 + 2) for L in lengths]
    lo = READ_LEN_WGS if Lp == 256 else Lp // 2 + 1
    read_lens = [lo if Lp == 256 else int(rng.integers(lo, Lp + 1))
                 for _ in range(n)]
    seqs, quals = [], []
    for L in read_lens:
        at = int(rng.integers(0, max(1, lengths[0] - L)))
        s = targets[0][at:at + L].copy()
        flip = rng.random(L) < 0.1
        s[flip] = bases[rng.integers(0, 4, int(flip.sum()))]
        seqs.append(s)
        quals.append(rng.integers(2, 41, L).astype(np.uint8))
    off = np.zeros(n + 1, np.int64)
    off[1:] = np.cumsum([len(s) for s in seqs])
    batch = SimpleNamespace(seq=np.concatenate(seqs),
                            qual=np.concatenate(quals), seq_off=off,
                            qual_off=off.copy(), n=n)
    return batch, np.arange(n, dtype=np.int64), targets, bp_ranges


def _smoke_shapes():
    """The K1 buckets and K3 tiers the default smoke's kernel checks
    launch at (phases 3 and 4)."""
    from manta_tpu_torch.align import device_jumpscore as dj
    from manta_tpu_torch.scoring import device_scan
    k1 = {(B, dj._bucket(nq), dj._bucket(nr), dj._bucket(nr))
          for B, nq, nr in KERNEL_SHAPES} | {MAIN_PATH_BUCKET}
    k3 = {(Lp, device_scan._bucket(Tp)) for _B, Lp, Tp in SPLIT_SHAPES}
    return k1, k3


def genome_shapes(armed: dict) -> dict:
    """Step e (the card only): every K1 bucket and K3 tier the armed
    runs launched at, one launch each on seeded inputs of that shape
    held against the plain PyTorch form on the card (bit-equal int32
    scores; bit-equal best lnlhood and position), with its profiler
    device time, the plain form's time and the bound. Shapes the
    default smoke's checks never launch are marked new."""
    phase("genome: the kernels at the shapes the whole genome launched")
    import numpy as np
    import torch
    from manta_tpu_torch.align import cuda_jumpscore, cuda_splitscore
    from manta_tpu_torch.align import device_jumpscore as dj
    from manta_tpu_torch.align import device_splitscore as ds
    from manta_tpu_torch.candidates.refiner import RefinerOptions
    from manta_tpu_torch.scoring import device_scan
    from manta_tpu_torch.scoring.evidence import QscoreSnp

    smoke_k1, smoke_k3 = _smoke_shapes()
    buckets, tiers = {}, {}
    for rec in armed.values():
        for key, calls in rec["kernels"]["jump_score"]["shapes"].items():
            buckets[key] = buckets.get(key, 0) + calls
        for key, tier in rec["kernels"]["split_score"]["shapes"].items():
            seen = tiers.setdefault(key, {"calls": 0, "reads": 0,
                                          "targets": 0})
            seen["calls"] += tier["calls"]
            seen["reads"] = max(seen["reads"], tier["reads"])
            seen["targets"] = max(seen["targets"], tier["targets"])
    rng = np.random.default_rng(20261017)
    opt = RefinerOptions()
    scores, jump = opt.spanning_scores, opt.jump_score
    jargs = (scores.match, scores.mismatch, scores.open, scores.extend,
             scores.off_edge, jump)
    out = {"step": "shapes", "jump_score": [], "split_score": []}

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        return res, (time.perf_counter() - t0) * 1e3

    for key in sorted(buckets, key=lambda k: tuple(map(int, k.split(",")))):
        B, nq, nr1, nr2 = map(int, key.split(","))
        arrays = dj.pad_jobs(_bucket_jobs(rng, B, nq, nr1, nr2), B)
        shape = (arrays[0].shape[0], arrays[0].shape[1],
                 arrays[2].shape[1], arrays[4].shape[1])
        if shape != (B, nq, nr1, nr2):
            raise AssertionError(f"K1 inputs padded to {shape}, not {key}")
        t = dj.from_reference_inputs(*arrays, "cuda")
        kern = cuda_jumpscore.jump_score_cuda(*t, *jargs)
        plain, plain_ms = timed(lambda: dj.batched_jump_score(
            *t, *jargs, nq, nr1, nr2))
        kern, plain = kern.cpu().numpy(), plain.cpu().numpy()
        if not np.array_equal(kern, plain):
            bad = np.flatnonzero(kern != plain)[:8]
            raise AssertionError(f"K1 != plain at {key}: rows "
                                 f"{bad.tolist()}")
        ms = _device_ms(lambda: cuda_jumpscore.jump_score_cuda(*t, *jargs),
                        "jump_systolic_kernel", runs=20)
        bound = _jump_bound(arrays, JUMP_OPS_PER_CELL, 1)
        row = {"bucket": key, "calls": buckets[key],
               "new": shape not in smoke_k1, "equal": "bit-equal int32",
               "device_ms": ms, "plain_ms": plain_ms, **bound}
        print(f"K1 {key}: {json.dumps(row)}", flush=True)
        out["jump_score"].append(row)
    qconv = QscoreSnp(1e-3)
    m, x = qconv.lut256()
    luts = [torch.from_numpy(np.ascontiguousarray(a[:71])).cuda()
            for a in (m, x)]
    staging = device_scan.ExactStaging(torch.device("cuda"))
    for key in sorted(tiers, key=lambda k: tuple(map(int, k.split(",")))):
        Lp, Tp = map(int, key.split(","))
        n, nt = tiers[key]["reads"], tiers[key]["targets"]
        batch, idx, targets, ranges = _tier_inputs(rng, n, nt, Lp, Tp)
        if device_scan.read_tier(batch, idx) != Lp or \
                device_scan._bucket(max(map(len, targets)) + 1) != Tp:
            raise AssertionError(f"K3 inputs off their tier {key}")
        staged = staging.stage(batch, idx, targets, ranges, Tp)
        fargs = (*staged, FLANK, *luts, Tp)
        kb, kp = cuda_splitscore.split_score_factored_cuda(*fargs)
        # the plain form in chunks of reads: it holds a (reads, targets,
        # Tp, Lp) plane
        chunk = max(1, min(n, int(4e9 // (nt * Tp * Lp * 4))))

        def plain():
            parts = [ds.batched_split_score_factored(
                staged[0][a:a + chunk], staged[1][a:a + chunk],
                staged[2][a:a + chunk], *staged[3:], FLANK, *luts, Tp)
                for a in range(0, n, chunk)]
            return (torch.cat([p[0] for p in parts]),
                    torch.cat([p[1] for p in parts]))
        (pb, pp), plain_ms = timed(plain)
        if not (torch.equal(kb, pb) and torch.equal(kp, pp)):
            raise AssertionError(f"K3 != plain at tier {key} ({n} reads x "
                                 f"{nt} targets)")
        ms = _device_ms(
            lambda: cuda_splitscore.split_score_factored_cuda(*fargs),
            "split_score_kernel", runs=20)
        rl = np.diff(batch.seq_off)
        terms = device_scan.useful_terms(
            rl[:, None], np.array([b for b, _e in ranges]),
            np.array([e for _b, e in ranges]), [len(tg) for tg in targets])
        n_bytes = (2 * n * Lp + nt * Tp + 4 * (n + 3 * nt) + 2 * 71 * 4
                   + 8 * n * nt)
        bound = _bound(n_bytes, SPLIT_OPS_PER_TERM * terms)
        row = {"tier": key, "reads": n, "targets": nt,
               "calls": tiers[key]["calls"], "new": (Lp, Tp) not in smoke_k3,
               "equal": "bit-equal best and position", "device_ms": ms,
               "plain_ms": plain_ms, "useful_terms": terms, **bound}
        print(f"K3 {key}: {json.dumps(row)}", flush=True)
        out["split_score"].append(row)
    return out


def genome(args, device: str = "cuda") -> dict:
    """The whole-genome phase, step by step (``args.steps``), each
    step's JSON line printed as it ends, with the disk the phase's
    directory took at most during the step and holds at its end; the
    card's lines and the last line as the default smoke ends."""
    card = environment() if device == "cuda" else "cpu"
    phase("genome")
    prefix = genome_prefix(args)
    plan = {"step": "plan", "workload": {**GENOME, "chroms": args.chroms,
                                         "mb": args.mb},
            "expected_reads": expected_reads(args),
            "jobs": args.jobs, "steps": list(args.steps),
            "reduced": genome_reduced(args), "device": card,
            "host": host_check(args.work_dir)}
    done = {"plan": _emit(args, plan)}
    gen = (start_genome_generation(args) if "gen" in args.steps
           else None)
    disk = DiskUse(os.path.dirname(prefix)).start()

    def emit(rec: dict) -> dict:
        return _emit(args, {**rec, "disk": disk.step()})

    try:
        if device == "cuda" and set(args.steps) - {"gen", "off", "check"}:
            # beside the generator, which takes one core: the runs'
            # walls then hold no kernel build
            build(("jump_score", "split_score"))
        if gen is not None:
            done["gen"] = emit(genome_generate(args, gen))
        runs = {}
        for mode in ("off", "jump", "exact", "auto"):
            if mode in args.steps:
                runs[mode] = done[mode] = emit(
                    genome_run(args, prefix, mode, device))
        if "check" in args.steps and runs:
            done["check"] = emit(genome_check(args, prefix, runs))
        body = next(iter(runs.values()))["body_sha256"] if runs else None
        armed = {}
        if "armed" in args.steps:
            for mode in GENOME_ARMED:
                armed[mode] = done[f"armed_{mode}"] = emit(
                    genome_armed(args, prefix, mode, device, body))
        if "shapes" in args.steps and armed and device == "cuda":
            done["shapes"] = emit(genome_shapes(armed))
    finally:
        disk.stop()
    return done


def genome_main(args) -> None:
    """``--genome``: the phase, then the line of what it measured, the
    card's line and the last line."""
    done = genome(args)
    import torch
    _no_foreign()
    print(json.dumps({"genome": {step: rec for step, rec in done.items()
                                 if step in ("plan", "check")},
                      "steps": list(done),
                      "total_s": round(time.perf_counter() - T_START, 1)}))
    print(done["plan"]["device"])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


def _no_foreign() -> None:
    foreign = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "manta_tpu"))
    if foreign:
        raise AssertionError(f"JAX or the JAX package was imported: "
                             f"{foreign[:8]}")


def main(argv=None) -> None:
    args = parse_args(argv)
    if not os.path.isdir(os.path.join(REPO, "manta_tpu_torch")):
        sys.exit("chip_smoke.py: run it from the root of a checkout "
                 "(manta_tpu_torch/ not found beside it)")
    sys.path.insert(0, REPO)
    try:
        genome_main(args) if args.genome else smoke()
    finally:
        for proc in BACKGROUND:
            if proc.poll() is None:
                proc.kill()
            proc.wait()


def smoke() -> None:
    card = environment()
    # the workloads' generators, one host core each, beside the phases
    # before the ones that read them
    wgs_gen = start_wgs_generation()
    high_gen = start_high_span_generation()
    joint_gen = start_joint_generation()
    build()
    measured = {"jump_score": check_jump_kernel(),
                "jump_score_bounded": check_bounded_kernel(),
                "split_score": check_split_kernel(card)}
    demo_workflow()
    launches, wgs = wgs_workload(wgs_gen, card)
    measured_launches = measurement_entry_points(card, wgs)
    high_span_launches, high = high_span(card, high_gen)
    twin_launches = bench_scripts(card, high)
    modes = calling_modes(card, wgs, joint_gen)
    on_paths = main_paths(card)
    for name, paths in worker_paths(card).items():
        on_paths[name].update(paths)
    launches["jump_score_bounded"] = device_timing()["jump_score_bounded"]
    dry_launches = dry_run()
    _no_foreign()
    import torch
    print(f"\nno jax, jaxlib or manta_tpu module imported in this process "
          f"and in its {len(CHILDREN)} child processes (each behind the "
          f"guard); total {time.perf_counter() - T_START:.1f} s")
    print(json.dumps({"kernels": [{
        "name": name, "route": "cuda", "source": source,
        "replaces": replaces, "launches": launches[name],
        # the further entry point's own launches, each wrapper's count
        # as the dry run's process read it
        "launches_dry_run": dry_launches[name],
        # the high-span jump runs, default edge chunk and 256, each
        # counted in its own process
        # the measurement entry points, each counted in its own
        # processes: the at-scale twin's jump run at -j 2, and the bench
        # twin (its workflow run and its device rate)
        **({"launches_high_span": high_span_launches["jump"],
            "launches_high_span_chunk256":
                high_span_launches["jump_chunk256"],
            "launches_at_scale": measured_launches["at_scale"],
            "launches_bench": measured_launches["bench"],
            "launches_bench_workflow": measured_launches["bench_workflow"],
            # the benchmark twins: bench_edges on the high-span BAM and
            # the jump repeats seed, each counted in its processes
            "launches_bench_edges": twin_launches["bench_edges"],
            "launches_repeats": twin_launches["repeats"],
            # the calling modes: RNA (every mode; none by design), the
            # ten-sample jump run, tumor-only jump and the exact rescore,
            # each counted in the processes that ran them
            "launches_rna": modes["rna"],
            "launches_joint10_jump": modes["joint10_jump"],
            "launches_tumor_only": modes["tumor_only_jump"],
            "launches_rescore": modes["rescore_k1"]}
           if name == "jump_score" else {}),
        **({"launches_repeats_exact": twin_launches["repeats_exact"],
            # the calling modes' exact runs; then K3 at the widest RNA
            # call (scan tier rna_tp): profiler device time, plain form,
            # bound and the router's wall for the call
            "launches_rna_exact": modes["rna_exact"],
            "launches_joint10_exact": modes["joint10_exact"],
            "launches_tumor_only": modes["tumor_only_exact"],
            "launches_rescore": modes["rescore_k3"],
            **{key: modes[key] for key in (
                "rna_tp", "rna_reads", "rna_ms", "rna_plain_ms",
                "rna_bound_ms", "rna_router_ms", "rna_library_ms",
                "rna_library_max_abs_diff", "rna_library_fit")
               if key in modes}}
           if name == "split_score" else {}),
        **{key: measured[name][key] for key in (
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "library_max_abs_diff", "bound_ms_int32")
           if key in measured[name]},
        # where the workflows launch it: launches, device ms, bound and
        # share, copies, the device's busy share of phase 2 (a run each)
        "main_paths": on_paths[name]}
        for name, (source, replaces) in KERNELS.items()]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
