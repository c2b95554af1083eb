"""Headline benchmark of the port: end-to-end throughput and the
Amdahl-corrected WGS projection, with the contig jump kernel's rate.

    python -m manta_tpu_torch.tools.bench [--device cuda|cpu]
        [--results-dir D] [--tiles 32] [--work-dir W]

Twin of bench.py at the repo root. It runs the port's workflow
(tumor-only, exome settings, all cores, the default device scoring:
contig jump scoring on the card) over the tiled demo junction
(``tools.stress_workload --tiles 32``, generated once under
``--work-dir``, by default ``.testdata/bench_torch/``), then reports:

  value / vs_baseline : the 20-core projection of a 50x NA12878 WGS run
      (840 M reads) from the measured CPU seconds a read and the
      measured serial phase-boundary tail, against the reference's
      published "< 20 minutes on 20 physical cores"; vs_baseline > 1
      beats it. Where ``--results-dir`` holds an at-scale artifact
      measured on a CUDA card (``tools.bench_wgs_at_scale``, scoring
      off), its projection is the headline instead
      (``wgs_20core_projection_measured``).
  device_contigs_per_s, device_gcells_per_s : the CUDA jump kernel at
      the reference's shape (B=64, queries 400, references 2x800, in
      the workflow scorer's bucket 64x512x1024), by the profiler's
      device time (``device_timed_by``).

It needs a CUDA device and raises without one. ``--device cpu`` runs the
workflow's device scoring and the rate through the plain PyTorch forms
on the host clock, and the line says so (``device``, ``device_form``).

Prints ONE JSON line.
"""

from __future__ import annotations

import argparse
import json
import os
import resource
import shutil
import tempfile
import time

from .bench_wgs_at_scale import RESULTS_DIR, log_phases

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
WORK_DIR = os.path.join(REPO, ".testdata", "bench_torch")

WGS_READS_M = 840.0          # 50x NA12878, docs/userGuide/README.md:474
BASELINE_WALL_MIN = 20.0     # reference's published bound, 20 cores
BASELINE_CORES = 20
BENCH_TILES = 32
# bench.py's measure_device: B, query, each reference
JUMP_SHAPE = (64, 400, 800)


def require_device(device: str) -> None:
    """Raise unless ``device`` is 'cpu' or a CUDA device is present."""
    if device not in ("cuda", "cpu"):
        raise ValueError(f"device must be 'cuda' or 'cpu', not {device!r}")
    if device == "cuda":
        from ..workflow.run import cuda_present
        if not cuda_present():
            raise RuntimeError("no CUDA device; pass device='cpu' (--device "
                               "cpu) to run the plain forms on the host")


def stress_workload(tiles: int, work_dir: str = WORK_DIR,
                    demo_fasta: str | None = None):
    """(bam, fasta, reads) of the tiled demo junction, generated once
    under ``work_dir``."""
    from . import stress_workload as sw
    prefix = os.path.join(work_dir, f"stress{tiles}")
    bam, fa, count = prefix + ".bam", prefix + ".fa", prefix + ".reads"
    if not all(os.path.exists(p) for p in (bam, fa, count)):
        from .. import native_core
        native_core.load()
        os.makedirs(work_dir, exist_ok=True)
        _bam, _fa, reads = sw.generate(
            tiles, prefix, demo_fasta=demo_fasta or sw.ensure_demo_fasta())
        with open(count, "w") as f:
            f.write(f"{reads}\n")
    with open(count) as f:
        return bam, fa, int(f.read())


def measure_host(device: str = "cuda", tiles: int = BENCH_TILES,
                 n_jobs: int = 0, work_dir: str = WORK_DIR,
                 demo_fasta: str | None = None) -> dict:
    """One workflow run over the stress workload at ``n_jobs`` (0: all
    cores), device scoring as the workflow defaults it on ``device``."""
    from ..workflow.run import resolve_device_scoring, run_workflow
    from .device_counts import WorkflowCounts
    require_device(device)
    n_cores = n_jobs or os.cpu_count() or 1
    bam, fa, reads = stress_workload(tiles, work_dir, demo_fasta)
    run_dir = tempfile.mkdtemp(prefix="bench_")
    r0 = resource.getrusage(resource.RUSAGE_SELF)
    c0 = resource.getrusage(resource.RUSAGE_CHILDREN)
    t0 = time.perf_counter()
    with WorkflowCounts() as counted:
        run_workflow([], [bam], fa, run_dir, is_exome=True, n_jobs=n_cores,
                     verbose=False, device=device)
    wall = time.perf_counter() - t0
    r1 = resource.getrusage(resource.RUSAGE_SELF)
    c1 = resource.getrusage(resource.RUSAGE_CHILDREN)
    cpu_s = (r1.ru_utime - r0.ru_utime + r1.ru_stime - r0.ru_stime
             + c1.ru_utime - c0.ru_utime + c1.ru_stime - c0.ru_stime)
    with open(os.path.join(run_dir, "workspace", "workflow_log.txt")) as f:
        phases = log_phases(f.read())
    shutil.rmtree(run_dir, ignore_errors=True)
    phase2_s = phases["phase2_s"] or wall
    c = counted.counts()
    return {
        "cores": n_cores,
        "e2e_s": round(wall, 2),
        "cpu_s": round(cpu_s, 1),
        "edges": phases["edges"],
        "phase2_s": round(phase2_s, 2),
        "edges_per_s": round(phases["edges"] / max(phase2_s, 1e-9), 2),
        "serial_tail_s": round(phases["serial_tail_s"], 2),
        "reads_m": reads / 1e6,
        "device_scoring_resolved": resolve_device_scoring("auto") or "off",
        "workflow_contig_jobs": c["contig_jobs"],
        "workflow_dispatches": c["dispatches"],
        "workflow_k1_launches": c["k1_launches"],
    }


def project_wgs(host: dict) -> dict:
    """Amdahl-corrected 20-core projection of the reference's headline
    WGS case from measured constants: parallel CPU work scaled by
    reads / 20 cores, plus the measured serial tail scaled by reads."""
    cpu_per_mread = (host["cpu_s"] - host["serial_tail_s"]) \
        / host["reads_m"]
    tail_per_mread = host["serial_tail_s"] / host["reads_m"]
    par_s = cpu_per_mread * WGS_READS_M / BASELINE_CORES
    ser_s = tail_per_mread * WGS_READS_M
    return {
        "wgs_projected_min": round((par_s + ser_s) / 60.0, 2),
        "wgs_parallel_min": round(par_s / 60.0, 2),
        "wgs_serial_min": round(ser_s / 60.0, 2),
        "cpu_s_per_mread": round(cpu_per_mread, 1),
        "serial_s_per_mread": round(tail_per_mread, 3),
    }


def measure_device(device: str = "cuda", shape=JUMP_SHAPE,
                   iters: int | None = None) -> dict:
    """The contig jump kernel's rate at ``shape`` in the workflow
    scorer's bucket (``tools.device_timing.bench_jump_cuda``), by the
    profiler's device time; with ``device='cpu'`` the plain PyTorch form
    on the host clock (``bench_jump``), labelled so. Raises without a
    CUDA device unless asked for the CPU."""
    import torch

    from ..align import cuda_jumpscore
    from . import device_timing as dt
    require_device(device)
    args = argparse.Namespace(jump_shape=tuple(shape), jump_bucketed=True,
                              seed=0)
    cuda = device == "cuda"
    name = torch.cuda.get_device_name(0) if cuda else "cpu"
    ctx = dt.Context(args, torch.device(device), name, None,
                     iters or (20 if cuda else 1))
    records = []
    ctx.emit = records.append
    before = cuda_jumpscore.KERNEL_LAUNCHES["jump_score"]
    (dt.bench_jump_cuda if cuda else dt.bench_jump)(ctx)
    if cuda:
        cuda_jumpscore.raise_on_kernel_error()
    rec = records[0]
    return {"device_contigs_per_s": rec["contigs_per_s"],
            "device_gcells_per_s": rec["gcells_per_s"],
            "device_timed_by": rec["timed_by"],
            "device_sec_per_iter": rec["sec_per_iter"],
            "device_shape": rec["shape"],
            "device_form": ("the CUDA jump kernel (csrc/jump_score.cu)" if cuda
                            else "the plain PyTorch jump DP on the CPU, not "
                                 "a device time"),
            "device": name,
            "device_k1_launches": (cuda_jumpscore.KERNEL_LAUNCHES["jump_score"]
                                   - before)}


def load_measured(results_dir: str = RESULTS_DIR) -> dict | None:
    """The largest at-scale artifact (``tools.bench_wgs_at_scale``,
    scoring off) in ``results_dir`` whose ``device`` names a CUDA card.
    Nothing under benchmarks/ is read: those artifacts were measured for
    the JAX package on other machines."""
    import glob
    root = os.path.realpath(results_dir)
    if os.path.commonpath([root, os.path.join(REPO, "benchmarks")]) == \
            os.path.join(REPO, "benchmarks"):
        return None
    best = None
    for p in sorted(glob.glob(os.path.join(root, "wgs_measured*.json"))):
        try:
            with open(p) as f:
                d = json.load(f)
        except (OSError, ValueError):
            continue
        if not isinstance(d, dict) or d.get("device") in (None, "", "cpu") \
                or not isinstance(d.get("device"), str):
            continue              # not measured on a CUDA card
        if d.get("device_scoring") not in ("off", None):
            continue              # headline = default host config
        if best is None or d.get("reads_m", 0) > best.get("reads_m", 0):
            best = d
    return best


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(
        description="The port's headline benchmark: one JSON line")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--results-dir", default=RESULTS_DIR,
                    help="where tools.bench_wgs_at_scale wrote its artifacts")
    ap.add_argument("--tiles", type=int, default=BENCH_TILES)
    ap.add_argument("--work-dir", default=WORK_DIR,
                    help="where the stress workload is generated, once")
    args = ap.parse_args(argv)
    require_device(args.device)
    host = measure_host(args.device, args.tiles, work_dir=args.work_dir)
    proj = project_wgs(host)
    dev = measure_device(args.device)
    measured = load_measured(args.results_dir)

    if measured is not None:
        value = measured["wgs840_20core_projection_min"]
        out = {
            "metric": "wgs_20core_projection_measured",
            "value": value,
            "unit": "min",
            # > 1 = beats the reference's published 20-min bound
            "vs_baseline": round(BASELINE_WALL_MIN / value, 3),
            "measured_reads_m": measured["reads_m"],
            "measured_pct_of_840m": measured["pct_of_840m"],
            "measured_wall_min": measured["wall_min"],
            "measured_cores": measured["cores"],
            "measured_cpu_s": measured["cpu_s"],
            "measured_peak_rss_gb": measured["peak_rss_gb"],
            # tree-summed Pss_Anon peak (ru_maxrss counts the mmap'd
            # BAM's reclaimable file pages)
            "measured_peak_pss_anon_gb": measured.get("peak_pss_anon_gb"),
            "measured_edges_per_s": measured["edges_per_s"],
            "measured_utc": measured["measured_utc"],
            "measured_device": measured["device"],
            "extrapolation": (
                f"cores {measured['cores']}->20 only; read scale "
                f"measured at {measured['pct_of_840m']}% of 840M"),
        }
    else:
        out = {
            "metric": "wgs_20core_projection",
            "value": proj["wgs_projected_min"],
            "unit": "min",
            "vs_baseline": round(
                BASELINE_WALL_MIN / proj["wgs_projected_min"], 3),
        }
    out.update({"phase2_graph_edges_per_s": host["edges_per_s"],
                **host, **proj, **dev})
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
