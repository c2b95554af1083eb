"""Phase-2 throughput: graph-edges/s through candidate generation,
assembly refinement, and scoring.

One of the BASELINE.md efficiency metrics ("graph-edges/s"). Times the
full workflow over the tiled stress BAM and reports edges processed per
second of candidate-generation wall time (the workflow's own phase
timing), plus the end-to-end figure.

Usage:
    python -m manta_tpu_torch.tools.stress_workload --tiles 32 --out P
    python -m manta_tpu_torch.tools.bench_edges --bam P.bam --fasta P.fa \
        [-j N] [--device cuda|cpu] [--device-scoring auto|off|jump|exact|mxu]
        [--work-dir W] [--run-dir D]

Twin of benchmarks/bench_edges.py on the port's workflow: the same run
(tumor-only, exome settings) and JSON line, plus ``device`` (the card's
``nvidia-smi --query-gpu=name,power.limit`` line, or ``"cpu"``),
``device_scoring_resolved`` and the device work of the run, counted in
every process that did it (``tools.device_counts``; at ``-j N`` the
workers). ``--device-scoring auto`` (the default) is the original's
behaviour: contig jump scoring on a CUDA card where one is present.
``--device cuda`` (the default) needs a CUDA device and raises without
one; ``--device cpu`` runs device scoring through the plain PyTorch
forms on the host. The run directory is a temporary one under
``--work-dir`` (default: the system's), removed at the end, or
``--run-dir``, which is kept.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import tempfile
import time

from .. import native_core
from .bench_wgs_at_scale import device_label


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="Phase-2 throughput (graph edges/s) through the port's "
                    "workflow")
    ap.add_argument("--bam", required=True)
    ap.add_argument("--fasta", required=True)
    ap.add_argument("-j", "--jobs", type=int, default=1)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--device-scoring", default="auto",
                    choices=("auto", "off", "jump", "exact", "mxu"))
    ap.add_argument("--work-dir", default=None,
                    help="where the temporary run directory goes")
    ap.add_argument("--run-dir", default=None,
                    help="run here and keep the run directory")
    args = ap.parse_args(argv)
    device = device_label(args.device)
    native_core.load()

    from ..workflow.run import resolve_device_scoring, run_workflow
    from .device_counts import WorkflowCounts

    mode = False if args.device_scoring == "off" else args.device_scoring
    run_dir = args.run_dir or tempfile.mkdtemp(prefix="bench_edges_",
                                               dir=args.work_dir)
    t0 = time.perf_counter()
    with WorkflowCounts() as counted:
        run_workflow([], [args.bam], args.fasta, run_dir,
                     is_exome=True, n_jobs=args.jobs, verbose=False,
                     use_device_scoring=mode, device=args.device)
    wall = time.perf_counter() - t0

    # edge count from the workflow log; phase timing from the edge
    # stats tracker's own wall measurement (SVGenTotalHours), which has
    # much finer resolution than the 1 s log timestamps
    log = open(os.path.join(run_dir, "workspace",
                            "workflow_log.txt")).read()
    m = re.search(r"processed (\d+) graph edges", log)
    n_edges = int(m.group(1)) if m else 0
    tsv = open(os.path.join(run_dir, "results", "stats",
                            "svCandidateGenerationStats.tsv")).read()
    mt = re.search(r"SVGenTotalHours\t([0-9.]+)h wall", tsv)
    phase2_s = float(mt.group(1)) * 3600.0 if mt else wall

    out = {
        "metric": "graph_edges_per_s",
        "value": round(n_edges / max(phase2_s, 1e-9), 2),
        "unit": "edges/s",
        "edges": n_edges,
        "phase2_s": round(phase2_s, 2),
        "e2e_s": round(wall, 2),
        "jobs": args.jobs,
        "device": device,
        "device_scoring_resolved": resolve_device_scoring(mode) or "off",
        **counted.counts(),
    }
    print(json.dumps(out), flush=True)
    if args.run_dir is None:
        shutil.rmtree(run_dir, ignore_errors=True)
    return out


if __name__ == "__main__":
    main()
