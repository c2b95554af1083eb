"""Phase-1 graph-build throughput: reads/s through scan + native merge.

One of the BASELINE.md efficiency metrics ("reads/s (graph build)").
Times estimate_sv_loci alone — fragment-stats estimation, read
ingestion, evidence scanning, and breakend-graph construction — over
the tiled stress BAM (benchmarks/stress_workload.py tiles the demo
junction neighborhoods so the evidence density is realistic).

Usage:
    python -m manta_tpu_torch.tools.stress_workload --tiles 32 --out P
    python -m manta_tpu_torch.tools.bench_graphbuild --bam P.bam \
        --fasta P.fa [-j N] [--work-dir W]

Twin of benchmarks/bench_graphbuild.py on the port's core.fragstats,
graph.finder, scan.scanner and workflow.run: the same stages and JSON
line. At ``-j N`` the merged graph goes to a temporary directory under
``--work-dir`` (default: the system's), removed at the end. Host only:
phase 1 has no device path.
"""

from __future__ import annotations

import argparse
import json
import os
import time

from .. import native_core


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="Phase-1 graph-build throughput (reads/s). Host only: "
                    "phase 1 has no device path")
    ap.add_argument("--bam", required=True)
    ap.add_argument("--fasta", required=True)
    ap.add_argument("--scan-size-mb", type=int, default=12)
    ap.add_argument("-j", "--jobs", type=int, default=1,
                    help="fork workers (host-level reads/s)")
    ap.add_argument("--work-dir", default=None,
                    help="where the -j N run's merged graph goes")
    args = ap.parse_args(argv)
    native_core.load()

    from ..core.fragstats import extract_read_group_stats
    from ..graph.finder import estimate_sv_loci
    from ..graph.locusgraph import SVLocusSetOptions
    from ..io.bam import BamReader
    from ..io.fasta import FastaReader
    from ..scan.scanner import ScannerOptions, SVScanner
    from ..workflow.run import segment_regions

    t0 = time.perf_counter()
    stats = extract_read_group_stats(args.bam)
    t_stats = time.perf_counter() - t0

    reader = BamReader(args.bam)
    header = reader.header
    fasta = FastaReader(args.fasta)
    scanner = SVScanner(ScannerOptions(), [stats.frag_stats],
                        header.ref_lengths, header.ref_names)
    regions = segment_regions(
        [(tid, 0, ln) for tid, ln in enumerate(header.ref_lengths)],
        args.scan_size_mb * 1_000_000)

    t0 = time.perf_counter()
    if args.jobs > 1:
        import shutil
        import tempfile

        from ..graph.locusgraph import SVLocusSet
        from ..workflow.run import _estimate_sv_loci_parallel
        tmp = tempfile.mkdtemp(prefix="graphbuild_", dir=args.work_dir)
        out_npz = os.path.join(tmp, "svLocusGraph.npz")
        _estimate_sv_loci_parallel(
            [args.bam], [False], scanner,
            SVLocusSetOptions(observation_weight=3), regions,
            args.fasta, None, args.jobs, out_path=out_npz)
        locus_set = SVLocusSet.load(out_npz)
        shutil.rmtree(tmp)
    else:
        locus_set = estimate_sv_loci(
            [args.bam], [False], scanner,
            SVLocusSetOptions(observation_weight=3), regions, fasta)
    t_graph = time.perf_counter() - t0

    n_reads = sum(c.get("total", 0) + c.get("split_supplementary_segment", 0)
                  + c.get("min_mapq", 0)
                  for c in locus_set.sample_counts)
    out = {
        "metric": "graph_build_reads_per_s",
        "value": round(n_reads / t_graph, 1),
        "unit": "reads/s",
        "reads": n_reads,
        "stats_s": round(t_stats, 2),
        "graph_s": round(t_graph, 2),
        "loci": locus_set.non_empty_size(),
        "nodes": locus_set.total_node_count(),
        "edges": locus_set.total_edge_count(),
        "jobs": args.jobs,
    }
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
