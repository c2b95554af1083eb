"""Standalone phase workers for distributed/multi-host deployment.

Equivalents of the reference's per-phase worker binaries, enabling
filesystem-handoff orchestration across hosts
(reference: applications/GetAlignmentStats, MergeAlignmentStats,
EstimateSVLoci, MergeSVLoci; scheduled by mantaWorkflow.py). Each
subcommand reads/writes the same checkpoint artifacts the integrated
workflow uses (alignmentStats.json, svLocusGraph.npz).
"""

from __future__ import annotations

import argparse
import sys


def cmd_get_stats(args):
    """(reference: GetAlignmentStats.cpp:28-56)."""
    from ..core.fragstats import (
        ReadGroupStatsSet, extract_read_group_stats_set,
    )
    out = ReadGroupStatsSet()
    for path in args.align_files:
        out.set_file_stats(path, extract_read_group_stats_set(
            path, reference=args.ref,
            per_read_group=args.per_read_group))
    out.save(args.output_file)
    return 0


def cmd_merge_stats(args):
    """(reference: MergeAlignmentStats.cpp)."""
    from ..core.fragstats import ReadGroupStatsSet
    merged = ReadGroupStatsSet()
    for path in args.stats_files:
        merged.merge(ReadGroupStatsSet.load(path))
    merged.save(args.output_file)
    return 0


def cmd_summarize_stats(args):
    """(reference: SummarizeAlignmentStats.cpp)."""
    from ..core.fragstats import ReadGroupStatsSet
    from ..workflow.stats import write_alignment_stats_summary
    write_alignment_stats_summary(
        ReadGroupStatsSet.load(args.stats_file), args.output_file)
    return 0


def cmd_get_chrom_depth(args):
    """(reference: GetChromDepth.cpp:32-54) — per-chromosome median
    depth for one alignment file, optionally restricted to a chromosome
    subset (the workflow fans chromosome chunks over tasks,
    mantaWorkflow.py:221 + sharedWorkflow.py)."""
    from ..core.chromdepth import read_chrom_depth, write_chrom_depth
    from ..io.bam import open_alignment_reader
    reader = open_alignment_reader(args.align_file, args.ref)
    wanted = set(args.chroms) if args.chroms else None
    depths = {}
    for tid, (name, size) in enumerate(zip(reader.header.ref_names,
                                           reader.header.ref_lengths)):
        if wanted is not None and name not in wanted:
            continue
        depths[name] = read_chrom_depth(reader, tid, size)
    write_chrom_depth(args.output_file, depths)
    return 0


def cmd_merge_chrom_depth(args):
    """(reference: libexec/mergeChromDepth.py) — sum per-chromosome
    depth across per-task depth files; every input must cover the same
    chromosome set."""
    from ..core.chromdepth import parse_chrom_depth, write_chrom_depth
    totals: dict[str, float] = {}
    for index, path in enumerate(args.in_files):
        part = parse_chrom_depth(path)
        if index != 0 and set(part) != set(totals):
            raise SystemExit(
                f"chromosome set mismatch in depth file: {path}")
        for name, d in part.items():
            totals[name] = totals.get(name, 0.0) + d
    write_chrom_depth(args.output_file, totals)
    return 0


def cmd_estimate_loci(args):
    """(reference: EstimateSVLoci.cpp:25-46) — build a partial graph
    for one genome region set."""
    from ..core.fragstats import ReadGroupStatsSet
    from ..graph.finder import estimate_sv_loci
    from ..graph.locusgraph import SVLocusSetOptions
    from ..io.bam import open_alignment_reader
    from ..io.fasta import FastaReader
    from ..scan.scanner import ScannerOptions, SVScanner
    from ..workflow.run import parse_region
    from ..core.chromdepth import parse_chrom_depth

    stats_set = ReadGroupStatsSet.load(args.align_stats)
    bams = args.align_files
    stats_list = [stats_set.get_stats(p) for p in bams]
    header = open_alignment_reader(bams[0], args.ref).header
    scanner = SVScanner(
        ScannerOptions(), [s.frag_stats for s in stats_list],
        header.ref_lengths, header.ref_names)
    fasta = FastaReader(args.ref)
    regions = []
    for r in args.regions:
        tid, beg, end = parse_region(r, header.name_to_tid)
        regions.append(
            (tid, beg, end if end is not None else header.ref_lengths[tid]))
    chrom_depths = parse_chrom_depth(args.chrom_depth) \
        if args.chrom_depth else None
    locus_set = estimate_sv_loci(
        bams, [t in args.tumor_indices for t in range(len(bams))],
        scanner, SVLocusSetOptions(observation_weight=3), regions, fasta,
        chrom_depths=chrom_depths)
    locus_set.save(args.output_file)
    return 0


def cmd_merge_loci(args):
    """(reference: MergeSVLoci.cpp) — sequential merge of partial
    graphs in argument order, then final noise-edge cleaning."""
    from ..workflow.run import merge_saved_graphs
    merged = merge_saved_graphs(list(args.graph_files))
    if merged is None:
        raise SystemExit("no input graphs")
    merged.finalize()
    merged.save(args.output_file)
    return 0


def main(argv=None):
    ap = argparse.ArgumentParser(description="phase worker commands")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("get-stats")
    p.add_argument("--align-file", dest="align_files", action="append",
                   required=True)
    p.add_argument("--ref", default=None)
    p.add_argument("--per-read-group", action="store_true",
                   help="estimate one distribution per (file, RG) "
                        "instead of pooling per file")
    p.add_argument("--output-file", required=True)
    p.set_defaults(fn=cmd_get_stats)

    p = sub.add_parser("merge-stats")
    p.add_argument("--align-stats-file", dest="stats_files",
                   action="append", required=True)
    p.add_argument("--output-file", required=True)
    p.set_defaults(fn=cmd_merge_stats)

    p = sub.add_parser("summarize-stats")
    p.add_argument("--stats-file", required=True)
    p.add_argument("--output-file", required=True)
    p.set_defaults(fn=cmd_summarize_stats)

    p = sub.add_parser("get-chrom-depth")
    p.add_argument("--align-file", required=True)
    p.add_argument("--ref", default=None)
    p.add_argument("--chrom", dest="chroms", action="append", default=[])
    p.add_argument("--output-file", required=True)
    p.set_defaults(fn=cmd_get_chrom_depth)

    p = sub.add_parser("merge-chrom-depth")
    p.add_argument("--in", dest="in_files", action="append", required=True)
    p.add_argument("--output-file", required=True)
    p.set_defaults(fn=cmd_merge_chrom_depth)

    p = sub.add_parser("estimate-loci")
    p.add_argument("--align-file", dest="align_files", action="append",
                   required=True)
    p.add_argument("--tumor-index", dest="tumor_indices", type=int,
                   action="append", default=[])
    p.add_argument("--align-stats", required=True)
    p.add_argument("--ref", required=True)
    p.add_argument("--region", dest="regions", action="append",
                   required=True)
    p.add_argument("--chrom-depth")
    p.add_argument("--output-file", required=True)
    p.set_defaults(fn=cmd_estimate_loci)

    p = sub.add_parser("merge-loci")
    p.add_argument("--graph-file", dest="graph_files", action="append",
                   required=True)
    p.add_argument("--output-file", required=True)
    p.set_defaults(fn=cmd_merge_loci)

    args = ap.parse_args(argv)
    from ..native_core import load as load_native_core
    load_native_core()
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
