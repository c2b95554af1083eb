"""Breakend-graph inspection CLI: check / dump / summarize.

Equivalents of the reference's graph utility binaries
(reference: applications/CheckSVLoci/CheckSVLoci.cpp,
DumpSVLoci/DumpSVLoci.cpp — documented at
docs/developerGuide/breakendGraph.md:23-36 — and
SummarizeSVLoci/SummarizeSVLoci.cpp) over the native .npz graph
serialization.
"""

from __future__ import annotations

import argparse
import sys

from ..graph.locusgraph import SVLocusSet


def cmd_check(args):
    """(reference: CheckSVLoci.cpp — load + checkState invariants)."""
    locus_set = SVLocusSet.load(args.graph_file)
    locus_set.check_state(check_overlap=True, check_connected=True)
    print(f"graph OK: {locus_set.non_empty_size()} loci, "
          f"{locus_set.total_node_count()} nodes")
    return 0


def _dump_locus(locus_set, li, out):
    locus = locus_set.loci[li]
    out.write(f"LOCUS BEGIN INDEX {li}\n")
    for ni, node in enumerate(locus.nodes):
        chrom = locus_set.chrom_names[node.tid] \
            if node.tid < len(locus_set.chrom_names) else str(node.tid)
        out.write(f"NodeIndex: {ni} LocusNode: GenomeInterval: "
                  f"{chrom}:[{node.beg},{node.end}) "
                  f"evidence: [{node.ev_beg},{node.ev_end})\n")
        for to, count in sorted(node.edges.items()):
            out.write(f"\tEdgeTo: {to} out_count: {count}\n")
    out.write(f"LOCUS END INDEX {li}\n")


def cmd_dump(args):
    """(reference: DumpSVLoci.cpp — whole graph, one locus, or region)."""
    locus_set = SVLocusSet.load(args.graph_file)
    out = sys.stdout
    if args.locus_index is not None:
        _dump_locus(locus_set, args.locus_index, out)
        return 0
    if args.region:
        chrom, _, span = args.region.partition(":")
        tid = locus_set.chrom_names.index(chrom)
        beg, _, end = span.partition("-")
        beg, end = int(beg) - 1, int(end)
        hit = set()
        for li, locus in enumerate(locus_set.loci):
            for node in locus.nodes:
                if node.intersects_interval(tid, beg, end):
                    hit.add(li)
                    break
        for li in sorted(hit):
            _dump_locus(locus_set, li, out)
        return 0
    for li, locus in enumerate(locus_set.loci):
        if locus.nodes:
            _dump_locus(locus_set, li, out)
    return 0


def cmd_summarize(args):
    """(reference: SummarizeSVLoci.cpp --global -> dumpStats tsv)."""
    from ..workflow.stats import write_graph_stats
    locus_set = SVLocusSet.load(args.graph_file)
    write_graph_stats(locus_set, args.output_file)
    return 0


def main(argv=None):
    ap = argparse.ArgumentParser(description="SV locus graph tools")
    sub = ap.add_subparsers(dest="cmd", required=True)
    p = sub.add_parser("check")
    p.add_argument("--graph-file", required=True)
    p.set_defaults(fn=cmd_check)
    p = sub.add_parser("dump")
    p.add_argument("--graph-file", required=True)
    p.add_argument("--locus-index", type=int)
    p.add_argument("--region")
    p.set_defaults(fn=cmd_dump)
    p = sub.add_parser("summarize")
    p.add_argument("--graph-file", required=True)
    p.add_argument("--output-file", required=True)
    p.set_defaults(fn=cmd_summarize)
    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
