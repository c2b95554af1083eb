"""WGS-scale breakend-graph soak: build, denoise, merge, serialize a
synthetic whole-genome-scale graph and check memory + determinism.

The reference caps whole-genome graph memory below 2 GB including
indexes for every genome observed, worst case a high-depth FFPE
tumor/normal (reference: docs/methods/primary/methods.tex:113), and
merges segment graphs sequentially with complexity aborts
(SVLocusSet.cpp:322, SVLocusSetOptions.hpp:50-54). This soak drives the
native engine at that scale:

- 24 chromosomes x ~130 Mb, anomalous-pair loci sampled at WGS-like
  evidence density (~1 signal locus per 3 kb plus noise singletons),
  target on the order of 1e6 loci before denoising;
- rolling denoise fan during the build (the production path's
  clean_stride);
- a repeat-build determinism check at full scale (catches any
  iteration-order nondeterminism in the native engine's hash
  containers; host-count independence of the segment-merge chain is
  covered by tests/test_distributed.py);
- a chromosome-split merge chain exercising merge(set) at scale;
- flat-format serialization round-trip;
- peak RSS asserted < 2 GB.

Usage: python -m manta_tpu_torch.tools.soak_graph [--loci 1000000]

Twin of benchmarks/soak_graph.py on the port's graph.native_set and
graph.locusgraph: the same builder, fingerprints and JSON line. Host
only: the graph engine is the native core, and the soak touches no
device. Its peak RSS is ru_maxrss, as the original's, which Linux
carries over from the process that started this one (fork, then exec):
start it from a small process, such as a shell, not from a large one.
"""

from __future__ import annotations

import argparse
import json
import resource
import sys
import time

import numpy as np

from .. import native_core


def build(loci: int, n_chrom: int, chrom_len: int, seed: int,
          which: str = "all"):
    """Insert synthetic read loci in genome order; 'even'/'odd' build
    the interleaved halves for the merge-determinism check."""
    from ..graph.locusgraph import SVLocusSetOptions
    from ..graph.native_set import NativeLocusSet

    opt = SVLocusSetOptions(observation_weight=3)
    g = NativeLocusSet(opt, n_chrom)
    rng = np.random.default_rng(seed)
    per_chrom = loci // n_chrom
    step = chrom_len // per_chrom
    k = 0
    for tid in range(n_chrom):
        # deterministic per-chromosome layout; ~2/3 of loci are paired
        # (spanning) observations repeated >= min-merge times so they
        # survive denoising, ~1/3 singleton noise that must be cleaned
        pos = (np.arange(per_chrom, dtype=np.int64) * step
               + rng.integers(0, step // 2, per_chrom))
        kinds = rng.integers(0, 3, per_chrom)
        mates = pos + rng.integers(2000, 200_000, per_chrom)
        for i in range(per_chrom):
            k += 1
            if which == "even" and k % 2 == 0:
                continue
            if which == "odd" and k % 2 == 1:
                continue
            p = int(pos[i])
            if kinds[i] < 2:
                m = int(min(mates[i], chrom_len - 200))
                for _ in range(3):  # >= minMergeEdgeObservations
                    g.insert_read_locus(tid, p, p + 150, p, p + 150, 3,
                                        False, tid, m, m + 150, 3)
            else:
                g.insert_read_locus(tid, p, p + 150, p, p + 150, 3, True)
        # rolling denoise fan over the chromosome (production path)
        g.clean_stride(tid, 0, 1000, chrom_len // 1000)
    return g


def fingerprint(g, n_chrom: int):
    locus_sizes, nodes, edges = g.export_flat()[:3]
    import hashlib
    h = hashlib.sha256()
    for a in (locus_sizes, nodes, edges):
        h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()[:16], len(locus_sizes), len(nodes), len(edges)


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="Whole-genome breakend-graph soak: build, merge, "
                    "serialize, peak RSS under 2 GB. Host only: it touches "
                    "no device")
    ap.add_argument("--loci", type=int, default=1_000_000)
    ap.add_argument("--chroms", type=int, default=24)
    ap.add_argument("--chrom-len", type=int, default=130_000_000)
    args = ap.parse_args(argv)
    native_core.load()

    t0 = time.perf_counter()
    g = build(args.loci, args.chroms, args.chrom_len, seed=11)
    t_build = time.perf_counter() - t0
    fp1, n_loci, n_nodes, n_edges = fingerprint(g, args.chroms)

    # repeat-build determinism at scale
    g_rep = build(args.loci, args.chroms, args.chrom_len, seed=11)
    fp2 = fingerprint(g_rep, args.chroms)[0]
    g_rep.free()

    # merge-chain soak: per-chromosome-half graphs merged in order
    # (exercises merge(set) against a large accumulated graph)
    t0 = time.perf_counter()
    ga = build(args.loci, args.chroms, args.chrom_len, seed=11,
               which="odd")
    gb = build(args.loci, args.chroms, args.chrom_len, seed=11,
               which="even")
    ga.merge_native(gb)
    gb.free()
    t_merge = time.perf_counter() - t0
    merged_nodes = fingerprint(ga, args.chroms)[2]
    ga.free()

    # serialization round-trip
    from ..graph.locusgraph import SVLocusSetOptions
    from ..graph.native_set import NativeLocusSet
    locus_sizes, nodes, edges = g.export_flat()[:3]
    g2 = NativeLocusSet(SVLocusSetOptions(observation_weight=3),
                        args.chroms)
    g2.load_flat(locus_sizes, nodes, edges)
    fp3 = fingerprint(g2, args.chroms)[0]
    g2.free()
    g.free()

    peak_rss_gb = resource.getrusage(
        resource.RUSAGE_SELF).ru_maxrss / 1e6  # linux: KB
    ok_mem = peak_rss_gb < 2.0
    out = {
        "metric": "graph_soak",
        "loci": n_loci, "nodes": n_nodes, "edge_slots": n_edges,
        "merged_nodes": merged_nodes,
        "build_s": round(t_build, 2), "split_merge_s": round(t_merge, 2),
        "build_deterministic": fp1 == fp2,
        "serialize_roundtrip": fp1 == fp3,
        "peak_rss_gb": round(peak_rss_gb, 3),
        "rss_under_2gb": ok_mem,
    }
    print(json.dumps(out), flush=True)
    if not (fp1 == fp2 and fp1 == fp3 and ok_mem):
        sys.exit(1)
    return out


if __name__ == "__main__":
    main()
