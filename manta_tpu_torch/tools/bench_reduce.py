"""Profile the phase-boundary reduce: part save -> merge -> finalize ->
save -> phase-2 load.

The serial merge/finalize tail grows with the reads and so
Amdahl-sinks the 20-core WGS projection (the reference's
MergeSVLoci + workflow boundary costs seconds at WGS scale, not
minutes — MergeSVLoci.cpp:48-62, mantaWorkflow.py:349-437). This
benchmark builds a WGS-scale graph with the soak builder, splits it
into P per-chromosome-slice parts (the shape _estimate_sv_loci_parallel
produces), and times every stage of the current boundary separately so
the optimization targets are measured, not guessed:

  part_save     per-part to_locus_set + SVLocusSet.save (paid in forked
                workers today — parallel, but on the critical path of
                the last-finishing worker)
  merge         merge_saved_graphs (np.load + native merge chain)
  finalize      Python SVLocusSet.clean over all loci
  master_save   SVLocusSet.save of the merged graph
  p2_load       SVLocusSet.load incl. reconstruct_index + check_state
                (what run.py pays before phase 2 starts)

Usage: python -m manta_tpu_torch.tools.bench_reduce [--loci 500000]
    [--chroms 24] [--work-dir W]
Prints one JSON line with per-stage seconds.

Twin of benchmarks/bench_reduce.py on the port's soak builder
(tools.soak_graph), workflow.run.merge_saved_graphs_native and
graph.locusgraph.SVLocusSet: the same stages and JSON line. Its part
and master graphs go to a temporary directory under ``--work-dir``
(default: the system's), removed at the end. Host only: it touches no
device.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time

from .. import native_core
from .soak_graph import build


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="Profile the phase-boundary reduce, stage by stage. "
                    "Host only: it touches no device")
    ap.add_argument("--loci", type=int, default=500_000)
    ap.add_argument("--chroms", type=int, default=24)
    ap.add_argument("--chrom-len", type=int, default=130_000_000)
    ap.add_argument("--work-dir", default=None,
                    help="where the temporary graph files go")
    args = ap.parse_args(argv)
    native_core.load()

    from ..workflow.run import merge_saved_graphs_native

    names = [f"chr{i + 1}" for i in range(args.chroms)]
    lengths = [args.chrom_len] * args.chroms

    # one part per chromosome: the per-group graphs the parallel
    # phase-1 path saves (each part covers a disjoint genome slice)
    t0 = time.perf_counter()
    parts = []
    for tid in range(args.chroms):
        g = build(args.loci // args.chroms, 1, args.chrom_len,
                  seed=100 + tid)
        parts.append(g)
    t_build = time.perf_counter() - t0

    tmp = tempfile.mkdtemp(prefix="reduce_", dir=args.work_dir)
    paths = []
    t0 = time.perf_counter()
    n_nodes_total = 0
    for tid, g in enumerate(parts):
        p = os.path.join(tmp, f"part_{tid:04d}.npz")
        n_nodes_total += len(g.export_flat()[1])
        g.save_npz(p, names, lengths, 1, [{}], is_finalized=False)
        paths.append(p)
        g.free()
    t_part_save = time.perf_counter() - t0

    t0 = time.perf_counter()
    nat, meta = merge_saved_graphs_native(paths)
    t_merge = time.perf_counter() - t0

    t0 = time.perf_counter()
    nat.finalize_native()
    t_finalize = time.perf_counter() - t0

    master = os.path.join(tmp, "svLocusGraph.npz")
    t0 = time.perf_counter()
    nat.save_npz(master, meta["chrom_names"], meta["chrom_lengths"],
                 meta["sample_count"], meta["sample_counts"],
                 is_finalized=True)
    nat.free()
    t_master_save = time.perf_counter() - t0

    from ..graph.locusgraph import SVLocusSet
    t0 = time.perf_counter()
    reloaded = SVLocusSet.load(master)
    t_p2_load = time.perf_counter() - t0

    out = {
        "metric": "reduce_profile",
        "loci": args.loci,
        "parts": args.chroms,
        "nodes": int(reloaded.total_node_count()),
        "nodes_presplit": int(n_nodes_total),
        "build_s": round(t_build, 2),
        "part_save_s": round(t_part_save, 2),
        "merge_s": round(t_merge, 2),
        "finalize_s": round(t_finalize, 2),
        "master_save_s": round(t_master_save, 2),
        "p2_load_s": round(t_p2_load, 2),
        "serial_tail_s": round(t_merge + t_finalize + t_master_save
                               + t_p2_load, 2),
    }
    print(json.dumps(out), flush=True)
    for p in paths + [master]:
        os.remove(p)
    os.rmdir(tmp)
    return out


if __name__ == "__main__":
    main()
