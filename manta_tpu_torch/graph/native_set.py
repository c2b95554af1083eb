"""Native breakend-graph build engine (handle wrapper).

Drives the C++ merge engine in native/manta_core.cpp (mt_graph_*),
which replicates locusgraph.py's SVLocusSet operation-for-operation
(reference semantics: svgraph/SVLocusSet.cpp merge/clean paths). The
phase-1 finder builds through this wrapper; results are exported to
the flat save() format and rehydrated as a Python SVLocusSet for
phase 2 / serialization, so downstream behavior is unchanged.
"""

from __future__ import annotations

import ctypes

import numpy as np

from .._native import get_lib, i64p
from .locusgraph import SVLocusSet, SVLocusSetOptions


class NativeLocusSet:
    """Opaque-handle graph under construction."""

    def __init__(self, opt: SVLocusSetOptions, n_tids: int):
        self.opt = opt
        self.n_tids = n_tids
        self._lib = get_lib()
        self._h = self._lib.mt_graph_new(
            opt.min_merge_edge_count, opt.max_search_count,
            float(opt.max_search_density), n_tids)

    def free(self):
        if self._h is not None:
            self._lib.mt_graph_free(self._h)
            self._h = None

    def __del__(self):
        try:
            self.free()
        except Exception:
            pass

    def insert_read_locus(self, tid1, beg1, end1, ev_beg, ev_end, w1,
                          is_complex, tid2=0, beg2=0, end2=0, w2=0):
        rc = self._lib.mt_graph_insert_read(
            self._h, int(tid1), int(beg1), int(end1), int(ev_beg),
            int(ev_end), int(w1), 1 if is_complex else 0,
            int(tid2), int(beg2), int(end2), int(w2))
        assert rc == 0, f"mt_graph_insert_read failed: {rc}"

    def clean_region(self, tid: int, beg: int, end: int):
        rc = self._lib.mt_graph_clean_region(self._h, tid, beg, end)
        assert rc == 0

    def clean_stride(self, tid: int, start: int, step: int, count: int):
        """count consecutive fixed-step clean_region fires in one native
        call (identical region sequence, one ctypes crossing)."""
        rc = self._lib.mt_graph_clean_stride(self._h, tid, start, step,
                                             count)
        assert rc == 0

    def merge_native(self, other: "NativeLocusSet"):
        rc = self._lib.mt_graph_merge_graph(self._h, other._h)
        assert rc == 0, f"mt_graph_merge_graph failed: {rc}"

    def finalize_native(self):
        """Whole-graph clean + finalization flag, entirely in native
        code (locusgraph.py SVLocusSet.finalize; reference
        SVLocusSet::finalize). Keeps the WGS phase boundary free of
        per-node Python work."""
        self._lib.mt_graph_finalize(self._h)

    def save_npz(self, path: str, chrom_names, chrom_lengths,
                 sample_count: int, sample_counts, is_finalized: bool):
        """Write the graph in the exact SVLocusSet.save() npz layout
        straight from the native export (no Python objectification).
        SVLocusSet.load() of the result is indistinguishable from a
        Python-side save of the same graph: mt_graph_export iterates
        loci/nodes/edges in save()'s order."""
        import json as _json
        locus_sizes, nodes, edges, stats = self.export_flat()
        np.savez_compressed(
            path,
            locus_sizes=locus_sizes,
            nodes=nodes,
            edges=edges,
            meta=np.frombuffer(_json.dumps({
                "chrom_names": list(chrom_names),
                "chrom_lengths": list(chrom_lengths),
                "opt": self.opt.__dict__,
                "is_finalized": bool(is_finalized),
                "total_cleaned": stats["total_cleaned"],
                "highest_search_count": stats["highest_search_count"],
                "highest_search_density": stats["highest_search_density"],
                "is_max_search_count": stats["is_max_search_count"],
                "is_max_search_density": stats["is_max_search_density"],
                "sample_count": sample_count,
                "sample_counts": sample_counts,
            }).encode(), np.uint8),
        )

    def compact(self) -> "NativeLocusSet":
        """Return a compacted copy with empty locus slots dropped and
        loci renumbered, freeing this handle. Phase-1 group graphs must
        cross this boundary before merging: the reference serializes
        each EstimateSVLoci graph (empty loci skipped on save,
        SVLocusSet.cpp:1277-1280) and MergeSVLoci re-loads it, so locus
        numbering entering the merge is always the compacted one."""
        sizes, nodes, edges, stats = self.export_flat()
        out = NativeLocusSet(self.opt, self.n_tids)
        out.load_flat(sizes, nodes, edges, stats["total_cleaned"],
                      stats["highest_search_count"],
                      stats["highest_search_density"],
                      stats["is_max_search_count"],
                      stats["is_max_search_density"])
        self.free()
        return out

    def load_flat(self, locus_sizes, nodes, edges, total_cleaned=0,
                  highest_count=0, highest_density=0.0,
                  is_max_count=False, is_max_density=False):
        """Reconstruct a saved graph into this handle (no merging)."""
        ls = np.ascontiguousarray(locus_sizes, np.int64)
        nd = np.ascontiguousarray(nodes, np.int64)
        ed = np.ascontiguousarray(edges, np.int64)
        rc = self._lib.mt_graph_load(
            self._h, len(ls), ls.ctypes.data_as(i64p),
            nd.ctypes.data_as(i64p), ed.ctypes.data_as(i64p))
        assert rc == 0
        self._lib.mt_graph_set_stats(
            self._h, int(total_cleaned), int(highest_count),
            float(highest_density), 1 if is_max_count else 0,
            1 if is_max_density else 0)

    def export_flat(self):
        """Return (locus_sizes, nodes(n,6), edges(n,2), stats dict) in
        the exact locusgraph.py save() array layout."""
        n_loci = ctypes.c_int64()
        n_nodes = ctypes.c_int64()
        n_edges = ctypes.c_int64()
        self._lib.mt_graph_counts(self._h, ctypes.byref(n_loci),
                                  ctypes.byref(n_nodes),
                                  ctypes.byref(n_edges))
        locus_sizes = np.empty(n_loci.value, np.int64)
        nodes = np.empty((n_nodes.value, 6), np.int64)
        edges = np.empty((n_edges.value, 2), np.int64)
        tc = ctypes.c_int64()
        hc = ctypes.c_int64()
        hd = ctypes.c_double()
        mc = ctypes.c_int32()
        md = ctypes.c_int32()
        rc = self._lib.mt_graph_export(
            self._h, locus_sizes.ctypes.data_as(i64p),
            nodes.ctypes.data_as(i64p), edges.ctypes.data_as(i64p),
            ctypes.byref(tc), ctypes.byref(hc), ctypes.byref(hd),
            ctypes.byref(mc), ctypes.byref(md))
        assert rc == 0
        stats = {
            "total_cleaned": int(tc.value),
            "highest_search_count": int(hc.value),
            "highest_search_density": float(hd.value),
            "is_max_search_count": bool(mc.value),
            "is_max_search_density": bool(md.value),
        }
        return locus_sizes, nodes, edges, stats

    def to_locus_set(self, chrom_names, chrom_lengths,
                     sample_count: int = 1) -> SVLocusSet:
        """Rehydrate a Python SVLocusSet (same structure as a save/load
        round-trip of the host engine)."""
        from .locusgraph import LocusNode, SVLocus
        locus_sizes, nodes, edges, stats = self.export_flat()
        out = SVLocusSet(self.opt, list(chrom_names), list(chrom_lengths),
                         sample_count)
        out.total_cleaned = stats["total_cleaned"]
        out.highest_search_count = stats["highest_search_count"]
        out.highest_search_density = stats["highest_search_density"]
        out.is_max_search_count = stats["is_max_search_count"]
        out.is_max_search_density = stats["is_max_search_density"]
        ni = ei = 0
        for li, size in enumerate(locus_sizes):
            locus = SVLocus(li)
            for _ in range(int(size)):
                tid, beg, end, ev_beg, ev_end, n_edges = nodes[ni]
                ni += 1
                node = LocusNode(int(tid), int(beg), int(end))
                node.ev_beg, node.ev_end = int(ev_beg), int(ev_end)
                for _ in range(int(n_edges)):
                    j, c = edges[ei]
                    ei += 1
                    node.edges[int(j)] = int(c)
                locus.nodes.append(node)
            out.loci.append(locus)
        out.reconstruct_index()
        return out

    @classmethod
    def from_locus_set(cls, s: SVLocusSet, n_tids: int) -> "NativeLocusSet":
        """Build a native handle from a Python SVLocusSet (non-empty
        loci in slot order, matching save())."""
        metas, node_arr, edge_arr = [], [], []
        for locus in s.loci:
            if locus.empty():
                continue
            metas.append(len(locus))
            for node in locus.nodes:
                node_arr.append((node.tid, node.beg, node.end,
                                 node.ev_beg, node.ev_end,
                                 len(node.edges)))
                for j, c in sorted(node.edges.items()):
                    edge_arr.append((j, c))
        out = cls(s.opt, n_tids)
        out.load_flat(
            np.array(metas, np.int64),
            np.array(node_arr, np.int64).reshape(-1, 6),
            np.array(edge_arr, np.int64).reshape(-1, 2),
            s.total_cleaned, s.highest_search_count,
            s.highest_search_density, s.is_max_search_count,
            s.is_max_search_density)
        return out
