"""Breakend graph: loci of interval nodes joined by evidence-count edges.

Behavioral parity with the reference svgraph layer
(reference: src/c++/lib/svgraph/SVLocus.{hpp,cpp},
SVLocusNode.hpp, SVLocusSet.{hpp,cpp}): node merge with
chimera-count max rule, noise-edge cleaning, the two-type mergeable-node
search (shared-edge evidence pooling + signal-node absorption), complexity
aborts (maxSearchCount/maxSearchDensity), and whole-set merge for the
phase-1 reduction.

Persistence uses numpy-array flat serialization instead of
boost::serialization.
"""

from __future__ import annotations

import json
from dataclasses import dataclass

import numpy as np
from sortedcontainers import SortedList

from ..core.svmodel import GenomeInterval


@dataclass
class SVLocusSetOptions:
    """(reference: options/SVLocusSetOptions.hpp:24-54); workflow config
    sets min_merge_edge_observations=3 via configManta.py.ini."""
    observation_weight: int = 1
    min_merge_edge_observations: int = 3
    max_search_count: int = 500
    max_search_density: float = 0.5

    @property
    def min_merge_edge_count(self) -> int:
        return self.observation_weight * self.min_merge_edge_observations


class LocusNode:
    __slots__ = ("tid", "beg", "end", "ev_beg", "ev_end", "edges")

    def __init__(self, tid=0, beg=0, end=0):
        self.tid = tid
        self.beg = beg
        self.end = end
        self.ev_beg = beg
        self.ev_end = end
        self.edges: dict[int, int] = {}  # to-node index -> out-edge count

    def interval(self) -> GenomeInterval:
        return GenomeInterval(self.tid, self.beg, self.end)

    def is_intersect(self, o: "LocusNode") -> bool:
        return self.tid == o.tid and self.beg < o.end and o.beg < self.end

    def intersects_interval(self, tid: int, beg: int, end: int) -> bool:
        return self.tid == tid and self.beg < end and beg < self.end

    def out_count(self) -> int:
        return sum(self.edges.values())

    def is_out_count(self) -> bool:
        return any(c > 0 for c in self.edges.values())

    def size(self) -> int:
        return len(self.edges)

    def merge_edge(self, index: int, count: int):
        self.edges[index] = self.edges.get(index, 0) + count

    def copy_with_offset(self, offset: int) -> "LocusNode":
        n = LocusNode(self.tid, self.beg, self.end)
        n.ev_beg, n.ev_end = self.ev_beg, self.ev_end
        n.edges = {k + offset: v for k, v in self.edges.items()}
        return n


class SVLocus:
    """A connected subgraph (reference: SVLocus.hpp:62)."""

    def __init__(self, index: int = 0):
        self.nodes: list[LocusNode] = []
        self.index = index
        self._observer = None  # parent SVLocusSet or None

    # -- observer notifications keep the parent set's interval index in sync
    def _notify_add(self, node_index: int):
        if self._observer is not None:
            self._observer._index_add(self.index, node_index)

    def _notify_del(self, node_index: int):
        if self._observer is not None:
            self._observer._index_del(self.index, node_index)

    def __len__(self):
        return len(self.nodes)

    def empty(self) -> bool:
        return not self.nodes

    def get_node(self, i: int) -> LocusNode:
        return self.nodes[i]

    def add_node(self, tid: int, beg: int, end: int) -> int:
        assert tid >= 0
        idx = len(self.nodes)
        self.nodes.append(LocusNode(tid, beg, end))
        self._notify_add(idx)
        return idx

    def link_nodes(self, i: int, j: int, from_count: int = 1, to_count: int = 0):
        assert j not in self.nodes[i].edges
        assert i not in self.nodes[j].edges
        self.nodes[i].merge_edge(j, from_count)
        self.nodes[j].merge_edge(i, to_count)

    def set_node_evidence(self, i: int, ev_beg: int, ev_end: int):
        self.nodes[i].ev_beg = ev_beg
        self.nodes[i].ev_end = ev_end

    def total_observation_count(self) -> int:
        return sum(n.out_count() for n in self.nodes)

    def total_edge_count(self) -> int:
        return sum(n.size() for n in self.nodes)

    def self_edge_count(self) -> int:
        return sum(1 for i, n in enumerate(self.nodes) if i in n.edges)

    def get_edge_count(self, i: int, j: int) -> int:
        return self.nodes[i].edges[j]

    def find_connected(self, start: int) -> set[int]:
        out: set[int] = set()
        stack = [start]
        while stack:
            i = stack.pop()
            out.add(i)
            for j in self.nodes[i].edges:
                if j not in out:
                    stack.append(j)
        return out

    def merge_node(self, from_idx: int, to_idx: int):
        """Join from-node into to-node (reference: SVLocus.cpp:45-167),
        including the chimera max-count rule for from<->to edges."""
        assert from_idx != to_idx
        fnode = self.nodes[from_idx]
        tnode = self.nodes[to_idx]
        assert fnode.tid == tnode.tid, "merging nodes on different chromosomes"

        self._notify_del(to_idx)
        tnode.beg = min(tnode.beg, fnode.beg)
        tnode.end = max(tnode.end, fnode.end)
        t_has, f_has = tnode.is_out_count(), fnode.is_out_count()
        if (not t_has) and f_has:
            tnode.ev_beg, tnode.ev_end = fnode.ev_beg, fnode.ev_end
        elif (not f_has) and t_has:
            pass
        else:
            tnode.ev_beg = min(tnode.ev_beg, fnode.ev_beg)
            tnode.ev_end = max(tnode.ev_end, fnode.ev_end)
        self._notify_add(to_idx)

        for edge_idx, edge_count in list(fnode.edges.items()):
            if edge_idx == from_idx:
                # self-edge of from-node becomes self-edge of to-node
                tnode.merge_edge(to_idx, edge_count)
                continue
            is_from_to_edge = edge_idx == to_idx
            merge_count = 0
            if is_from_to_edge:
                # anti-double-count rule: take max of from->to / to->from
                # and add to any existing to->to self edge
                from_count = edge_count
                to_count = tnode.edges.get(from_idx, 0)
                merge_count = tnode.edges.get(to_idx, 0) + max(from_count, to_count)
            tnode.merge_edge(edge_idx, edge_count)
            if is_from_to_edge:
                tnode.edges[to_idx] = merge_count
                tnode.edges[from_idx] = 0
            # update the remote node's return edge
            remote = self.nodes[edge_idx]
            assert from_idx in remote.edges, "missing return edge"
            remote.merge_edge(to_idx, remote.edges[from_idx])

        self._clear_node_edges(from_idx)

    def _clear_node_edges(self, i: int):
        node = self.nodes[i]
        for j in list(node.edges):
            if j == i:
                continue
            del self.nodes[j].edges[i]
        node.edges = {}

    def erase_node(self, i: int):
        """Remove node i, moving the last node into its slot
        (reference: SVLocus.cpp:322-379)."""
        if i >= len(self.nodes):
            return
        self._clear_node_edges(i)
        last = len(self.nodes) - 1
        if last != i:
            lnode = self.nodes[last]
            handle_self = False
            for j in list(lnode.edges):
                if j == last:
                    handle_self = True
                    continue
                remote = self.nodes[j]
                remote.edges[i] = remote.edges.pop(last)
            if handle_self:
                lnode.edges[i] = lnode.edges.pop(last)
            self._notify_del(i)
            self.nodes[i] = lnode
            self._notify_add(i)
        self._notify_del(last)
        self.nodes.pop()

    def erase_nodes(self, idxs: set[int]):
        if not idxs:
            return
        if len(idxs) == len(self.nodes):
            self.clear()
            return
        for i in sorted(idxs, reverse=True):
            self.erase_node(i)

    def clear(self):
        for i in range(len(self.nodes)):
            self._notify_del(i)
        self.nodes = []

    def merge_self_overlap(self):
        """(reference: SVLocus.cpp:443-462)."""
        n = len(self.nodes)
        for i in range(n):
            for j in range(i + 1, n):
                ri = n - (i + 1)
                rj = n - (j + 1)
                if not self.nodes[ri].is_intersect(self.nodes[rj]):
                    continue
                obs = self._observer
                self._observer = None
                self.merge_node(ri, rj)
                self.erase_node(ri)
                self._observer = obs
                break

    def is_noise_node(self, min_merge_count: int, i: int) -> bool:
        node = self.nodes[i]
        for j, c in node.edges.items():
            if c >= min_merge_count:
                return False
            if self.nodes[j].edges[i] >= min_merge_count:
                return False
        return True

    def _clean_node_core(self, min_merge_count: int, i: int,
                         empty_nodes: set[int]) -> int:
        total = 0
        node = self.nodes[i]
        erase_edges = []
        for j in list(node.edges):
            c = node.edges[j]
            if c != 0 and c < min_merge_count:
                total += c
                node.edges[j] = 0
                c = 0
            if c == 0:
                if self.nodes[j].edges[i] == 0:
                    erase_edges.append(j)
                    remote = self.nodes[j]
                    if (not remote.is_out_count()) and remote.size() == 1:
                        empty_nodes.add(j)
        for j in erase_edges:
            del node.edges[j]
            if j != i:
                del self.nodes[j].edges[i]
        if not node.edges and not node.is_out_count():
            empty_nodes.add(i)
        return total

    def clean_node(self, min_merge_count: int, i: int) -> int:
        empty: set[int] = set()
        total = self._clean_node_core(min_merge_count, i, empty)
        self.erase_nodes(empty)
        return total

    def clean(self, min_merge_count: int) -> int:
        empty: set[int] = set()
        total = 0
        for i in range(len(self.nodes)):
            total += self._clean_node_core(min_merge_count, i, empty)
        self.erase_nodes(empty)
        return total

    def check_state(self, check_connected: bool = False):
        n = len(self.nodes)
        if n == 0:
            return
        for i, node in enumerate(self.nodes):
            for j in node.edges:
                assert i in self.nodes[j].edges, \
                    f"edge {i}->{j} lacks return edge"
        if check_connected:
            assert len(self.find_connected(0)) == n, \
                f"locus {self.index} contains unconnected components"

    def copy_from(self, other: "SVLocus"):
        """copyLocus: append other's nodes with index offset."""
        offset = len(self.nodes)
        for node in other.nodes:
            idx = len(self.nodes)
            self.nodes.append(node.copy_with_offset(offset))
            self._notify_add(idx)


class _RegionSum:
    """Peak interval-sum (reference: blt_util/RegionSum.hpp)."""

    def __init__(self):
        self.items: list[tuple[int, int, int]] = []

    def clear(self):
        self.items = []

    def add(self, beg: int, end: int, val: int):
        self.items.append((beg, end, val))

    def max_val(self) -> int:
        if not self.items:
            return 0
        events = []
        for beg, end, val in self.items:
            events.append((beg, val))
            events.append((end, -val))
        events.sort()
        best = cur = 0
        for _, delta in events:
            cur += delta
            best = max(best, cur)
        return best


class SVLocusSet:
    """Whole-genome breakend graph (reference: SVLocusSet.hpp:90)."""

    def __init__(self, opt: SVLocusSetOptions | None = None,
                 chrom_names: list[str] | None = None,
                 chrom_lengths: list[int] | None = None,
                 sample_count: int = 1):
        self.opt = opt or SVLocusSetOptions()
        self.chrom_names = chrom_names or []
        self.chrom_lengths = chrom_lengths or []
        self.loci: list[SVLocus] = []
        self.empty_loci: set[int] = set()
        # index: sorted by (interval, locus, node); entries are
        # (tid, beg, end, locus_idx, node_idx)
        self._inodes: SortedList = SortedList()
        self._max_region_size: dict[int, int] = {}
        self.is_finalized = False
        self.total_cleaned = 0
        self.highest_search_count = 0
        self.highest_search_density = 0.0
        self.is_max_search_count = False
        self.is_max_search_density = False
        self.sample_count = sample_count
        # per-sample evidence-count stats (plain dicts; see
        # finder.SampleCounts) used for phase-2 noise rates
        self.sample_counts: list[dict] = [{} for _ in range(sample_count)]
        self._merge_regions = [_RegionSum() for _ in range(4)]

    # ------------------------------------------------------------------
    # index bookkeeping (flyweight observer equivalent)

    def _entry(self, locus_idx: int, node_idx: int):
        n = self.loci[locus_idx].nodes[node_idx]
        return (n.tid, n.beg, n.end, locus_idx, node_idx)

    def _index_add(self, locus_idx: int, node_idx: int):
        self._inodes.add(self._entry(locus_idx, node_idx))
        n = self.loci[locus_idx].nodes[node_idx]
        size = n.end - n.beg
        if size > self._max_region_size.get(n.tid, 0):
            self._max_region_size[n.tid] = size

    def _index_del(self, locus_idx: int, node_idx: int):
        self._inodes.remove(self._entry(locus_idx, node_idx))

    # ------------------------------------------------------------------

    @property
    def min_merge_edge_count(self) -> int:
        return self.opt.min_merge_edge_count

    def get_node(self, addr: tuple[int, int]) -> LocusNode:
        return self.loci[addr[0]].nodes[addr[1]]

    def non_empty_size(self) -> int:
        return sum(1 for l in self.loci if not l.empty())

    def total_node_count(self) -> int:
        return sum(len(l) for l in self.loci)

    def total_edge_count(self) -> int:
        return sum(l.total_edge_count() for l in self.loci)

    def self_edge_count(self) -> int:
        return sum(l.self_edge_count() for l in self.loci)

    def total_observation_count(self) -> int:
        return sum(l.total_observation_count() for l in self.loci)

    def is_overlap_allowed(self) -> bool:
        return not self.is_finalized

    def is_noise_node(self, addr: tuple[int, int]) -> bool:
        return self.loci[addr[0]].is_noise_node(self.min_merge_edge_count, addr[1])

    def insert_locus(self, locus: SVLocus) -> int:
        if self.empty_loci:
            idx = min(self.empty_loci)
            assert self.loci[idx].empty()
            self.empty_loci.discard(idx)
        else:
            idx = len(self.loci)
            self.loci.append(SVLocus(idx))
        target = self.loci[idx]
        target.index = idx
        target._observer = self
        target.copy_from(locus)
        return idx

    def clear_locus(self, idx: int):
        self.loci[idx].clear()
        self.empty_loci.add(idx)

    # ------------------------------------------------------------------
    # intersection search

    def _intersecting_core(self, query_addr: tuple[int, int],
                           search: SortedList, filter_locus: int,
                           is_test_usability: bool = False):
        """getIntersectingNodeAddressesCore (SVLocusSet.cpp:351-462).
        Returns (addresses:set, usable:bool)."""
        out: set[tuple[int, int]] = set()
        qnode = self.get_node(query_addr)
        q_entry = (qnode.tid, qnode.beg, qnode.end, query_addr[0], query_addr[1])
        start = search.bisect_left(q_entry)
        max_region = self._max_region_size.get(qnode.tid, 0)
        usable = True
        search_count = 0

        # forward: begin positions >= query begin
        n = len(search)
        for k in range(start, n):
            if is_test_usability:
                search_count += 1
                if search_count > self.opt.max_search_count:
                    usable = False
                    self.is_max_search_count = True
                    break
            tid, beg, end, li, ni = search[k]
            if li == filter_locus:
                continue
            if not qnode.intersects_interval(tid, beg, end):
                break
            out.add((li, ni))

        # backward
        for k in range(start - 1, -1, -1):
            if is_test_usability:
                if not usable:
                    break
                search_count += 1
                if search_count > self.opt.max_search_count:
                    usable = False
                    self.is_max_search_count = True
                    break
            tid, beg, end, li, ni = search[k]
            if li == filter_locus:
                continue
            if not qnode.intersects_interval(tid, beg, end):
                if not self.is_overlap_allowed():
                    break
                if qnode.tid != tid:
                    break
                if beg + max_region < qnode.beg:
                    break
                continue
            out.add((li, ni))

        if not is_test_usability:
            return out, True

        self.highest_search_count = max(self.highest_search_count, search_count)
        search_size = qnode.end - max(0, qnode.beg - max_region)
        assert search_size >= 0
        if search_size != 0:
            search_size = max(search_size, 40)
            density = search_count / search_size
            self.highest_search_density = max(self.highest_search_density, density)
            if density > self.opt.max_search_density:
                usable = False
                self.is_max_search_density = True
        return out, usable

    def get_intersecting(self, locus_idx: int, node_idx: int,
                         is_test_usability: bool = False):
        return self._intersecting_core(
            (locus_idx, node_idx), self._inodes, locus_idx, is_test_usability)

    def _get_intersecting_edges(self, query_locus: int, query_remote_node: int,
                                remote_to_local: dict, remote_search: SortedList):
        """getIntersectingEdges (SVLocusSet.cpp:464-494): returns list of
        ((locus, local_node), remote_node)."""
        hits, _ = self._intersecting_core(
            (query_locus, query_remote_node), remote_search, query_locus)
        edges = []
        for addr in hits:
            for local_node in remote_to_local[addr]:
                edges.append(((addr[0], local_node), addr[1]))
        return edges

    def _get_intersecting_signal(self, filter_locus: int,
                                 target_addr: tuple[int, int],
                                 signal_set: set, noise_test_targets: set):
        """getIntersectingSignalNodeAddresses (SVLocusSet.cpp:496-534).
        Returns is_intersecting_noise_target."""
        hits, _ = self._intersecting_core(target_addr, self._inodes, filter_locus)
        intersects_target = False
        for addr in hits:
            if not self.is_noise_node(addr):
                signal_set.add(addr)
            elif addr in noise_test_targets:
                intersects_target = True
        return intersects_target

    def _get_mergeable(self, query_locus: int, query_node: int,
                       is_query_duplicated: bool) -> set[tuple[int, int]]:
        """getMergeableIntersectingNodeAddresses
        (SVLocusSet.cpp:536-957)."""
        query_addr = (query_locus, query_node)
        qnode = self.get_node(query_addr)
        out: set[tuple[int, int]] = set()

        intersecting, _ = self.get_intersecting(query_locus, query_node)

        # build remote-connection search structure
        remote_search = SortedList()
        remote_to_local: dict[tuple[int, int], list[int]] = {}
        for addr in intersecting:
            inode = self.get_node(addr)
            for j in inode.edges:
                conn = (addr[0], j)
                if conn not in remote_to_local:
                    remote_to_local[conn] = []
                    cn = self.get_node(conn)
                    remote_search.add((cn.tid, cn.beg, cn.end, conn[0], conn[1]))
                remote_to_local[conn].append(addr[1])

        signal_nodes: set[tuple[int, int]] = set()
        for addr in intersecting:
            if not self.is_noise_node(addr):
                signal_nodes.add(addr)

        for remote_node_idx, _edge_count in self.loci[query_locus] \
                .nodes[query_node].edges.items():
            edges = self._get_intersecting_edges(
                query_locus, remote_node_idx, remote_to_local, remote_search)
            edge_count = len(edges)
            if not is_query_duplicated:
                edge_count += 1

            is_region_check = edge_count > 2
            if is_region_check:
                for rs in self._merge_regions:
                    rs.clear()
            out_ev = in_ev = 0

            def add_edge_evidence(locus: SVLocus, from_node: int, to_node: int):
                nonlocal out_ev, in_ev
                inc = locus.nodes[to_node].edges[from_node]
                outc = locus.nodes[from_node].edges[to_node]
                if is_region_check:
                    ln = locus.nodes[from_node]
                    rn = locus.nodes[to_node]
                    self._merge_regions[0].add(ln.beg, ln.end, outc)
                    self._merge_regions[1].add(ln.beg, ln.end, inc)
                    self._merge_regions[2].add(rn.beg, rn.end, inc)
                    self._merge_regions[3].add(rn.beg, rn.end, outc)
                else:
                    out_ev += outc
                    in_ev += inc

            for (laddr, rnode) in edges:
                add_edge_evidence(self.loci[laddr[0]], laddr[1], rnode)
            if not is_query_duplicated:
                add_edge_evidence(self.loci[query_locus], query_node,
                                  remote_node_idx)

            if is_region_check:
                out_ev = min(self._merge_regions[0].max_val(),
                             self._merge_regions[3].max_val())
                in_ev = min(self._merge_regions[1].max_val(),
                            self._merge_regions[2].max_val())

            if out_ev < self.min_merge_edge_count and \
                    in_ev < self.min_merge_edge_count:
                continue

            # type1 nodes
            for (laddr, _rn) in edges:
                out.add(laddr)

            remote_addrs = {(laddr[0], rn) for (laddr, rn) in edges}
            intersect_remotes = False
            intersect_remotes |= self._get_intersecting_signal(
                query_locus, query_addr, signal_nodes, remote_addrs)
            for (laddr, _rn) in edges:
                intersect_remotes |= self._get_intersecting_signal(
                    query_locus, laddr, signal_nodes, remote_addrs)
            if intersect_remotes:
                for raddr in remote_addrs:
                    out.add(raddr)
                    self._get_intersecting_signal(
                        query_locus, raddr, signal_nodes, remote_addrs)

            # type2 nodes
            out.update(signal_nodes)
        return out

    # ------------------------------------------------------------------
    # merge

    def merge_locus(self, input_locus: SVLocus):
        """merge(SVLocus) (SVLocusSet.cpp:96-320)."""
        assert not self.is_finalized
        assert not input_locus.empty()
        input_locus.check_state(True)

        start_locus_idx = self.insert_locus(input_locus)
        head_locus_idx = start_locus_idx
        is_duplicated = False
        is_abort = False

        start_locus = self.loci[start_locus_idx]
        # order nodes by interval; identical intervals keep only the first
        # node (std::map insert semantics in the reference)
        interval_map: dict[tuple, int] = {}
        for i, nd in enumerate(start_locus.nodes):
            interval_map.setdefault((nd.tid, nd.beg, nd.end), i)
        node_order = [interval_map[k] for k in sorted(interval_map)]

        is_test_usability = len(input_locus) <= 2
        for node_idx in node_order:
            _, usable = self.get_intersecting(
                start_locus_idx, node_idx, is_test_usability)
            if not usable:
                is_abort = True
                break

        for node_idx in node_order:
            if is_abort:
                break
            mergeable = self._get_mergeable(start_locus_idx, node_idx,
                                            is_duplicated)
            if not mergeable:
                continue
            if is_duplicated and len(mergeable) < 2:
                continue

            while not all(a[0] == head_locus_idx for a in mergeable):
                head_locus_idx = self._move_to_lowest_locus(
                    mergeable, start_locus_idx, head_locus_idx)
                if not is_duplicated:
                    is_duplicated = head_locus_idx != start_locus_idx
                mergeable = self._get_mergeable(start_locus_idx, node_idx,
                                                is_duplicated)
                assert mergeable

            # find superset node of the start node, in ascending
            # ADDRESS order — the reference iterates
            # std::set<NodeAddressType>, i.e. (locus, node-index)
            # pairs (SVLocusSet.cpp:270-288)
            snode = self.loci[start_locus_idx].nodes[node_idx]
            superset_addr = None
            for addr in sorted(mergeable):
                assert addr[0] == head_locus_idx
                cand = self.get_node(addr)
                if cand.beg <= snode.beg and cand.end >= snode.end:
                    superset_addr = addr
                    break
            assert superset_addr is not None, "no superset node found"

            # Merge every mergeable node into the running target, in
            # descending ADDRESS order (the reference's
            # BOOST_REVERSE_FOREACH over the address set,
            # SVLocusSet.cpp:292-310). Each erase moves the locus's
            # last node into the freed slot; descending order keeps
            # remaining addresses below the erased index, so the remap
            # table below stays a no-op safety net.
            target_addr = superset_addr
            remap: dict[int, int] = {}

            def resolve(a):
                i = a[1]
                while i in remap:
                    i = remap[i]
                return (a[0], i)

            for addr in sorted(mergeable, reverse=True):
                if addr == superset_addr:
                    continue
                a = resolve(addr)
                t = resolve(target_addr)
                if a == t:
                    continue
                if a < t:
                    a, t = t, a
                assert a[0] == t[0]
                locus = self.loci[a[0]]
                last = len(locus.nodes) - 1
                locus.merge_node(a[1], t[1])
                locus.erase_node(a[1])
                if last != a[1]:
                    remap[last] = a[1]
                target_addr = t

        if is_abort or is_duplicated:
            self.clear_locus(start_locus_idx)

    def _move_to_lowest_locus(self, mergeable: set, start_locus_idx: int,
                              head_locus_idx: int) -> int:
        """moveIntersectingNodesToLowestLocusIndex
        (SVLocusSet.cpp:969-1000)."""
        input_head = head_locus_idx
        new_head = min(a[0] for a in mergeable)
        clear_source = start_locus_idx != input_head
        self._combine_loci(input_head, new_head, clear_source)
        for addr in sorted(mergeable):
            self._combine_loci(addr[0], new_head, True)
        return new_head

    def _combine_loci(self, from_idx: int, to_idx: int, clear_source: bool = True):
        if from_idx == to_idx or from_idx >= len(self.loci):
            return
        from_locus = self.loci[from_idx]
        if from_locus.empty():
            return
        self.loci[to_idx].copy_from(from_locus)
        if clear_source:
            self.clear_locus(from_idx)

    def merge_set(self, other: "SVLocusSet"):
        """merge(SVLocusSet) (SVLocusSet.cpp:322-349)."""
        assert self.min_merge_edge_count == other.min_merge_edge_count
        for locus in other.loci:
            if locus.empty():
                continue
            self.merge_locus(locus)
        self.total_cleaned += other.total_cleaned
        self.highest_search_count = max(self.highest_search_count,
                                        other.highest_search_count)
        self.is_max_search_count |= other.is_max_search_count
        self.highest_search_density = max(self.highest_search_density,
                                          other.highest_search_density)
        self.is_max_search_density |= other.is_max_search_density

    # ------------------------------------------------------------------
    # cleaning / finalization

    def clean(self):
        for locus in self.loci:
            if locus.empty():
                continue
            self.total_cleaned += locus.clean(self.min_merge_edge_count)
            if locus.empty():
                self.empty_loci.add(locus.index)

    def clean_region(self, tid: int, beg: int, end: int):
        """cleanRegion (SVLocusSet.cpp:1083-1110)."""
        hits = self.get_region_intersect(tid, beg, end)
        for addr in sorted(hits, reverse=True):
            locus = self.loci[addr[0]]
            if locus.empty():
                continue
            self.total_cleaned += locus.clean_node(
                self.min_merge_edge_count, addr[1])
            if locus.empty():
                self.empty_loci.add(locus.index)

    def get_region_intersect(self, tid: int, beg: int, end: int):
        probe = SVLocus()
        probe.add_node(tid, beg, end)
        idx = self.insert_locus(probe)
        hits, _ = self.get_intersecting(idx, 0)
        self.clear_locus(idx)
        return hits

    def finalize(self):
        self.clean()
        self.is_finalized = True

    def check_state(self, check_overlap: bool = False,
                    check_connected: bool = False):
        total_nodes = 0
        for li, locus in enumerate(self.loci):
            locus.check_state(check_connected)
            total_nodes += len(locus)
            if len(locus) == 0:
                assert li in self.empty_loci, \
                    f"empty locus {li} not in empty index"
            for ni in range(len(locus)):
                assert self._entry(li, ni) in self._inodes, \
                    f"node {li}:{ni} missing from index"
        assert total_nodes == len(self._inodes), "node count mismatch"
        if not check_overlap:
            return
        filter_noise = self.is_overlap_allowed()
        last = None
        for (tid, beg, end, li, ni) in self._inodes:
            if filter_noise and self.is_noise_node((li, ni)):
                continue
            assert beg < end
            if last is not None and last[0] == tid:
                assert last[2] <= beg, \
                    f"overlapping nodes {last} vs {(tid, beg, end, li, ni)}"
            last = (tid, beg, end)

    # ------------------------------------------------------------------
    # serialization (flat arrays + JSON meta)

    def save(self, path: str):
        metas = []
        node_arr = []
        edge_arr = []
        for locus in self.loci:
            if locus.empty():
                continue
            metas.append(len(locus))
            for node in locus.nodes:
                node_arr.append((node.tid, node.beg, node.end,
                                 node.ev_beg, node.ev_end, len(node.edges)))
                for j, c in sorted(node.edges.items()):
                    edge_arr.append((j, c))
        np.savez_compressed(
            path,
            locus_sizes=np.array(metas, np.int64),
            nodes=np.array(node_arr, np.int64).reshape(-1, 6),
            edges=np.array(edge_arr, np.int64).reshape(-1, 2),
            meta=np.frombuffer(json.dumps({
                "chrom_names": self.chrom_names,
                "chrom_lengths": self.chrom_lengths,
                "opt": self.opt.__dict__,
                "is_finalized": self.is_finalized,
                "total_cleaned": self.total_cleaned,
                "highest_search_count": self.highest_search_count,
                "highest_search_density": self.highest_search_density,
                "is_max_search_count": self.is_max_search_count,
                "is_max_search_density": self.is_max_search_density,
                "sample_count": self.sample_count,
                "sample_counts": self.sample_counts,
            }).encode(), np.uint8),
        )

    @classmethod
    def load(cls, path: str, skip_index: bool = False,
             check: bool = False) -> "SVLocusSet":
        """check=True additionally runs the full structural invariant
        sweep after indexing (debug aid; the reference validates graph
        state only under -DDEBUG_SVL, SVLocusSet.hpp checkState — the
        production load path must stay O(nodes) with small constants
        because it gates phase-2 start at WGS scale)."""
        data = np.load(path)
        meta = json.loads(data["meta"].tobytes().decode())
        opt = SVLocusSetOptions(**meta["opt"])
        out = cls(opt, meta["chrom_names"], meta["chrom_lengths"],
                  meta["sample_count"])
        out.is_finalized = meta["is_finalized"]
        out.total_cleaned = meta["total_cleaned"]
        out.highest_search_count = meta["highest_search_count"]
        out.highest_search_density = meta["highest_search_density"]
        out.is_max_search_count = meta["is_max_search_count"]
        out.is_max_search_density = meta["is_max_search_density"]
        out.sample_counts = meta.get("sample_counts",
                                     [{} for _ in range(out.sample_count)])
        from itertools import islice
        # .tolist() converts to Python ints at C speed; per-element
        # int() in the hot loop costs ~3x at WGS node counts
        nodes_l = data["nodes"].tolist()
        edges_it = iter(data["edges"].tolist())
        ni = 0
        for li, size in enumerate(data["locus_sizes"].tolist()):
            locus = SVLocus(li)
            locus._observer = None
            append = locus.nodes.append
            for _ in range(size):
                tid, beg, end, ev_beg, ev_end, n_edges = nodes_l[ni]
                ni += 1
                node = LocusNode(tid, beg, end)
                node.ev_beg = ev_beg
                node.ev_end = ev_end
                if n_edges:
                    node.edges = {j: c
                                  for j, c in islice(edges_it, n_edges)}
                append(node)
            out.loci.append(locus)
        if not skip_index:
            out.reconstruct_index()
            if check:
                out.check_state(True, True)
        return out

    def reconstruct_index(self):
        # bulk build: collect entries then one SortedList construction
        # (O(n log n) sort with C constants, vs n incremental .add()s)
        entries = []
        max_rs = {}
        self.empty_loci = set()
        for li, locus in enumerate(self.loci):
            locus.index = li
            locus._observer = self
            for ni, n in enumerate(locus.nodes):
                entries.append((n.tid, n.beg, n.end, li, ni))
                size = n.end - n.beg
                if size > max_rs.get(n.tid, 0):
                    max_rs[n.tid] = size
            if locus.empty():
                self.empty_loci.add(li)
        self._inodes = SortedList(entries)
        self._max_region_size = max_rs
