"""Phase-2 low-resolution candidate generation: graph edge -> SV candidates.

Behavioral parity with the reference SVFinder
(reference: src/c++/lib/applications/GenerateSVCandidates/SVFinder.cpp):
bidirectional-edge filtering, per-node read gathering into a
qname-keyed fragment bank with submapped gathering for somatic normals,
fragment->candidate clustering via breakend intersection, overlap
consolidation, and noise-significance filters (binomial signal tests at
alpha=0.03 spanning / 0.005 assembly with (s+10)/(n+1000) noise rates).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..core.binomial import binomial_gte_n_success_pval
from ..core.depthsweep import DepthSweep
from ..core.readfilter import has_sa_tag, is_read_unmapped_or_filtered_core
from ..core.svmodel import (
    EV_SIZE,
    EV_LOCAL_PAIR,
    EV_PAIR,
    EV_SPLIT_ALIGN,
    BND_COMPLEX,
    BND_UNKNOWN,
    GenomeInterval,
    SVCandidate,
    SVObservation,
    get_sv_type,
    SV_INDEL,
    is_complex_sv,
    is_cis,
    is_spanning_sv,
    is_sv_below_min_size,
)
from ..io.bam import FLAG_READ2, ReadBatch, open_alignment_reader
from ..scan.scanner import SVScanner


def get_spanning_noise_rate(counts: dict) -> float:
    """(reference: SVFinder.cpp:39-51)."""
    anom_or_split = counts.get("anom", 0) + counts.get("split", 0) \
        - counts.get("anom_and_split", 0)
    return (anom_or_split + 10.0) / (counts.get("total", 0) + 1000.0)


def get_assembly_noise_rate(counts: dict) -> float:
    """(reference: SVFinder.cpp:53-62)."""
    return (counts.get("assm", 0) + 10.0) / (counts.get("total", 0) + 1000.0)


@dataclass
class ReadRef:
    """Reference to one read in a fetched batch."""
    batch: ReadBatch
    index: int
    is_node1: bool = True      # sourced from graph edge node1
    is_submapped: bool = False
    read_index: float = 0.0    # position among mapped(/submapped) scan reads

    @property
    def is_set(self) -> bool:
        return True


@dataclass
class Fragment:
    """(reference: SVCandidateSetSequenceFragment)."""
    read1: ReadRef | None = None
    read2: ReadRef | None = None
    read1_supplemental: list[ReadRef] = field(default_factory=list)
    read2_supplemental: list[ReadRef] = field(default_factory=list)
    sv_link: list[tuple[int, int]] = field(default_factory=list)

    def is_anchored(self) -> bool:
        return any(r is not None and not r.is_submapped
                   for r in (self.read1, self.read2))

    def check_read_pair(self) -> bool:
        r1, r2 = self.read1, self.read2
        if r1 is None or r2 is None:
            return True
        b1, i1 = r1.batch, r1.index
        b2, i2 = r2.batch, r2.index
        if b1.refid[i1] != b2.next_refid[i2]:
            return False
        if b2.refid[i2] != b1.next_refid[i1]:
            return False
        if b1.pos[i1] != b2.next_pos[i2]:
            return False
        if b2.pos[i2] != b1.next_pos[i1]:
            return False
        if bool(b1.flag[i1] & 0x10) != bool(b2.flag[i2] & 0x20):
            return False
        if bool(b2.flag[i2] & 0x10) != bool(b1.flag[i1] & 0x20):
            return False
        return True


class SampleGroup:
    """(reference: SVCandidateSetSequenceFragmentSampleGroup)."""

    MAX_DATA_SIZE = 4000

    def __init__(self):
        self.fragments: list[Fragment] = []
        self._index: dict[str, int] = {}
        self.is_full = False
        self.mapped_read_index = 0.0
        self.submapped_read_index = 0.0

    def increment(self, is_submapped: bool):
        if is_submapped:
            self.submapped_read_index += 1
        else:
            self.mapped_read_index += 1

    def add(self, ref: ReadRef, is_expect_repeat: bool,
            read_index: float | None = None):
        b, i = ref.batch, ref.index
        qname = b.name_bytes(i)
        if qname in self._index:
            frag = self.fragments[self._index[qname]]
        else:
            if self.is_full:
                return
            self._index[qname] = len(self.fragments)
            frag = Fragment()
            self.fragments.append(frag)
        is_read2 = bool(b.flag[i] & FLAG_READ2)
        sa = b.get_tag(i, b"SA") is not None
        flag = int(b.flag[i])
        nss = bool(flag & 0x800) or (bool(flag & 0x100) and sa)
        if read_index is not None:
            ref.read_index = read_index
        else:
            ref.read_index = self.submapped_read_index if ref.is_submapped \
                else self.mapped_read_index
        if is_read2:
            if nss:
                frag.read2_supplemental.append(ref)
                return
            target = "read2"
        else:
            if nss:
                frag.read1_supplemental.append(ref)
                return
            target = "read1"
        if getattr(frag, target) is not None:
            if is_expect_repeat:
                return
            raise RuntimeError(f"Unexpected alignment name collision: {qname}")
        setattr(frag, target, ref)


class FatSVCandidate(SVCandidate):
    def __init__(self, copy_from: SVCandidate, bam_count: int):
        super().__init__(bp1=copy_from.bp1.copy(), bp2=copy_from.bp2.copy(),
                         is_imprecise=copy_from.is_imprecise)
        self.forward_transcript_strand_read_count = \
            copy_from.forward_transcript_strand_read_count
        self.reverse_transcript_strand_read_count = \
            copy_from.reverse_transcript_strand_read_count
        self.bp1_evidence_index = [[[] for _ in range(bam_count)]
                                   for _ in range(EV_SIZE)]
        self.bp2_evidence_index = [[[] for _ in range(bam_count)]
                                   for _ in range(EV_SIZE)]
        self.is_single_junction_filter = False

    def merge_fat(self, rhs: "FatSVCandidate", expand_region: bool = True) -> bool:
        if not self.merge(rhs, expand_region):
            return False
        for ev in range(EV_SIZE):
            for bi in range(len(self.bp1_evidence_index[ev])):
                self.bp1_evidence_index[ev][bi].extend(
                    rhs.bp1_evidence_index[ev][bi])
                self.bp2_evidence_index[ev][bi].extend(
                    rhs.bp2_evidence_index[ev][bi])
        return True


def is_breakpoint_significant(alpha: float, noise_rate: float,
                              signal: list[float]) -> bool:
    """(reference: SVFinder.cpp isBreakPointSignificant:807-940)."""
    n = len(signal)
    if n < 2:
        return False
    signal = sorted(signal)
    window = min(4, n - 1)
    min_bg = None
    for i in range(n - window):
        bg = signal[i + window] - signal[i]
        if min_bg is None or bg < min_bg:
            min_bg = bg
    if window > min_bg:
        window = int(min_bg)
    # P(X >= window | trials=min_bg, p=noise) <= alpha ?
    n_trials = int(min_bg)
    if n_trials > 0:
        pval = binomial_gte_n_success_pval(noise_rate, window, n_trials)
    else:
        pval = 1.0 if window == 0 else 0.0
    return pval <= alpha


def _is_spanning_signal_significant(noise_rate: float, sv: FatSVCandidate,
                                    bam_index: int) -> bool:
    ev1: list[float] = []
    ev2: list[float] = []
    for ev in range(EV_SIZE):
        ev1.extend(sv.bp1_evidence_index[ev][bam_index])
        ev2.extend(sv.bp2_evidence_index[ev][bam_index])
    alpha = 0.03
    return is_breakpoint_significant(alpha, noise_rate, ev1) or \
        is_breakpoint_significant(alpha, noise_rate, ev2)


def _is_complex_signal_significant(noise_rate: float, sv: FatSVCandidate,
                                   bam_index: int) -> bool:
    ev: list[float] = []
    for t in range(EV_SIZE):
        ev.extend(sv.bp1_evidence_index[t][bam_index])
    return is_breakpoint_significant(0.005, noise_rate, ev)


def _is_candidate_count_sufficient(sv: SVCandidate) -> bool:
    for i in range(EV_SIZE):
        if i in (EV_PAIR, EV_LOCAL_PAIR):
            continue
        if sv.bp1.evidence[i] >= 2:
            return True
    return False


@dataclass
class SVFinderStats:
    edge_filter: int = 0
    semi_mapped_filter: int = 0
    complex_low_count_filter: int = 0
    complex_low_signal_filter: int = 0
    unmatched_read_pair_filter: int = 0


class SVFinder:
    def __init__(self, scanner: SVScanner, bam_paths: list[str],
                 is_tumor: list[bool], sample_counts: list[dict], fasta,
                 chrom_depths: dict | None = None,
                 max_depth_factor: float = 12.0,
                 skip_evidence_signal_filter: bool = False,
                 is_rna: bool = False):
        self.scanner = scanner
        self.readers = [open_alignment_reader(p, fasta) for p in bam_paths]
        self.is_tumor = list(is_tumor)
        self.is_somatic = any(is_tumor)
        self.fasta = fasta
        self.chrom_depths = chrom_depths
        self.max_depth_factor = max_depth_factor
        self.skip_evidence_signal_filter = skip_evidence_signal_filter
        self.is_rna = is_rna
        self.spanning_noise_rate = [get_spanning_noise_rate(c)
                                    for c in sample_counts]
        self.assembly_noise_rate = [get_assembly_noise_rate(c)
                                    for c in sample_counts]
        self.stats = SVFinderStats()

    # ------------------------------------------------------------------

    def _get_node_ref(self, node):
        """Search interval = node interval merged with evidence range,
        ref fetched with 100b pad (reference: SVFinder.cpp:156-170)."""
        tid = node.tid
        beg = min(node.beg, node.ev_beg)
        end = max(node.end, node.ev_end)
        chrom = self.scanner.chrom_names[tid]
        ref_beg = max(0, beg - 100)
        refseq = self.fasta.fetch_arr(chrom, ref_beg, end + 100)
        return (tid, beg, end), refseq, ref_beg

    def _add_sv_node_data(self, locus, local_idx, remote_idx, search,
                          refseq, ref_off, is_node1, groups, intervals_seen):
        """(reference: SVFinder.cpp addSVNodeData:189-275 +
        addSVNodeRead:108-154)."""
        local_node = locus.nodes[local_idx]
        remote_node = locus.nodes[remote_idx]
        tid, beg, end = search
        is_expect_repeat = any(
            si[0] == tid and si[1] < end and beg < si[2]
            for si in intervals_seen)
        intervals_seen.append((tid, beg, end))
        if not is_expect_repeat:
            is_expect_repeat = local_node.tid == remote_node.tid

        max_depth = None
        chrom = self.scanner.chrom_names[tid]
        if self.chrom_depths is not None and chrom in self.chrom_depths:
            max_depth = self.chrom_depths[chrom] * self.max_depth_factor
        sweep = DepthSweep() if max_depth is not None else None

        min_mapq = self.scanner.opt.min_mapq
        min_tier2 = self.scanner.opt.min_tier2_mapq
        gi_local = GenomeInterval(local_node.tid, local_node.beg,
                                  local_node.end)
        gi_remote = GenomeInterval(remote_node.tid, remote_node.beg,
                                   remote_node.end)

        for bam_index, reader in enumerate(self.readers):
            is_tumor = self.is_tumor[bam_index]
            gather_submapped = self.is_somatic and not is_tumor
            group = groups[bam_index]
            batch = reader.fetch(tid, beg, end)
            if batch.n == 0:
                continue
            sa = has_sa_tag(batch)
            core_bad = is_read_unmapped_or_filtered_core(batch, sa)
            order = np.argsort(batch.pos, kind="stable")
            pos_s = batch.pos[order].astype(np.int64)
            # vectorized equivalent of the scalar in-order gating: window,
            # core filters, pileup max-depth gate (checked after the
            # read's own increment), then the two-tier mapq gates
            alive = ~core_bad[order] & (pos_s < end)
            if sweep is not None:
                lens_s = (batch.seq_off[1:] - batch.seq_off[:-1])[order]
                contrib = alive if not is_tumor \
                    else np.zeros(batch.n, bool)
                depths = sweep.start_depth(pos_s, lens_s, contrib)
                alive &= (pos_s < beg) | (depths <= max_depth)
            mapq_s = batch.mapq[order]
            alive &= mapq_s >= min_tier2
            submapped_s = mapq_s < min_mapq
            if not gather_submapped:
                alive &= ~submapped_s
            # running read-scan counters; each add records the counter
            # value as of its own increment (reference: addSVNodeRead)
            sub_pass = alive & submapped_s
            map_pass = alive & ~submapped_s
            sub_idx = np.cumsum(sub_pass) + group.submapped_read_index
            map_idx = np.cumsum(map_pass) + group.mapped_read_index
            cand = []
            if alive.any():
                ev_masks = self.scanner.sv_evidence_mask(
                    batch, bam_index, refseq, ref_off, sa=sa)
                cand = np.flatnonzero(alive & ev_masks[order]).tolist()
            for k in cand:
                i = int(order[k])
                is_submapped = bool(submapped_s[k])
                if not group.is_full and \
                        len(group.fragments) >= SampleGroup.MAX_DATA_SIZE:
                    group.is_full = True
                # check the read's loci intersect local and remote nodes
                loci_data = self.scanner.get_read_loci_data(
                    batch, i, bam_index, refseq, ref_off)
                for (bp1, bp2, w1, w2, _ev, is_complex) in loci_data:
                    if bp2 is not None:
                        local_bp, remote_bp = bp1, bp2
                        if w1 == 0:
                            local_bp, remote_bp = bp2, bp1
                        if not remote_bp.interval.is_intersect(gi_remote):
                            continue
                        if not local_bp.interval.is_intersect(gi_local):
                            continue
                    else:
                        if not bp1.interval.is_intersect(gi_remote):
                            continue
                        if not bp1.interval.is_intersect(gi_local):
                            continue
                    group.add(ReadRef(batch, i, is_node1, is_submapped),
                              is_expect_repeat,
                              read_index=float(sub_idx[k] if is_submapped
                                               else map_idx[k]))
                    break
            group.submapped_read_index += float(sub_pass.sum())
            group.mapped_read_index += float(map_pass.sum())

    # ------------------------------------------------------------------

    def _update_evidence_index(self, fragment: Fragment, obs: SVObservation,
                               sv: FatSVCandidate, bam_index: int):
        """(reference: SVFinder.cpp updateEvidenceIndex:440-500)."""
        def add(bp_index_list, rref):
            if rref is not None and not rref.is_submapped:
                bp_index_list[obs.ev_type][bam_index].append(rref.read_index)

        if obs.is_single_read_source():
            cand_read = fragment.read1 if obs.is_read1_source() else fragment.read2
            if obs.ev_type != EV_SPLIT_ALIGN:
                add(sv.bp1_evidence_index, cand_read)
            else:
                is_1to1 = sv.is_intersect_1to1(obs)
                read_bp = sv.bp1_evidence_index if is_1to1 else sv.bp2_evidence_index
                read_supp_bp = sv.bp2_evidence_index if is_1to1 else sv.bp1_evidence_index
                read = cand_read
                read_supp = fragment.read1_supplemental if obs.is_read1_source() \
                    else fragment.read2_supplemental
                if read is not None and not read.is_submapped:
                    read_bp[obs.ev_type][bam_index].append(read.read_index)
                if len(read_supp) == 1:
                    supp = read_supp[0]
                    if not supp.is_submapped:
                        read_supp_bp[obs.ev_type][bam_index].append(
                            supp.read_index)
        else:
            is_1to1 = sv.is_intersect_1to1(obs)
            bp1_read = fragment.read1 if is_1to1 else fragment.read2
            bp2_read = fragment.read2 if is_1to1 else fragment.read1
            if bp1_read is not None and not bp1_read.is_submapped:
                sv.bp1_evidence_index[obs.ev_type][bam_index].append(
                    bp1_read.read_index)
            # NB the reference gates this on bp1Read being set and
            # bp2Read's submapped flag, pushing bp2Read.readIndex which
            # defaults to 0.0 when bp2Read is unset
            if bp1_read is not None and \
                    (bp2_read is None or not bp2_read.is_submapped):
                sv.bp2_evidence_index[obs.ev_type][bam_index].append(
                    0.0 if bp2_read is None else bp2_read.read_index)

    def _assign_observations(self, node1, node2, read_candidates,
                             is_expand, fragment, svs, bam_index):
        """(reference: SVFinder.cpp
        assignFragmentObservationsToSVCandidates:502-576)."""
        bam_count = len(self.readers)
        gi1 = GenomeInterval(node1.tid, node1.beg, node1.end)
        gi2 = GenomeInterval(node2.tid, node2.beg, node2.end)
        for cand in read_candidates:
            if self.is_rna:
                min_len = self.scanner.opt.min_rna_cis_length if is_cis(cand) \
                    else self.scanner.opt.min_rna_length
                if is_sv_below_min_size(cand, min_len):
                    continue
            if is_complex_sv(cand):
                if not cand.bp1.interval.is_intersect(gi1):
                    continue
                if not cand.bp1.interval.is_intersect(gi2):
                    continue
            else:
                isect = cand.bp1.interval.is_intersect(gi1) and \
                    cand.bp2.interval.is_intersect(gi2)
                swap_isect = cand.bp1.interval.is_intersect(gi2) and \
                    cand.bp2.interval.is_intersect(gi1)
                if not (isect or swap_isect):
                    continue
            is_spanning = is_spanning_sv(cand)
            matched = False
            for sv_index, sv in enumerate(svs):
                if sv.is_intersect(cand):
                    if is_spanning:
                        fragment.sv_link.append((sv_index, cand.ev_type))
                    self._update_evidence_index(fragment, cand, sv, bam_index)
                    sv.merge_fat(FatSVCandidate(cand, bam_count), is_expand)
                    matched = True
                    break
            if is_expand and not matched:
                new_index = len(svs)
                fat = FatSVCandidate(cand, bam_count)
                fat.candidate_index = new_index
                svs.append(fat)
                if is_spanning:
                    fragment.sv_link.append((new_index, cand.ev_type))
                self._update_evidence_index(fragment, cand, fat, bam_index)

    def _process_fragment(self, node1, node2, refs, fragment, bam_index,
                          is_expand, svs):
        """(reference: SVFinder.cpp processSequenceFragment:596-676)."""
        local = fragment.read1
        remote = fragment.read2
        fragment.sv_link = []
        if local is None:
            local, remote = remote, local
        if local is None:
            return
        if not fragment.check_read_pair():
            self.stats.unmatched_read_pair_filter += 1
            return
        node1_ref, node1_off, node2_ref, node2_off = refs
        local_ref, local_off = (node1_ref, node1_off) if local.is_node1 \
            else (node2_ref, node2_off)
        remote_arg = None
        remote_ref_arg = None
        if remote is not None:
            remote_arg = (remote.batch, remote.index)
            remote_ref_arg = (node1_ref, node1_off) if remote.is_node1 \
                else (node2_ref, node2_off)
        cands, _ = self.scanner.get_read_breakends(
            local.batch, local.index, bam_index, local_ref, local_off,
            remote=remote_arg, remote_refseq=remote_ref_arg)

        # merge nearby INDEL bp pairs into complex regions
        # (reference: SVFinder.cpp:624-641)
        for cand in cands:
            if get_sv_type(cand) != SV_INDEL:
                continue
            r1 = (cand.bp1.interval.beg - 30, cand.bp1.interval.end + 30)
            r2 = (cand.bp2.interval.beg - 30, cand.bp2.interval.end + 30)
            if not (r2[1] > r1[0] and r2[0] < r1[1]):
                continue
            cand.bp1.state = BND_COMPLEX
            cand.bp2.state = BND_UNKNOWN
            cand.bp1.interval.beg = min(cand.bp1.interval.beg,
                                        cand.bp2.interval.beg)
            cand.bp1.interval.end = max(cand.bp1.interval.end,
                                        cand.bp2.interval.end)

        # ensure both breakends of split candidates carry split evidence
        for cand in cands:
            if cand.ev_type != EV_SPLIT_ALIGN:
                continue
            if cand.bp1.evidence[EV_SPLIT_ALIGN] == 0:
                cand.bp1.add_evidence(EV_SPLIT_ALIGN)
            if cand.bp2.evidence[EV_SPLIT_ALIGN] == 0:
                cand.bp2.add_evidence(EV_SPLIT_ALIGN)

        self._assign_observations(node1, node2, cands, is_expand, fragment,
                                  svs, bam_index)

    # ------------------------------------------------------------------

    def _consolidate_overlap(self, groups, svs: list[FatSVCandidate]):
        """(reference: SVFinder.cpp consolidateOverlap:339-438)."""
        move_index: dict[int, int] = {}
        deleted: set[int] = set()
        inner_shift: list[int] = []
        n = len(svs)
        for outer in range(1, n):
            prev_shift = 0 if outer <= 1 else inner_shift[outer - 2]
            inner_shift.append(prev_shift + (1 if (outer - 1) in deleted else 0))
            for inner in range(outer):
                if inner in deleted:
                    continue
                if svs[inner].is_intersect(svs[outer]):
                    svs[inner].merge_fat(svs[outer])
                    move_index[outer] = inner - inner_shift[inner]
                    deleted.add(outer)
                    break
        if deleted:
            kept = [sv for i, sv in enumerate(svs) if i not in deleted]
            # assign move map for surviving indices
            shift = 0
            for i in range(n):
                if i in deleted:
                    shift += 1
                else:
                    if shift:
                        move_index[i] = i - shift
            svs[:] = kept
            for i, sv in enumerate(svs):
                sv.candidate_index = i
        if move_index:
            for group in groups:
                for fragment in group.fragments:
                    fragment.sv_link = [
                        (move_index.get(idx, idx), ev)
                        for (idx, ev) in fragment.sv_link]

    def _filter_candidates(self, svs: list[FatSVCandidate]):
        """(reference: SVFinder.cpp filterCandidates:829-975)."""
        bam_count = len(self.readers)
        index = 0
        while index < len(svs):
            sv = svs[index]
            is_filter = False
            if sv.bp1.get_local_pair_count() == sv.bp1.evidence.sum() and \
                    sv.bp2.get_local_pair_count() == sv.bp2.evidence.sum():
                self.stats.semi_mapped_filter += 1
                is_filter = True
            elif is_spanning_sv(sv):
                if not self.skip_evidence_signal_filter:
                    if not any(_is_spanning_signal_significant(
                            self.spanning_noise_rate[bi], sv, bi)
                            for bi in range(bam_count)):
                        sv.is_single_junction_filter = True
            elif is_complex_sv(sv):
                if not _is_candidate_count_sufficient(sv):
                    self.stats.complex_low_count_filter += 1
                    is_filter = True
                elif not any(_is_complex_signal_significant(
                        self.assembly_noise_rate[bi], sv, bi)
                        for bi in range(bam_count)):
                    self.stats.complex_low_signal_filter += 1
                    is_filter = True
            else:
                raise AssertionError("Unknown SV candidate type")
            if is_filter:
                if index + 1 < len(svs):
                    svs[index] = svs[-1]
                svs.pop()
            else:
                index += 1

    # ------------------------------------------------------------------

    def find_candidate_sv(self, locus_set, locus_index: int,
                          node_index1: int, node_index2: int):
        """(reference: SVFinder.cpp findCandidateSVImpl:998-1105).
        Returns (svs, groups)."""
        locus = locus_set.loci[locus_index]
        min_count = locus_set.min_merge_edge_count
        if locus.nodes[node_index1].edges[node_index2] < min_count or \
                locus.nodes[node_index2].edges[node_index1] < min_count:
            self.stats.edge_filter += 1
            return [], None

        groups = [SampleGroup() for _ in self.readers]
        intervals_seen: list[tuple[int, int, int]] = []

        search1, ref1, off1 = self._get_node_ref(locus.nodes[node_index1])
        self._add_sv_node_data(locus, node_index1, node_index2, search1,
                               ref1, off1, True, groups, intervals_seen)
        if node_index1 != node_index2:
            search2, ref2, off2 = self._get_node_ref(locus.nodes[node_index2])
            self._add_sv_node_data(locus, node_index2, node_index1, search2,
                                   ref2, off2, False, groups, intervals_seen)
        else:
            ref2, off2 = ref1, off1

        node1 = locus.nodes[node_index1]
        node2 = locus.nodes[node_index2]
        refs = (ref1, off1, ref2, off2)
        svs: list[FatSVCandidate] = []
        for bam_index, group in enumerate(groups):
            for fragment in group.fragments:
                if not fragment.is_anchored():
                    continue
                self._process_fragment(node1, node2, refs, fragment,
                                       bam_index, True, svs)
        if self.is_somatic:
            for bam_index, group in enumerate(groups):
                if self.is_tumor[bam_index]:
                    continue
                for fragment in group.fragments:
                    if fragment.is_anchored():
                        continue
                    self._process_fragment(node1, node2, refs, fragment,
                                           bam_index, False, svs)

        self._consolidate_overlap(groups, svs)
        self._filter_candidates(svs)
        return svs, groups


def iterate_edges(locus_set, graph_node_max_edge_count: int = 10):
    """Yield (locus_index, node_index1, node_index2) for every graph edge
    once, in locus/node order, skipping edges whose two nodes both exceed
    the node edge-count cap (reference: EdgeRetrieverBin semantics over a
    single bin)."""
    for li, locus in enumerate(locus_set.loci):
        if locus.empty():
            continue
        for n1 in range(len(locus.nodes)):
            node1 = locus.nodes[n1]
            filter1 = graph_node_max_edge_count > 0 and \
                node1.size() > graph_node_max_edge_count
            for n2 in sorted(node1.edges):
                if n2 < n1:
                    continue
                if filter1:
                    node2 = locus.nodes[n2]
                    if node2.size() > graph_node_max_edge_count:
                        continue
                yield (li, n1, n2)
