"""Core SV data model: genome intervals, breakends, candidates.

Behavioral parity with the reference's GenomeInterval
(svgraph/GenomeInterval.hpp), SVBreakend (manta/SVBreakend.hpp) and
SVCandidate/SVObservation (manta/SVCandidate.hpp).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

# SVEvidenceType (reference: SVBreakend.hpp:35-48)
EV_PAIR, EV_LOCAL_PAIR, EV_CIGAR, EV_SOFTCLIP, EV_SEMIALIGN, EV_SHADOW, \
    EV_SPLIT_ALIGN, EV_UNKNOWN = range(8)
EV_SIZE = 8
EV_LABELS = ["pair", "local_pair", "cigar", "softclip", "semialign", "shadow",
             "split_align", "unknown"]

# SVBreakendState (reference: SVBreakend.hpp:147-155)
BND_UNKNOWN, BND_RIGHT_OPEN, BND_LEFT_OPEN, BND_COMPLEX = range(4)

# SourceOfSVEvidenceInDNAFragment
FRAG_UNKNOWN, FRAG_READ1, FRAG_READ2, FRAG_READ_PAIR = range(4)


@dataclass(slots=True)
class GenomeInterval:
    tid: int = 0
    beg: int = 0   # 0-based inclusive
    end: int = 0   # 0-based exclusive

    def is_intersect(self, o: "GenomeInterval") -> bool:
        return self.tid == o.tid and self.beg < o.end and o.beg < self.end

    def size(self) -> int:
        return max(0, self.end - self.beg)

    def merge(self, o: "GenomeInterval") -> None:
        assert self.tid == o.tid
        self.beg = min(self.beg, o.beg)
        self.end = max(self.end, o.end)

    def contains(self, o: "GenomeInterval") -> bool:
        return self.tid == o.tid and self.beg <= o.beg and self.end >= o.end

    def center_pos(self) -> int:
        """(reference: known_pos_range2.hpp:83)."""
        return self.beg + (max(self.size(), 1) - 1) // 2

    def __lt__(self, o: "GenomeInterval"):
        if self.tid != o.tid:
            return self.tid < o.tid
        if self.beg != o.beg:
            return self.beg < o.beg
        return self.end < o.end

    def copy(self) -> "GenomeInterval":
        return GenomeInterval(self.tid, self.beg, self.end)

    def __repr__(self):
        return f"GenomeInterval(tid={self.tid}:[{self.beg},{self.end}))"


@dataclass(slots=True)
class SVBreakend:
    interval: GenomeInterval = field(default_factory=GenomeInterval)
    state: int = BND_UNKNOWN
    evidence: np.ndarray = field(default_factory=lambda: np.zeros(EV_SIZE, np.int32))

    def add_evidence(self, i: int, count: int = 1):
        self.evidence[i] += count

    def get_pair_count(self) -> int:
        return int(self.evidence[EV_PAIR])

    def get_local_pair_count(self) -> int:
        return int(self.evidence[EV_LOCAL_PAIR])

    def get_any_non_pair_count(self) -> int:
        s = int(self.evidence.sum())
        return s - int(self.evidence[EV_PAIR]) - int(self.evidence[EV_LOCAL_PAIR]) \
            - int(self.evidence[EV_UNKNOWN])

    def get_spanning_count(self) -> int:
        return int(self.evidence[EV_PAIR] + self.evidence[EV_CIGAR]
                   + self.evidence[EV_SPLIT_ALIGN])

    def is_intersect(self, o: "SVBreakend") -> bool:
        if self.state != o.state:
            return False
        if self.state == BND_UNKNOWN:
            return True
        return self.interval.is_intersect(o.interval)

    def merge(self, o: "SVBreakend", expand_region: bool) -> bool:
        if not self.is_intersect(o):
            return False
        if expand_region:
            self.interval.merge(o.interval)
        self.evidence += o.evidence
        return True

    def left_side_of_bkpt_adjustment(self) -> int:
        return -1 if self.state == BND_LEFT_OPEN else 0

    def copy(self) -> "SVBreakend":
        return SVBreakend(self.interval.copy(), self.state, self.evidence.copy())


@dataclass(slots=True)
class SVCandidate:
    bp1: SVBreakend = field(default_factory=SVBreakend)
    bp2: SVBreakend = field(default_factory=SVBreakend)
    is_imprecise: bool = True
    # refined (assembly) fields, populated during candidate refinement:
    insert_seq: str = ""
    contig_seq: str = ""
    candidate_index: int = 0
    assembly_align_index: int = 0
    assembly_segment_index: int = 0
    is_unknown_size_insertion: bool = False
    unknown_size_insertion_left_seq: str = ""
    unknown_size_insertion_right_seq: str = ""
    forward_transcript_strand_read_count: int = 0
    reverse_transcript_strand_read_count: int = 0
    # insertAlignment/CIGAR of contig alignment for small indels
    insert_alignment: tuple | None = None

    def is_intersect(self, o: "SVCandidate") -> bool:
        return (self.bp1.is_intersect(o.bp1) and self.bp2.is_intersect(o.bp2)) or \
               (self.bp1.is_intersect(o.bp2) and self.bp2.is_intersect(o.bp1))

    def is_intersect_1to1(self, o: "SVCandidate") -> bool:
        return self.bp1.is_intersect(o.bp1) and self.bp2.is_intersect(o.bp2)

    def merge(self, o: "SVCandidate", expand_region: bool = True) -> bool:
        """(reference: SVCandidate.hpp:67-86): the 1-to-1 orientation is
        preferred whenever bp1 intersects rhs.bp1, even if the bp2 pair
        does not intersect (in which case no bp2 evidence is merged)."""
        if not self.is_intersect(o):
            return False
        if self.bp1.is_intersect(o.bp1):
            self.bp1.merge(o.bp1, expand_region)
            self.bp2.merge(o.bp2, expand_region)
            self.forward_transcript_strand_read_count += \
                o.forward_transcript_strand_read_count
            self.reverse_transcript_strand_read_count += \
                o.reverse_transcript_strand_read_count
        else:
            self.bp1.merge(o.bp2, expand_region)
            self.bp2.merge(o.bp1, expand_region)
            self.forward_transcript_strand_read_count += \
                o.reverse_transcript_strand_read_count
            self.reverse_transcript_strand_read_count += \
                o.forward_transcript_strand_read_count
        self.is_imprecise = self.is_imprecise or o.is_imprecise
        return True

    def is_forward_strand(self) -> bool:
        return self.forward_transcript_strand_read_count > \
            self.reverse_transcript_strand_read_count

    def is_transcript_strand_known(self) -> bool:
        fw, rv = (self.forward_transcript_strand_read_count,
                  self.reverse_transcript_strand_read_count)
        return (fw + rv >= 2) and (fw == 0 or rv == 0)

    def copy(self) -> "SVCandidate":
        c = SVCandidate(self.bp1.copy(), self.bp2.copy(), self.is_imprecise)
        c.insert_seq = self.insert_seq
        c.candidate_index = self.candidate_index
        c.is_unknown_size_insertion = self.is_unknown_size_insertion
        c.unknown_size_insertion_left_seq = self.unknown_size_insertion_left_seq
        c.unknown_size_insertion_right_seq = self.unknown_size_insertion_right_seq
        c.forward_transcript_strand_read_count = self.forward_transcript_strand_read_count
        c.reverse_transcript_strand_read_count = self.reverse_transcript_strand_read_count
        c.insert_alignment = self.insert_alignment
        return c


def is_complex_sv(cand: SVCandidate) -> bool:
    return cand.bp1.state == BND_COMPLEX and cand.bp2.state == BND_UNKNOWN


def is_simple_breakend(state: int) -> bool:
    return state in (BND_RIGHT_OPEN, BND_LEFT_OPEN)


def is_spanning_sv(cand: SVCandidate) -> bool:
    return is_simple_breakend(cand.bp1.state) and is_simple_breakend(cand.bp2.state)


def is_same_orientation(s1: int, s2: int) -> bool:
    return is_simple_breakend(s1) and is_simple_breakend(s2) and s1 == s2


def _is_innies(is_bp1_first: bool, s1: int, s2: int) -> bool:
    if is_bp1_first:
        return s1 == BND_RIGHT_OPEN and s2 == BND_LEFT_OPEN
    return s2 == BND_RIGHT_OPEN and s1 == BND_LEFT_OPEN


# SV_TYPE (reference: SVCandidateUtil.hpp)
SV_UNKNOWN, SV_INTERTRANSLOC, SV_INVERSION, SV_INDEL, SV_TANDUP, SV_COMPLEX = \
    range(6)
# EXTENDED_SV_TYPE
EXT_UNKNOWN, EXT_INTERTRANSLOC, EXT_INTRATRANSLOC, EXT_INVERSION, EXT_INSERT, \
    EXT_DELETE, EXT_TANDUP = range(7)
EXT_LABELS = ["UNKNOWN", "BND", "BND", "BND", "INS", "DEL", "DUP:TANDEM"]


def get_sv_type(sv: SVCandidate) -> int:
    """(reference: SVCandidateUtil.cpp getSVType)."""
    if sv.bp1.state == BND_UNKNOWN or sv.bp2.state == BND_UNKNOWN:
        return SV_UNKNOWN
    bp1_first = sv.bp1.interval.beg <= sv.bp2.interval.beg
    bp2_first = sv.bp2.interval.beg <= sv.bp1.interval.beg
    if sv.bp1.interval.tid != sv.bp2.interval.tid:
        return SV_INTERTRANSLOC
    if is_same_orientation(sv.bp1.state, sv.bp2.state):
        return SV_INVERSION
    if bp1_first or bp2_first:
        if _is_innies(bp1_first, sv.bp1.state, sv.bp2.state):
            return SV_INDEL
        if _is_innies(not bp1_first, sv.bp1.state, sv.bp2.state):
            return SV_TANDUP
    return SV_UNKNOWN


def get_extended_sv_type(sv: SVCandidate,
                         force_intra_chrom_bnd: bool = False) -> int:
    """(reference: SVCandidateUtil.cpp getExtendedSVType)."""
    t = get_sv_type(sv)
    if t == SV_INTERTRANSLOC:
        return EXT_INTERTRANSLOC
    if force_intra_chrom_bnd:
        return EXT_INTRATRANSLOC
    if t == SV_INVERSION:
        return EXT_INVERSION
    if t == SV_TANDUP:
        return EXT_TANDUP
    if t == SV_INDEL:
        if sv.is_unknown_size_insertion:
            return EXT_INSERT
        bp1_first = sv.bp1.interval.beg <= sv.bp2.interval.beg
        bpa, bpb = (sv.bp1, sv.bp2) if bp1_first else (sv.bp2, sv.bp1)
        delete_size = bpb.interval.beg - bpa.interval.beg
        insert_size = len(sv.insert_seq)
        return EXT_DELETE if delete_size >= insert_size else EXT_INSERT
    return EXT_UNKNOWN


def get_delete_size(sv: SVCandidate) -> int:
    if get_extended_sv_type(sv) != EXT_DELETE:
        return 0
    return abs(sv.bp1.interval.beg - sv.bp2.interval.beg)


def is_cis(sv: SVCandidate) -> bool:
    """(reference: SVCandidateUtil.cpp isCis)."""
    if sv.bp1.interval.tid != sv.bp2.interval.tid:
        return False
    if is_same_orientation(sv.bp1.state, sv.bp2.state):
        return False
    bp1_left = sv.bp1.interval.center_pos() < sv.bp2.interval.center_pos()
    if sv.bp1.state == BND_RIGHT_OPEN and bp1_left:
        return True
    if sv.bp1.state == BND_LEFT_OPEN and not bp1_left:
        return True
    return False


def is_invalid_breakpoint_interval(sv: SVCandidate) -> bool:
    """IMPRECISE case where CIEND is a subset of CIPOS
    (reference: SVCandidateUtil.cpp:41-55)."""
    t = get_extended_sv_type(sv)
    if t in (EXT_INTERTRANSLOC, EXT_INTRATRANSLOC) or not sv.is_imprecise:
        return False
    bp1_first = sv.bp1.interval.beg <= sv.bp2.interval.beg
    bpa, bpb = (sv.bp1, sv.bp2) if bp1_first else (sv.bp2, sv.bp1)
    return bpb.interval.center_pos() <= bpa.interval.center_pos()


def is_sv_below_min_size(sv: SVCandidate, min_size: int) -> bool:
    """(reference: SVCandidateUtil.cpp:27-39)."""
    if sv.bp1.interval.tid != sv.bp2.interval.tid:
        return False
    if is_invalid_breakpoint_interval(sv):
        return True
    bp_size = abs(sv.bp1.interval.center_pos()
                  - sv.bp2.interval.center_pos()) - 1
    insert_size = len(sv.insert_seq)
    return max(bp_size, insert_size) < min_size


@dataclass(slots=True)
class SVObservation(SVCandidate):
    ev_type: int = EV_UNKNOWN
    frag_source: int = FRAG_UNKNOWN

    def is_single_read_source(self) -> bool:
        return self.frag_source in (FRAG_READ1, FRAG_READ2)

    def is_read1_source(self) -> bool:
        return self.frag_source == FRAG_READ1
