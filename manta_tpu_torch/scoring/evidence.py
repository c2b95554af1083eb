"""Scoring evidence structures and fragment evidence gathering.

Behavioral parity with the reference scoring data model and evidence
search (reference: GenerateSVCandidates/SVEvidence.hpp, SVScorerShared,
SVScorerPair.cpp, SVScorePair{Processor,RefProcessor,AltProcessor},
SVScorerSplit.cpp + SplitReadAlignment.cpp, manta/SVScoreInfo.cpp).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np

from ..core import cigar as cg
from ..core.svmodel import SVCandidate
from ..candidates.assembler_reads import revcomp

MAX_QSCORE = 70


class QscoreSnp:
    """(reference: blt_util/qscore_snp.cpp): basecall error probability
    mixed with a SNP prior."""

    def __init__(self, snp_prob: float):
        comp_snp3 = 1.0 - snp_prob / 3.0
        q = np.arange(MAX_QSCORE + 1, dtype=np.float64)
        qerr = np.power(10.0, -q / 10.0)
        self.p = qerr * comp_snp3 + (1.0 - qerr) * snp_prob
        with np.errstate(divide="ignore"):
            # q=0/1 entries are -inf but unused (quals clamped >= 2)
            self.ln_comp_e = np.log1p(-self.p)
            self.ln_e = np.log(self.p)
        self._lut256 = None

    def lut256(self):
        """256-entry float32 match/mismatch ln-likelihood LUTs indexed
        by raw qual byte (clamped to [2, MAX_QSCORE])."""
        if self._lut256 is None:
            qi = np.clip(np.arange(256), 2, MAX_QSCORE)
            lut_m = self.ln_comp_e[qi].astype(np.float32)
            lut_x = (self.ln_e[qi] + math.log(1 / 3.0)).astype(np.float32)
            self._lut256 = (np.ascontiguousarray(lut_m),
                            np.ascontiguousarray(lut_x))
        return self._lut256


# NOTE: the per-fragment evidence state (reference: SVEvidence.hpp
# SVFragmentEvidence) lives in the columnar FragmentBank (fragbank.py);
# its consumers run as native/vectorized passes over whole tracks.


@dataclass(slots=True)
class SampleAlleleInfo:
    """(reference: SVSampleAlleleInfo)."""
    spanning_pair_count: int = 0
    confident_spanning_pair_count: int = 0
    confident_semi_mapped_spanning_pair_count: int = 0
    split_read_count: int = 0
    split_read_evidence: float = 0.0
    split_read_mapq: float = 0.0
    confident_split_read_count: int = 0
    confident_split_read_and_pair_count_ref_bp1: int = 0
    confident_split_read_and_pair_count_ref_bp2: int = 0


@dataclass(slots=True)
class SampleInfo:
    alt: SampleAlleleInfo = field(default_factory=SampleAlleleInfo)
    ref: SampleAlleleInfo = field(default_factory=SampleAlleleInfo)


@dataclass(slots=True)
class ScoreInfo:
    """(reference: SVScoreInfo)."""
    samples: list[SampleInfo] = field(default_factory=list)
    bp1_max_depth: int = 0
    bp2_max_depth: int = 0
    bp1_mq0_frac: float = 0.0
    bp2_mq0_frac: float = 0.0


# ---------------------------------------------------------------------------
# split-read scoring

@dataclass(slots=True)
class SRAlignmentInfo:
    align_pos: int = 0
    left_size: int = 0
    hom_size: int = 0
    right_size: int = 0
    left_mismatches: int = 0
    hom_mismatches: int = 0
    right_mismatches: int = 0
    align_score: int = 0
    align_ln_lhood: float = 0.0
    is_evidence: bool = False
    is_tier2_evidence: bool = False
    evidence: float = 0.0


def _is_evidence_check(a: SRAlignmentInfo, min_flank: int) -> bool:
    if a.left_size < min_flank or a.right_size < min_flank:
        return False
    if a.left_mismatches / a.left_size >= 0.25:
        return False
    if a.right_mismatches / a.right_size >= 0.25:
        return False
    size = float(a.left_size + a.right_size)
    if a.align_score / size < 0.9:
        return False
    return True


def _set_evidence(a: SRAlignmentInfo):
    a.is_evidence = _is_evidence_check(a, 16)
    a.is_tier2_evidence = _is_evidence_check(a, 8)
    a.evidence = 0.0
    if not (a.is_evidence or a.is_tier2_evidence):
        return
    size = float(a.left_size + a.right_size)
    a.evidence = 2 * min(a.left_size, a.right_size) / size


class _SplitScanScratch:
    """Reusable ctypes state for the native split scan (per-call
    pointer casts otherwise dominate the wrapper)."""

    def __init__(self):
        import ctypes
        from .._native import get_lib, u8p
        self.lib = get_lib()
        self.u8p = u8p
        self.fp = ctypes.POINTER(ctypes.c_float)
        self.out_lnl = ctypes.c_float()
        self.out_pos = ctypes.c_int32()
        self.p_lnl = ctypes.byref(self.out_lnl)
        self.p_pos = ctypes.byref(self.out_pos)
        self.ln_random = ctypes.c_float(-math.log(4.0))
        self._lut_id = None
        self._p_lut_m = None
        self._p_lut_x = None

    def luts_for(self, qconv):
        lut_m, lut_x = qconv.lut256()
        if id(qconv) != self._lut_id:
            self._lut_id = id(qconv)
            self._keep_qconv = qconv
            self._p_lut_m = lut_m.ctypes.data_as(self.fp)
            self._p_lut_x = lut_x.ctypes.data_as(self.fp)
        return self._p_lut_m, self._p_lut_x


_SPLIT_SCRATCH = None


def _native_split_scan(query, qual, target, nq, nt, bp_beg, bp_end,
                       flank_score_size, qconv):
    global _SPLIT_SCRATCH
    sc = _SPLIT_SCRATCH
    if sc is None:
        sc = _SPLIT_SCRATCH = _SplitScanScratch()
    if not query.flags["C_CONTIGUOUS"]:
        query = np.ascontiguousarray(query)
    if not qual.flags["C_CONTIGUOUS"]:
        qual = np.ascontiguousarray(qual)
    if not target.flags["C_CONTIGUOUS"]:
        target = np.ascontiguousarray(target)
    p_lut_m, p_lut_x = sc.luts_for(qconv)
    u8p = sc.u8p
    rc = sc.lib.mt_split_read_scan(
        query.ctypes.data_as(u8p), nq, qual.ctypes.data_as(u8p),
        target.ctypes.data_as(u8p), nt,
        bp_beg, bp_end, flank_score_size,
        p_lut_m, p_lut_x, sc.ln_random, sc.p_lnl, sc.p_pos)
    assert rc == 0, f"mt_split_read_scan failed: {rc}"
    return float(sc.out_lnl.value), int(sc.out_pos.value)


def split_read_scan_multi(flank_score_size: int, batch, read_idx,
                          qconv: QscoreSnp, targets: list,
                          bp_ranges: list):
    """Score selected batch reads against several junction targets in
    one native call; returns (lnl, pos) arrays of shape (n, t)."""
    import ctypes
    from .._native import get_lib, i32p, i64p, u8p
    lib = get_lib()
    fp = ctypes.POINTER(ctypes.c_float)
    n = len(read_idx)
    t = len(targets)
    idx = np.ascontiguousarray(read_idx, dtype=np.int64)
    tgt_off = np.zeros(t + 1, np.int64)
    for k, tg in enumerate(targets):
        tgt_off[k + 1] = tgt_off[k] + len(tg)
    blob = np.concatenate([np.ascontiguousarray(tg, dtype=np.uint8)
                           for tg in targets])
    bpb = np.array([b for (b, _e) in bp_ranges], np.int32)
    bpe = np.array([e for (_b, e) in bp_ranges], np.int32)
    lut_m, lut_x = qconv.lut256()
    out_lnl = np.empty((n, t), np.float32)
    out_pos = np.empty((n, t), np.int32)
    rc = lib.mt_split_read_scan_multi(
        n, idx.ctypes.data_as(i64p),
        batch.seq_off.ctypes.data_as(i64p),
        batch.seq.ctypes.data_as(u8p),
        batch.qual_off.ctypes.data_as(i64p),
        batch.qual.ctypes.data_as(u8p),
        t, blob.ctypes.data_as(u8p), tgt_off.ctypes.data_as(i64p),
        bpb.ctypes.data_as(i32p), bpe.ctypes.data_as(i32p),
        flank_score_size,
        lut_m.ctypes.data_as(fp), lut_x.ctypes.data_as(fp),
        ctypes.c_float(-math.log(4.0)),
        out_lnl.ctypes.data_as(fp), out_pos.ctypes.data_as(i32p))
    assert rc == 0, f"mt_split_read_scan_multi failed: {rc}"
    return out_lnl, out_pos


def split_read_aligner(flank_score_size: int, query: np.ndarray,
                       qconv: QscoreSnp, qual: np.ndarray,
                       target: np.ndarray, bp_beg: int, bp_end: int) -> SRAlignmentInfo:
    """Sliding basecall-likelihood scan of a read across a breakpoint
    junction (reference: SplitReadAlignment.cpp splitReadAligner).

    query/target are uint8 ASCII arrays; (bp_beg, bp_end) is the
    microhomology-aware breakend offset range in target coordinates.
    Vectorized over scan positions with float32 sequential accumulation
    to match the reference's summation order.
    """
    a = SRAlignmentInfo()
    nq = len(query)
    nt = len(target)
    assert nq < nt, "split read alignment: query >= target"
    scan_start = max(0, bp_beg - nq + 2)
    scan_end = max(0, min(bp_end, nt - nq))
    assert scan_end >= scan_start, "scanEnd < scanStart"
    score_beg = bp_beg - flank_score_size
    score_end = bp_end + flank_score_size

    # native scan (native/manta_core.cpp mt_split_read_scan): per scan
    # position float32 base-order accumulation, winner-takes-first
    best, best_pos = _native_split_scan(query, qual, target, nq, nt,
                                        bp_beg, bp_end, flank_score_size,
                                        qconv)
    return finalize_split_alignment(a, best, best_pos, query, target,
                                    bp_beg, bp_end)


def matchify_ranges_batch(batch):
    """Soft-clip-matchified reference ranges for every read in a batch
    (native mt_matchify_ranges), cached on the batch: phase-2 evaluates
    several breakends against the same fetched window."""
    cached = getattr(batch, "_matchify_ranges", None)
    if cached is not None:
        return cached
    from .._native import get_lib, i32p, i64p, u32p
    lib = get_lib()
    beg = np.empty(batch.n, np.int32)
    end = np.empty(batch.n, np.int32)
    rc = lib.mt_matchify_ranges(
        batch.n, batch.pos.ctypes.data_as(i32p),
        batch.cigar_off.ctypes.data_as(i64p),
        batch.cigar.ctypes.data_as(u32p),
        beg.ctypes.data_as(i32p), end.ctypes.data_as(i32p))
    assert rc == 0, f"mt_matchify_ranges failed: {rc}"
    batch._matchify_ranges = (beg, end)
    return beg, end


def split_finalize_multi(batch, read_idx, targets: list, bp_ranges: list,
                         best_pos) -> "np.ndarray":
    """Batched mismatch accounting at the winning scan positions for
    selected reads x targets (native mt_split_finalize_multi). Returns
    (n, t, 3) int32 left/hom/right mismatch counts — the exact values
    finalize_split_alignment computes per pair."""
    from .._native import get_lib, i32p, i64p, u8p
    lib = get_lib()
    n = len(read_idx)
    t = len(targets)
    idx = np.ascontiguousarray(read_idx, dtype=np.int64)
    tgt_off = np.zeros(t + 1, np.int64)
    for k, tg in enumerate(targets):
        tgt_off[k + 1] = tgt_off[k] + len(tg)
    blob = np.concatenate([np.ascontiguousarray(tg, dtype=np.uint8)
                           for tg in targets])
    bpb = np.array([b for (b, _e) in bp_ranges], np.int32)
    bpe = np.array([e for (_b, e) in bp_ranges], np.int32)
    bpos = np.ascontiguousarray(best_pos, dtype=np.int32)
    out = np.empty((n, t, 3), np.int32)
    rc = lib.mt_split_finalize_multi(
        n, idx.ctypes.data_as(i64p),
        batch.seq_off.ctypes.data_as(i64p),
        batch.seq.ctypes.data_as(u8p),
        t, blob.ctypes.data_as(u8p), tgt_off.ctypes.data_as(i64p),
        bpb.ctypes.data_as(i32p), bpe.ctypes.data_as(i32p),
        bpos.ctypes.data_as(i32p), out.ctypes.data_as(i32p))
    assert rc == 0, f"mt_split_finalize_multi failed: {rc}"
    return out


def finalize_split_evidence_multi(nq, best_pos, bp_ranges: list, mm):
    """Vectorized finalize_split_alignment evidence summary over the
    (reads x targets) scan winners: the flank/homology sizing and
    evidence checks of finalize_split_alignment_counts + _set_evidence,
    restricted to the fields the scorer consumes downstream. All float
    expressions match the scalar path operation-for-operation so the
    results are bit-identical.

    nq: (n,) read lengths; best_pos: (n, t) winning positions;
    bp_ranges: t (beg, end) pairs; mm: (n, t, 3) mismatch counts.
    Returns (is_evidence, is_tier2_evidence, evidence) of shape (n, t).
    """
    bp_beg = np.array([b for (b, _e) in bp_ranges], np.int64)
    bp_end = np.array([e for (_b, e) in bp_ranges], np.int64)
    nq = np.asarray(nq, np.int64)[:, None]
    pos = best_pos.astype(np.int64)
    left = np.maximum((bp_beg + 1) - pos, 0)
    hom = np.minimum(nq - left, ((bp_end + 1) - pos) - left)
    right = np.maximum(nq - (left + hom), 0)
    mm = mm.astype(np.int64)
    score = (nq - mm.sum(-1)).astype(np.float64)
    left_f = left.astype(np.float64)
    right_f = right.astype(np.float64)
    size = left_f + right_f
    with np.errstate(divide="ignore", invalid="ignore"):
        frac_ok = (mm[..., 0] / left_f < 0.25) & \
            (mm[..., 2] / right_f < 0.25) & (score / size >= 0.9)
        is_ev = (left >= 16) & (right >= 16) & frac_ok
        is_t2 = (left >= 8) & (right >= 8) & frac_ok
        evd = np.where(is_ev | is_t2,
                       2 * np.minimum(left, right) / size, 0.0)
    return is_ev, is_t2, np.where(np.isfinite(evd), evd, 0.0)


def finalize_split_alignment_counts(a: SRAlignmentInfo, best: float,
                                    best_pos: int, nq: int, bp_beg: int,
                                    bp_end: int, mm) -> SRAlignmentInfo:
    """finalize_split_alignment with the window mismatch counts already
    computed natively (split_finalize_multi)."""
    if best_pos <= bp_beg + 1:
        a.left_size = (bp_beg + 1) - best_pos
    else:
        a.left_size = 0
    a.hom_size = min(nq - a.left_size,
                     ((bp_end + 1) - best_pos) - a.left_size)
    if a.left_size + a.hom_size < nq:
        a.right_size = nq - (a.left_size + a.hom_size)
    else:
        a.right_size = 0
    a.align_ln_lhood = best
    a.align_pos = best_pos
    a.left_mismatches = int(mm[0])
    a.hom_mismatches = int(mm[1])
    a.right_mismatches = int(mm[2])
    a.align_score = nq - (a.left_mismatches + a.hom_mismatches
                          + a.right_mismatches)
    _set_evidence(a)
    return a


def finalize_split_alignment(a: SRAlignmentInfo, best: float, best_pos: int,
                             query: np.ndarray, target: np.ndarray,
                             bp_beg: int, bp_end: int) -> SRAlignmentInfo:
    """Flank/homology sizing + mismatch accounting at the winning scan
    position (reference: SplitReadAlignment.cpp setEvidence +
    calculateAlignScore)."""
    nq = len(query)
    assert best_pos <= bp_end + 1
    if best_pos <= bp_beg + 1:
        a.left_size = (bp_beg + 1) - best_pos
    else:
        a.left_size = 0
    assert a.left_size <= nq
    a.hom_size = min(nq - a.left_size, ((bp_end + 1) - best_pos) - a.left_size)
    if a.left_size + a.hom_size < nq:
        a.right_size = nq - (a.left_size + a.hom_size)
    else:
        a.right_size = 0
    a.align_ln_lhood = best
    a.align_pos = best_pos

    # calculateAlignScore: the three regions are contiguous position
    # ranges (<= left_end, left_end+1..hom_end, > hom_end), so slice
    # sums replace the positional masks
    w = target[best_pos:best_pos + nq]
    mism = (query != w) | (query == ord("N"))
    left_end = a.left_size
    hom_end = a.left_size + a.hom_size
    a.left_mismatches = int(mism[:left_end + 1].sum())
    a.hom_mismatches = int(mism[left_end + 1:hom_end + 1].sum())
    a.right_mismatches = int(mism[hom_end + 1:].sum())
    a.align_score = nq - (a.left_mismatches + a.hom_mismatches
                          + a.right_mismatches)
    _set_evidence(a)
    return a


class SVAlignmentInfo:
    """Contig/reference sequences + breakpoint offsets for split scoring
    (reference: manta/SVScoreInfo.cpp SVAlignmentInfo)."""

    def __init__(self, sv: SVCandidate, assembly_data):
        self.is_spanning = assembly_data.is_spanning
        self._bp1_rev = assembly_data.bporient.is_bp1_reversed
        self._bp2_rev = assembly_data.bporient.is_bp2_reversed
        self.contig_seq = ""
        self.rev_contig_seq = ""
        self.bp1_ref_seq = ""
        self.bp2_ref_seq = ""
        self.bp1_contig_offset = (0, 0)
        self.bp2_contig_offset = (0, 0)
        self.bp1_ref_offset = (0, 0)
        self.bp2_ref_offset = (0, 0)
        if sv.is_imprecise:
            return
        bp1_hom = sv.bp1.interval.size() - 1
        bp2_hom = sv.bp2.interval.size() - 1
        self.contig_seq = assembly_data.extended_contigs[sv.assembly_align_index]
        if self.is_spanning:
            res = assembly_data.spanning_alignments[sv.assembly_align_index]
            align1_size = cg.read_length(res.align1.ops, res.align1.lens)
            bp1_beg = res.align1.begin_pos - assembly_data.bp1ref_align_offset \
                if False else res.align1.begin_pos
            # NB begin_pos here is relative to the full (uncut) align1 ref
            bp1_contig_beg = res.align1.begin_pos + align1_size - 1
            bp2_contig_beg = bp1_contig_beg + res.jump_insert_size
            o1, o2 = bp1_contig_beg, bp2_contig_beg
            if assembly_data.bporient.is_bp2_aligned_first:
                o1, o2 = o2, o1
            self.bp1_contig_offset = (o1, o1 + bp1_hom)
            self.bp2_contig_offset = (o2, o2 + bp2_hom)
            if self._bp1_rev or self._bp2_rev:
                assert not (self._bp1_rev and self._bp2_rev)
                self.rev_contig_seq = revcomp(self.contig_seq)
                rev_size = len(self.contig_seq) - 2
                if self._bp1_rev:
                    b, e = self.bp1_contig_offset
                    self.bp1_contig_offset = (rev_size - e, rev_size - b)
                else:
                    b, e = self.bp2_contig_offset
                    self.bp2_contig_offset = (rev_size - e, rev_size - b)
            self.bp1_ref_seq = assembly_data.bp1ref[0]
            self.bp2_ref_seq = assembly_data.bp2ref[0]
            b1 = sv.bp1.interval.beg - assembly_data.bp1ref[1]
            self.bp1_ref_offset = (b1, b1 + bp1_hom)
            b2 = sv.bp2.interval.beg - assembly_data.bp2ref[1]
            self.bp2_ref_offset = (b2, b2 + bp2_hom)
        else:
            res = assembly_data.small_sv_alignments[sv.assembly_align_index]
            seg = assembly_data.small_sv_segments[
                sv.assembly_align_index][sv.assembly_segment_index]
            rl_start = cg.read_length(res.align.ops[:seg[0]],
                                      res.align.lens[:seg[0]])
            rl_end = cg.read_length(res.align.ops[:seg[1] + 1],
                                    res.align.lens[:seg[1] + 1])
            o1 = res.align.begin_pos + rl_start - 1
            o2 = res.align.begin_pos + rl_end - 1
            self.bp1_contig_offset = (o1, o1 + bp1_hom)
            self.bp2_contig_offset = (o2, o2 + bp2_hom)
            self.bp1_ref_seq = assembly_data.bp1ref[0]
            off = assembly_data.bp1ref[1]
            self.bp1_ref_offset = (sv.bp1.interval.beg - off,
                                   sv.bp1.interval.end - off)
            self.bp2_ref_offset = (sv.bp2.interval.beg - off,
                                   sv.bp2.interval.end - off)

    def bp1_contig(self) -> str:
        return self.rev_contig_seq if self._bp1_rev else self.contig_seq

    def bp2_contig(self) -> str:
        return self.rev_contig_seq if self._bp2_rev else self.contig_seq

    def bp1_reference(self) -> str:
        return self.bp1_ref_seq

    def bp2_reference(self) -> str:
        return self.bp2_ref_seq if self.is_spanning else self.bp1_ref_seq

    def is_min_bp_edge(self, min_edge: int) -> bool:
        """(reference: SVScoreInfo.cpp isMinBpEdge)."""
        m = min_edge
        if self.bp1_contig_offset[0] + 1 < m:
            return False
        if self.bp2_contig_offset[0] + 1 < m:
            return False
        if self.bp1_ref_offset[0] + 1 < m:
            return False
        if self.bp2_ref_offset[0] + 1 < m:
            return False
        contig_bp_size = len(self.contig_seq) - 1
        if contig_bp_size - self.bp1_contig_offset[1] < m:
            return False
        if contig_bp_size - self.bp2_contig_offset[1] < m:
            return False
        if len(self.bp1_reference()) - 1 - self.bp1_ref_offset[1] < m:
            return False
        if len(self.bp2_reference()) - 1 - self.bp2_ref_offset[1] < m:
            return False
        return True
