"""Candidate refinement: low-res candidate -> assembly -> alignment ->
base-pair-resolution SV candidates.

Behavioral parity with the reference SVCandidateAssemblyRefiner
(reference: src/c++/lib/applications/GenerateSVCandidates/
SVCandidateAssemblyRefiner.cpp): spanning (jump-aligned) path with
breakend orientation normalization, 250b edge + 100b split reference
padding, contig selection at >=75%-of-perfect score over ref-span QC
windows, breakend homology (jumpRange) adjustment; complex path with
the large-indel aligner, kmer-guided reference cuts, leading/trailing
alignment-quality pruning, flank-uniqueness repeat filtering, two-rank
contig selection, and semi-assembled large-insertion detection.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..align.aligners import (
    AlignmentScores, GlobalAligner, GlobalJumpAligner, GlobalLargeIndelAligner,
)
from ..core import cigar as cg
from ..core.svmodel import (
    BND_COMPLEX,
    BND_LEFT_OPEN,
    BND_RIGHT_OPEN,
    BND_UNKNOWN,
    EXT_INSERT,
    SVCandidate,
    get_extended_sv_type,
    get_sv_type,
    is_complex_sv,
    is_same_orientation,
    is_spanning_sv,
    SV_INDEL,
)
from ..io.bam import C_D, C_I, C_M, C_N, C_S, C_EQ, C_X
from .assembler_reads import BreakendReadAssembler, revcomp
from ..assembly.assembler import AssemblerOptions


@dataclass
class RefinerOptions:
    """(reference: options/SVRefinerOptions.hpp:36-76)."""
    large_sv_scores: AlignmentScores = field(
        default_factory=lambda: AlignmentScores(2, -8, -24, -1, -1))
    large_insert_edge_scores: AlignmentScores = field(
        default_factory=lambda: AlignmentScores(2, -8, -18, -1, -1))
    large_insert_complete_scores: AlignmentScores = field(
        default_factory=lambda: AlignmentScores(2, -8, -100, 0, -1))
    spanning_scores: AlignmentScores = field(
        default_factory=lambda: AlignmentScores(2, -8, -12, -1, -1))
    large_gap_open_score: int = -100
    jump_score: int = -100
    rna_spanning_scores: AlignmentScores = field(
        default_factory=lambda: AlignmentScores(2, -8, -19, -1, -1))
    rna_jump_score: int = -100
    rna_intron_open_score: int = -15
    rna_intron_off_edge_score: int = -1
    contig_filter_scores: AlignmentScores = field(
        default_factory=lambda: AlignmentScores(2, -8, -18, 0, -1))

    def __post_init__(self):
        self.small_sv_assemble_opt = AssemblerOptions()
        self.spanning_assemble_opt = AssemblerOptions(min_contig_length=75)
        # (reference: SVRefinerOptions.hpp:56-59): larger contigs, smaller
        # kmers for RNA spanning assembly
        self.rna_spanning_assemble_opt = AssemblerOptions(
            min_contig_length=75, min_word_length=31)


def path_score(scores: AlignmentScores, ops, lens,
               score_off_edge: bool = False) -> int:
    """(reference: AlignmentScoringUtilImpl.hpp getPathScore). Note the
    per-segment isIndel reset replicated from the reference."""
    val = 0
    for o, l in zip(ops.tolist(), lens.tolist()):
        if o == C_EQ:
            val += scores.match * l
        elif o == C_X:
            val += scores.mismatch * l
        elif o in (C_I, C_D):
            val += scores.open + scores.extend * l
        elif o == C_S:
            if score_off_edge:
                val += scores.off_edge * l
    return val


def max_path_score(scores: AlignmentScores, ops, lens):
    """(reference: getMaxPathScore): returns (max_score, read_off, ref_off)."""
    val = 0
    read_off = ref_off = 0
    max_val = 0
    max_read = max_ref = 0
    for o, l in zip(ops.tolist(), lens.tolist()):
        if o == C_EQ:
            val += scores.match * l
            read_off += l
            ref_off += l
        elif o == C_X:
            val += scores.mismatch * l
            read_off += l
            ref_off += l
        elif o == C_I:
            val += scores.open + scores.extend * l
            read_off += l
        elif o == C_D:
            val += scores.open + scores.extend * l
            ref_off += l
        elif o == C_S:
            read_off += l
        if val > max_val:
            max_val = val
            max_read = read_off
            max_ref = ref_off
    return max_val, max_read, max_ref


def limit_ref_length(target: int, ops, lens):
    """(reference: apath_limit_ref_length)."""
    out_o, out_l = [], []
    ref_len = 0
    for o, l in zip(ops.tolist(), lens.tolist()):
        if o not in cg.REF_LEN_OPS:
            out_o.append(o)
            out_l.append(l)
            continue
        ref_len += l
        if ref_len < target:
            out_o.append(o)
            out_l.append(l)
            continue
        if ref_len > target:
            l -= ref_len - target
        out_o.append(o)
        out_l.append(l)
        break
    return np.array(out_o, np.int32), np.array(out_l, np.int32)


def limit_read_length(start: int, end: int, ops, lens):
    """(reference: apath_limit_read_length:295-329)."""
    ops = ops.tolist()
    lens = lens.tolist()
    n = len(ops)
    start_segment = 0
    end_segment = n
    is_start_set = False
    read_length = 0
    for i in range(n):
        if ops[i] not in cg.READ_LEN_OPS:
            continue
        read_length += lens[i]
        if (not is_start_set) and read_length > start:
            extra = lens[i] - (read_length - start)
            lens[i] -= extra
            start_segment = i
            is_start_set = True
        if read_length >= end:
            if read_length > end:
                lens[i] -= read_length - end
            end_segment = i + 1
            break
    return (np.array(ops[start_segment:end_segment], np.int32),
            np.array(lens[start_segment:end_segment], np.int32))


@dataclass
class BPOrientation:
    """(reference: SVCandidateAssemblyData BPOrientation)."""
    is_bp2_aligned_first: bool = False
    is_bp1_reversed: bool = False
    is_bp2_reversed: bool = False
    is_bp1_first: bool = True
    is_transcript_strand_known: bool = False


@dataclass
class LargeInsertionInfo:
    is_left_candidate: bool = False
    is_right_candidate: bool = False
    contig_offset: int = 0
    ref_offset: int = 0
    score: int = 0


@dataclass
class AssemblyData:
    """(reference: SVCandidateAssemblyData)."""
    is_candidate_spanning: bool = False
    is_spanning: bool = False
    is_overlap_skip: bool = False
    bporient: BPOrientation = field(default_factory=BPOrientation)
    contigs: list = field(default_factory=list)
    # per-contig alignment results
    spanning_alignments: list = field(default_factory=list)
    small_sv_alignments: list = field(default_factory=list)
    small_sv_segments: list = field(default_factory=list)
    large_insert_info: list = field(default_factory=list)
    extended_contigs: list = field(default_factory=list)
    # deferred spanning-alignment job context (cross-edge batching)
    pending_prep: dict | None = None
    best_alignment_index: int = 0
    # reference segments: (seq bytes, offset)
    bp1ref: tuple | None = None
    bp2ref: tuple | None = None
    remote_reads: dict = field(default_factory=dict)
    svs: list = field(default_factory=list)


class IntervalTracker:
    """Merged-interval set per chromosome
    (reference: blt_util/RegionTracker GenomeIntervalTracker)."""

    def __init__(self):
        self._regions: dict[int, list[tuple[int, int]]] = {}

    def clear(self):
        self._regions = {}

    def add(self, tid: int, beg: int, end: int):
        regions = self._regions.setdefault(tid, [])
        regions.append((beg, end))
        regions.sort()
        merged = []
        for b, e in regions:
            if merged and b <= merged[-1][1]:
                merged[-1] = (merged[-1][0], max(merged[-1][1], e))
            else:
                merged.append((b, e))
        self._regions[tid] = merged

    def is_subset(self, tid: int, beg: int, end: int) -> bool:
        for b, e in self._regions.get(tid, []):
            if b <= beg and end <= e:
                return True
        return False


def kmer_mask_reference(ref: str, contig: str):
    """Remove long reference stretches without contig kmer matches
    (reference: kmerMaskReference:1139-1185). Returns
    (masked_ref, exclusion_blocks [(start, length, n_spacer)])."""
    mer = 10
    min_exclusion = 1000
    padding = 50
    n_spacer = 25
    excl = []
    contig_hash = {contig[i:i + mer]
                   for i in range(max(0, len(contig) - (mer - 1)))}
    masked = []
    max_ref = len(ref) - (mer - 1)
    pot_excl_start = 0
    incl_start = 0
    for r in range(max(0, max_ref)):
        if ref[r:r + mer] in contig_hash:
            if (r - pot_excl_start) > (min_exclusion + padding):
                spacer = 0
                if pot_excl_start > 0:
                    masked.append(ref[incl_start:pot_excl_start])
                    masked.append("N" * n_spacer)
                    spacer = n_spacer
                incl_start = r - padding
                excl.append((pot_excl_start, incl_start - pot_excl_start,
                             spacer))
            pot_excl_start = r + padding
    masked.append(ref[incl_start:min(max(0, max_ref), pot_excl_start)])
    out = "".join(masked)
    if not out:
        out = "N" * n_spacer
    return out, excl


def _translate_masked_pos(excl, masked_pos: int) -> int:
    offset = 0
    for (start, length, spacer) in excl:
        if start > offset + masked_pos:
            break
        offset += length - spacer
    return offset + masked_pos


def translate_masked_alignment(al, excl) -> bool:
    """(reference: translateMaskedAlignment:1101-1135)."""
    new_ops = []
    new_lens = []
    cpos = al.begin_pos
    for o, l in zip(al.ops.tolist(), al.lens.tolist()):
        if o not in (C_M, C_EQ, C_X, C_D, C_N):
            new_ops.append(o)
            new_lens.append(l)
        else:
            length = _translate_masked_pos(excl, cpos + l) - \
                _translate_masked_pos(excl, cpos)
            if o in (C_M, C_EQ, C_X) and length != l:
                return False
            cpos += l
            new_ops.append(o)
            new_lens.append(length)
    if len(al.ops) > 0:
        al.begin_pos = _translate_masked_pos(excl, al.begin_pos)
        al.ops = np.array(new_ops, np.int32)
        al.lens = np.array(new_lens, np.int32)
    return True


def _is_low_quality_spanning_alignment(max_qc_ref_span: int,
                                       scores: AlignmentScores,
                                       is_leading: bool,
                                       ops, lens,
                                       is_rna: bool = False) -> bool:
    """(reference: isLowQualitySpanningSVAlignment:93-118)."""
    min_align_read_length = 20 if is_rna else 30
    min_score_frac = 0.75
    if is_leading:
        ops = ops[::-1].copy()
        lens = lens[::-1].copy()
    ops, lens = limit_ref_length(max_qc_ref_span, ops, lens)
    read_size = cg.read_length(ops, lens)
    clip_size = cg.soft_clip_trail_size(ops, lens)
    clipped = read_size - clip_size
    if clipped < min_align_read_length:
        return True
    non_clip_score = max(0, path_score(scores, ops, lens))
    optimal = clipped * scores.match
    return (non_clip_score / optimal) < min_score_frac


def _is_jump_segment_qc_fail(al) -> bool:
    return (not al.is_aligned) or cg.ref_length(al.ops, al.lens) < 20


def _spliced_length(ops, lens) -> int:
    return int(sum(l for o, l in zip(ops.tolist(), lens.tolist())
                   if o == C_N))


def _is_low_quality_jump_alignment(res, scores: AlignmentScores,
                                   is_rna: bool = False) -> bool:
    low1 = low2 = True
    spans = (36, 75, 100) if is_rna else (75, 100, 200)
    for span in spans:
        span1 = span + (_spliced_length(res.align1.ops, res.align1.lens)
                        if is_rna else 0)
        span2 = span + (_spliced_length(res.align2.ops, res.align2.lens)
                        if is_rna else 0)
        if not _is_low_quality_spanning_alignment(span1, scores, True,
                                                  res.align1.ops,
                                                  res.align1.lens, is_rna):
            low1 = False
        if not _is_low_quality_spanning_alignment(span2, scores, False,
                                                  res.align2.ops,
                                                  res.align2.lens, is_rna):
            low2 = False
    return low1 or low2


def _is_low_quality_small_alignment(max_qc_ref_span: int,
                                    scores: AlignmentScores,
                                    is_leading: bool, is_complex: bool,
                                    ops, lens) -> bool:
    """(reference: isLowQualitySmallSVAlignment:318-392)."""
    min_span = 35 if is_complex else 30
    min_read = 35 if is_complex else 30
    min_score_frac = 0.75
    if is_leading:
        ops = ops[::-1].copy()
        lens = lens[::-1].copy()
    ops, lens = limit_ref_length(max_qc_ref_span, ops, lens)
    if cg.ref_length(ops, lens) < min_span:
        return True
    read_size = cg.read_length(ops, lens)
    clip = cg.soft_clip_trail_size(ops, lens)
    clipped = read_size - clip
    if clipped < min_read:
        return True
    non_clip = max(0, path_score(scores, ops, lens))
    optimal = clipped * scores.match
    return (non_clip / optimal) < min_score_frac


def get_large_indel_segments(ops, lens, min_size: int):
    """(reference: getLargeIndelSegments:173-208): runs of I/D segments
    containing at least one >= min_size."""
    segments = []
    in_seg = False
    is_cand = False
    seg_start = 0
    n = len(ops)
    for i in range(n):
        if ops[i] in (C_D, C_I):
            if lens[i] >= min_size:
                is_cand = True
            if not in_seg:
                seg_start = i
            in_seg = True
        else:
            if is_cand:
                segments.append((seg_start, i - 1))
            in_seg = False
            is_cand = False
    if is_cand:
        segments.append((seg_start, n - 1))
    return segments


def get_largest_indel_size(ops, lens, segments) -> int:
    largest = 0
    for (a, b) in segments:
        for i in range(a, b + 1):
            if ops[i] in (C_D, C_I) and lens[i] > largest:
                largest = int(lens[i])
    return largest


def get_largest_insert_segment(ops, lens, min_size: int):
    """(reference: getLargestInsertSegment:230-285)."""
    in_seg = False
    is_cand = False
    seg_start = 0
    is_max = False
    max_size = min_size
    max_segment = None
    n = len(ops)
    for i in range(n):
        if ops[i] in (C_D, C_I):
            if ops[i] == C_I and lens[i] >= max_size:
                is_max = True
                max_size = int(lens[i])
                is_cand = True
            if not in_seg:
                seg_start = i
            in_seg = True
        else:
            if is_cand:
                max_segment = (seg_start, i - 1)
            in_seg = False
            is_cand = False
    if is_cand:
        max_segment = (seg_start, n - 1)
    return [max_segment] if (is_max and max_segment is not None) else []


def _query_seq_match_count(target: str, query: str,
                           max_mismatch_rate: float) -> int:
    """(reference: getQuerySeqMatchCount:393-428)."""
    count = 0
    nq, nt = len(query), len(target)
    if nq > nt or nq == 0:
        return 0
    q = np.frombuffer(query.encode(), np.uint8)
    t = np.frombuffer(target.encode(), np.uint8)
    is_n = q == ord("N")
    for i in range(nt - nq + 1):
        mism = int(((q != t[i:i + nq]) | is_n).sum())
        if mism / nq <= max_mismatch_rate:
            count += 1
    return count


def find_candidate_variants_from_complex_alignment(
        max_qc_ref_span: int, scores: AlignmentScores, align,
        contig_seq: str, ref_seq: str, min_candidate_indel_size: int):
    """(reference:
    findCandidateVariantsFromComplexSVContigAlignment:430-554).
    Returns candidate segments list or []."""
    ops, lens = align.ops, align.lens
    segments = get_large_indel_segments(ops, lens, min_candidate_indel_size)
    if not segments:
        return []
    is_complex = len(segments) > 1 or segments[0][0] != segments[0][1]

    while True:
        first = segments[0][0]
        if not _is_low_quality_small_alignment(
                max_qc_ref_span, scores, True, is_complex,
                ops[:first], lens[:first]):
            break
        if len(segments) == 1:
            return []
        segments = segments[1:]
    while True:
        last = segments[-1][1]
        if not _is_low_quality_small_alignment(
                max_qc_ref_span, scores, False, is_complex,
                ops[last + 1:], lens[last + 1:]):
            break
        if len(segments) == 1:
            return []
        segments = segments[:-1]

    # flank-uniqueness repeat filter
    left_size = cg.read_length(ops[:segments[0][0]], lens[:segments[0][0]])
    end_pos = cg.read_length(ops[:segments[-1][1] + 1],
                             lens[:segments[-1][1] + 1])
    left_contig = contig_seq[:left_size]
    right_contig = contig_seq[end_pos:]
    search_window = 500
    mismatch_rate = 0.05
    ref_align_start = align.begin_pos
    ref_align_end = align.begin_pos + cg.ref_length(ops, lens)
    left_search_start = max(0, ref_align_end - search_window)
    ref_left = ref_seq[left_search_start:ref_align_end]
    if _query_seq_match_count(ref_left, left_contig, mismatch_rate) > 1:
        return []
    right_size = min(search_window, len(ref_seq) - ref_align_start)
    ref_right = ref_seq[ref_align_start:ref_align_start + right_size]
    if _query_seq_match_count(ref_right, right_contig, mismatch_rate) > 1:
        return []

    out = []
    for (a, b) in segments:
        for i in range(a, b + 1):
            if ops[i] in (C_I, C_D) and lens[i] >= min_candidate_indel_size:
                out.append((a, b))
                break
    return out


def get_variant_range(ref: str, ref_range: tuple, read: str,
                      read_range: tuple):
    """Breakend micro-homology range
    (reference: getVariantRange:677-718)."""
    max_right = min(len(ref) - ref_range[1], len(read) - read_range[1])
    right = 0
    while right < max_right:
        if ref[ref_range[0] + right] != read[read_range[0] + right]:
            break
        right += 1
    min_left = max(-ref_range[0], -read_range[0])
    left = 0
    while left >= min_left:
        if ref[ref_range[1] + left - 1] != read[read_range[1] + left - 1]:
            break
        left -= 1
    return (left, right)


def set_small_cand_sv(ref_seq: str, ref_offset: int, contig: str, align,
                      seg_range: tuple, sv: SVCandidate,
                      is_output_contig: bool = False):
    """(reference: setSmallCandSV:720-800)."""
    sv.is_imprecise = False
    read_beg = read_end = 0
    ref_beg = ref_end = 0
    read_pos = 0
    ref_pos = align.begin_pos
    for i, (o, l) in enumerate(zip(align.ops.tolist(), align.lens.tolist())):
        if i == seg_range[0]:
            ref_beg = ref_pos
            read_beg = read_pos
        if o in cg.REF_LEN_OPS:
            ref_pos += l
        if o in cg.READ_LEN_OPS:
            read_pos += l
        if i == seg_range[1]:
            ref_end = ref_pos
            read_end = read_pos
    cipos = get_variant_range(ref_seq, (ref_beg, ref_end), contig,
                              (read_beg, read_end))
    assert cipos[0] == 0, "unexpected non-left-shifted alignment"
    sv.bp1.state = BND_RIGHT_OPEN
    begin_pos = ref_offset + ref_beg - 1
    sv.bp1.interval.beg = begin_pos
    sv.bp1.interval.end = begin_pos + cipos[1] + 1
    sv.bp2.state = BND_LEFT_OPEN
    end_pos = ref_offset + ref_end
    sv.bp2.interval.beg = end_pos
    sv.bp2.interval.end = end_pos + cipos[1] + 1
    sv.bp2.interval.tid = sv.bp1.interval.tid
    sv.insert_seq = contig[read_beg:read_end]
    if is_output_contig:
        # (reference: SVCandidateAssemblyRefiner.cpp:796-799)
        sv.contig_seq = contig
    sv.insert_alignment = (align.ops[seg_range[0]:seg_range[1] + 1].copy(),
                           align.lens[seg_range[0]:seg_range[1] + 1].copy())


def _adjust_assembled_breakend(align, is_align1: bool, jump_range: int,
                               ref_seq_len: int, ref_offset: int,
                               is_reversed: bool, bp):
    """(reference: adjustAssembledBreakend:59-91)."""
    align_end = align.begin_pos + cg.ref_length(align.ops, align.lens)
    if is_reversed:
        bp_begin = ref_seq_len - align_end
        bp_end = ref_seq_len - align.begin_pos
    else:
        bp_begin = align.begin_pos
        bp_end = align_end
    is_bp_at_align_end = bp.state == BND_RIGHT_OPEN
    bp_breakend_offset = (bp_end - 1) if is_bp_at_align_end else bp_begin
    bp_breakend_pos = ref_offset + bp_breakend_offset
    is_left_aligned = is_align1 == is_bp_at_align_end
    if is_left_aligned:
        bp.interval.beg = bp_breakend_pos
        bp.interval.end = bp_breakend_pos + jump_range + 1
    else:
        bp.interval.beg = bp_breakend_pos - jump_range
        bp.interval.end = bp_breakend_pos + 1


def _add_cigar_to_spanning(sv: SVCandidate):
    """(reference: addCigarToSpanningAlignment:287-316)."""
    if get_sv_type(sv) != SV_INDEL:
        return
    bp1_first = sv.bp1.interval.beg <= sv.bp2.interval.beg
    bpa, bpb = (sv.bp1, sv.bp2) if bp1_first else (sv.bp2, sv.bp1)
    delete_size = bpb.interval.beg - bpa.interval.beg - 1
    insert_size = len(sv.insert_seq)
    assert delete_size >= 0
    ops, lens = [], []
    if insert_size:
        ops.append(C_I)
        lens.append(insert_size)
    if delete_size:
        ops.append(C_D)
        lens.append(delete_size)
    sv.insert_alignment = (np.array(ops, np.int32), np.array(lens, np.int32))


class SVCandidateAssemblyRefiner:
    def __init__(self, scanner, readers, is_tumor, fasta,
                 opt: RefinerOptions | None = None,
                 chrom_depths: dict | None = None,
                 enable_remote_read_retrieval: bool = True,
                 min_candidate_variant_size: int = 8,
                 is_output_contig: bool = False,
                 is_rna: bool = False,
                 is_unstranded_rna: bool = False,
                 jump_score_backend: str | None = "native",
                 device=None):
        """``jump_score_backend``: ``"native"`` (the host score batch),
        ``"device"`` (the bucketed scorer of ``align.device_jumpscore``
        on the torch device ``device``) or None."""
        self.opt = opt or RefinerOptions()
        self.is_output_contig = is_output_contig
        self.is_rna = is_rna
        self.is_unstranded_rna = is_unstranded_rna
        self.scanner = scanner
        self.fasta = fasta
        self.min_candidate_variant_size = min_candidate_variant_size
        self.enable_remote_read_retrieval = enable_remote_read_retrieval
        self._small_assembler = BreakendReadAssembler(
            scanner, readers, is_tumor, self.opt.small_sv_assemble_opt,
            chrom_depths)
        self._spanning_assembler = BreakendReadAssembler(
            scanner, readers, is_tumor,
            self.opt.rna_spanning_assemble_opt if is_rna
            else self.opt.spanning_assemble_opt,
            chrom_depths)
        self._large_sv_aligner = GlobalLargeIndelAligner(
            self.opt.large_sv_scores, self.opt.large_gap_open_score)
        self._large_insert_edge_scores = self.opt.large_insert_edge_scores
        self._large_insert_complete_aligner = GlobalAligner(
            self.opt.large_insert_complete_scores)
        self._spanning_aligner = GlobalJumpAligner(
            self.opt.spanning_scores, self.opt.jump_score)
        from ..align.aligners import GlobalJumpIntronAligner
        self._rna_spanning_aligner = GlobalJumpIntronAligner(
            self.opt.rna_spanning_scores, self.opt.rna_jump_score,
            self.opt.rna_intron_open_score,
            self.opt.rna_intron_off_edge_score)
        self._contig_filter_scores = self.opt.contig_filter_scores
        self._span_to_complex_regions = IntervalTracker()
        # spanning-contig score backend: all contigs are scored cheaply
        # (score-only native DP or the device jump kernel, both bit-
        # exact vs the traceback aligner), then only descending-score
        # winners are tracebacked (reference hot loop:
        # GlobalJumpAlignerImpl.hpp via alignJumpContigs:1524)
        if jump_score_backend == "native":
            from ..align.aligners import jump_score_batch

            def backend(jobs):
                return jump_score_batch(jobs, self.opt.spanning_scores,
                                        self.opt.jump_score)
            self._jump_score_backend = backend
        elif jump_score_backend == "device":
            if device is None:
                raise ValueError("the device jump backend needs a device")
            from ..align.device_jumpscore import make_bucketed_scorer
            self._jump_score_backend = make_bucketed_scorer(
                self.opt.spanning_scores, self.opt.jump_score, device)
        elif jump_score_backend is None:
            self._jump_score_backend = None
        else:
            raise ValueError(
                f"unknown jump_score_backend {jump_score_backend!r}")

    def clear_edge_data(self):
        self._span_to_complex_regions.clear()

    # ------------------------------------------------------------------

    def _fetch_ref(self, tid: int, beg: int, end: int):
        """Fetch [beg,end) clamped to chromosome; returns
        (seq str, offset, leading_trim, trailing_trim)."""
        chrom_len = self.scanner.chrom_lengths[tid]
        lead = max(0, -beg)
        trail = max(0, end - chrom_len)
        cbeg, cend = max(0, beg), min(chrom_len, end)
        chrom = self.scanner.chrom_names[tid]
        seq = self.fasta.fetch(chrom, cbeg, cend).decode()
        return seq, cbeg, lead, trail

    def get_candidate_assembly_data(self, sv: SVCandidate,
                                    is_find_large_insertions: bool,
                                    defer_spanning: bool = False
                                    ) -> AssemblyData:
        """defer_spanning: stop the spanning (DNA jump) path after
        assembly and record the alignment-job context on the returned
        data (pending_prep) so contig scoring can be batched across
        junctions and edges in one backend dispatch; the caller then
        completes it with finish_deferred. RNA and complex paths always
        run to completion."""
        data = AssemblyData()
        if is_spanning_sv(sv):
            data.is_candidate_spanning = True
            prep = self._prepare_jump_assembly(sv, is_find_large_insertions,
                                               data)
            if prep is not None:
                if defer_spanning and not self.is_rna and \
                        self._jump_score_backend is not None and \
                        len(data.contigs) > 1:
                    data.pending_prep = prep
                else:
                    self._finish_jump_assembly(sv, data, prep)
        elif is_complex_sv(sv):
            data.is_candidate_spanning = False
            self._get_small_sv_assembly(sv, is_find_large_insertions, data)
        else:
            raise AssertionError("Unknown candidate SV type")
        return data

    def finish_deferred(self, sv: SVCandidate, data: AssemblyData, scores):
        """Complete a deferred spanning path with pre-computed batch
        scores (one slice of the cross-edge dispatch)."""
        prep = data.pending_prep
        data.pending_prep = None
        self._finish_jump_assembly(sv, data, prep, scores=scores)

    # ------------------------------------------------------------------
    # spanning path

    def _get_jump_assembly(self, sv: SVCandidate, is_find_large_insertions,
                           data: AssemblyData):
        prep = self._prepare_jump_assembly(sv, is_find_large_insertions,
                                           data)
        if prep is not None:
            self._finish_jump_assembly(sv, data, prep)

    def _prepare_jump_assembly(self, sv: SVCandidate,
                               is_find_large_insertions,
                               data: AssemblyData):
        """Front half of getJumpAssembly (reference:
        getJumpAssembly:1745-1860): complex handoff, breakend
        orientation, reference fetch, spanning assembly. Returns the
        contig-alignment job context, or None when the candidate was
        handed to the small-SV assembler. Split from the alignment/
        selection stage so contig scoring can be batched across
        junctions and edges (device or native score-only backends)."""
        # (reference: getJumpAssembly:1745-1760) RNA contigs may span
        # large introns, so the alignment reference is much wider
        extra_edge = 25000 if self.is_rna else 250
        extra_split = 100
        extra = extra_edge + extra_split

        if sv.bp1.interval.tid == sv.bp2.interval.tid and \
                not is_same_orientation(sv.bp1.state, sv.bp2.state):
            t = get_sv_type(sv)
            if t == SV_INDEL:
                # candidate breakend regions too close: hand off to the
                # local assembler
                if self._is_ref_region_overlap(extra, sv):
                    single = sv.copy()
                    single.bp1 = sv.bp1.copy()
                    single.bp2 = sv.bp2.copy()
                    single.bp1.state = BND_COMPLEX
                    single.bp2.state = BND_UNKNOWN
                    single.bp1.interval.beg = min(sv.bp1.interval.beg,
                                                  sv.bp2.interval.beg)
                    single.bp1.interval.end = max(sv.bp1.interval.end,
                                                  sv.bp2.interval.end)
                    self._get_small_sv_assembly(single,
                                                is_find_large_insertions, data)
                    return None

        data.is_spanning = True
        bpo = data.bporient
        bpo.is_bp1_first = sv.is_forward_strand()
        bpo.is_transcript_strand_known = sv.is_transcript_strand_known()
        if sv.bp1.state != sv.bp2.state:
            if sv.bp2.state == BND_RIGHT_OPEN:
                bpo.is_bp2_aligned_first = True
        else:
            if sv.bp1.state == BND_RIGHT_OPEN:
                bpo.is_bp2_reversed = True
            else:
                bpo.is_bp1_reversed = True

        # reference segments
        ref1, off1, lead1, trail1 = self._fetch_ref(
            sv.bp1.interval.tid, sv.bp1.interval.beg - extra,
            sv.bp1.interval.end + extra)
        ref2, off2, lead2, trail2 = self._fetch_ref(
            sv.bp2.interval.tid, sv.bp2.interval.beg - extra,
            sv.bp2.interval.end + extra)
        data.bp1ref = (ref1, off1)
        data.bp2ref = (ref2, off2)
        a1_lead = max(0, extra_split - lead1)
        a1_trail = max(0, extra_split - trail1)
        a2_lead = max(0, extra_split - lead2)
        a2_trail = max(0, extra_split - trail2)

        data.contigs = self._spanning_assembler.assemble_spanning(
            sv.bp1, sv.bp2, bpo.is_bp1_reversed, bpo.is_bp2_reversed,
            np.frombuffer(ref1.encode(), np.uint8), off1,
            np.frombuffer(ref2.encode(), np.uint8), off2)

        bp1_seq, bp2_seq = ref1, ref2
        if bpo.is_bp1_reversed:
            bp1_seq = revcomp(bp1_seq)
            a1_lead, a1_trail = a1_trail, a1_lead
        if bpo.is_bp2_reversed:
            bp2_seq = revcomp(bp2_seq)
            a2_lead, a2_trail = a2_trail, a2_lead
        align1_ref, align2_ref = bp1_seq, bp2_seq
        if bpo.is_bp2_aligned_first:
            align1_ref, align2_ref = align2_ref, align1_ref
            a1_lead, a2_lead = a2_lead, a1_lead
            a1_trail, a2_trail = a2_trail, a1_trail
        return {
            "align1_ref": align1_ref, "align2_ref": align2_ref,
            "a1_lead": a1_lead, "a2_lead": a2_lead,
            "a1_trail": a1_trail, "a2_trail": a2_trail,
            "r1": align1_ref[a1_lead:len(align1_ref) - a1_trail],
            "r2": align2_ref[a2_lead:len(align2_ref) - a2_trail],
        }

    def jump_jobs(self, data: AssemblyData, prep) -> list:
        """(query, ref1, ref2) byte triples for the score backend."""
        r1 = prep["r1"].encode()
        r2 = prep["r2"].encode()
        return [(c.seq.encode(), r1, r2) for c in data.contigs]

    def _align_contig_full(self, data: AssemblyData, prep, ci: int):
        """Full traceback alignment of one contig, including the
        near-edge re-alignment fallback against the uncut references
        (reference: alignJumpContigs:1524-1570)."""
        contig = data.contigs[ci]
        r1, r2 = prep["r1"], prep["r2"]
        res = self._spanning_aligner.align(contig.seq.encode(),
                                           r1.encode(), r2.encode())
        used_a1_lead, used_a2_lead = prep["a1_lead"], prep["a2_lead"]
        if res.jump_insert_size > 0:
            min_buffer = 5
            ref1_end = len(r1) - 1
            align1_end = res.align1.begin_pos + \
                cg.ref_length(res.align1.ops, res.align1.lens)
            close1 = (ref1_end - align1_end) < min_buffer
            close2 = res.align2.begin_pos < min_buffer
            if close1 or close2:
                res = self._spanning_aligner.align(
                    contig.seq.encode(), prep["align1_ref"].encode(),
                    prep["align2_ref"].encode())
                used_a1_lead = used_a2_lead = 0
        res.align1.begin_pos += used_a1_lead
        res.align2.begin_pos += used_a2_lead
        return res

    def _extend_contig(self, data: AssemblyData, prep, ci: int, res) -> str:
        ext1 = prep["align1_ref"][:res.align1.begin_pos]
        a2_end = res.align2.begin_pos + cg.ref_length(res.align2.ops,
                                                      res.align2.lens)
        ext2 = prep["align2_ref"][a2_end:]
        return ext1 + data.contigs[ci].seq + ext2

    def _finish_jump_assembly(self, sv: SVCandidate, data: AssemblyData,
                              prep, scores=None):
        """Back half of getJumpAssembly: contig alignment + selection
        (reference: alignJumpContigs:1524 + selectJumpContigDNA:1364).

        With batch scores (device or native score-only backend), contigs
        are tracebacked in descending effective-score order and the
        first segment-QC pass wins — identical selection to aligning
        everything, since max scores are tie-order independent and the
        scalar tie-break (lowest index among equal scores) is preserved
        by the (-score, index) heap order."""
        contig_count = len(data.contigs)
        if self.is_rna:
            for contig in data.contigs:
                res = self._align_rna_contig(sv, data.bporient, contig,
                                             prep["r1"], prep["r2"])
                res.align1.begin_pos += prep["a1_lead"]
                res.align2.begin_pos += prep["a2_lead"]
                data.spanning_alignments.append(res)
                data.extended_contigs.append(
                    self._extend_contig(data, prep,
                                        len(data.extended_contigs), res))
            if not self._select_jump_contig_rna(data):
                return
        else:
            if scores is None and self._jump_score_backend is not None \
                    and contig_count > 1:
                # a single contig needs the full traceback regardless,
                # so pre-scoring it would only add work
                scores = self._jump_score_backend(self.jump_jobs(data, prep))
            if scores is None:
                # legacy path: full-align every contig, select among
                # QC passes by max score (first index wins ties)
                for ci in range(contig_count):
                    res = self._align_contig_full(data, prep, ci)
                    data.spanning_alignments.append(res)
                    data.extended_contigs.append(
                        self._extend_contig(data, prep, ci, res))
                best = -1
                best_res = None
                for ci, res in enumerate(data.spanning_alignments):
                    if _is_jump_segment_qc_fail(res.align1) or \
                            _is_jump_segment_qc_fail(res.align2):
                        continue
                    if best == -1 or res.score > best_res.score:
                        best = ci
                        best_res = res
            else:
                import heapq
                heap = [(-int(scores[ci]), ci)
                        for ci in range(contig_count)]
                heapq.heapify(heap)
                aligned: dict[int, object] = {}
                best = -1
                best_res = None
                while heap:
                    negs, ci = heapq.heappop(heap)
                    res = aligned.get(ci)
                    if res is None:
                        res = self._align_contig_full(data, prep, ci)
                        aligned[ci] = res
                        if res.score != -negs:
                            # the near-edge fallback re-aligned against
                            # the uncut refs; re-rank with its score
                            heapq.heappush(heap, (-res.score, ci))
                            continue
                    if _is_jump_segment_qc_fail(res.align1) or \
                            _is_jump_segment_qc_fail(res.align2):
                        continue
                    best = ci
                    best_res = res
                    break
                data.spanning_alignments = [aligned.get(ci)
                                            for ci in range(contig_count)]
                data.extended_contigs = [
                    "" if aligned.get(ci) is None else
                    self._extend_contig(data, prep, ci, aligned[ci])
                    for ci in range(contig_count)]
            if best == -1 or _is_low_quality_jump_alignment(
                    best_res, self._contig_filter_scores):
                return
            data.best_alignment_index = best

        new_sv = sv.copy()
        self._generate_refined_from_jump(data, new_sv)
        data.svs.append(new_sv)

    def _align_rna_contig(self, sv, bpo, contig, r1: str, r2: str):
        """Kmer-masked splice-aware contig alignment
        (reference: alignJumpContigs RNA branch:1580-1650)."""
        cut1, excl1 = kmer_mask_reference(r1, contig.seq)
        cut2, excl2 = kmer_mask_reference(r2, contig.seq)
        # strand of the fusion transcript at each breakend
        if bpo.is_bp1_first:
            bp1_fw = (sv.bp1.state == BND_RIGHT_OPEN)
            bp2_fw = (sv.bp2.state == BND_LEFT_OPEN)
        else:
            bp1_fw = (sv.bp1.state == BND_LEFT_OPEN)
            bp2_fw = (sv.bp2.state == BND_RIGHT_OPEN)
        f1 = bpo.is_bp1_reversed != bp1_fw
        f2 = bpo.is_bp2_reversed != bp2_fw
        if bpo.is_bp2_aligned_first:
            f1, f2 = f2, f1
        res = self._rna_spanning_aligner.align(
            contig.seq.encode(), cut1.encode(), cut2.encode(),
            f1, f2, bpo.is_transcript_strand_known, seqmatch=False)
        ok = translate_masked_alignment(res.align1, excl1) and \
            translate_masked_alignment(res.align2, excl2)
        if not ok:
            res.align1.ops = np.zeros(0, np.int32)
            res.align1.lens = np.zeros(0, np.int32)
            res.align2.ops = np.zeros(0, np.int32)
            res.align2.lens = np.zeros(0, np.int32)
            return res
        from ..align.aligners import add_seqmatch
        if res.align1.is_aligned:
            res.align1.ops, res.align1.lens = add_seqmatch(
                contig.seq.encode(), r1.encode(), res.align1.begin_pos,
                res.align1.ops, res.align1.lens)
        if res.align2.is_aligned:
            qoff = (cg.read_length(res.align1.ops, res.align1.lens)
                    if res.align1.is_aligned else 0) + res.jump_insert_size
            res.align2.ops, res.align2.lens = add_seqmatch(
                contig.seq.encode(), r2.encode(), res.align2.begin_pos,
                res.align2.ops, res.align2.lens, qoff)
        return res

    def _select_jump_contig_rna(self, data) -> bool:
        """(reference: selectJumpContigRNA:1312-1360)."""
        good = []
        for ci, res in enumerate(data.spanning_alignments):
            if _is_jump_segment_qc_fail(res.align1) or \
                    _is_jump_segment_qc_fail(res.align2):
                continue
            if _is_low_quality_jump_alignment(
                    res, self._contig_filter_scores, is_rna=True):
                continue
            good.append(ci)
        if not good:
            return False
        max_score = 0
        selected = good[0]
        for ci in good:
            if data.spanning_alignments[ci].score > max_score:
                max_score = data.spanning_alignments[ci].score
                selected = ci
        for ci in good:
            sufficient = data.spanning_alignments[ci].score * 2 > max_score
            more_reads = len(data.contigs[ci].support_reads) > \
                len(data.contigs[selected].support_reads)
            if sufficient and more_reads:
                selected = ci
        data.best_alignment_index = selected
        return True

    def _is_ref_region_overlap(self, extra: int, sv: SVCandidate) -> bool:
        if sv.bp1.interval.tid != sv.bp2.interval.tid:
            return False
        chrom_len = self.scanner.chrom_lengths[sv.bp1.interval.tid]

        def clamp(iv):
            return (max(0, iv.beg - extra), min(chrom_len, iv.end + extra))

        r1 = clamp(sv.bp1.interval)
        r2 = clamp(sv.bp2.interval)
        return r1[0] < r2[1] and r2[0] < r1[1]

    def _generate_refined_from_jump(self, data: AssemblyData,
                                    sv: SVCandidate):
        """(reference:
        generateRefinedVCFSVCandidateFromJumpAlignment:1228-1252)."""
        res = data.spanning_alignments[data.best_alignment_index]
        bp1_align, bp2_align = res.align1, res.align2
        if data.bporient.is_bp2_aligned_first:
            bp1_align, bp2_align = bp2_align, bp1_align
        sv.assembly_align_index = data.best_alignment_index
        sv.assembly_segment_index = 0
        sv.is_imprecise = False
        _adjust_assembled_breakend(
            bp1_align, not data.bporient.is_bp2_aligned_first, res.jump_range,
            len(data.bp1ref[0]), data.bp1ref[1],
            data.bporient.is_bp1_reversed, sv.bp1)
        _adjust_assembled_breakend(
            bp2_align, data.bporient.is_bp2_aligned_first, res.jump_range,
            len(data.bp2ref[0]), data.bp2ref[1],
            data.bporient.is_bp2_reversed, sv.bp2)
        contig = data.contigs[data.best_alignment_index]
        sv.insert_seq = ""
        if res.jump_insert_size > 0:
            align1_size = cg.read_length(res.align1.ops, res.align1.lens)
            ins = contig.seq[align1_size:align1_size + res.jump_insert_size]
            if data.bporient.is_bp1_reversed:
                ins = revcomp(ins)
            sv.insert_seq = ins
        if self.is_output_contig:
            # (reference: SVCandidateAssemblyRefiner.cpp:1243-1246)
            sv.contig_seq = contig.seq
        _add_cigar_to_spanning(sv)

    # ------------------------------------------------------------------
    # complex path

    def _get_small_sv_assembly(self, sv: SVCandidate,
                               is_find_large_insertions: bool,
                               data: AssemblyData):
        data.is_spanning = False
        iv = sv.bp1.interval
        if data.is_candidate_spanning:
            self._span_to_complex_regions.add(iv.tid, iv.beg, iv.end)
        else:
            if self._span_to_complex_regions.is_subset(iv.tid, iv.beg, iv.end):
                data.is_overlap_skip = True
                return

        extra_edge = 700
        extra_split = 100
        extra = extra_edge + extra_split

        ref, off, lead_trim, trail_trim = self._fetch_ref(
            iv.tid, iv.beg - extra, iv.end + extra)
        data.bp1ref = (ref, off)
        max_leading_cut = max(0, extra - lead_trim)
        max_trailing_cut = max(0, extra - trail_trim)
        leading_cut = max(0, max_leading_cut - extra_edge)
        trailing_cut = max(0, max_trailing_cut - extra_edge)

        search_remote = self.enable_remote_read_retrieval and \
            is_find_large_insertions
        refarr = np.frombuffer(ref.encode(), np.uint8)
        data.contigs = self._small_assembler.assemble_complex(
            sv.bp1, refarr, off, search_remote, data.remote_reads)

        contig_count = len(data.contigs)
        data.small_sv_alignments = [None] * contig_count
        data.small_sv_segments = [[] for _ in range(contig_count)]
        data.large_insert_info = [LargeInsertionInfo()
                                  for _ in range(contig_count)]
        data.extended_contigs = [""] * contig_count

        rank1 = {"defined": False, "score": 0, "index": 0, "variant_size": 0,
                 "is_jumped": False}
        rank2 = dict(rank1)
        large_insertion_candidates = []

        for ci, contig in enumerate(data.contigs):
            assert contig.seq, "zero-length contig"
            # kmer-guided reference cut adjustment
            mer = 10
            contig_hash = {contig.seq[k:k + mer]
                           for k in range(max(0, len(contig.seq) - mer + 1))}
            ref_size = len(ref)
            min_ref_index = leading_cut
            max_ref_index = ref_size - (trailing_cut + mer)
            max_fwd = min(max_leading_cut, max_ref_index)
            ri = min_ref_index
            while ri <= max_fwd:
                if ref[ri:ri + mer] in contig_hash:
                    break
                ri += 1
            adj_lead = ri
            min_rev = max(min_ref_index, ref_size - max_trailing_cut)
            ri = max_ref_index
            while ri >= min_rev:
                if ref[ri:ri + mer] in contig_hash:
                    break
                ri -= 1
            adj_trail = ref_size - (ri + mer)

            cut_ref = ref[adj_lead:ref_size - adj_trail]
            res = self._large_sv_aligner.align(contig.seq.encode(),
                                               cut_ref.encode())
            res.align.begin_pos += adj_lead
            data.small_sv_alignments[ci] = res
            ext1 = ref[:res.align.begin_pos]
            aend = res.align.begin_pos + cg.ref_length(res.align.ops,
                                                       res.align.lens)
            data.extended_contigs[ci] = ext1 + contig.seq + ref[aend:]

            is_small_cand = False
            for span in (100, 200):
                segments = find_candidate_variants_from_complex_alignment(
                    span, self._contig_filter_scores, res.align, contig.seq,
                    ref, self.min_candidate_variant_size)
                if segments:
                    if len(segments) > len(data.small_sv_segments[ci]):
                        data.small_sv_segments[ci] = segments
                    is_small_cand = True

            if is_find_large_insertions:
                info = self._check_large_insert(contig, res)
                if info is not None:
                    data.large_insert_info[ci] = info
                    large_insertion_candidates.append(ci)

            if is_small_cand:
                def refresh(rank):
                    rank["defined"] = True
                    rank["index"] = ci
                    rank["score"] = res.score
                    rank["variant_size"] = get_largest_indel_size(
                        res.align.ops, res.align.lens,
                        data.small_sv_segments[ci])
                    rank["is_jumped"] = res.is_jumped

                both_jumped = res.is_jumped and rank1["is_jumped"]
                both_not = (not res.is_jumped) and (not rank1["is_jumped"])
                if (not rank1["defined"]) or \
                        (res.is_jumped and not rank1["is_jumped"]) or \
                        ((both_jumped or both_not)
                         and res.score > rank1["score"]):
                    if rank1["defined"]:
                        rank2 = dict(rank1)
                    refresh(rank1)
                elif (not rank2["defined"]) or res.score > rank2["score"]:
                    refresh(rank2)

        if rank2["defined"]:
            r1_support = len(data.contigs[rank1["index"]].support_reads)
            r2_support = len(data.contigs[rank2["index"]].support_reads)
            rank1_selected = rank1["is_jumped"] and not rank2["is_jumped"]
            if not rank1_selected:
                rank2_best = (rank2["score"] > rank1["score"] * 0.9) and \
                    ((r2_support > r1_support * 1.2) or
                     (rank2["variant_size"] > rank1["variant_size"] * 1.1))
                if rank2_best:
                    rank1 = rank2

        ins_pos = set()
        if rank1["defined"]:
            data.best_alignment_index = rank1["index"]
            best_contig = data.contigs[rank1["index"]]
            best_align = data.small_sv_alignments[rank1["index"]]
            for seg_index, seg_range in enumerate(
                    data.small_sv_segments[rank1["index"]]):
                new_sv = sv.copy()
                new_sv.assembly_align_index = rank1["index"]
                new_sv.assembly_segment_index = seg_index
                set_small_cand_sv(ref, off, best_contig.seq, best_align.align,
                                  seg_range, new_sv,
                                  is_output_contig=self.is_output_contig)
                if get_extended_sv_type(new_sv) == EXT_INSERT:
                    ins_pos.add(new_sv.bp1.interval.beg)
                data.svs.append(new_sv)

        if is_find_large_insertions:
            self._process_large_insertion(
                sv, leading_cut, trailing_cut, large_insertion_candidates,
                ins_pos, data)

    def _check_large_insert(self, contig, res):
        """(reference: large insertion candidate check in
        getSmallSVAssembly:1706-1744)."""
        cons_ops, cons_lens = limit_read_length(
            contig.conservative_beg, contig.conservative_end,
            res.align.ops, res.align.lens)
        info = self._is_large_insert_alignment(cons_ops, cons_lens)
        if info is None:
            return None
        info2 = self._is_large_insert_alignment(res.align.ops, res.align.lens)
        if info2 is None:
            return None
        if info.is_left_candidate != info2.is_left_candidate or \
                info.is_right_candidate != info2.is_right_candidate:
            return None
        info.contig_offset = info2.contig_offset
        info.ref_offset = info2.ref_offset
        return info

    def _is_large_insert_segment(self, ops, lens, trim_insert_length=0):
        """(reference: isLargeInsertSegment:563-609).
        Returns (ok, contig_offset, ref_offset, score)."""
        scores = self._large_insert_edge_scores
        path_size = cg.read_length(ops, lens)
        score, contig_off, ref_off = max_path_score(scores, ops, lens)
        score = max(0, score)
        if ref_off < 40 or contig_off < 40:
            return (False, contig_off, ref_off, score)
        if (path_size - contig_off) < (40 + trim_insert_length):
            return (False, contig_off, ref_off, score)
        optimal = contig_off * scores.match
        if optimal <= 0 or score / optimal < 0.75:
            return (False, contig_off, ref_off, score)
        return (True, contig_off, ref_off, score)

    def _is_large_insert_alignment(self, ops, lens):
        """(reference: isLargeInsertAlignment:611-640)."""
        info = LargeInsertionInfo()
        ok, coff, roff, score = self._is_large_insert_segment(ops, lens)
        if ok:
            info.is_left_candidate = True
            info.contig_offset = coff
            info.ref_offset = roff
            info.score = score
            return info
        rops, rlens = ops[::-1].copy(), lens[::-1].copy()
        ok, coff, roff, score = self._is_large_insert_segment(rops, rlens)
        if ok:
            info.is_right_candidate = True
            info.contig_offset = cg.read_length(ops, lens) - coff
            info.ref_offset = cg.ref_length(ops, lens) - roff
            info.score = score
            return info
        return None

    def _process_large_insertion(self, sv, leading_cut, trailing_cut,
                                 candidates, excluded_pos, data):
        """(reference: processLargeInsertion:833-1007)."""
        if not candidates:
            return
        best_pair = None
        best_dist = 0
        best_score = 0
        for i1 in range(len(candidates) - 1):
            c1 = candidates[i1]
            a1 = data.small_sv_alignments[c1].align
            in1 = data.large_insert_info[c1]
            for i2 in range(i1 + 1, len(candidates)):
                c2 = candidates[i2]
                a2 = data.small_sv_alignments[c2].align
                in2 = data.large_insert_info[c2]
                if not ((in1.is_left_candidate and in2.is_right_candidate) or
                        (in2.is_left_candidate and in1.is_right_candidate)):
                    continue
                dist = abs((a1.begin_pos + in1.ref_offset)
                           - (a2.begin_pos + in2.ref_offset))
                if dist > 35:
                    continue
                score = in1.score + in2.score
                better = (dist < best_dist) or \
                    (dist == best_dist and score > best_score)
                if best_pair is None or better:
                    left, right = c1, c2
                    if in1.is_right_candidate:
                        left, right = right, left
                    best_pair = (left, right)
                    best_dist = dist
                    best_score = score
        if best_pair is None:
            return

        ref = data.bp1ref[0]
        middle = "N" * 100
        left_contig = data.contigs[best_pair[0]]
        right_contig = data.contigs[best_pair[1]]
        fake_seq = left_contig.seq + middle + right_contig.seq
        sub_ref = ref[leading_cut:len(ref) - trailing_cut]
        fake_align = self._large_insert_complete_aligner.align(
            fake_seq.encode(), sub_ref.encode())
        fake_align.align.begin_pos += leading_cut
        fake_segments = get_largest_insert_segment(
            fake_align.align.ops, fake_align.align.lens, len(middle))
        if len(fake_segments) != 1 or \
                fake_segments[0][1] < fake_segments[0][0]:
            return
        if not self._is_finished_large_insert(
                fake_align.align.ops, fake_align.align.lens,
                fake_segments[0], len(middle)):
            return
        # insert trim range on the fake contig
        seg = fake_segments[0]
        read_pos = 0
        trim_beg = trim_end = 0
        for i, (o, l) in enumerate(zip(fake_align.align.ops.tolist(),
                                       fake_align.align.lens.tolist())):
            if i == seg[0]:
                trim_beg = read_pos
            if o in cg.READ_LEN_OPS:
                read_pos += l
            if i == seg[1]:
                trim_end = read_pos
                break
        min_flank = 40
        if trim_beg + min_flank > len(left_contig.seq):
            return
        right_offset = len(left_contig.seq) + len(middle)
        if right_offset + min_flank > trim_end:
            return

        contig_count = len(data.contigs)
        from ..assembly.assembler import AssembledContig
        fake_contig = AssembledContig(seq=fake_seq)
        data.contigs.append(fake_contig)
        data.small_sv_alignments.append(fake_align)
        data.small_sv_segments.append(fake_segments)
        aend = fake_align.align.begin_pos + cg.ref_length(
            fake_align.align.ops, fake_align.align.lens)
        data.extended_contigs.append(
            ref[:fake_align.align.begin_pos] + fake_seq + ref[aend:])

        new_sv = sv.copy()
        new_sv.assembly_align_index = contig_count
        new_sv.assembly_segment_index = 0
        set_small_cand_sv(ref, data.bp1ref[1], fake_seq, fake_align.align,
                          fake_segments[0], new_sv,
                          is_output_contig=self.is_output_contig)
        if new_sv.bp1.interval.beg in excluded_pos:
            return
        new_sv.is_unknown_size_insertion = True
        new_sv.unknown_size_insertion_left_seq = left_contig.seq[trim_beg:]
        new_sv.unknown_size_insertion_right_seq = \
            right_contig.seq[:trim_end - right_offset]
        data.svs.append(new_sv)

    def _is_finished_large_insert(self, ops, lens, seg, middle_size):
        """(reference: isFinishedLargeInsertAlignment:642-675)."""
        left_ops = ops[:seg[1] + 1]
        left_lens = lens[:seg[1] + 1]
        ok_left, _, _, _ = self._is_large_insert_segment(
            left_ops, left_lens, middle_size)
        right_ops = ops[seg[0]:][::-1].copy()
        right_lens = lens[seg[0]:][::-1].copy()
        ok_right, _, _, _ = self._is_large_insert_segment(
            right_ops, right_lens, middle_size)
        return ok_left and ok_right
