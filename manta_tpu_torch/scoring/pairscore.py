"""Read-pair evidence gathering for SV scoring.

Behavioral parity with the reference pair scoring path
(reference: GenerateSVCandidates/SVScorerPair.cpp,
SVScorePairProcessor.{hpp,cpp}, SVScorePairRefProcessor.cpp,
SVScorePairAltProcessor.cpp): existing alt-pair transfer from the
candidate fragment bank, alt/ref pair processors streaming reads around
breakend centers, fragment-size cdf support probabilities, and
shadow/chimera realignment for large insertions.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..align.aligners import AlignmentScores, GlobalAligner
from ..core import cigar as cg
from ..core.svmodel import (
    BND_RIGHT_OPEN, SVCandidate, get_sv_type, SV_INDEL,
)
from ..candidates.assembler_reads import revcomp
from ..candidates.refiner import path_score
from ..io.bam import (
    FLAG_MATE_REVERSE, FLAG_MATE_UNMAPPED, FLAG_PAIRED, FLAG_PROPER_PAIR,
    FLAG_READ1, FLAG_REVERSE, FLAG_UNMAPPED,
)
from .fragbank import AL_ALT, AL_REF


@dataclass
class PairOptions:
    """(reference: SVScorerPairOptions.hpp)."""
    min_frag_support: int = 50
    min_frag_prob: float = 0.0001
    rna: bool = False
    use_proper_pair_flag: bool = False


def is_large_insert_sv(sv: SVCandidate) -> bool:
    return len(sv.insert_seq) >= 100


def _set_allele_frag(frag_distro, size: int, track, row: int, allele: int,
                     bp: int, rna: bool, min_frag_prob: float):
    """(reference: SVScorePairProcessor.hpp setAlleleFrag)."""
    frag_prob = frag_distro.cdf(size)
    frag_prob = min(frag_prob, 1 - frag_prob)
    if rna:
        frag_prob = max(frag_prob, min_frag_prob)
    track.set_pair_support(row, allele, bp, frag_prob)


def read_rg_distro(rg_distros, default_distro, batch, i: int):
    """Fragment-size distribution for one read: its own read group's
    when the file has several (per-(file, RG) stats; reference:
    ReadGroupLabel.hpp:38), else the file's distribution."""
    if not rg_distros:
        return default_distro
    v = batch.get_tag(i, b"RG")
    return rg_distros.get(v if v is not None else "", default_distro)


def _cdf_per_rg(proc, batch, idx, sizes) -> np.ndarray:
    """Per-read fragment-size cdf routed through each read's RG
    distribution (float64, matching the scalar path)."""
    if not getattr(proc, "rg_distros", None):
        return proc.frag_distro.cdf_arr(sizes).astype(np.float64)
    out = np.empty(len(idx), np.float64)
    for j, i in enumerate(idx):
        d = read_rg_distro(proc.rg_distros, proc.frag_distro, batch, int(i))
        out[j] = d.cdf(int(sizes[j]))
    return out


def _is_first_read(batch, i) -> bool:
    """The upstream read of a pair (reference:
    htsapi/bam_record_util.hpp:70-75): pos < mate pos, with the
    read1 flag breaking position ties."""
    pos = int(batch.pos[i])
    mate = int(batch.next_pos[i])
    if pos < mate:
        return True
    return pos == mate and bool(batch.flag[i] & FLAG_READ1)


class PairProcessorParams:
    """(reference: SVScorePairInitParams + bamParams)."""

    def __init__(self, scanner, sv: SVCandidate, is_bp1: bool,
                 pair_opt: PairOptions):
        c1 = sv.bp1.interval.center_pos()
        c2 = sv.bp2.interval.center_pos()
        self.center_pos = c1 if is_bp1 else c2
        is_bp1_lower = c1 <= c2
        self.center_pos_a = c1 if is_bp1_lower else c2
        self.center_pos_b = c2 if is_bp1_lower else c1
        alt_ins_size = len(sv.insert_seq)
        if sv.is_unknown_size_insertion:
            alt_ins_size = len(sv.unknown_size_insertion_left_seq) + \
                len(sv.unknown_size_insertion_right_seq)
        self.alt_shift = (self.center_pos_b - self.center_pos_a) - alt_ins_size
        self.min_mapq = scanner.opt.min_mapq
        self.min_tier2_mapq = scanner.opt.min_tier2_mapq
        self.pair_opt = pair_opt
        self.is_bp1 = is_bp1
        self.sv = sv
        self.scanner = scanner

    def interval_for_bam(self, bam_index: int):
        st = self.scanner.stats[bam_index]
        self.min_frag = int(st.evidence_pair[0])
        self.max_frag = int(st.evidence_pair[1])
        self.frag_distro = self.scanner.frag_dists[bam_index]
        self.rg_distros = self.scanner.rg_frag_dists[bam_index]
        max_supported = self.max_frag - self.pair_opt.min_frag_support
        beg = self.center_pos - max_supported
        end = self.center_pos + max_supported + 1
        bp = self.sv.bp1 if self.is_bp1 else self.sv.bp2
        self.interval = (bp.interval.tid, beg, end)
        return self.interval


def _skip_record_mask(batch) -> np.ndarray:
    """Vectorized isSkipRecord (reference:
    SVScorePairProcessor::isSkipRecord): unmapped, mate-unmapped, or
    non-innie records are never pair evidence."""
    from ..core.readfilter import is_innie_pair
    f = batch.flag
    unmapped = (f & FLAG_UNMAPPED) != 0
    mate_un = ((f & FLAG_PAIRED) != 0) & ((f & FLAG_MATE_UNMAPPED) != 0)
    return unmapped | mate_un | ~is_innie_pair(batch)


class RefPairProcessor(PairProcessorParams):
    """(reference: SVScorePairRefProcessor)."""

    def __init__(self, scanner, sv, is_bp1, pair_opt, evidence_tracks):
        super().__init__(scanner, sv, is_bp1, pair_opt)
        self.evidence_tracks = evidence_tracks

    def is_skip_record(self, batch, i) -> bool:
        f = int(batch.flag[i])
        if (f & FLAG_UNMAPPED) or ((f & FLAG_PAIRED) and (f & FLAG_MATE_UNMAPPED)):
            return True
        from ..scan.scanner import _is_innie_read
        return not _is_innie_read(batch, i)

    def survivor_mask(self, batch) -> np.ndarray:
        """Batch prefilter applying exactly the per-record rejects of
        is_skip_record + process(); process() is only invoked on
        surviving indices (it re-checks cheaply). Records here carry no
        cross-record state, so filtering preserves output exactly."""
        tid, beg, end = self.interval
        pos = batch.pos.astype(np.int64)
        ok = ~_skip_record_mask(batch)
        ok &= (pos >= beg) & (pos < end)
        ts = np.abs(batch.tlen.astype(np.int64))
        if not self.pair_opt.use_proper_pair_flag:
            ok &= (ts >= self.min_frag) & (ts <= self.max_frag)
        else:
            ok &= (batch.flag & FLAG_PROPER_PAIR) != 0
        first = (pos < batch.next_pos) | \
            ((pos == batch.next_pos) & ((batch.flag & FLAG_READ1) != 0))
        frag_beg = np.where(first, pos, batch.next_pos.astype(np.int64))
        frag_end = frag_beg + ts
        overlap = np.minimum(1 + self.center_pos - frag_beg,
                             frag_end - self.center_pos)
        ok &= overlap >= self.pair_opt.min_frag_support
        return ok

    def process_batch(self, batch, order, bam_index):
        """Vectorized process() over survivor_mask survivors: every
        per-record reject is already applied by the mask, so only the
        evidence-bank updates remain. The fragment-size cdf is batched;
        min(p, 1-p) stays in float64 like the scalar path."""
        if len(order) == 0:
            return
        idx = np.asarray(order, np.int64)
        ts = np.abs(batch.tlen[idx].astype(np.int64))
        p32 = _cdf_per_rg(self, batch, idx, ts)
        frag_prob = np.minimum(p32, 1.0 - p32)
        if self.pair_opt.rna:
            frag_prob = np.maximum(frag_prob, self.pair_opt.min_frag_prob)
        mapqs = batch.mapq[idx].astype(np.int32)
        read_lens = (batch.seq_off[idx + 1]
                     - batch.seq_off[idx]).astype(np.int32)
        rds = ((batch.flag[idx] & FLAG_READ1) == 0).astype(np.int64)
        track = self.evidence_tracks[bam_index]
        rows = track.rows_for([batch.name_bytes(int(i)) for i in idx])
        bp = 0 if self.is_bp1 else 1
        # setReadEvidence (first write wins per fragment read); survivor
        # rows are unique per (fragment, read) after the dup/secondary
        # filters, so a masked scatter preserves the sequential result
        new = ~track.r_scanned[rows, rds]
        r_new, d_new = rows[new], rds[new]
        track.r_scanned[r_new, d_new] = True
        track.r_mapq[r_new, d_new] = mapqs[new]
        track.r_shadow[r_new, d_new] = False
        track.r_anch[r_new, d_new] = mapqs[new] >= self.min_mapq
        track.r_t2anch[r_new, d_new] = mapqs[new] >= self.min_tier2_mapq
        track.r_size[r_new, d_new] = read_lens[new]
        track.pair_sup[rows, AL_REF, bp] = True
        track.pair_prob[rows, AL_REF, bp] = frag_prob

    def process(self, batch, i, bam_index):
        pos = int(batch.pos[i])
        tid, beg, end = self.interval
        if not (beg <= pos < end):
            return
        template_size = abs(int(batch.tlen[i]))
        if not self.pair_opt.use_proper_pair_flag:
            if template_size < self.min_frag or template_size > self.max_frag:
                return
        elif not (batch.flag[i] & FLAG_PROPER_PAIR):
            return
        frag_beg = pos if _is_first_read(batch, i) else int(batch.next_pos[i])
        frag_end = frag_beg + template_size
        assert frag_beg <= frag_end
        frag_overlap = min(1 + self.center_pos - frag_beg,
                           frag_end - self.center_pos)
        if frag_overlap < self.pair_opt.min_frag_support:
            return
        track = self.evidence_tracks[bam_index]
        row = track.row(batch.name_bytes(i))
        rd = 0 if (batch.flag[i] & FLAG_READ1) else 1
        track.set_read_evidence(row, rd, self.min_mapq, self.min_tier2_mapq,
                                int(batch.mapq[i]), batch.read_len(i), False)
        distro = read_rg_distro(getattr(self, "rg_distros", None),
                                self.frag_distro, batch, i)
        _set_allele_frag(distro, template_size, track, row,
                         AL_REF, 0 if self.is_bp1 else 1,
                         self.pair_opt.rna, self.pair_opt.min_frag_prob)


class AltPairProcessor(PairProcessorParams):
    """(reference: SVScorePairAltProcessor). Handles INDEL-type
    candidates whose alt fragment-size shift can be computed; includes
    shadow/chimera realignment for large insertions."""

    # the alt processor reuses the spanning aligner scores
    # (reference: SVScorePairAltProcessor.hpp:63)
    SHADOW_SCORES = AlignmentScores(2, -8, -12, -1, -1)

    def __init__(self, scanner, sv, is_bp1, pair_opt, evidence_tracks,
                 assembly_data, sv_id=None, support=None):
        super().__init__(scanner, sv, is_bp1, pair_opt)
        self.sv_id = sv_id
        self.support = support
        assert sv.bp1.interval.tid == sv.bp2.interval.tid
        assert get_sv_type(sv) == SV_INDEL
        assert not sv.is_imprecise
        self.evidence_tracks = evidence_tracks
        self.assembly_data = assembly_data
        self._shadow_aligner = GlobalAligner(self.SHADOW_SCORES)
        self._shadow_last_qname = None
        self._shadow_last_mapq = 0
        self._shadow_set = False
        self._shadow_consumed_mate = False
        self._init_contig(sv)

    def _init_contig(self, sv):
        """(reference: ContigParams ctor)."""
        data = self.assembly_data
        self.ext_seq = data.extended_contigs[sv.assembly_align_index]
        bp1_first = sv.bp1.interval.beg <= sv.bp2.interval.beg
        bpa = sv.bp1 if bp1_first else sv.bp2
        bpb = sv.bp2 if bp1_first else sv.bp1
        bpa_hom = bpa.interval.size() - 1
        bpb_hom = bpb.interval.size() - 1
        self.segment_span = (bpa.interval.beg + 1, bpb.interval.beg)
        if data.is_spanning:
            res = data.spanning_alignments[sv.assembly_align_index]
            align_begin = res.align1.begin_pos
            read_start = cg.read_length(res.align1.ops, res.align1.lens)
        else:
            res = data.small_sv_alignments[sv.assembly_align_index]
            seg = data.small_sv_segments[
                sv.assembly_align_index][sv.assembly_segment_index]
            align_begin = res.align.begin_pos
            read_start = cg.read_length(res.align.ops[:seg[0]],
                                        res.align.lens[:seg[0]])
        a_beg = align_begin + read_start - 1
        self.bpa_offset = (a_beg, a_beg + bpa_hom)
        b_beg = a_beg + len(sv.insert_seq)
        self.bpb_offset = (b_beg, b_beg + bpb_hom)

    def is_skip_record(self, batch, i) -> bool:
        """(reference: SVScorePairAltProcessor::isSkipRecord override:
        large-insert SVs keep unmapped/mate-unmapped records)."""
        if not is_large_insert_sv(self.sv):
            f = int(batch.flag[i])
            if (f & FLAG_UNMAPPED) or \
                    ((f & FLAG_PAIRED) and (f & FLAG_MATE_UNMAPPED)):
                return True
            from ..scan.scanner import _is_innie_read
            return not _is_innie_read(batch, i)
        return False

    def survivor_mask(self, batch) -> np.ndarray | None:
        """Batch prefilter for the stateless (non-large-insert) path;
        the large-insert path tracks shadow anchors across consecutive
        records, so it must see every record (returns None)."""
        if is_large_insert_sv(self.sv):
            return None
        tid, beg, end = self.interval
        pos = batch.pos.astype(np.int64)
        ok = ~_skip_record_mask(batch)
        ok &= (pos >= beg) & (pos < end)
        ts = np.abs(batch.tlen.astype(np.int64))
        alt_ts = ts - self.alt_shift
        anom = (ts < self.min_frag) | (ts > self.max_frag)
        alt_bad = (alt_ts < self.min_frag) | (alt_ts > self.max_frag)
        ok &= ~(anom & alt_bad)
        first = (pos < batch.next_pos) | \
            ((pos == batch.next_pos) & ((batch.flag & FLAG_READ1) != 0))
        frag_beg = np.where(first, pos, batch.next_pos.astype(np.int64))
        frag_end = frag_beg + ts
        overlap = np.minimum(1 + self.center_pos_a - frag_beg,
                             frag_end - self.center_pos_b)
        ok &= overlap >= self.pair_opt.min_frag_support
        return ok

    def process_batch(self, batch, order, bam_index):
        """Vectorized process() for the stateless (non-large-insert) alt
        path; survivor_mask already applied every per-record reject, so
        only the evidence-bank updates and the support hook remain."""
        if len(order) == 0:
            return
        idx = np.asarray(order, np.int64)
        ts = np.abs(batch.tlen[idx].astype(np.int64))
        alt_ts = ts - self.alt_shift
        p_alt = _cdf_per_rg(self, batch, idx, alt_ts)
        alt_prob = np.minimum(p_alt, 1.0 - p_alt)
        p_ref = _cdf_per_rg(self, batch, idx, ts)
        ref_prob = np.minimum(p_ref, 1.0 - p_ref)
        if self.pair_opt.rna:
            alt_prob = np.maximum(alt_prob, self.pair_opt.min_frag_prob)
            ref_prob = np.maximum(ref_prob, self.pair_opt.min_frag_prob)
        mapqs = batch.mapq[idx].astype(np.int32)
        read_lens = (batch.seq_off[idx + 1]
                     - batch.seq_off[idx]).astype(np.int32)
        rds = ((batch.flag[idx] & FLAG_READ1) == 0).astype(np.int64)
        track = self.evidence_tracks[bam_index]
        rows = track.rows_for([batch.name_bytes(int(i)) for i in idx])
        new = ~track.r_scanned[rows, rds]
        r_new, d_new = rows[new], rds[new]
        track.r_scanned[r_new, d_new] = True
        track.r_mapq[r_new, d_new] = mapqs[new]
        track.r_shadow[r_new, d_new] = False
        track.r_anch[r_new, d_new] = mapqs[new] >= self.min_mapq
        track.r_t2anch[r_new, d_new] = mapqs[new] >= self.min_tier2_mapq
        track.r_size[r_new, d_new] = read_lens[new]
        bp = 0 if self.is_bp1 else 1
        track.pair_sup[rows, AL_ALT, bp] = True
        track.pair_prob[rows, AL_ALT, bp] = alt_prob
        track.pair_sup[rows, AL_REF, bp] = True
        track.pair_prob[rows, AL_REF, bp] = ref_prob
        if self.support is not None and self.sv_id is not None:
            # (reference: SVScorePairAltProcessor.cpp:542-544)
            for i in idx:
                sfrag = self.support.get_fragment(bam_index, batch, int(i))
                sfrag.add_spanning_support(self.sv_id)

    def _realign_paired_read(self, is_left_of_insert: bool, float_read: str,
                             anchor_pos: int):
        """(reference: realignPairedRead). Returns alt_template_size or
        None."""
        if is_left_of_insert:
            if anchor_pos >= self.segment_span[0]:
                return None
        else:
            if anchor_pos + len(float_read) <= self.segment_span[1]:
                return None
        assert float_read
        contig = self.ext_seq
        contig_begin_offset = 0
        if self.sv.is_unknown_size_insertion:
            if is_left_of_insert:
                contig = contig[:self.bpa_offset[0]
                                + len(self.sv.unknown_size_insertion_left_seq)]
            else:
                contig_begin_offset = self.bpb_offset[0] - \
                    len(self.sv.unknown_size_insertion_right_seq)
                assert contig_begin_offset >= 0
                contig = contig[contig_begin_offset:]
        assert contig
        res = self._shadow_aligner.align(float_read.encode(), contig.encode())
        read_size = len(float_read)
        clip_size = 0
        if self.sv.is_unknown_size_insertion:
            if is_left_of_insert:
                clip_size = cg.soft_clip_trail_size(res.align.ops,
                                                    res.align.lens)
            else:
                clip_size = cg.soft_clip_lead_size(res.align.ops,
                                                   res.align.lens)
        clipped = read_size - clip_size
        if clipped < 40:
            return None
        non_clip = path_score(self.SHADOW_SCORES, res.align.ops,
                              res.align.lens)
        optimal = clipped * self.SHADOW_SCORES.match
        if non_clip / optimal < 0.85:
            return None
        if is_left_of_insert:
            fake_beg = anchor_pos
            shadow_ref_span = cg.ref_length(res.align.ops, res.align.lens)
            read_contig_end = contig_begin_offset + res.align.begin_pos + \
                shadow_ref_span
            if read_contig_end < self.bpa_offset[0]:
                return None
            fake_end = self.segment_span[0] + \
                (read_contig_end - self.bpa_offset[0])
        else:
            fake_end = anchor_pos + read_size
            read_contig_begin = contig_begin_offset + res.align.begin_pos
            if read_contig_begin > self.bpb_offset[0]:
                return None
            fake_beg = self.segment_span[1] - \
                (self.bpb_offset[0] - read_contig_begin)
        assert fake_beg <= fake_end
        alt_template_size = fake_end - fake_beg
        frag_overlap = min(1 + self.center_pos_a - fake_beg,
                           fake_end - self.center_pos_b)
        if frag_overlap < self.pair_opt.min_frag_support:
            return None
        return alt_template_size

    def process(self, batch, i, bam_index):
        pos = int(batch.pos[i])
        tid, beg, end = self.interval
        if not (beg <= pos < end):
            return
        f = int(batch.flag[i])
        unmapped = bool(f & FLAG_UNMAPPED)
        is_large_insert = is_large_insert_sv(self.sv)
        is_shadow_alignment = False
        is_chimera_alignment = False
        template_size = 0
        alt_template_size = 0
        shadow_mate_mapq = 0

        if is_large_insert:
            # shadow handling (ShadowReadFinder::check emulation): any
            # record consumes a pending anchor; a non-shadow record may
            # then become the new anchor itself, in which case it also
            # gets read evidence recorded (isShadowMate branch)
            is_shadow_read = False
            if self._shadow_set:
                self._shadow_set = False
                if unmapped and not (f & FLAG_MATE_UNMAPPED):
                    qual = batch.qual_arr(i)
                    avg_q = int(qual.sum()) // max(1, len(qual))
                    if avg_q >= 25 and \
                            batch.name_bytes(i) == self._shadow_last_qname:
                        is_shadow_read = True
            if not is_shadow_read:
                # anchor check restricted by strand: left-open search for
                # bp2, right-open for bp1 (reference:
                # SVScorePairAltProcessor.hpp:64-67)
                fwd = (f & FLAG_REVERSE) == 0
                strand_ok = (fwd == self.is_bp1)
                if strand_ok and (f & FLAG_PAIRED) and not unmapped and \
                        (f & FLAG_MATE_UNMAPPED) and batch.mapq[i] >= \
                        self.scanner.opt.min_singleton_mapq_candidates:
                    self._shadow_last_qname = batch.name_bytes(i)
                    self._shadow_last_mapq = int(batch.mapq[i])
                    self._shadow_set = True
                    # this read just became the anchor
                    track = self.evidence_tracks[bam_index]
                    row = track.row(batch.name_bytes(i))
                    rd = 0 if (f & FLAG_READ1) else 1
                    track.set_read_evidence(
                        row, rd, self.min_mapq, self.min_tier2_mapq,
                        int(batch.mapq[i]), batch.read_len(i), False)

            if is_shadow_read:
                is_left = (f & FLAG_MATE_REVERSE) == 0
                if is_left != self.is_bp1:
                    return
                shadow_read = batch.seq_str(i)
                if is_left:
                    shadow_read = revcomp(shadow_read)
                ats = self._realign_paired_read(
                    is_left, shadow_read, int(batch.next_pos[i]))
                if ats is None:
                    return
                alt_template_size = ats
                is_shadow_alignment = True
                shadow_mate_mapq = self._shadow_last_mapq
            else:
                if unmapped or ((f & FLAG_PAIRED) and (f & FLAG_MATE_UNMAPPED)):
                    return

            if not is_shadow_alignment:
                remotes = self.assembly_data.remote_reads
                qname = batch.name_bytes(i)
                if qname in remotes:
                    read_no, remote_seq = remotes[qname]
                    my_no = 2 if (f & 0x80) else 1
                    if read_no != (2 if my_no == 1 else 1):
                        return
                    is_left = (f & FLAG_REVERSE) == 0
                    if is_left != self.is_bp1:
                        return
                    ats = self._realign_paired_read(is_left, remote_seq, pos)
                    if ats is None:
                        return
                    alt_template_size = ats
                    is_chimera_alignment = True
                else:
                    if not (unmapped or (f & FLAG_MATE_UNMAPPED)):
                        from ..scan.scanner import _is_innie_read
                        if not _is_innie_read(batch, i):
                            return

        is_realigned = is_large_insert and \
            (is_shadow_alignment or is_chimera_alignment)

        is_anom_template = True
        if not is_realigned:
            template_size = abs(int(batch.tlen[i]))
            alt_template_size = template_size - self.alt_shift
            is_anom_template = (template_size < self.min_frag
                                or template_size > self.max_frag)
        if is_anom_template:
            if alt_template_size < self.min_frag:
                return
            if alt_template_size > self.max_frag:
                return
        if not is_realigned:
            frag_beg = pos if _is_first_read(batch, i) \
                else int(batch.next_pos[i])
            frag_end = frag_beg + template_size
            assert frag_beg <= frag_end
            frag_overlap = min(1 + self.center_pos_a - frag_beg,
                               frag_end - self.center_pos_b)
            if frag_overlap < self.pair_opt.min_frag_support:
                return

        track = self.evidence_tracks[bam_index]
        row = track.row(batch.name_bytes(i))
        rd = 0 if (f & FLAG_READ1) else 1
        read_size = batch.read_len(i)
        mapq = int(batch.mapq[i])
        if is_shadow_alignment:
            mapq = shadow_mate_mapq
        track.set_read_evidence(row, rd, self.min_mapq, self.min_tier2_mapq,
                                mapq, read_size, is_realigned)
        if is_chimera_alignment:
            track.set_read_evidence(row, 1 - rd, self.min_mapq,
                                    self.min_tier2_mapq, mapq, read_size,
                                    is_realigned)
        bp = 0 if self.is_bp1 else 1
        distro = read_rg_distro(getattr(self, "rg_distros", None),
                                self.frag_distro, batch, i)
        _set_allele_frag(distro, alt_template_size, track, row,
                         AL_ALT, bp, self.pair_opt.rna,
                         self.pair_opt.min_frag_prob)
        if self.support is not None and self.sv_id is not None:
            # (reference: SVScorePairAltProcessor.cpp:542-544)
            sfrag = self.support.get_fragment(bam_index, batch, i)
            sfrag.add_spanning_support(self.sv_id)
        if not is_realigned:
            _set_allele_frag(distro, template_size, track, row,
                             AL_REF, bp, self.pair_opt.rna,
                             self.pair_opt.min_frag_prob)


def get_frag_prob(pair_opt: PairOptions, sv: SVCandidate, fragment,
                  frag_distro, is_strict_match: bool):
    """(reference: getFragProb SVScorerPair.cpp:200-350).
    Returns (is_support, frag_prob)."""
    r1, r2 = fragment.read1, fragment.read2

    def frag_info_from(local):
        b, i = local.batch, local.index
        f = int(b.flag[i])
        local_fwd = (f & FLAG_REVERSE) == 0
        local_size = b.read_len(i)
        local_tid = int(b.refid[i])
        local_beg = int(b.pos[i])
        from ..scan.scanner import get_alignment
        al = get_alignment(b, i)
        local_end = local_beg + al.ref_length
        remote_fwd = (f & FLAG_MATE_REVERSE) == 0
        remote_tid = int(b.next_refid[i])
        remote_beg = int(b.next_pos[i])
        remote_end = remote_beg + local_size
        return ((local_tid, local_beg, local_end, local_fwd, local_size),
                (remote_tid, remote_beg, remote_end, remote_fwd, local_size))

    if r1 is not None:
        i1, i2 = frag_info_from(r1)
        if r2 is not None:
            b2, j2 = r2.batch, r2.index
            from ..scan.scanner import get_alignment
            al2 = get_alignment(b2, j2)
            i2 = (i2[0], i2[1], i2[1] + al2.ref_length, i2[3],
                  b2.read_len(j2))
    elif r2 is not None:
        i2, i1 = frag_info_from(r2)
    else:
        raise AssertionError("neither fragment read found")

    def terminal(info):
        tid, beg, end, fwd, size = info
        return (tid, beg if fwd else end, fwd, size)

    f1 = terminal(i1)
    f2 = terminal(i2)
    same_frag_tid = f1[0] == f2[0]
    same_bp_tid = sv.bp1.interval.tid == sv.bp2.interval.tid
    if same_frag_tid != same_bp_tid:
        if not is_strict_match:
            return False, 0.0
        raise RuntimeError("Can't resolve fragment/sv chromosome pair(s)")

    bp1pos = sv.bp1.interval.center_pos()
    bp2pos = sv.bp2.interval.center_pos()

    reversed_frag = False
    if f1[0] != sv.bp1.interval.tid:
        reversed_frag = True
    elif f1[2] != (sv.bp1.state == BND_RIGHT_OPEN):
        reversed_frag = True
    elif f1[2] == f2[2]:
        if same_frag_tid:
            if (f1[1] < f2[1]) != (bp1pos < bp2pos):
                if f1[1] != f2[1]:
                    reversed_frag = True
    if reversed_frag:
        f1, f2 = f2, f1

    error = None
    if f1[0] != f2[0]:
        if f1[0] != sv.bp1.interval.tid:
            error = "chrom mismatch bp1"
        if f2[0] != sv.bp2.interval.tid:
            error = "chrom mismatch bp2"
    elif f1[2] != f2[2]:
        if f1[2] != (sv.bp1.state == BND_RIGHT_OPEN):
            error = "strand mismatch bp1"
        if f2[2] != (sv.bp2.state == BND_RIGHT_OPEN):
            error = "strand mismatch bp2"
    else:
        if same_frag_tid:
            if (f1[1] < f2[1]) != (bp1pos < bp2pos):
                if f1[1] != f2[1]:
                    error = "position mismatch"
    if error is not None:
        if not is_strict_match:
            return False, 0.0
        raise RuntimeError(f"getFragProb: {error}")

    frag1_size = bp1pos - f1[1]
    if not f1[2]:
        frag1_size = -frag1_size
    frag2_size = bp2pos - f2[1]
    if not f2[2]:
        frag2_size = -frag2_size
    if frag1_size < pair_opt.min_frag_support:
        return False, 0.0
    if frag2_size < pair_opt.min_frag_support:
        return False, 0.0
    frag_prob = frag_distro.cdf(frag1_size + frag2_size)
    frag_prob = min(frag_prob, 1 - frag_prob)
    if pair_opt.rna:
        frag_prob = max(frag_prob, pair_opt.min_frag_prob)
    return (frag_prob >= pair_opt.min_frag_prob), frag_prob
