"""Read -> SV-evidence scanner: the single source of truth shared by
graph building (phase 1) and candidate generation (phase 2).

Behavioral parity with the reference SVLocusScanner
(reference: src/c++/lib/manta/SVLocusScanner.{hpp,cpp}) including:
CIGAR indel candidates (SVLocusScanner.cpp:356), SA-tag split-read
candidates (:236,322), semi-aligned edge candidates (:475 +
SVLocusScannerSemiAligned.cpp), anomalous-pair analysis with
large-event breakend-region scaling (AlignmentPairAnalyzer :547-858),
and the fast isSVEvidence pre-filter (:1437).

Architecture note: the fast pre-filter and pair classification are
vectorized numpy masks over whole ReadBatches (device-friendly);
full candidate generation runs per evidence-read on host.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..core import cigar as cg
from ..core.readfilter import has_sa_tag, is_innie_pair, is_mapped_pair
from ..core.svmodel import (
    BND_COMPLEX,
    BND_LEFT_OPEN,
    BND_RIGHT_OPEN,
    BND_UNKNOWN,
    EV_CIGAR,
    EV_LOCAL_PAIR,
    EV_PAIR,
    EV_SEMIALIGN,
    EV_SPLIT_ALIGN,
    FRAG_READ1,
    FRAG_READ2,
    FRAG_READ_PAIR,
    SVBreakend,
    SVObservation,
)
from ..io.bam import (
    C_D,
    C_I,
    C_M,
    C_S,
    FLAG_MATE_REVERSE,
    FLAG_MATE_UNMAPPED,
    FLAG_PAIRED,
    FLAG_PROPER_PAIR,
    FLAG_READ1,
    FLAG_READ2,
    FLAG_REVERSE,
    FLAG_SECONDARY,
    FLAG_SUPPLEMENTARY,
    FLAG_UNMAPPED,
    ReadBatch,
)


@dataclass
class ScannerOptions:
    """Defaults mirror the reference ReadScannerOptions
    (options/ReadScannerOptions.hpp:25-112) with configManta.py.ini
    overrides applied by the workflow (minCandidateVariantSize=8)."""

    min_mapq: int = 15
    min_tier2_mapq: int = 5
    breakend_edge_quantile_prob: float = 0.25
    large_scale_event_breakend_edge_quantile_prob: float = 0.1
    proper_pair_quantile_prob: float = 0.01
    evidence_trim_quantile_prob: float = 0.15
    shadow_search_distance_quantile_prob: float = 0.05
    shadow_search_distance_factor: float = 1.2
    min_candidate_variant_size: int = 8
    max_candidate_size_for_local_assm_evidence: int = 100
    min_pair_breakend_size: int = 40
    min_semi_aligned_mismatch_len: int = 8
    min_rna_cis_length: int = 100000
    min_rna_length: int = 1000
    min_singleton_mapq_graph: int = 30
    min_singleton_mapq_candidates: int = 15
    use_overlap_pair_evidence: bool = False
    is_ignore_anom_proper_pair: bool = False
    max_depth_factor: float = 12.0
    max_local_depth_factor_for_remote_read_retrieval: float = 7.0

    @property
    def is_small_candidates(self) -> bool:
        return self.min_candidate_variant_size <= \
            self.max_candidate_size_for_local_assm_evidence

    @property
    def before_breakend(self) -> int:
        return self.min_pair_breakend_size // 2

    @property
    def after_breakend(self) -> int:
        return self.min_pair_breakend_size - self.before_breakend


# evidence weights (reference: SVLocusScanner.hpp:68-77)
WEIGHT_OBSERVATION = 3
WEIGHT_READ_PAIR = 3
WEIGHT_CLOSE_READ_PAIR = 1
WEIGHT_INTERNAL_READ_EVENT = 3

CLOSE_PAIR_FACTOR = 4.0
MIN_LARGE_EVENT_REGION_FACTOR = 10.0
MAX_LARGE_EVENT_REGION_FACTOR = 20.0


@dataclass
class CachedReadGroupStats:
    """Summary stats from one fragment-size distribution
    (reference: SVLocusScanner.hpp:241-270, ctor :1276-1329)."""

    breakend_region: tuple[float, float] = (0, 0)
    large_scale_breakend_region: tuple[float, float] = (0, 0)
    proper_pair: tuple[float, float] = (0, 0)
    evidence_pair: tuple[float, float] = (0, 0)
    fifth_perc: tuple[float, float] = (0, 0)
    shadow_search_distance: int = 0
    min_distant_fragment_size: int = 0
    large_event_region_min: int = 0
    large_event_region_max: int = 0

    def large_event_region_scale(self, val: float) -> float:
        f = (val - self.large_event_region_min) / max(
            1e-30, float(self.large_event_region_max - self.large_event_region_min))
        return min(1.0, max(0.0, f))


def _quantile_range(dist, prob: float) -> tuple[float, float]:
    lo = dist.quantile(prob)
    hi = dist.quantile(1 - prob)
    return (max(0.0, float(lo)), float(hi))


def build_cached_stats(dist, opt: ScannerOptions) -> CachedReadGroupStats:
    s = CachedReadGroupStats()
    s.breakend_region = _quantile_range(dist, opt.breakend_edge_quantile_prob)
    s.large_scale_breakend_region = _quantile_range(
        dist, opt.large_scale_event_breakend_edge_quantile_prob)
    s.proper_pair = _quantile_range(dist, opt.proper_pair_quantile_prob)
    s.evidence_pair = _quantile_range(dist, opt.evidence_trim_quantile_prob)
    s.fifth_perc = _quantile_range(dist, 0.05)
    s.shadow_search_distance = int(
        dist.quantile(1 - opt.shadow_search_distance_quantile_prob)
        * opt.shadow_search_distance_factor)
    s.min_distant_fragment_size = int(s.proper_pair[1] * CLOSE_PAIR_FACTOR)
    s.large_event_region_min = int(s.proper_pair[1] * MIN_LARGE_EVENT_REGION_FACTOR)
    s.large_event_region_max = int(s.proper_pair[1] * MAX_LARGE_EVENT_REGION_FACTOR)
    return s


@dataclass
class SimpleAlign:
    """Minimal alignment view (tid, pos, strand, cigar arrays)."""
    tid: int
    pos: int
    is_fwd: bool
    ops: np.ndarray
    lens: np.ndarray

    @property
    def ref_length(self) -> int:
        return cg.ref_length(self.ops, self.lens)

    @property
    def read_length(self) -> int:
        return cg.read_length(self.ops, self.lens)

    @property
    def end_pos(self) -> int:
        return self.pos + self.ref_length


def get_alignment(batch: ReadBatch, i: int) -> SimpleAlign:
    ops, lens = batch.cigar_ops_lens(i)
    return SimpleAlign(
        tid=int(batch.refid[i]), pos=int(batch.pos[i]),
        is_fwd=(batch.flag[i] & FLAG_REVERSE) == 0, ops=ops, lens=lens)


def mate_ref_len_batch(batch: ReadBatch) -> np.ndarray:
    """Mate reference span for every read: MC-tag cigar ref length when
    present, else the read's own length (native batch scan; cached on
    the batch)."""
    cached = getattr(batch, "_mate_ref_len", None)
    if cached is not None:
        return cached
    from .._native import get_lib, i32p, i64p
    lib = get_lib()
    out = np.empty(batch.n, np.int32)
    tags = batch.tags if isinstance(batch.tags, bytes) else bytes(batch.tags)
    lib.mt_mate_ref_len(
        batch.n, batch.tag_off.ctypes.data_as(i64p), tags,
        batch.seq_off.ctypes.data_as(i64p), out.ctypes.data_as(i32p))
    batch._mate_ref_len = out
    return out


def mate_align_stats_batch(batch: ReadBatch):
    """Batched mate-alignment stats from MC tags (faked as a full match
    of the read's own length when absent): (ref_len, read_len,
    unaligned_prefix, unaligned_suffix) int32 arrays, cached on the
    batch (native mt_mate_align_stats)."""
    cached = getattr(batch, "_mate_align_stats", None)
    if cached is not None:
        return cached
    from .._native import get_lib, i32p, i64p
    lib = get_lib()
    n = batch.n
    ref_len = np.empty(n, np.int32)
    read_len = np.empty(n, np.int32)
    un_pre = np.empty(n, np.int32)
    un_suf = np.empty(n, np.int32)
    tags = batch.tags if isinstance(batch.tags, bytes) else bytes(batch.tags)
    lib.mt_mate_align_stats(
        n, batch.tag_off.ctypes.data_as(i64p), tags,
        batch.seq_off.ctypes.data_as(i64p),
        ref_len.ctypes.data_as(i32p), read_len.ctypes.data_as(i32p),
        un_pre.ctypes.data_as(i32p), un_suf.ctypes.data_as(i32p))
    batch._mate_align_stats = (ref_len, read_len, un_pre, un_suf)
    return batch._mate_align_stats



def _unaligned_edge_sizes_batch(batch: ReadBatch):
    """Per-read unaligned-edge read lengths (S/I runs at either cigar
    end; H consumes nothing), vectorized and cached on the batch —
    the apath_read_lead/trail_size inputs of the pair analyzer."""
    cached = getattr(batch, "_unal_edges", None)
    if cached is not None:
        return cached
    n = batch.n
    pre = np.zeros(n, np.int64)
    suf = np.zeros(n, np.int64)
    if n == 0 or len(batch.cigar) == 0:
        batch._unal_edges = (pre, suf)
        return pre, suf
    ops = (batch.cigar & 0xF).astype(np.int32)
    lens = (batch.cigar >> 4).astype(np.int64)
    off = batch.cigar_off
    nseg = (off[1:] - off[:-1]).astype(np.int64)
    is_unal = (ops == C_I) | (ops == 5) | (ops == C_S)   # I/H/S
    readlen = (ops == C_M) | (ops == C_I) | (ops == C_S) | \
        (ops == 7) | (ops == 8)                          # M/I/S/=/X
    contrib = np.where(is_unal & readlen, lens, 0)
    top = len(ops) - 1
    K = int(nseg.max())
    act = nseg > 0
    for k in range(K):
        idx = np.minimum(off[:-1] + k, top)
        u = act & (k < nseg) & is_unal[idx]
        pre += np.where(u, contrib[idx], 0)
        act = u
        if not act.any():
            break
    act = nseg > 0
    for k in range(K):
        idx = np.maximum(np.minimum(off[1:] - 1 - k, top), 0)
        u = act & (k < nseg) & is_unal[idx]
        suf += np.where(u, contrib[idx], 0)
        act = u
        if not act.any():
            break
    batch._unal_edges = (pre, suf)
    return pre, suf


def _read_has_sa(batch: ReadBatch, i: int) -> bool:
    """SA-tag presence for one read via the cached batch mask."""
    return bool(has_sa_tag(batch)[i])


def get_mate_alignment(batch: ReadBatch, i: int) -> SimpleAlign:
    """Mate alignment from the MC tag if present, else faked as a full
    match of this read's length (reference:
    SimpleAlignment_bam_util.cpp:43-61)."""
    mc = batch.get_tag(i, b"MC")
    if mc is not None:
        ops, lens = cg.string_to_arrays(mc)
    else:
        ops = np.array([C_M], np.int32)
        lens = np.array([batch.read_len(i)], np.int32)
    return SimpleAlign(
        tid=int(batch.next_refid[i]), pos=int(batch.next_pos[i]),
        is_fwd=(batch.flag[i] & FLAG_MATE_REVERSE) == 0, ops=ops, lens=lens)


class SVScanner:
    def __init__(self, opt: ScannerOptions, frag_dists: list, chrom_lengths: list[int],
                 chrom_names: list[str], is_rna: bool = False,
                 is_transcript_strand_known: bool = False):
        self.opt = opt
        self.stats = [build_cached_stats(d, opt) for d in frag_dists]
        self.frag_dists = frag_dists
        # optional per-file {RG id -> SizeDistribution} maps for multi-
        # read-group files: pair-support likelihoods route each fragment
        # through its own group's distribution (reference estimates per
        # (file, RG), ReadGroupStatsUtil.cpp:751-946; scanner-level
        # range caches stay per file, SVLocusScanner.cpp:1495)
        self.rg_frag_dists: list = [None] * len(frag_dists)
        self.chrom_lengths = chrom_lengths
        self.chrom_names = chrom_names
        self.name_to_tid = {n: i for i, n in enumerate(chrom_names)}
        self.is_rna = is_rna
        self.is_transcript_strand_known = is_transcript_strand_known
        fps = [s.fifth_perc for s in self.stats]
        self.extreme_fifth = (min(f[0] for f in fps), max(f[1] for f in fps)) \
            if fps else (0.0, 0.0)

    # ------------------------------------------------------------------
    # vectorized batch masks

    def anomalous_pair_mask(self, batch: ReadBatch, rg: int) -> np.ndarray:
        """isAnomalousReadPair (SVLocusScanner.cpp:1356-1374); assumes
        callers apply this only where meaningful (paired mapped)."""
        ppr = self.stats[rg].proper_pair
        innie = is_innie_pair(batch)
        frag = np.abs(batch.tlen)
        anom = (~innie) | (frag == 0) | (frag > 1.5 * ppr[1]) | (frag < ppr[0])
        return anom

    def _fragment_large_mask(self, batch: ReadBatch, rg: int) -> np.ndarray:
        """isLarge(fragment size type): CLOSE/DISTANT/UNKNOWN."""
        st = self.stats[rg]
        diff_chrom = batch.refid != batch.next_refid
        frag = np.abs(batch.tlen)
        unknown = frag == 0
        compressed = frag < st.proper_pair[0]
        normal = (frag >= st.proper_pair[0]) & (frag <= st.proper_pair[1])
        return diff_chrom | (~diff_chrom & (unknown | ~(compressed | normal)))

    def non_compressed_anomalous_mask(self, batch: ReadBatch, rg: int) -> np.ndarray:
        """isNonCompressedAnomalousReadPair (SVLocusScanner.cpp:1391)."""
        mapped_pair = is_mapped_pair(batch)
        anom = self.anomalous_pair_mask(batch, rg)
        innie = is_innie_pair(batch)
        large = self._fragment_large_mask(batch, rg)
        return mapped_pair & anom & ((~innie) | large)

    def local_indel_mask(self, batch: ReadBatch) -> np.ndarray:
        """Any I/D cigar op with length >= minCandidateVariantSize."""
        ops = (batch.cigar & 0xF).astype(np.int32)
        lens = (batch.cigar >> 4).astype(np.int64)
        hit = ((ops == C_I) | (ops == C_D)) & (lens >= self.opt.min_candidate_variant_size)
        csum = np.concatenate([[0], np.cumsum(hit)])
        return (csum[batch.cigar_off[1:]] - csum[batch.cigar_off[:-1]]) > 0

    def sv_evidence_mask(self, batch: ReadBatch, rg: int, refseq: np.ndarray,
                         ref_offset: int, sa: np.ndarray | None = None) -> np.ndarray:
        """Fast pre-filter isSVEvidence (SVLocusScanner.cpp:1437-1483)."""
        return self.sv_evidence_masks(batch, rg, refseq, ref_offset, sa)["evidence"]

    def sv_evidence_masks(self, batch: ReadBatch, rg: int, refseq: np.ndarray,
                          ref_offset: int, sa: np.ndarray | None = None,
                          sel: np.ndarray | None = None) -> dict:
        """isSVEvidence with per-type component masks, for evidence-count
        statistics (SVLocusScanner.cpp:1437-1483). The assm (semi-aligned)
        mask is computed for all reads not already accepted by a cheaper
        test AND all non-split reads, matching the reference's isAssm
        definition. `sel` restricts the evaluation (and all returned
        masks) to the selected rows, letting callers skip a batch
        subset copy."""
        if sa is None:
            sa = has_sa_tag(batch)
        anom = self.non_compressed_anomalous_mask(batch, rg)
        indel = self.local_indel_mask(batch)
        semi_sel = ~sa if sel is None else ~sa & sel
        assm = np.zeros(batch.n, dtype=bool)
        if self.opt.is_small_candidates:
            if self.opt.use_overlap_pair_evidence:
                # rare config needing per-read adapter checks
                for i in np.flatnonzero(semi_sel):
                    lead, _, trail, _ = self.semi_aligned_lengths(
                        batch, int(i), refseq, ref_offset)
                    if lead >= self.opt.min_semi_aligned_mismatch_len or \
                            trail >= self.opt.min_semi_aligned_mismatch_len:
                        assm[i] = True
            else:
                assm = self._semi_aligned_mask_batch(batch, semi_sel, refseq,
                                                     ref_offset)
        if sel is not None:
            anom = anom & sel
            sa = sa & sel
            indel = indel & sel
        return {
            "evidence": anom | sa | indel | assm,
            "anom": anom, "split": sa, "indel": indel, "assm": assm,
        }

    # ------------------------------------------------------------------
    # semi-aligned edge detection

    def _overlapping_pair_mask(self, batch: ReadBatch) -> np.ndarray:
        """Vectorized _is_overlapping_pair; the reverse-strand mate-end
        comparison falls back to a per-read check on the small subset
        that reaches it."""
        f = batch.flag.astype(np.int64)
        read_len = (batch.seq_off[1:] - batch.seq_off[:-1]).astype(np.int64)
        cand = ((f & FLAG_PAIRED) != 0) & \
            ((f & (FLAG_UNMAPPED | FLAG_MATE_UNMAPPED)) == 0) & \
            (batch.refid == batch.next_refid)
        fwd = (f & FLAG_REVERSE) == 0
        mate_fwd = (f & FLAG_MATE_REVERSE) == 0
        cand &= (fwd != mate_fwd)
        pos_diff = batch.pos.astype(np.int64) - \
            batch.next_pos.astype(np.int64)
        pos_diff = np.where(fwd, pos_diff, -pos_diff)
        cand &= pos_diff <= read_len
        out = np.zeros(batch.n, dtype=bool)
        # forward branch fully vectorized
        fcand = cand & fwd
        out[fcand] = (batch.end_pos[fcand].astype(np.int64)
                      - batch.next_pos[fcand]) >= 0
        # reverse branch: mate reference span from the MC tag (native
        # batch scan; faked as read length when absent)
        rcand = cand & ~fwd
        if rcand.any():
            mate_end = batch.next_pos.astype(np.int64) + \
                mate_ref_len_batch(batch)
            out[rcand] = (batch.pos[rcand].astype(np.int64)
                          - mate_end[rcand]) <= 0
        return out

    def semi_aligned_values_batch(self, batch: ReadBatch, sel: np.ndarray,
                                  refseq: np.ndarray, ref_offset: int,
                                  min_bq: int = 20,
                                  min_hq_frac: float = 0.75):
        """Vectorized semi_aligned_lengths over selected reads with
        use_overlap_pair_evidence=False semantics: returns (lead, trail)
        int32 arrays over the whole batch (zeros where gated out or not
        selected)."""
        overlap = getattr(batch, "_overlap_mask", None)
        if overlap is None:
            overlap = self._overlapping_pair_mask(batch)
            batch._overlap_mask = overlap
        if min_bq == 20 and min_hq_frac == 0.75:
            # the per-row result cache is window-independent (the fetch
            # window always covers the read); several pipeline users
            # scan the same batch, so only not-yet-done rows hit native
            cache = getattr(batch, "_semi_cache", None)
            if cache is not None:
                todo = sel & ~cache[4]
                if todo.any():
                    self._semi_aligned_values_uncached(
                        batch, todo, overlap, refseq, ref_offset,
                        min_bq, min_hq_frac)
            else:
                self._semi_aligned_values_uncached(
                    batch, sel, overlap, refseq, ref_offset, min_bq,
                    min_hq_frac)
                cache = batch._semi_cache
            keep = sel & ~overlap
            return (np.where(keep, cache[0], 0).astype(np.int32),
                    np.where(keep, cache[2], 0).astype(np.int32))
        return self._semi_aligned_values_uncached(
            batch, sel, overlap, refseq, ref_offset, min_bq, min_hq_frac)

    @staticmethod
    def _ensure_semi_cache(batch: ReadBatch):
        cache = getattr(batch, "_semi_cache", None)
        if cache is None:
            cache = batch._semi_cache = [
                np.zeros(batch.n, np.int32), np.zeros(batch.n, np.int32),
                np.zeros(batch.n, np.int32), np.zeros(batch.n, np.int32),
                np.zeros(batch.n, bool)]
        return cache

    def _semi_aligned_values_uncached(self, batch: ReadBatch,
                                      sel: np.ndarray, overlap: np.ndarray,
                                      refseq: np.ndarray, ref_offset: int,
                                      min_bq: int, min_hq_frac: float):
        import ctypes
        from .._native import get_lib, i32p, i64p, u8p, u32p
        idx = np.flatnonzero(sel & ~overlap).astype(np.int64)
        out_lead = np.zeros(batch.n, np.int32)
        out_trail = np.zeros(batch.n, np.int32)
        m = len(idx)
        if m == 0:
            if min_bq == 20 and min_hq_frac == 0.75:
                cache = self._ensure_semi_cache(batch)
                cache[4][sel & overlap] = True
            return out_lead, out_trail
        lib = get_lib()
        lead = np.empty(m, np.int32)
        lead_ref = np.empty(m, np.int32)
        trail = np.empty(m, np.int32)
        trail_ref = np.empty(m, np.int32)
        lead_hq = np.empty(m, np.int32)
        trail_hq = np.empty(m, np.int32)
        if not refseq.flags["C_CONTIGUOUS"]:
            refseq = np.ascontiguousarray(refseq)
        lib.mt_semi_aligned_batch_idx(
            m, idx.ctypes.data_as(i64p),
            batch.pos.ctypes.data_as(i32p),
            batch.cigar_off.ctypes.data_as(i64p),
            batch.cigar.ctypes.data_as(u32p),
            batch.seq_off.ctypes.data_as(i64p),
            batch.seq.ctypes.data_as(u8p),
            refseq.ctypes.data_as(u8p), len(refseq), ref_offset, 5,
            batch.qual_off.ctypes.data_as(i64p),
            batch.qual.ctypes.data_as(u8p), min_bq,
            lead.ctypes.data_as(i32p), lead_ref.ctypes.data_as(i32p),
            trail.ctypes.data_as(i32p), trail_ref.ctypes.data_as(i32p),
            lead_hq.ctypes.data_as(i32p), trail_hq.ctypes.data_as(i32p))

        read_len = (batch.seq_off[idx + 1] - batch.seq_off[idx]).astype(
            np.int64)
        degenerate = (lead.astype(np.int64) + trail) >= read_len
        # high-quality base fraction gates over lead/trail windows
        # (counted natively in the same pass as the edge scan)
        lead_ok = (lead > 0) & (lead_hq >= min_hq_frac * lead)
        trail_ok = (trail > 0) & (trail_hq >= min_hq_frac * trail)
        keep = ~degenerate
        out_lead[idx] = np.where(keep & lead_ok, lead, 0)
        out_trail[idx] = np.where(keep & trail_ok, trail, 0)
        # retain per-row gated values + breakend ref positions so the
        # per-evidence-read candidate pass reuses this batch scan
        # instead of re-running the scalar edge walk (values are
        # window-independent: the fetch window always covers the read)
        if min_bq == 20 and min_hq_frac == 0.75:
            cache = self._ensure_semi_cache(batch)
            c_lead, c_lead_ref, c_trail, c_trail_ref, done = cache
            c_lead[idx] = out_lead[idx]
            c_trail[idx] = out_trail[idx]
            c_lead_ref[idx] = np.where(keep, lead_ref, 0)
            c_trail_ref[idx] = np.where(keep, trail_ref, 0)
            done[idx] = True
            # overlapping pairs are hard-gated to zero under
            # use_overlap_pair_evidence=False — mark them resolved
            done[sel & overlap] = True
        return out_lead, out_trail

    def _semi_aligned_mask_batch(self, batch: ReadBatch, sel: np.ndarray,
                                 refseq: np.ndarray, ref_offset: int) \
            -> np.ndarray:
        """Batched semi-aligned evidence mask over selected reads."""
        lead, trail = self.semi_aligned_values_batch(batch, sel, refseq,
                                                     ref_offset)
        min_len = self.opt.min_semi_aligned_mismatch_len
        return (lead >= min_len) | (trail >= min_len)

    def _is_overlapping_pair(self, batch: ReadBatch, i: int, al: SimpleAlign) -> bool:
        f = int(batch.flag[i])
        if not (f & FLAG_PAIRED) or (f & (FLAG_UNMAPPED | FLAG_MATE_UNMAPPED)):
            return False
        if batch.refid[i] != batch.next_refid[i]:
            return False
        fwd = (f & FLAG_REVERSE) == 0
        mate_fwd = (f & FLAG_MATE_REVERSE) == 0
        if fwd == mate_fwd:
            return False
        pos_diff = int(batch.pos[i]) - int(batch.next_pos[i])
        if not fwd:
            pos_diff = -pos_diff
        if pos_diff > batch.read_len(i):
            return False
        if fwd:
            return (al.end_pos - int(batch.next_pos[i])) >= 0
        mate = get_mate_alignment(batch, i)
        return (al.pos - mate.end_pos) <= 0

    def _is_adapter_pair(self, batch: ReadBatch, i: int, al: SimpleAlign,
                         sa_split: bool) -> bool:
        if sa_split:
            return False
        if batch.get_tag(i, b"MC") is not None:
            mate = get_mate_alignment(batch, i)
            if al.is_fwd:
                endpos = al.end_pos + cg.soft_clip_trail_size(al.ops, al.lens)
                mate_start = mate.end_pos + cg.soft_clip_trail_size(mate.ops, mate.lens)
                return endpos > mate_start
            endpos = al.pos - cg.soft_clip_lead_size(al.ops, al.lens)
            mate_start = mate.pos - cg.soft_clip_lead_size(mate.ops, mate.lens)
            return endpos < mate_start
        sc = cg.soft_clip_trail_size(al.ops, al.lens) if al.is_fwd \
            else cg.soft_clip_lead_size(al.ops, al.lens)
        return sc > 0

    def semi_aligned_lengths(self, batch: ReadBatch, i: int, refseq: np.ndarray,
                             ref_offset: int, min_bq: int = 20,
                             min_hq_frac: float = 0.75):
        """getSVBreakendCandidateSemiAligned
        (SVLocusScannerSemiAligned.cpp): returns
        (lead_len, lead_ref_pos, trail_len, trail_ref_pos)."""
        al = get_alignment(batch, i)
        sa_split = _read_has_sa(batch, i)
        overlapping = self._is_overlapping_pair(batch, i, al)
        if overlapping:
            if (not self.opt.use_overlap_pair_evidence) or \
                    self._is_adapter_pair(batch, i, al, sa_split):
                return 0, 0, 0, 0

        read = batch.seq[batch.seq_off[i]:batch.seq_off[i + 1]]
        qual = batch.qual_arr(i)
        n = len(read)

        # native edge scan (matchifies edge soft-clips internally;
        # native/manta_core.cpp mt_semi_aligned_batch)
        lead_tmp, lead_ref, trail_tmp, trail_ref = \
            _edge_poor_alignment_native(batch, i, refseq, ref_offset, 5)
        if lead_tmp + trail_tmp >= n:
            return 0, 0, 0, 0

        fwd = (batch.flag[i] & FLAG_REVERSE) == 0
        lead = trail = 0
        if lead_tmp and ((not overlapping) or sa_split or fwd):
            hq = int((qual[:lead_tmp] >= min_bq).sum())
            if hq / lead_tmp >= min_hq_frac:
                lead = lead_tmp
        if trail_tmp and ((not overlapping) or sa_split or not fwd):
            hq = int((qual[n - trail_tmp:] >= min_bq).sum())
            if hq / trail_tmp >= min_hq_frac:
                trail = trail_tmp
        return lead, lead_ref, trail, trail_ref

    # ------------------------------------------------------------------
    # candidate generation

    def _split_candidate(self, tid: int, left: int, right: int, ev: int,
                         frag_source: int, is_complex: bool = False) -> SVObservation:
        """getSplitSVCandidate (SVLocusScanner.cpp:93-138)."""
        opt = self.opt
        chrom_len = self.chrom_lengths[tid]
        sv = SVObservation()
        sv.ev_type = ev
        sv.frag_source = frag_source
        sv.bp1.interval.tid = tid
        sv.bp2.interval.tid = tid
        sv.bp1.add_evidence(ev)
        if not is_complex:
            sv.bp2.add_evidence(ev)
            sv.bp1.state = BND_RIGHT_OPEN
            sv.bp2.state = BND_LEFT_OPEN
        else:
            sv.bp1.state = BND_COMPLEX
            sv.bp2.state = BND_UNKNOWN
        sv.bp1.interval.beg = max(0, left - opt.before_breakend)
        if not is_complex:
            sv.bp1.interval.end = min(chrom_len, left + opt.after_breakend)
        else:
            sv.bp1.interval.end = min(chrom_len, right + opt.after_breakend)
        sv.bp2.interval.beg = max(0, right - opt.before_breakend)
        sv.bp2.interval.end = min(chrom_len, right + opt.after_breakend)
        return sv

    def _indel_candidates(self, al: SimpleAlign, frag_source: int,
                          out: list[SVObservation]) -> None:
        """getSVCandidatesFromReadIndels (SVLocusScanner.cpp:356-460)."""
        opt = self.opt
        first, last = cg.match_edge_segments(al.ops)
        path_index = 0
        ref_head = al.pos
        nseg = len(al.ops)
        while path_index < nseg:
            o = int(al.ops[path_index])
            l = int(al.lens[path_index])
            is_edge = path_index < first or path_index > last
            is_swap = cg.is_swap_start(al.ops, path_index)
            consumed = 1
            if is_edge:
                if o == C_I and l >= opt.min_candidate_variant_size:
                    out.append(self._split_candidate(
                        al.tid, ref_head, ref_head, EV_CIGAR, frag_source,
                        is_complex=True))
            elif is_swap:
                n_seg, ins_len, del_len = cg.swap_info(al.ops, al.lens, path_index)
                if del_len >= opt.min_candidate_variant_size or \
                        ins_len >= opt.min_candidate_variant_size:
                    out.append(self._split_candidate(
                        al.tid, ref_head, ref_head + del_len, EV_CIGAR, frag_source))
                consumed = n_seg
            elif o in (C_I, C_D):
                if l >= opt.min_candidate_variant_size:
                    if o == C_D:
                        out.append(self._split_candidate(
                            al.tid, ref_head, ref_head + l, EV_CIGAR, frag_source))
                    else:
                        out.append(self._split_candidate(
                            al.tid, ref_head, ref_head, EV_CIGAR, frag_source))
            for k in range(consumed):
                oo = int(al.ops[path_index])
                ll = int(al.lens[path_index])
                if oo in cg.REF_LEN_OPS:
                    ref_head += ll
                path_index += 1

    def parse_sa_alignments(self, batch: ReadBatch, i: int) -> list[SimpleAlign]:
        """parseSACandidatesFromRead (SVLocusScanner.cpp:236-307)."""
        sa = batch.get_tag(i, b"SA")
        if sa is None:
            return []
        segs = [s for s in sa.split(";") if s]
        if len(segs) > 1:
            return []
        out = []
        for seg in segs:
            fields = seg.split(",")
            if len(fields) != 6:
                raise ValueError(f"Unexpected SA format: {seg}")
            chrom, pos, strand, cig, mapq, _nm = fields
            if int(mapq) < self.opt.min_mapq:
                continue
            if chrom not in self.name_to_tid:
                raise ValueError(f"SA segment maps to unknown chromosome: {chrom}")
            ops, lens = cg.string_to_arrays(cig)
            out.append(SimpleAlign(
                tid=self.name_to_tid[chrom], pos=int(pos) - 1,
                is_fwd=(strand == "+"), ops=ops, lens=lens))
        return out

    def _sa_breakend(self, al: SimpleAlign) -> SVBreakend:
        """updateSABreakend (SVLocusScanner.cpp:149-184)."""
        bp = SVBreakend()
        downstream = cg.clip_lead_size(al.ops, al.lens) < cg.clip_trail_size(al.ops, al.lens)
        bp.state = BND_RIGHT_OPEN if downstream else BND_LEFT_OPEN
        bp.interval.tid = al.tid
        pos = al.pos
        if downstream:
            pos += al.ref_length
        chrom_len = self.chrom_lengths[al.tid]
        bp.interval.beg = max(0, pos - self.opt.before_breakend)
        bp.interval.end = min(chrom_len, pos + self.opt.after_breakend)
        return bp

    def _sa_candidates(self, batch: ReadBatch, i: int, al: SimpleAlign,
                       frag_source: int, out: list[SVObservation]) -> None:
        """getSACandidatesFromRead (SVLocusScanner.cpp:322-349)."""
        remotes = self.parse_sa_alignments(batch, i)
        if len(remotes) != 1:
            return
        for ral in remotes:
            sv = SVObservation()
            sv.ev_type = EV_SPLIT_ALIGN
            sv.frag_source = frag_source
            sv.bp1 = self._sa_breakend(al)
            sv.bp1.add_evidence(EV_SPLIT_ALIGN)
            sv.bp2 = self._sa_breakend(ral)
            if self.is_transcript_strand_known:
                downstream = cg.clip_lead_size(al.ops, al.lens) < \
                    cg.clip_trail_size(al.ops, al.lens)
                is_first = (batch.flag[i] & FLAG_READ1) != 0
                fwd = (batch.flag[i] & FLAG_REVERSE) == 0
                if (is_first == fwd) == downstream:
                    sv.forward_transcript_strand_read_count += 1
                else:
                    sv.reverse_transcript_strand_read_count += 1
            out.append(sv)

    def _semi_aligned_candidates(self, batch: ReadBatch, i: int, al: SimpleAlign,
                                 frag_source: int, refseq: np.ndarray,
                                 ref_offset: int, out: list[SVObservation]) -> None:
        """getSVCandidatesFromSemiAligned (SVLocusScanner.cpp:475-534)."""
        cache = None if self.opt.use_overlap_pair_evidence else \
            getattr(batch, "_semi_cache", None)
        if cache is not None and cache[4][i]:
            lead = int(cache[0][i])
            lead_ref = int(cache[1][i])
            trail = int(cache[2][i])
            trail_ref = int(cache[3][i])
        else:
            lead, lead_ref, trail, trail_ref = self.semi_aligned_lengths(
                batch, i, refseq, ref_offset)
        if lead + trail >= batch.read_len(i):
            return
        tid = int(batch.refid[i])
        if lead >= self.opt.min_semi_aligned_mismatch_len:
            out.append(self._split_candidate(
                tid, lead_ref, lead_ref, EV_SEMIALIGN, frag_source, is_complex=True))
        if trail >= self.opt.min_semi_aligned_mismatch_len:
            out.append(self._split_candidate(
                tid, trail_ref, trail_ref, EV_SEMIALIGN, frag_source, is_complex=True))


    def _pair_candidate_table(self, batch: ReadBatch, rg: int):
        """Vectorized getSVCandidatesFromPair/AlignmentPairAnalyzer for
        the whole batch (local-mate case; remote-read recovery keeps the
        scalar path). Cached on the batch: per-read validity plus the
        two breakend intervals, so the per-evidence-read loop only
        constructs the observation object."""
        cached = getattr(batch, "_pair_cand", None)
        if cached is not None and cached[0] == rg:
            return cached[1]
        f = batch.flag.astype(np.int64)
        sa = has_sa_tag(batch)
        valid = (f & FLAG_PAIRED) != 0
        valid &= ~(((f & FLAG_SUPPLEMENTARY) != 0) |
                   (((f & FLAG_SECONDARY) != 0) & sa))
        valid &= (f & (FLAG_UNMAPPED | FLAG_MATE_UNMAPPED)) == 0
        if self.opt.is_ignore_anom_proper_pair:
            valid &= (f & FLAG_PROPER_PAIR) == 0

        m_ref, m_read, m_pre, m_suf = mate_align_stats_batch(batch)
        r_tid = batch.next_refid.astype(np.int64)
        r_pos = batch.next_pos.astype(np.int64)
        r_fwd = (f & FLAG_MATE_REVERSE) == 0
        remote_noninsert = m_read.astype(np.int64) - \
            np.where(r_fwd, m_suf, m_pre).astype(np.int64)
        remote_end = r_pos + m_ref.astype(np.int64)

        st = self.stats[rg]
        fwd = (f & FLAG_REVERSE) == 0
        pre, suf = _unaligned_edge_sizes_batch(batch)
        read_len = (batch.seq_off[1:] - batch.seq_off[:-1]).astype(np.int64)
        local_noninsert = read_len - np.where(fwd, suf, pre)
        total_noninsert = local_noninsert + remote_noninsert
        pos = batch.pos.astype(np.int64)
        local_end = pos + batch.aligned_lengths.astype(np.int64)

        # setLargeEventRegionScale; scale < 0 marks non-anomalous pairs
        same_opp = (batch.refid.astype(np.int64) == r_tid) & (fwd != r_fwd)
        ins_beg = np.where(fwd, local_end, remote_end)
        ins_end = np.where(fwd, r_pos, pos)
        cigar_adj = (total_noninsert + ins_end - ins_beg).astype(np.float64)
        thresh = st.proper_pair[1] + self.opt.min_candidate_variant_size
        in_range = same_opp & (cigar_adj >= 0)
        denom = max(1e-30, float(st.large_event_region_max
                                 - st.large_event_region_min))
        sc = np.clip((cigar_adj - st.large_event_region_min) / denom,
                     0.0, 1.0)
        scale = np.where(in_range & (cigar_adj > thresh), sc, 1.0)
        valid &= ~(in_range & ~(cigar_adj > thresh))

        # isAlignedToChromEnds
        chrom_arr = np.asarray(self.chrom_lengths, np.int64)
        lchrom = chrom_arr[batch.refid]
        rchrom = chrom_arr[np.maximum(r_tid, 0)]
        valid &= ~np.where(fwd, local_end >= lchrom, pos <= 0)
        valid &= ~np.where(r_fwd, remote_end >= rchrom, r_pos <= 0)

        max_frag = scale * st.large_scale_breakend_region[1] + \
            (1.0 - scale) * st.breakend_region[1]
        bk = np.maximum(self.opt.min_pair_breakend_size,
                        (max_frag - total_noninsert).astype(np.int64))

        bp1_beg = np.where(fwd, np.minimum(lchrom, local_end),
                           np.maximum(0, pos - bk))
        bp1_end = np.where(fwd, np.minimum(lchrom, local_end + bk), pos)
        bp2_beg = np.where(r_fwd, np.minimum(rchrom, remote_end),
                           np.maximum(0, r_pos - bk))
        bp2_end = np.where(r_fwd, np.minimum(rchrom, remote_end + bk),
                           r_pos)
        tbl = (valid, fwd, r_fwd, r_tid, bp1_beg, bp1_end, bp2_beg,
               bp2_end)
        batch._pair_cand = (rg, tbl)
        return tbl

    def _pair_candidate(self, batch: ReadBatch, i: int, al: SimpleAlign, rg: int,
                        remote: tuple[ReadBatch, int] | None,
                        out: list[SVObservation]) -> None:
        """getSVCandidatesFromPair + AlignmentPairAnalyzer
        (SVLocusScanner.cpp:547-918)."""
        f = int(batch.flag[i])
        if remote is None:
            # local-mate case: all per-read math precomputed in one
            # vectorized pass (_pair_candidate_table); only the
            # observation object is built here
            (valid, fwd_a, r_fwd_a, r_tid_a, b1b, b1e, b2b,
             b2e) = self._pair_candidate_table(batch, rg)
            if not valid[i]:
                return
            sv = SVObservation()
            sv.ev_type = EV_LOCAL_PAIR
            sv.frag_source = FRAG_READ_PAIR
            sv.bp1.add_evidence(EV_LOCAL_PAIR)
            if self.is_transcript_strand_known:
                if f & FLAG_READ1:
                    sv.forward_transcript_strand_read_count += 1
                else:
                    sv.reverse_transcript_strand_read_count += 1
            sv.bp1.interval.tid = int(batch.refid[i])
            sv.bp1.state = BND_RIGHT_OPEN if fwd_a[i] else BND_LEFT_OPEN
            sv.bp1.interval.beg = int(b1b[i])
            sv.bp1.interval.end = int(b1e[i])
            sv.bp2.interval.tid = int(r_tid_a[i])
            sv.bp2.state = BND_RIGHT_OPEN if r_fwd_a[i] else BND_LEFT_OPEN
            sv.bp2.interval.beg = int(b2b[i])
            sv.bp2.interval.end = int(b2e[i])
            out.append(sv)
            return
        if not (f & FLAG_PAIRED):
            return
        sa_split = _read_has_sa(batch, i)
        if (f & FLAG_SUPPLEMENTARY) or ((f & FLAG_SECONDARY) and sa_split):
            return
        if f & (FLAG_UNMAPPED | FLAG_MATE_UNMAPPED):
            return
        if self.opt.is_ignore_anom_proper_pair and (f & FLAG_PROPER_PAIR):
            return

        if remote is not None:
            ral = get_alignment(remote[0], remote[1])
            r_tid, r_pos, r_fwd = ral.tid, ral.pos, ral.is_fwd
            remote_noninsert = ral.read_length - (
                cg.unaligned_suffix_size(ral.ops, ral.lens) if r_fwd
                else cg.unaligned_prefix_size(ral.ops, ral.lens))
            remote_end = ral.end_pos
        else:
            # mate alignment derived from the batched MC-tag scan
            # (identical to get_mate_alignment; reference:
            # SimpleAlignment_bam_util.cpp:43-61)
            m_ref, m_read, m_pre, m_suf = mate_align_stats_batch(batch)
            r_tid = int(batch.next_refid[i])
            r_pos = int(batch.next_pos[i])
            r_fwd = (batch.flag[i] & FLAG_MATE_REVERSE) == 0
            remote_noninsert = int(m_read[i]) - \
                int(m_suf[i] if r_fwd else m_pre[i])
            remote_end = r_pos + int(m_ref[i])
        st = self.stats[rg]

        # setLargeEventRegionScale
        local_noninsert = al.read_length - (
            cg.unaligned_suffix_size(al.ops, al.lens) if al.is_fwd
            else cg.unaligned_prefix_size(al.ops, al.lens))
        total_noninsert = local_noninsert + remote_noninsert
        local_end = al.end_pos

        scale = 1.0
        if al.tid == r_tid and al.is_fwd != r_fwd:
            if al.is_fwd:
                ins_beg, ins_end = local_end, r_pos
            else:
                ins_beg, ins_end = remote_end, al.pos
            cigar_adj_frag = total_noninsert + (ins_end - ins_beg)
            if cigar_adj_frag >= 0:
                if cigar_adj_frag > st.proper_pair[1] + self.opt.min_candidate_variant_size:
                    scale = st.large_event_region_scale(cigar_adj_frag)
                else:
                    scale = -1.0
        if scale < 0:
            return  # non-anomalous

        # isAlignedToChromEnds
        if al.is_fwd:
            if local_end >= self.chrom_lengths[al.tid]:
                return
        elif al.pos <= 0:
            return
        if r_fwd:
            if remote_end >= self.chrom_lengths[r_tid]:
                return
        elif r_pos <= 0:
            return

        # getSVObservation
        sv = SVObservation()
        sv.ev_type = EV_LOCAL_PAIR
        sv.frag_source = FRAG_READ_PAIR
        sv.bp1.add_evidence(EV_LOCAL_PAIR)
        if self.is_transcript_strand_known:
            if f & FLAG_READ1:
                sv.forward_transcript_strand_read_count += 1
            else:
                sv.reverse_transcript_strand_read_count += 1
        if remote is not None:
            sv.bp2.add_evidence(EV_LOCAL_PAIR)
            sv.bp1.add_evidence(EV_PAIR)
            sv.bp2.add_evidence(EV_PAIR)
            sv.ev_type = EV_PAIR

        max_frag = (scale * st.large_scale_breakend_region[1]
                    + (1.0 - scale) * st.breakend_region[1])
        bk_size = max(self.opt.min_pair_breakend_size,
                      int(max_frag - total_noninsert))

        lchrom = self.chrom_lengths[al.tid]
        sv.bp1.interval.tid = al.tid
        if al.is_fwd:
            sv.bp1.state = BND_RIGHT_OPEN
            sv.bp1.interval.beg = min(lchrom, local_end)
            sv.bp1.interval.end = min(lchrom, local_end + bk_size)
        else:
            sv.bp1.state = BND_LEFT_OPEN
            sv.bp1.interval.end = al.pos
            sv.bp1.interval.beg = max(0, al.pos - bk_size)
        rchrom = self.chrom_lengths[r_tid]
        sv.bp2.interval.tid = r_tid
        if r_fwd:
            sv.bp2.state = BND_RIGHT_OPEN
            sv.bp2.interval.beg = min(rchrom, remote_end)
            sv.bp2.interval.end = min(rchrom, remote_end + bk_size)
        else:
            sv.bp2.state = BND_LEFT_OPEN
            sv.bp2.interval.end = r_pos
            sv.bp2.interval.beg = max(0, r_pos - bk_size)
        out.append(sv)

    def _single_read_candidates(self, batch: ReadBatch, i: int, al: SimpleAlign,
                                refseq: np.ndarray, ref_offset: int,
                                out: list[SVObservation]) -> None:
        """getSingleReadSVCandidates (SVLocusScanner.cpp:992-1031)."""
        f = int(batch.flag[i])
        is_read2 = bool(f & FLAG_PAIRED) and bool(f & FLAG_READ2)
        frag_source = FRAG_READ2 if is_read2 else FRAG_READ1
        self._indel_candidates(al, frag_source, out)
        if _read_has_sa(batch, i):
            self._sa_candidates(batch, i, al, frag_source, out)
        elif self.opt.is_small_candidates:
            self._semi_aligned_candidates(
                batch, i, al, frag_source, refseq, ref_offset, out)

    def get_read_breakends(self, batch: ReadBatch, i: int, rg: int,
                           refseq: np.ndarray, ref_offset: int,
                           remote: tuple[ReadBatch, int] | None = None,
                           remote_refseq: tuple[np.ndarray, int] | None = None):
        """getReadBreakendsImpl (SVLocusScanner.cpp:1037-1158):
        returns (candidates, local_evidence_range)."""
        out: list[SVObservation] = []
        al = get_alignment(batch, i)
        self._single_read_candidates(batch, i, al, refseq, ref_offset, out)
        if remote is not None:
            rr, ri = remote
            ral = get_alignment(rr, ri)
            rref, roff = remote_refseq
            self._single_read_candidates(rr, ri, ral, rref, roff, out)
        self._pair_candidate(batch, i, al, rg, remote, out)
        ev_range = (al.pos, al.pos + al.ref_length)
        return out, ev_range

    def get_read_loci_data(self, batch: ReadBatch, i: int, rg: int,
                           refseq: np.ndarray, ref_offset: int):
        """Per-candidate graph insertion data, mirroring getSVLociImpl
        (SVLocusScanner.cpp:1166-1260): list of
        (bp1, bp2|None, weight1, weight2, evidence_range, is_complex)."""
        cands, ev_range = self.get_read_breakends(batch, i, rg, refseq, ref_offset)
        st = self.stats[rg]
        out = []
        for cand in cands:
            is_complex = (cand.bp1.state == BND_COMPLEX
                          and cand.bp2.state == BND_UNKNOWN)
            lb, rb = cand.bp1, cand.bp2
            assert lb.interval.size() > 0 and (is_complex or rb.interval.size() > 0)
            w1 = w2 = 0
            if lb.get_any_non_pair_count() != 0:
                w1 = WEIGHT_INTERNAL_READ_EVENT
                if rb.get_any_non_pair_count() != 0:
                    w2 = WEIGHT_INTERNAL_READ_EVENT
            elif lb.get_local_pair_count() != 0:
                is_close = _is_innie_read(batch, i) and \
                    abs(int(batch.tlen[i])) < st.min_distant_fragment_size
                w = WEIGHT_CLOSE_READ_PAIR if is_close else WEIGHT_READ_PAIR
                w1 = w
                if rb.get_local_pair_count() != 0:
                    w2 = w
            out.append((lb, (None if is_complex else rb), w1, w2, ev_range,
                        is_complex))
        return out


def _is_innie_read(batch: ReadBatch, i: int) -> bool:
    """Scalar is_innie_pair for one read (htsapi/bam_record_util.cpp:44)."""
    f = int(batch.flag[i])
    if not (f & FLAG_PAIRED) or (f & (FLAG_UNMAPPED | FLAG_MATE_UNMAPPED)):
        return False
    if batch.refid[i] != batch.next_refid[i]:
        return False
    fwd = (f & FLAG_REVERSE) == 0
    mate_fwd = (f & FLAG_MATE_REVERSE) == 0
    if fwd == mate_fwd:
        return False
    if batch.pos[i] < batch.next_pos[i]:
        return fwd
    if batch.pos[i] > batch.next_pos[i]:
        return not fwd
    return True


class _EdgeScanScratch:
    """Reusable single-read buffers + precast pointers for the native
    edge scan (ctypes cast cost dominates otherwise)."""

    def __init__(self):
        import ctypes
        from .._native import get_lib, i32p, i64p, u8p, u32p
        self.lib = get_lib()
        self.pos1 = np.empty(1, np.int32)
        self.coff = np.empty(2, np.int64)
        self.soff = np.empty(2, np.int64)
        self.out = np.empty(4, np.int32)
        self.p_pos1 = self.pos1.ctypes.data_as(i32p)
        self.p_coff = self.coff.ctypes.data_as(i64p)
        self.p_soff = self.soff.ctypes.data_as(i64p)
        self.p_lead_len = self.out[0:].ctypes.data_as(i32p)
        self.p_lead_ref = self.out[1:].ctypes.data_as(i32p)
        self.p_trail_len = self.out[2:].ctypes.data_as(i32p)
        self.p_trail_ref = self.out[3:].ctypes.data_as(i32p)
        self.i32p, self.i64p, self.u8p, self.u32p = i32p, i64p, u8p, u32p
        self._batch_id = None
        self._p_cig = None
        self._p_seq = None
        self._ref_id = None
        self._p_ref = None
        self._ref_len = 0

    def ptrs_for(self, batch, refseq):
        # hold references so the cached id()s can never be recycled to
        # a different (freed-and-reallocated) object
        if batch is not getattr(self, "_keep_batch", None):
            self._keep_batch = batch
            self._batch_id = id(batch)
            self._p_cig = batch.cigar.ctypes.data_as(self.u32p)
            self._p_seq = batch.seq.ctypes.data_as(self.u8p)
        if id(refseq) != self._ref_id:
            if not refseq.flags["C_CONTIGUOUS"]:
                refseq = np.ascontiguousarray(refseq)
            self._ref_id = id(refseq)
            self._keep_ref = refseq
            self._p_ref = refseq.ctypes.data_as(self.u8p)
            self._ref_len = len(refseq)
        return self._p_cig, self._p_seq, self._p_ref, self._ref_len


_EDGE_SCRATCH = None


def _edge_poor_alignment_native(batch: ReadBatch, i: int,
                                refseq: np.ndarray, ref_offset: int,
                                contiguous: int):
    """Single-read call into the batched native edge scan; equivalent to
    matchify_edge_soft_clip + _edge_poor_alignment."""
    global _EDGE_SCRATCH
    sc = _EDGE_SCRATCH
    if sc is None:
        sc = _EDGE_SCRATCH = _EdgeScanScratch()
    p_cig, p_seq, p_ref, ref_len = sc.ptrs_for(batch, refseq)
    sc.pos1[0] = batch.pos[i]
    sc.coff[0] = batch.cigar_off[i]
    sc.coff[1] = batch.cigar_off[i + 1]
    sc.soff[0] = batch.seq_off[i]
    sc.soff[1] = batch.seq_off[i + 1]
    sc.lib.mt_semi_aligned_batch(
        1, sc.p_pos1, sc.p_coff, p_cig, sc.p_soff, p_seq,
        p_ref, ref_len, ref_offset, contiguous,
        sc.p_lead_len, sc.p_lead_ref, sc.p_trail_len, sc.p_trail_ref)
    o = sc.out
    return int(o[0]), int(o[1]), int(o[2]), int(o[3])


def _edge_poor_alignment(pos: int, ops: np.ndarray, lens: np.ndarray,
                         read: np.ndarray, refseq: np.ndarray, ref_offset: int,
                         contiguous: int):
    """leading/trailingEdgePoorAlignmentLength
    (SVLocusScannerSemiAligned.cpp:33-131). N bases always match."""
    n_read = len(read)

    def base_match(r_idx: int, f_idx: int) -> bool:
        rb = read[r_idx]
        fi = f_idx - ref_offset
        fb = refseq[fi] if 0 <= fi < len(refseq) else ord("N")
        return rb == ord("N") or fb == ord("N") or rb == fb

    # leading
    read_idx = 0
    ref_idx = pos
    lead_len = None
    lead_ref = pos
    run = 0
    for o, l in zip(ops.tolist(), lens.tolist()):
        if o in cg.MATCH_OPS:
            for sp in range(l):
                if base_match(read_idx + sp, ref_idx + sp):
                    run += 1
                    if run >= contiguous:
                        lead_len = (read_idx + sp) - (run - 1)
                        lead_ref = (ref_idx + sp) - (run - 1)
                        break
                else:
                    run = 0
            if lead_len is not None:
                break
        elif o in cg.INDEL_OPS:
            run = 0
        if o in cg.READ_LEN_OPS:
            read_idx += l
        if o in cg.REF_LEN_OPS:
            ref_idx += l
    if lead_len is None:
        lead_len = read_idx
        lead_ref = ref_idx

    # trailing
    read_idx = n_read - 1
    ref_idx = pos + cg.ref_length(ops, lens) - 1
    trail_len = None
    trail_ref = 0
    run = 0
    for o, l in zip(ops.tolist()[::-1], lens.tolist()[::-1]):
        if o in cg.MATCH_OPS:
            for sp in range(l):
                if base_match(read_idx - sp, ref_idx - sp):
                    run += 1
                    if run >= contiguous:
                        trail_len = (n_read - (read_idx - sp)) - run
                        trail_ref = (ref_idx - sp) + run
                        break
                else:
                    run = 0
            if trail_len is not None:
                break
        elif o in cg.INDEL_OPS:
            run = 0
        if o in cg.READ_LEN_OPS:
            read_idx -= l
        if o in cg.REF_LEN_OPS:
            ref_idx -= l
    if trail_len is None:
        trail_len = n_read - (read_idx + 1)
        trail_ref = ref_idx + 1
    return lead_len, lead_ref, trail_len, trail_ref
