"""SV scoring: evidence orchestration + diploid/somatic/tumor models.

Behavioral parity with the reference SVScorer
(reference: GenerateSVCandidates/SVScorer.cpp, SVScorerSplit.cpp):
breakend depth/MQ0 checks, pair+split evidence gathering, pair/split
conflict resolution, fragment likelihoods with chimera/mapping-error
mixing, diploid genotyping (theta=1e-5 prior, GQ/PL, filters), somatic
two-tier scoring with mutation/noise frequency estimation, and
tumor-only filters.
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass, field

import numpy as np

from ..core.readfilter import has_sa_tag, is_read_unmapped_or_filtered_core
from ..core.svmodel import (
    EXT_DELETE, EXT_INSERT, EXT_TANDUP, SVCandidate, get_extended_sv_type,
    get_delete_size, is_sv_below_min_size,
)
from ..io.bam import FLAG_READ1
from ..parallel import counters as _counters
from .evidence import QscoreSnp, SVAlignmentInfo, SampleInfo, ScoreInfo
from .fragbank import (
    AL_ALT, AL_REF, FragmentBank, accumulate_lhood,
    resolve_pair_split_conflicts, support_counts,
)
from .pairscore import (
    AltPairProcessor, PairOptions, RefPairProcessor, get_frag_prob,
    is_large_insert_sv,
)

# DIPLOID_GT: REF, HET, HOM
DGT_REF, DGT_HET, DGT_HOM, DGT_SIZE = 0, 1, 2, 3
DGT_LABELS = ["ref", "het", "hom"]
_DGT_ALT_FRACTION = np.array([0.0, 0.5, 0.99])
# Tandem-duplication genotype fractions (accuracy refinement beyond the
# reference model; CallOptionsDiploid.dup_gt_model gates it).
#
# The reference applies {0, 0.5, 0.99} to every SV type
# (SVScoreInfoDiploid.hpp:40, altPriors), which systematically calls
# hom tandem DUPs as het: the alt haplotype ...X|a..b|a..b|Y... still
# CONTAINS both reference-junction contexts (X|a at copy-1 start, b|Y
# at copy-2 end) next to its one alt junction (b|a), so reference-
# junction-supporting fragments are produced by the alt allele itself.
# Counting junction loci: het = 1 alt / (1 + 2 + 2) = 0.2,
# hom = 2 alt / (2 + 4) = 1/3 — confirmed empirically on the 420 M-read
# WGS workload (observed alt-support fractions: het 0.210, hom 0.340;
# docs/PERF_r05.md). The mixture fractions below encode that structure.
_DGT_ALT_FRACTION_TANDUP = np.array([0.0, 0.2, 1.0 / 3.0])
# expected interior/flank read-depth ratio per genotype for a tandem
# duplication (ref, het, hom) — the depth channel the junction mixture
# cannot see
_DUP_DEPTH_RATIO = (1.0, 1.5, 2.0)
# SOMATIC_GT: REF, HET, HOM, SOM, NOISE
SGT_REF, SGT_HET, SGT_HOM, SGT_SOM, SGT_NOISE, SGT_SIZE = 0, 1, 2, 3, 4, 5
# what score_sv did in this process, for the run trace
# (parallel/counters, key "joint"): junctions scored, their
# samples summed (sample-junctions), the fragments in each sample's
# banks, and the ns spent gathering evidence and in the score models
JOINT_STATS = {"junctions": 0, "sample_junctions": 0, "fragments": [],
               "evidence_ns": 0, "genotype_ns": 0}
_counters.register({"joint": JOINT_STATS})


def _count_junction(tracks, evidence_ns: int, genotype_ns: int):
    frags = JOINT_STATS["fragments"]
    frags.extend([0] * (len(tracks) - len(frags)))
    for i, track in enumerate(tracks):
        frags[i] += track.n
    JOINT_STATS["junctions"] += 1
    JOINT_STATS["sample_junctions"] += len(tracks)
    JOINT_STATS["evidence_ns"] += evidence_ns
    JOINT_STATS["genotype_ns"] += genotype_ns


def log_sum(a: float, b: float) -> float:
    if a < b:
        a, b = b, a
    return a + math.log1p(math.exp(b - a))


def error_prob_to_qphred(p: float) -> int:
    if p <= 0:
        return 999
    return int(math.floor(-10.0 * math.log10(p) + 0.5))


def ln_error_prob_to_qphred(lnp: float) -> int:
    return int(math.floor(-10.0 * lnp / math.log(10.0) + 0.5))


def normalize_log_distro(vals: list[float]):
    """(reference: prob_util.hpp normalizeLogDistro): in-place
    ln->normalized-prob; returns argmax."""
    max_i = 0
    for i in range(1, len(vals)):
        if vals[i] > vals[max_i]:
            max_i = i
    m = vals[max_i]
    total = 0.0
    for i in range(len(vals)):
        vals[i] = math.exp(vals[i] - m)
        total += vals[i]
    for i in range(len(vals)):
        vals[i] /= total
    return max_i


def prob_comp(vals, skip_index: int) -> float:
    return sum(v for i, v in enumerate(vals) if i != skip_index)


@dataclass
class CallOptionsDiploid:
    indel_prior: float = 1e-5
    max_depth_factor: float = 3.0
    min_output_alt_score: int = 10
    min_pass_alt_score: int = 20
    max_mq0_frac: float = 0.4
    min_pass_gt_score: int = 15
    # "tandem-aware" (default): DUP junctions use the tandem-structure
    # alt fractions plus an interior/flank read-depth likelihood term;
    # "reference" reproduces the reference model exactly
    # (SVScoreInfoDiploid.hpp:40 fractions for all types, no depth term)
    dup_gt_model: str = "tandem-aware"


@dataclass
class CallOptionsSomatic:
    germline_sv_prior: float = 1e-5
    somatic_sv_prior: float = 1e-7
    small_noise_sv_prior: float = 1e-9
    large_noise_sv_prior: float = 1e-10
    max_depth_factor: float = 3.0
    min_output_somatic_score: int = 10
    min_pass_somatic_score: int = 30
    max_mq0_frac: float = 0.4


@dataclass
class CallOptionsTumor:
    max_depth_factor: float = 3.0
    max_mq0_frac: float = 0.4


@dataclass
class ProbSet:
    prob: float

    def __post_init__(self):
        self.comp = 1 - self.prob
        self.ln_prob = math.log(self.prob)
        self.ln_comp = math.log(self.comp)


@dataclass
class DiploidSampleResult:
    gt: int = DGT_REF
    gt_score: int = 0
    phred_loghood: list = field(default_factory=lambda: [0] * DGT_SIZE)
    pprob: list = field(default_factory=lambda: [0.0] * DGT_SIZE)
    filters: set = field(default_factory=set)


@dataclass
class DiploidResult:
    alt_score: int = 0
    filters: set = field(default_factory=set)
    samples: list = field(default_factory=list)


@dataclass
class SomaticResult:
    somatic_score: int = 0
    somatic_score_tier: int = 0
    filters: set = field(default_factory=set)


@dataclass
class TumorResult:
    filters: set = field(default_factory=set)


@dataclass
class RnaResult:
    """(reference: manta/SVScoreInfoRna.hpp + SVScorer.cpp
    scoreRNASV:1158): the reference's RNA fusion model — fixed default
    alt score with Imprecise/Local/LowEvidence filter branches."""
    alt_score: int = 0
    filters: set = field(default_factory=set)

    DEFAULT_SCORE = 42
    MIN_LENGTH = 100_000
    RNA_FILTER_LABEL = "LowEvidence"
    IMPRECISE_LABEL = "Imprecise"
    LOCAL_LABEL = "Local"


@dataclass
class ModelScoreInfo:
    base: ScoreInfo = field(default_factory=ScoreInfo)
    diploid: DiploidResult = field(default_factory=DiploidResult)
    somatic: SomaticResult = field(default_factory=SomaticResult)
    tumor: TumorResult = field(default_factory=TumorResult)
    rna: RnaResult = field(default_factory=RnaResult)


def _linear_scale(val, lo, hi):
    return min(1.0, max(0.0, (val - lo) / float(hi - lo)))


def get_spanning_pair_weight(sv: SVCandidate) -> float:
    """Small-deletion pair-evidence down-weighting ramp
    (reference: SVScorer.cpp getSpanningPairWeight:712)."""
    t = get_extended_sv_type(sv)
    if t not in (EXT_INSERT, EXT_DELETE):
        return 1.0
    if t == EXT_INSERT and is_large_insert_sv(sv):
        return _linear_scale(len(sv.insert_seq), 100, 150)
    center_size = abs(sv.bp2.interval.center_pos()
                      - sv.bp1.interval.center_pos())
    return _linear_scale(center_size, 300, 500)


def large_noise_sv_prior_weight(sv: SVCandidate) -> float:
    if sv.bp1.interval.tid != sv.bp2.interval.tid:
        return 1.0
    center_size = abs(sv.bp2.interval.center_pos()
                      - sv.bp1.interval.center_pos())
    return _linear_scale(center_size, 5000, 10000)


# ---------------------------------------------------------------------------
# fragment-level likelihoods (native over the fragment bank)

def add_diploid_loglhood(spanning_pair_weight: float, track: FragmentBank,
                         loglhood: list, fractions=None):
    """(reference: addDiploidLoglhood:767-801). Native accumulation in
    qname order over the bank (the reference's evidenceTrack_t is a
    std::map<std::string,...>, SVEvidence.hpp:243, and the per-genotype
    loglhood sums are float-order-sensitive). `fractions` overrides the
    genotype alt-allele fractions (tandem-DUP refinement)."""
    if fractions is None:
        fractions = _DGT_ALT_FRACTION
    accumulate_lhood(track, spanning_pair_weight, 0.0, 1e-3, 1e-3,
                     1e-6, 1e-5, False, fractions, loglhood)


def _compute_somatic_sample_loghood(spanning_pair_weight, track,
                                    somatic_freq, noise_freq, is_permissive,
                                    is_tumor, ref_chimera, alt_chimera,
                                    ref_split_map, alt_split_map, loglhood):
    """(reference: computeSomaticSampleLoghood:1143-1200)."""
    semi_mapped_power = 1.0 if (is_permissive and not is_tumor) else 0.0
    fractions = [0.0, 0.5, 1.0, somatic_freq, noise_freq]
    accumulate_lhood(track, spanning_pair_weight, semi_mapped_power,
                     ref_chimera.prob, alt_chimera.prob,
                     ref_split_map.prob, alt_split_map.prob,
                     is_permissive, fractions, loglhood)


def _resolve_pair_split_conflicts(sv: SVCandidate, evidence_tracks: list):
    """(reference: resolvePairSplitConflicts:476+)."""
    if sv.is_imprecise:
        return
    center_size = abs(sv.bp2.interval.center_pos()
                      - sv.bp1.interval.center_pos())
    find_alt_pair_conflict = center_size <= 1000
    for track in evidence_tracks:
        resolve_pair_split_conflicts(track, find_alt_pair_conflict)


# ---------------------------------------------------------------------------

class SVScorer:
    def __init__(self, scanner, readers, is_tumor: list[bool], fasta,
                 diploid_opt: CallOptionsDiploid | None = None,
                 somatic_opt: CallOptionsSomatic | None = None,
                 tumor_opt: CallOptionsTumor | None = None,
                 chrom_depths: dict | None = None,
                 is_rna: bool = False,
                 use_device_scoring: bool | str = False,
                 device=None):
        """``use_device_scoring``: ``"exact"`` or ``True`` (the exact
        split scan on the torch device ``device``), ``"mxu"`` (the
        matmul form), or anything else for the native host scan."""
        self.scanner = scanner
        self.readers = readers
        self.is_tumor = list(is_tumor)
        self.fasta = fasta
        self.diploid_opt = diploid_opt or CallOptionsDiploid()
        self.somatic_opt = somatic_opt or CallOptionsSomatic()
        self.tumor_opt = tumor_opt or CallOptionsTumor()
        self.chrom_depths = chrom_depths
        self.is_rna = is_rna
        self.sample_count = len(readers)
        self.diploid_sample_count = sum(1 for t in is_tumor if not t)
        self.ref_q = QscoreSnp(1e-3)
        self.alt_q = QscoreSnp(0.0)
        self._device_scan = None
        # 'jump' routes only contig jump scoring to the device (the
        # refiner's backend); split scans stay on the host-native scan
        if use_device_scoring in ("exact", "mxu", True):
            if device is None:
                raise ValueError("the device split scan needs a device")
            from .device_scan import DeviceScanContext
            self._device_scan = DeviceScanContext(
                mxu=(use_device_scoring == "mxu"), device=device)
        # diploid priors
        d = self.diploid_opt
        self.diploid_prior = [1 - d.indel_prior - d.indel_prior / 2,
                              d.indel_prior, d.indel_prior / 2]
        self.diploid_log_prior = [
            math.log(np.float32(p)) for p in
            [np.float32(self.diploid_prior[0]), np.float32(self.diploid_prior[1]),
             np.float32(self.diploid_prior[2])]]
        s = self.somatic_opt
        som_prior = [0.0] * SGT_SIZE
        som_prior[SGT_SOM] = s.somatic_sv_prior
        som_prior[SGT_NOISE] = s.large_noise_sv_prior
        som_prior[SGT_HET] = s.germline_sv_prior
        som_prior[SGT_HOM] = s.germline_sv_prior / 2
        som_prior[SGT_REF] = 1 - sum(som_prior[1:] + [som_prior[SGT_SOM]]) \
            if False else 1 - (som_prior[SGT_SOM] + som_prior[SGT_NOISE]
                               + som_prior[SGT_HET] + som_prior[SGT_HOM])
        self.somatic_prior = som_prior
        self.somatic_log_prior = [math.log(p) for p in som_prior]

    def somatic_log_prior_gt(self, gt: int, large_noise_weight: float) -> float:
        if gt != SGT_NOISE:
            return self.somatic_log_prior[gt]
        s = self.somatic_opt
        if large_noise_weight <= 0:
            return math.log(s.small_noise_sv_prior)
        if large_noise_weight >= 1:
            return math.log(s.large_noise_sv_prior)
        return math.log((1 - large_noise_weight) * s.small_noise_sv_prior
                        + large_noise_weight * s.large_noise_sv_prior)

    # ------------------------------------------------------------------
    # depth and MQ0

    def _get_breakend_depth_mq0(self, is_tumor_only: bool, bp):
        """(reference: getBreakendMaxMappedDepthAndMQ0:76-143)."""
        region_size = 50
        center = bp.interval.center_pos()
        beg = max(center - region_size, 0)
        end = center + region_size
        if end <= beg:
            return 0, 0.0
        from .._native import get_lib, i32p, i64p, u32p
        lib = get_lib()
        depth = np.zeros(end - beg, np.int32)
        total_reads = 0
        total_mq0 = 0
        for bam_index, reader in enumerate(self.readers):
            if (not is_tumor_only) and self.is_tumor[bam_index]:
                continue
            batch = reader.fetch(bp.interval.tid, beg, end)
            if batch.n == 0:
                continue
            sa = has_sa_tag(batch)
            bad = is_read_unmapped_or_filtered_core(batch, sa)
            keep = ~bad & (batch.pos < end)
            sel = np.flatnonzero(keep).astype(np.int64)
            total_reads += len(sel)
            total_mq0 += int((batch.mapq[sel] == 0).sum())
            # add align-match segments to depth (native pileup)
            rc = lib.mt_depth_pileup(
                len(sel), sel.ctypes.data_as(i64p),
                batch.pos.ctypes.data_as(i32p),
                batch.cigar_off.ctypes.data_as(i64p),
                batch.cigar.ctypes.data_as(u32p),
                beg, end, depth.ctypes.data_as(i32p))
            assert rc == 0, f"mt_depth_pileup failed: {rc}"
        max_depth = int(depth.max()) if len(depth) else 0
        mq0_frac = 0.0
        if total_reads >= 10:
            mq0_frac = total_mq0 / total_reads
        return max_depth, mq0_frac

    def _dup_depth_loglhood(self, sv, diploid_sample_index: int):
        """Per-genotype read-depth log-likelihood for a tandem DUP:
        compares the read-start count inside the duplicated interval
        against local flanks (expected interior/flank depth ratio 1 /
        1.5 / 2 for ref / het / hom). This is the evidence channel the
        junction mixture fundamentally cannot see — at a tandem DUP the
        alt haplotype itself emits reference-junction fragments, so
        junction support saturates at 0.2 (het) vs 1/3 (hom). Returns
        a DGT_SIZE list of log-likelihood increments (zeros when the
        interval is too small or flanks are data-poor). Poisson on read
        starts: reads, not bases, are the independent units."""
        zeros = [0.0] * DGT_SIZE
        tid = sv.bp1.interval.tid
        if sv.bp2.interval.tid != tid:
            return zeros
        a = min(sv.bp1.interval.center_pos(), sv.bp2.interval.center_pos())
        b = max(sv.bp1.interval.center_pos(), sv.bp2.interval.center_pos())
        margin, flank_w, max_in = 25, 400, 800
        if b - a < 2 * margin + 30:
            return zeros
        in_beg, in_end = a + margin, b - margin
        if in_end - in_beg > max_in:
            # sample the interval's two ends (GC-local to the flanks)
            halves = [(in_beg, in_beg + max_in // 2),
                      (in_end - max_in // 2, in_end)]
        else:
            halves = [(in_beg, in_end)]
        chrom_len = self.scanner.chrom_lengths[tid]
        flanks = [(max(a - margin - flank_w, 0), max(a - margin, 0)),
                  (min(b + margin, chrom_len), min(b + margin + flank_w,
                                                   chrom_len))]
        bam_index = [i for i, t in enumerate(self.is_tumor) if not t][
            diploid_sample_index]
        reader = self.readers[bam_index]

        def start_count(beg, end):
            if end <= beg:
                return 0
            batch = reader.fetch(tid, beg, end)
            if batch.n == 0:
                return 0
            sa = has_sa_tag(batch)
            bad = is_read_unmapped_or_filtered_core(batch, sa)
            return int((~bad & (batch.pos >= beg)
                        & (batch.pos < end)).sum())

        w_in = sum(e - s for s, e in halves)
        w_fl = sum(e - s for s, e in flanks)
        if w_in < 30 or w_fl < 100:
            return zeros
        k_in = sum(start_count(s, e) for s, e in halves)
        k_fl = sum(start_count(s, e) for s, e in flanks)
        if k_fl < 10:
            return zeros
        rate = k_fl / w_fl                      # ref-state reads per bp
        out = []
        for ratio in _DUP_DEPTH_RATIO:
            mu = max(rate * w_in * ratio, 1e-9)
            out.append(k_in * math.log(mu) - mu)   # Poisson, minus ln k!
        cross = self._dup_crossing_frag_loglhood(
            reader, tid, a, b, rate, bam_index)
        m = max(out)
        return [out[gt] - m + cross[gt] for gt in range(DGT_SIZE)]

    def _dup_crossing_frag_loglhood(self, reader, tid, a, b, read_rate,
                                    bam_index):
        """Whole-DUP-crossing fragment term — the channel that separates
        small hom from het tandem DUPs where the interior-depth window
        is too narrow (~1.4 sigma at 200 bp; PERF_r05 §1 residuals).

        A fragment whose mates flank the ENTIRE duplication maps with a
        normal template length only when drawn from a reference-like
        haplotype: on the duplicated haplotype the same flank-to-flank
        span must cover BOTH copies (physical length >= 2*size + 2
        anchors — essentially impossible for size ~>= fragment sigma) —
        so hom DUPs produce ~ZERO normal-tlen crossing fragments while
        het keeps ~half the reference rate. Poisson on the observed
        normal-tlen crossing count with expectations scaled (1, 0.5,
        0.05) for (ref, het, hom); the expectation integrates the
        fragment-size survival function over left-anchor positions, so
        sizes near the fragment ceiling degrade gracefully to a
        zero-information term."""
        zeros = [0.0] * DGT_SIZE
        size = b - a
        dists = getattr(self.scanner, "frag_dists", None)
        stats = getattr(self.scanner, "stats", None)
        if not dists or not stats:
            return zeros
        dist = dists[bam_index]
        st = stats[bam_index]
        p_lo, p_hi = st.proper_pair
        anchor = 30
        if size + 2 * anchor >= p_hi:
            return zeros            # proper fragments cannot cross
        w = int(p_hi) + 50
        beg = max(a - w, 0)
        batch = reader.fetch(tid, beg, a)
        if batch.n == 0:
            return zeros
        sa = has_sa_tag(batch)
        bad = is_read_unmapped_or_filtered_core(batch, sa)
        fwd = (batch.flag & 0x10) == 0
        tl = batch.tlen.astype(np.int64)
        # left mate fully left of the dup, fragment end beyond it, and
        # a template length consistent with the reference allele
        frag_end = batch.pos + tl
        cand = (~bad) & fwd & (tl > 0) & (batch.end_pos <= a) & \
            (frag_end >= b + anchor) & (tl <= p_hi) & (tl >= p_lo)
        k = int(cand.sum())
        # expected REF-allele crossing count: read-start rate times the
        # survival mass of fragments long enough to cross from each
        # left-anchor offset (coarse 10 bp integration). A start at s
        # needs F >= (b + anchor) - s with s <= a - read_len, i.e.
        # F >= size + anchor + read_len.
        rl = int(np.median(np.diff(batch.seq_off))) if batch.n else 100
        mu_ref = 0.0
        for d0 in range(size + anchor + rl, int(p_hi), 10):
            mu_ref += (1.0 - dist.cdf(d0)) * 10.0
        mu_ref *= read_rate / 2.0     # fwd left-anchors only
        if mu_ref < 3.0:
            return zeros              # too little power to speak
        out = []
        for frac in (1.0, 0.5, 0.05):
            mu = max(mu_ref * frac, 1e-9)
            out.append(k * math.log(mu) - mu)
        m = max(out)
        return [v - m for v in out]

    # ------------------------------------------------------------------
    # evidence orchestration

    def get_sv_supporting_evidence(self, svfinder_groups, assembly_data,
                                   is_tumor_only: bool, sv: SVCandidate,
                                   sv_id=None, support=None):
        """(reference: getSVSupportingEvidence:491+).
        Returns (ScoreInfo, evidence_tracks)."""
        base_info = ScoreInfo(samples=[SampleInfo()
                                       for _ in range(self.sample_count)])
        evidence_tracks = [FragmentBank() for _ in range(self.sample_count)]

        base_info.bp1_max_depth, base_info.bp1_mq0_frac = \
            self._get_breakend_depth_mq0(is_tumor_only, sv.bp1)
        base_info.bp2_max_depth, base_info.bp2_mq0_frac = \
            self._get_breakend_depth_mq0(is_tumor_only, sv.bp2)

        self._get_pair_support(svfinder_groups, assembly_data, sv,
                               evidence_tracks, sv_id, support)
        self._get_split_support(assembly_data, sv, base_info,
                                evidence_tracks, sv_id, support)
        _resolve_pair_split_conflicts(sv, evidence_tracks)

        for si in range(self.sample_count):
            counts = support_counts(evidence_tracks[si])
            sample = base_info.samples[si]
            for al, info in ((AL_ALT, sample.alt), (AL_REF, sample.ref)):
                info.spanning_pair_count += int(counts[al, 0])
                info.confident_spanning_pair_count += int(counts[al, 1])
                info.confident_semi_mapped_spanning_pair_count += \
                    int(counts[al, 2])
                info.confident_split_read_count += int(counts[al, 3])
            sample.ref.confident_split_read_and_pair_count_ref_bp1 += \
                int(counts[AL_REF, 4])
            sample.ref.confident_split_read_and_pair_count_ref_bp2 += \
                int(counts[AL_REF, 5])
        return base_info, evidence_tracks

    def _get_pair_support(self, groups, assembly_data, sv, evidence_tracks,
                          sv_id=None, support=None):
        """(reference: getSVPairSupport SVScorerPair.cpp:400-493)."""
        pair_opt = PairOptions(rna=self.is_rna,
                               use_proper_pair_flag=self.is_rna)
        processors = []
        alt_pair_found = False
        if assembly_data.is_candidate_spanning and \
                (sv.is_imprecise or assembly_data.is_spanning):
            incomplete_alt = False
            if not sv.is_imprecise:
                delete_size = get_delete_size(sv)
                max_close = int(self.scanner.extreme_fifth[1] * 2)
                incomplete_alt = 0 < delete_size <= max_close
            if not incomplete_alt:
                self._process_existing_alt_pairs(pair_opt, groups, sv,
                                                 evidence_tracks, sv_id,
                                                 support)
                alt_pair_found = True
        if not alt_pair_found:
            processors.append(AltPairProcessor(
                self.scanner, sv, True, pair_opt, evidence_tracks,
                assembly_data, sv_id=sv_id, support=support))
            processors.append(AltPairProcessor(
                self.scanner, sv, False, pair_opt, evidence_tracks,
                assembly_data, sv_id=sv_id, support=support))
        processors.append(RefPairProcessor(
            self.scanner, sv, True, pair_opt, evidence_tracks))
        processors.append(RefPairProcessor(
            self.scanner, sv, False, pair_opt, evidence_tracks))

        # stream each bam region once per processor interval
        for bam_index, reader in enumerate(self.readers):
            for proc in processors:
                tid, beg, end = proc.interval_for_bam(bam_index)
                if end - beg < 1:
                    continue
                batch = reader.fetch(tid, max(0, beg), end)
                if batch.n == 0:
                    continue
                sa = has_sa_tag(batch)
                from ..core.readfilter import is_read_filtered_core
                core_bad = is_read_filtered_core(batch, sa)
                nss = ((batch.flag & 0x800) != 0) | \
                    (((batch.flag & 0x100) != 0) & sa)
                keep = ~(core_bad | nss)
                # batch prefilter: stateless processors expose the exact
                # per-record rejects as a vectorized mask, so the Python
                # loop only touches surviving records
                mask = proc.survivor_mask(batch)
                if mask is not None:
                    keep &= mask
                order = np.argsort(batch.pos, kind="stable")
                order = order[keep[order]]
                if mask is not None and hasattr(proc, "process_batch"):
                    proc.process_batch(batch, order, bam_index)
                    continue
                for oi in order:
                    i = int(oi)
                    if mask is None and proc.is_skip_record(batch, i):
                        continue
                    proc.process(batch, i, bam_index)

    def _process_existing_alt_pairs(self, pair_opt, groups, sv,
                                    evidence_tracks, sv_id=None,
                                    support=None):
        """(reference: processExistingAltPairInfo:352-447)."""
        from ..core.svmodel import EV_PAIR, EV_LOCAL_PAIR
        min_mapq = self.scanner.opt.min_mapq
        min_tier2 = self.scanner.opt.min_tier2_mapq
        for bam_index, group in enumerate(groups):
            frag_distro = self.scanner.frag_dists[bam_index]
            for fragment in group.fragments:
                if fragment.read1 is None and fragment.read2 is None:
                    continue
                if not fragment.check_read_pair():
                    continue
                link = None
                for (idx, evtype) in fragment.sv_link:
                    if idx == sv.candidate_index:
                        link = evtype
                        break
                if link is None:
                    continue
                is_pair_type = link in (EV_PAIR, EV_LOCAL_PAIR)
                qname = None
                for r in (fragment.read1, fragment.read2):
                    if r is not None:
                        qname = r.batch.name_bytes(r.index)
                        break
                track = evidence_tracks[bam_index]
                row = track.row(qname)
                for (r, rd) in ((fragment.read1, 0), (fragment.read2, 1)):
                    if r is not None:
                        track.set_read_evidence(
                            row, rd, min_mapq, min_tier2,
                            int(r.batch.mapq[r.index]),
                            r.batch.read_len(r.index), False)
                is_support, frag_prob = get_frag_prob(
                    pair_opt, sv, fragment, frag_distro, is_pair_type)
                if not is_support or frag_prob <= 0:
                    continue
                track.set_pair_support(row, AL_ALT, 0, frag_prob)
                track.set_pair_support(row, AL_ALT, 1, frag_prob)
                if support is not None and sv_id is not None:
                    sfrag = support.get_fragment_from_pair(bam_index,
                                                           fragment)
                    sfrag.add_spanning_support(sv_id)

    def _get_split_support(self, assembly_data, sv, base_info,
                           evidence_tracks, sv_id=None, support=None):
        """(reference: getSVSplitReadSupport SVScorerSplit.cpp:369-461)."""
        if sv.is_imprecise:
            return
        align_info = SVAlignmentInfo(sv, assembly_data)
        if not align_info.is_min_bp_edge(100):
            return
        flank_score_size = 50
        min_mapq = self.scanner.opt.min_mapq
        min_tier2 = self.scanner.opt.min_tier2_mapq
        for bam_index, reader in enumerate(self.readers):
            sample = base_info.samples[bam_index]
            track = evidence_tracks[bam_index]
            for (bp, is_bp1) in ((sv.bp1, True), (sv.bp2, False)):
                self._score_split_reads(
                    flank_score_size, bp, align_info, is_bp1, min_mapq,
                    min_tier2, reader, track, sample,
                    bam_index=bam_index, sv_id=sv_id, support=support)
            # rms finish
            for allele in (sample.alt, sample.ref):
                if allele.split_read_count:
                    allele.split_read_mapq = math.sqrt(
                        allele.split_read_mapq / allele.split_read_count)
                else:
                    allele.split_read_mapq = 0.0

    def _score_split_reads(self, flank_score_size, bp, align_info, is_bp1,
                           min_mapq, min_tier2, reader, track, sample,
                           bam_index=0, sv_id=None, support=None):
        extended = 200
        tid = bp.interval.tid
        beg = max(0, bp.interval.beg - extended)
        end = bp.interval.end + extended
        batch = reader.fetch(tid, beg, end)
        if batch.n == 0:
            return
        sa = has_sa_tag(batch)
        bad = is_read_unmapped_or_filtered_core(batch, sa)
        nss = ((batch.flag & 0x800) != 0) | (((batch.flag & 0x100) != 0) & sa)
        order = np.argsort(batch.pos, kind="stable")
        bp1_contig = np.frombuffer(align_info.bp1_contig().encode(), np.uint8)
        bp2_contig = np.frombuffer(align_info.bp2_contig().encode(), np.uint8)
        bp1_ref = np.frombuffer(align_info.bp1_reference().encode(), np.uint8)
        bp2_ref = np.frombuffer(align_info.bp2_reference().encode(), np.uint8)
        # phase A: collect unevaluated candidate reads. The
        # soft-clip-matchified overlap test runs natively over the whole
        # batch (mt_matchify_ranges); only overlapping reads reach the
        # Python fragment-bank lookups.
        from .evidence import matchify_ranges_batch
        rng_beg, rng_end = matchify_ranges_batch(batch)
        overlap = (rng_end > bp.interval.beg) & (rng_beg < bp.interval.end)
        keep = ~(bad | nss) & overlap
        order = order[keep[order]]
        if len(order) == 0:
            return
        names = [batch.name_bytes(int(i)) for i in order]
        rows_all = track.rows_for(names)
        rds_all = ((batch.flag[order] & FLAG_READ1) == 0).astype(np.int64)
        fresh = ~track.sp_eval[rows_all, AL_ALT, 0, rds_all]
        if not fresh.any():
            return
        idx = order[fresh].astype(np.int64)
        rows = rows_all[fresh]
        rds = rds_all[fresh]
        # phase B: one scan for all reads x {alt,ref} x {bp1,bp2},
        # routed to the device scan when enabled (bit-identical results)
        from .evidence import split_finalize_multi, split_read_scan_multi
        scan = split_read_scan_multi
        if self._device_scan is not None and len(idx) >= 32:
            scan = self._device_scan.scan_multi
        alt_targets = [bp1_contig, bp2_contig]
        alt_ranges = [align_info.bp1_contig_offset,
                      align_info.bp2_contig_offset]
        ref_targets = [bp1_ref, bp2_ref]
        ref_ranges = [align_info.bp1_ref_offset, align_info.bp2_ref_offset]
        alt_lnl, alt_pos = scan(flank_score_size, batch, idx, self.alt_q,
                                alt_targets, alt_ranges)
        ref_lnl, ref_pos = scan(flank_score_size, batch, idx, self.ref_q,
                                ref_targets, ref_ranges)
        # winner-position mismatch accounting + evidence summary,
        # batched natively / vectorized over (reads x targets)
        from .evidence import finalize_split_evidence_multi
        alt_mm = split_finalize_multi(batch, idx, alt_targets, alt_ranges,
                                      alt_pos)
        ref_mm = split_finalize_multi(batch, idx, ref_targets, ref_ranges,
                                      ref_pos)
        nq_arr = batch.seq_off[idx + 1] - batch.seq_off[idx]
        alt_ev = finalize_split_evidence_multi(nq_arr, alt_pos, alt_ranges,
                                               alt_mm)
        ref_ev = finalize_split_evidence_multi(nq_arr, ref_pos, ref_ranges,
                                               ref_mm)
        self._finish_split_batch(batch, idx, rows, rds, track, sample,
                                 min_mapq, min_tier2, alt_lnl, alt_ev,
                                 ref_lnl, ref_ev, bam_index, sv_id, support)

    def _finish_split_batch(self, batch, idx, rows, rds, track, sample,
                            min_mapq, min_tier2, alt_lnl, alt_ev,
                            ref_lnl, ref_ev, bam_index, sv_id, support):
        """(reference: getReadSplitScore:104-229) — vectorized evidence
        update over the scanned reads from the per-(read, breakend) scan
        winners; bank scatters replace the per-read object writes."""
        mapqs = batch.mapq[idx].astype(np.int64)
        nq = (batch.seq_off[idx + 1] - batch.seq_off[idx]).astype(np.int32)
        track.sp_eval[rows, :, :, rds] = True

        # setReadEvidence (first write wins per fragment read)
        new = ~track.r_scanned[rows, rds]
        r_new, d_new = rows[new], rds[new]
        track.r_scanned[r_new, d_new] = True
        track.r_mapq[r_new, d_new] = mapqs[new].astype(np.int32)
        track.r_shadow[r_new, d_new] = False
        track.r_anch[r_new, d_new] = mapqs[new] >= min_mapq
        track.r_t2anch[r_new, d_new] = mapqs[new] >= min_tier2
        track.r_size[r_new, d_new] = nq[new]

        for bpi in (0, 1):
            track.sp_lnl[rows, AL_REF, bpi, rds] = \
                ref_lnl[:, bpi].astype(np.float64)
            track.sp_lnl[rows, AL_ALT, bpi, rds] = \
                alt_lnl[:, bpi].astype(np.float64)

        ref_llh = np.maximum(ref_lnl[:, 0], ref_lnl[:, 1])
        alt_llh = np.maximum(alt_lnl[:, 0], alt_lnl[:, 1])
        if self.is_rna:
            do_ref = do_alt = np.ones(len(idx), bool)
        else:
            do_ref = ref_llh > alt_llh
            do_alt = alt_llh > ref_llh

        for al, do, ev3, info in ((AL_REF, do_ref, ref_ev, sample.ref),
                                  (AL_ALT, do_alt, alt_ev, sample.alt)):
            is_ev, is_t2, evd = ev3
            for bpi in (0, 1):
                f = do & is_ev[:, bpi]
                track.sp_sup[rows[f], al, bpi, rds[f]] = True
                track.sp_ev[rows[f], al, bpi, rds[f]] = evd[f, bpi]
                t = do & is_t2[:, bpi]
                track.sp_t2[rows[t], al, bpi, rds[t]] = True
            counted = do & (is_ev[:, 0] | is_ev[:, 1])
            n_counted = int(counted.sum())
            if n_counted:
                info.split_read_count += n_counted
                evm = np.maximum(np.where(is_ev[:, 0], evd[:, 0], 0.0),
                                 np.where(is_ev[:, 1], evd[:, 1], 0.0))
                for v in evm[counted]:
                    info.split_read_evidence += float(v)
                info.split_read_mapq += float((mapqs[counted] ** 2).sum())

        if support is not None and sv_id is not None:
            # (reference: SVScorerSplit.cpp:254-256)
            flagged = track.sp_sup[rows, AL_ALT, 0, rds] | \
                track.sp_sup[rows, AL_ALT, 1, rds]
            for k in np.flatnonzero(flagged):
                sfrag = support.get_fragment(bam_index, batch, int(idx[k]))
                sfrag.add_split_support(bool(rds[k] == 0), sv_id)

    # ------------------------------------------------------------------
    # models

    def score_diploid(self, junction_data, result: DiploidResult):
        """(reference: scoreDiploidSV:803-960)."""
        max_q = 999
        result.samples = [DiploidSampleResult()
                          for _ in range(self.diploid_sample_count)]
        joint_ref_prob = 1.0
        tandem_aware = self.diploid_opt.dup_gt_model == "tandem-aware"
        for ds in range(self.diploid_sample_count):
            sres = result.samples[ds]
            loglhood = [0.0] * DGT_SIZE
            for (sv, tracks, base, weight) in junction_data:
                is_dup = tandem_aware and \
                    get_extended_sv_type(sv) == EXT_TANDUP
                add_diploid_loglhood(
                    weight, tracks[ds], loglhood,
                    fractions=_DGT_ALT_FRACTION_TANDUP if is_dup else None)
                if is_dup:
                    dlh = self._dup_depth_loglhood(sv, ds)
                    for gt in range(DGT_SIZE):
                        loglhood[gt] += dlh[gt]
            pprob = [loglhood[gt] + self.diploid_log_prior[gt]
                     for gt in range(DGT_SIZE)]
            max_gt = normalize_log_distro(pprob)
            sres.gt = max_gt
            sres.gt_score = min(max_q, error_prob_to_qphred(
                prob_comp(pprob, sres.gt)))
            max_lhood_i = 0
            for gt in range(1, DGT_SIZE):
                if loglhood[gt] > loglhood[max_lhood_i]:
                    max_lhood_i = gt
            for gt in range(DGT_SIZE):
                sres.pprob[gt] = pprob[gt]
                sres.phred_loghood[gt] = min(max_q, ln_error_prob_to_qphred(
                    loglhood[gt] - loglhood[max_lhood_i]))
            joint_ref_prob *= pprob[DGT_REF]
        result.alt_score = min(max_q, error_prob_to_qphred(joint_ref_prob))

        d = self.diploid_opt
        if result.alt_score < d.min_pass_alt_score:
            result.filters.add("MinQUAL")
        # Under the tandem-aware DUP model, het (0.2) and hom (1/3)
        # fractions are intentionally close, so the het-vs-hom margin —
        # and with it GQ — is small even when the variant's presence is
        # certain. The MinGQ sample filter exists to drop unreliable
        # CALLS, not uncertain zygosity, so for these junctions it keys
        # off the non-ref posterior instead; the GQ column itself stays
        # the honest genotype quality.
        dup_nonref_filter = tandem_aware and all(
            get_extended_sv_type(sv) == EXT_TANDUP
            for (sv, _, _, _) in junction_data)
        all_filtered = True
        for sres in result.samples:
            if sres.gt == DGT_REF:
                sres.filters.add("HomRef")
            filter_gq = sres.gt_score
            if dup_nonref_filter and sres.gt != DGT_REF:
                nonref_q = min(max_q,
                               error_prob_to_qphred(sres.pprob[DGT_REF]))
                filter_gq = max(filter_gq, nonref_q)
            if filter_gq < d.min_pass_gt_score:
                sres.filters.add("MinGQ")
            if not sres.filters:
                all_filtered = False
        if all_filtered:
            result.filters.add("SampleFT")
        junction_count = len(junction_data)
        if self.chrom_depths is not None:
            filtered = 0
            for (sv, tracks, base, weight) in junction_data:
                d1 = self.chrom_depths.get(
                    self.scanner.chrom_names[sv.bp1.interval.tid], None)
                d2 = self.chrom_depths.get(
                    self.scanner.chrom_names[sv.bp2.interval.tid], None)
                if d1 is not None and \
                        base.bp1_max_depth > d1 * d.max_depth_factor:
                    filtered += 1
                elif d2 is not None and \
                        base.bp2_max_depth > d2 * d.max_depth_factor:
                    filtered += 1
            if filtered * 2 > junction_count:
                result.filters.add("MaxDepth")
        filtered = 0
        for (sv, tracks, base, weight) in junction_data:
            if is_sv_below_min_size(sv, 1000):
                if base.bp1_mq0_frac > d.max_mq0_frac or \
                        base.bp2_mq0_frac > d.max_mq0_frac:
                    filtered += 1
        if filtered * 2 > junction_count:
            result.filters.add("MaxMQ0Frac")
        max_close = int(self.scanner.extreme_fifth[1])
        filtered = 0
        for (sv, tracks, base, weight) in junction_data:
            t = get_extended_sv_type(sv)
            if t != EXT_INSERT and not is_sv_below_min_size(sv, max_close):
                total = sum(
                    base.samples[ds].alt.confident_spanning_pair_count
                    for ds in range(self.diploid_sample_count))
                if total == 0:
                    filtered += 1
        if filtered * 2 > junction_count:
            result.filters.add("NoPairSupport")

    def score_somatic(self, junction_data, result: SomaticResult):
        """(reference: scoreSomaticSV:1202-1406)."""
        assert self.sample_count == 2 and self.diploid_sample_count == 1
        normal_index, tumor_index = 0, 1
        is_mj_event = len(junction_data) > 1
        large_noise_weight = max(
            large_noise_sv_prior_weight(sv)
            for (sv, _, _, _) in junction_data)

        def support_count(allele, weight):
            return allele.confident_split_read_count + \
                int(weight * allele.confident_spanning_pair_count)

        tier_score = [0, 0]
        for tier in range(2):
            is_permissive = tier != 0
            normal_lhood = [0.0] * SGT_SIZE
            tumor_lhood = [0.0] * SGT_SIZE
            alt_counts = ref_counts = 0
            for (sv, tracks, base, weight) in junction_data:
                alt_counts += support_count(base.samples[tumor_index].alt,
                                            weight)
                ref_counts += support_count(base.samples[tumor_index].ref,
                                            weight)
            somatic_freq = alt_counts / (alt_counts + ref_counts) \
                if alt_counts + ref_counts else 0.0
            alt_counts = ref_counts = 0
            for (sv, tracks, base, weight) in junction_data:
                for si in (normal_index, tumor_index):
                    alt_counts += support_count(base.samples[si].alt, weight)
                    ref_counts += support_count(base.samples[si].ref, weight)
            noise_freq = alt_counts / (alt_counts + ref_counts) \
                if alt_counts + ref_counts else 0.0

            chimera_default = ProbSet(2e-5 if is_mj_event else 1e-4)
            chimera_permissive = ProbSet(5e-6)
            chimera = chimera_permissive if is_permissive else chimera_default
            ref_split_map = ProbSet(1e-6)
            alt_split_default = ProbSet(1e-4)
            alt_split_permissive = ProbSet(1e-6)
            alt_split = alt_split_permissive if is_permissive \
                else alt_split_default

            for (sv, tracks, base, weight) in junction_data:
                _compute_somatic_sample_loghood(
                    weight, tracks[tumor_index], somatic_freq, noise_freq,
                    is_permissive, True, chimera_default, chimera_default,
                    ref_split_map, alt_split_default, tumor_lhood)
                _compute_somatic_sample_loghood(
                    weight, tracks[normal_index], 0, noise_freq,
                    is_permissive, False, chimera_default, chimera,
                    ref_split_map, alt_split, normal_lhood)

            somatic_pprob = [
                tumor_lhood[gt] + normal_lhood[gt]
                + self.somatic_log_prior_gt(gt, large_noise_weight)
                for gt in range(SGT_SIZE)]
            normalize_log_distro(somatic_pprob)

            normal_diploid = [0.0] * DGT_SIZE
            for (sv, tracks, base, weight) in junction_data:
                add_diploid_loglhood(weight, tracks[normal_index],
                                     normal_diploid)
            normal_pprob = list(normal_diploid)
            normalize_log_distro(normal_pprob)

            nonsomatic = prob_comp(somatic_pprob, SGT_SOM)
            nonref = prob_comp(normal_pprob, DGT_REF)
            nonsomatic_ref = nonsomatic + nonref - nonsomatic * nonref
            tier_score[tier] = error_prob_to_qphred(nonsomatic_ref)
            if tier_score[tier] <= 0:
                break

        result.somatic_score = min(tier_score[0], tier_score[1])
        result.somatic_score_tier = 1 if tier_score[1] > tier_score[0] else 0

        s = self.somatic_opt
        junction_count = len(junction_data)
        if self.chrom_depths is not None:
            filtered = 0
            for (sv, tracks, base, weight) in junction_data:
                d1 = self.chrom_depths.get(
                    self.scanner.chrom_names[sv.bp1.interval.tid], None)
                d2 = self.chrom_depths.get(
                    self.scanner.chrom_names[sv.bp2.interval.tid], None)
                if (d1 is not None
                        and base.bp1_max_depth > d1 * s.max_depth_factor) or \
                        (d2 is not None
                         and base.bp2_max_depth > d2 * s.max_depth_factor):
                    filtered += 1
            if filtered * 2 > junction_count:
                result.filters.add("MaxDepth")
        if result.somatic_score < s.min_pass_somatic_score:
            result.filters.add("MinSomaticScore")
        filtered = 0
        for (sv, tracks, base, weight) in junction_data:
            if is_sv_below_min_size(sv, 1000):
                if base.bp1_mq0_frac > s.max_mq0_frac or \
                        base.bp2_mq0_frac > s.max_mq0_frac:
                    filtered += 1
        if filtered * 2 > junction_count:
            result.filters.add("MaxMQ0Frac")

    def score_tumor(self, junction_data, result: TumorResult):
        """(reference: scoreTumorSV:958-1030)."""
        t = self.tumor_opt
        junction_count = len(junction_data)
        if self.chrom_depths is not None:
            filtered = 0
            for (sv, tracks, base, weight) in junction_data:
                d1 = self.chrom_depths.get(
                    self.scanner.chrom_names[sv.bp1.interval.tid], None)
                d2 = self.chrom_depths.get(
                    self.scanner.chrom_names[sv.bp2.interval.tid], None)
                if (d1 is not None
                        and base.bp1_max_depth > d1 * t.max_depth_factor) or \
                        (d2 is not None
                         and base.bp2_max_depth > d2 * t.max_depth_factor):
                    filtered += 1
            if filtered * 2 > junction_count:
                result.filters.add("MaxDepth")
        filtered = 0
        for (sv, tracks, base, weight) in junction_data:
            if is_sv_below_min_size(sv, 1000):
                if base.bp1_mq0_frac > t.max_mq0_frac or \
                        base.bp2_mq0_frac > t.max_mq0_frac:
                    filtered += 1
        if filtered * 2 > junction_count:
            result.filters.add("MaxMQ0Frac")

    def score_rna(self, junction_data, result: RnaResult):
        """(reference: scoreRNASV SVScorer.cpp)."""
        (sv, _tracks, base, _w) = junction_data[0]
        result.alt_score = RnaResult.DEFAULT_SCORE
        if sv.is_imprecise:
            result.filters.add(RnaResult.IMPRECISE_LABEL)
            return
        if sv.bp1.interval.tid == sv.bp2.interval.tid and \
                abs(sv.bp2.interval.center_pos()
                    - sv.bp1.interval.center_pos()) < RnaResult.MIN_LENGTH:
            result.filters.add(RnaResult.LOCAL_LABEL)
        base_sample = base.samples[0]
        if base_sample.alt.split_read_count == 0:
            result.filters.add(RnaResult.RNA_FILTER_LABEL)
        if base_sample.alt.confident_spanning_pair_count == 0:
            result.filters.add(RnaResult.RNA_FILTER_LABEL)

    def compute_all_score_models(self, is_somatic, is_tumor_only,
                                 junction_data, model_info: ModelScoreInfo):
        if self.is_rna:
            self.score_rna(junction_data, model_info.rna)
        elif is_tumor_only:
            self.score_tumor(junction_data, model_info.tumor)
        else:
            self.score_diploid(junction_data, model_info.diploid)
            if is_somatic:
                self.score_somatic(junction_data, model_info.somatic)

    def score_sv(self, svfinder_groups, mj_assembly_data, mj_junctions,
                 is_junction_filtered, is_somatic, is_tumor_only,
                 sv_ids=None, support=None):
        """(reference: scoreSV:1432-1530). Returns
        (model_infos, joint_model_info, is_mj_event)."""
        junction_count = len(mj_junctions)
        model_infos = [ModelScoreInfo() for _ in range(junction_count)]
        junction_evidence = [None] * junction_count
        junction_weight = [0.0] * junction_count

        unfiltered = 0
        for ji in range(junction_count):
            if is_junction_filtered[ji]:
                continue
            unfiltered += 1
            sv = mj_junctions[ji]
            sv_id = sv_ids[ji].local_id if sv_ids is not None else None
            t0 = time.perf_counter_ns()
            base, tracks = self.get_sv_supporting_evidence(
                svfinder_groups, mj_assembly_data[ji], is_tumor_only, sv,
                sv_id=sv_id, support=support)
            t1 = time.perf_counter_ns()
            model_infos[ji].base = base
            junction_evidence[ji] = tracks
            junction_weight[ji] = get_spanning_pair_weight(sv)
            junction_data = [(sv, tracks, base, junction_weight[ji])]
            self.compute_all_score_models(is_somatic, is_tumor_only,
                                          junction_data, model_infos[ji])
            _count_junction(tracks, t1 - t0, time.perf_counter_ns() - t1)

        joint_info = ModelScoreInfo()
        is_mj_event = False
        if unfiltered == 2:
            is_mj_event = True
            junction_data = []
            for ji in range(junction_count):
                if is_junction_filtered[ji]:
                    continue
                junction_data.append(
                    (mj_junctions[ji], junction_evidence[ji],
                     model_infos[ji].base, junction_weight[ji]))
            t0 = time.perf_counter_ns()
            self.compute_all_score_models(is_somatic, is_tumor_only,
                                          junction_data, joint_info)
            JOINT_STATS["genotype_ns"] += time.perf_counter_ns() - t0
        return model_infos, joint_info, is_mj_event
