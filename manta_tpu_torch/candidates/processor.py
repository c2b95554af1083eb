"""Per-edge candidate evaluation: assembly, filtering, scoring, writing.

Behavioral parity with the reference SVCandidateProcessor
(reference: GenerateSVCandidates/SVCandidateProcessor.cpp): isolated-edge
large-insertion search, per-junction assembly with multi-assembly
round-robin output, candidate span/size filters, scoring dispatch, and
the SVWriter diploid/somatic/tumor output rules.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..core.svmodel import SVCandidate, is_complex_sv, is_sv_below_min_size
from ..format.vcfwriter import EventInfo, make_sv_id
from ..scoring.scorer import DGT_REF, ModelScoreInfo


def test_isolated_edge(locus_set, locus_index, n1, n2) -> bool:
    """(reference: svgraph/EdgeInfoUtil.cpp testIsolatedEdge): true if
    this is a self-edge of a node whose locus has few (bi-)edges."""
    if n1 != n2:
        return False
    locus = locus_set.loci[locus_index]
    min_count = locus_set.min_merge_edge_count
    edge_count = 0
    bi_edge_count = 0
    for a in range(len(locus.nodes)):
        for b in sorted(locus.nodes[a].edges):
            if b < a:
                continue
            if a == b:
                continue
            edge_count += 1
            if locus.nodes[a].edges[b] >= min_count and \
                    locus.nodes[b].edges[a] >= min_count:
                bi_edge_count += 1
    is_low_bi = 1 <= bi_edge_count <= 2
    is_low_total = edge_count <= 4
    return not (is_low_bi and is_low_total)


@dataclass
class ProcessorOptions:
    min_candidate_spanning_count: int = 3
    min_scored_variant_size: int = 50
    min_candidate_variant_size: int = 8
    is_rna: bool = False
    is_skip_assembly: bool = False
    is_skip_scoring: bool = False


@dataclass
class EdgeState:
    """Per-edge processing state, split from the processor instance so
    many edges can sit between the prepare and finish stages while
    their contig-alignment jobs ride one batched backend dispatch
    (SURVEY §2.4 P3: batch many edges per device step)."""
    edge: tuple
    mj_groups: list
    svfinder_groups: list
    is_self_edge: bool = False
    find_large_insertions: bool = False
    mj_datas: list = None
    pending: list = None
    assembly_time: object = None
    scoring_time: object = None
    assembled_count: int = 0
    assembled_complex_count: int = 0
    edge_support: object = None


class SVCandidateProcessor:
    def __init__(self, opt: ProcessorOptions, refiner, scorer, writer,
                 locus_set, is_somatic: bool, is_tumor_only: bool,
                 edge_tracker=None, evidence_enabled: bool = False):
        self.opt = opt
        self.refiner = refiner
        self.scorer = scorer
        self.writer = writer
        self.locus_set = locus_set
        self.is_somatic = is_somatic
        self.is_tumor_only = is_tumor_only
        self.edge_tracker = edge_tracker
        self.evidence_enabled = evidence_enabled
        self.edge_support = None
        self._reset_edge_state(False)

    def _reset_edge_state(self, is_self_edge):
        from ..workflow.stats import CpuTimes
        self._is_self_edge = is_self_edge
        self.assembly_time = CpuTimes()
        self.scoring_time = CpuTimes()
        self.assembled_count = 0
        self.assembled_complex_count = 0
        if self.evidence_enabled:
            from ..scoring.evidence_bam import SupportSamples
            self.edge_support = SupportSamples(self.scorer.sample_count)

    def evaluate_candidates(self, edge, mj_groups, svfinder_groups):
        """(reference: evaluateCandidates:54-96) — single-edge
        convenience: prepare, flush the (at most one edge's) deferred
        alignment jobs, finish."""
        st = self.prepare_candidates(edge, mj_groups, svfinder_groups)
        self.flush_pending([st])
        self.finish_candidates(st)
        return st

    # ------------------------------------------------------------------
    # staged pipeline

    def prepare_candidates(self, edge, mj_groups,
                           svfinder_groups) -> EdgeState:
        """Stage 1: per-junction breakend assembly with the spanning
        contig alignment deferred (refiner defer_spanning)."""
        from ..workflow.stats import CpuTimes, TimeBlock
        li, n1, n2 = edge
        st = EdgeState(edge=edge, mj_groups=mj_groups,
                       svfinder_groups=svfinder_groups,
                       is_self_edge=(n1 == n2))
        st.assembly_time = CpuTimes()
        st.scoring_time = CpuTimes()
        st.mj_datas = []
        st.pending = []
        if self.evidence_enabled:
            from ..scoring.evidence_bam import SupportSamples
            st.edge_support = SupportSamples(self.scorer.sample_count)
        is_isolated = test_isolated_edge(self.locus_set, li, n1, n2)
        find_large_insertions = is_isolated
        if find_large_insertions:
            for junctions in mj_groups:
                for sv in junctions:
                    if not is_complex_sv(sv):
                        find_large_insertions = False
        st.find_large_insertions = find_large_insertions
        self.refiner.clear_edge_data()
        for junctions in mj_groups:
            datas = []
            for sv in junctions:
                if self.opt.is_skip_assembly:
                    from .refiner import AssemblyData
                    datas.append(AssemblyData())
                    continue
                tb = TimeBlock()
                with tb:
                    data = self.refiner.get_candidate_assembly_data(
                        sv, find_large_insertions, defer_spanning=True)
                st.assembly_time.merge(tb.times)
                if data.pending_prep is not None:
                    st.pending.append((sv, data))
                datas.append(data)
            st.mj_datas.append(datas)
        return st

    def flush_pending(self, states: list):
        """Stage 2: score every deferred contig-alignment job across
        all prepared edges in one backend dispatch (device jump kernel
        or native score batch), then complete each junction's selection
        and refinement. Dispatch wall time is attributed back to each
        edge's assembly time by job share."""
        pendings = [(st, sv, data) for st in states
                    for (sv, data) in st.pending]
        if not pendings:
            return
        from ..workflow.stats import TimeBlock
        jobs = []
        spans = []
        for (_st, _sv, data) in pendings:
            j = self.refiner.jump_jobs(data, data.pending_prep)
            spans.append((len(jobs), len(jobs) + len(j)))
            jobs.extend(j)
        tb = TimeBlock()
        with tb:
            scores = self.refiner._jump_score_backend(jobs)
            for (st, sv, data), (lo, hi) in zip(pendings, spans):
                self.refiner.finish_deferred(sv, data, scores[lo:hi])
        total_jobs = max(1, len(jobs))
        for st in states:
            n_st = sum(hi - lo for (s2, _, _), (lo, hi)
                       in zip(pendings, spans) if s2 is st)
            if n_st:
                share = tb.times.scaled(n_st / total_jobs)
                st.assembly_time.merge(share)
                st.flush_wall = getattr(st, "flush_wall", 0.0) + share.wall

    def finish_candidates(self, st: EdgeState):
        """Stage 3: multi-assembly round-robin, filtering, scoring and
        output for one prepared edge (runs in edge order)."""
        self._is_self_edge = st.is_self_edge
        self.assembly_time = st.assembly_time
        self.scoring_time = st.scoring_time
        self.assembled_count = 0
        self.assembled_complex_count = 0
        self.edge_support = st.edge_support
        for junctions, datas in zip(st.mj_groups, st.mj_datas):
            if not self.opt.is_skip_assembly:
                for data in datas:
                    self.assembled_count += len(data.svs)
                    if data.svs and not data.is_spanning:
                        self.assembled_complex_count += len(data.svs)
                    if self.edge_tracker is not None:
                        self.edge_tracker.update_assembly_count(
                            st.is_self_edge, len(data.svs),
                            data.is_spanning)
            self._evaluate_candidate(st.edge, junctions,
                                     st.svfinder_groups, datas)
        st.assembled_count = self.assembled_count
        st.assembled_complex_count = self.assembled_complex_count

    def _evaluate_candidate(self, edge, junctions, svfinder_groups,
                            mj_assembly_data):
        """(reference: evaluateCandidate:271-363)."""
        junction_count = len(junctions)
        any_small_assembler = any(
            data.svs and not data.is_spanning for data in mj_assembly_data)

        trackers = [0] * junction_count
        while True:
            is_write = False
            assembled = [None] * junction_count
            for ji in range(junction_count):
                data = mj_assembly_data[ji]
                if not data.svs:
                    if trackers[ji] != 0:
                        continue
                    assembled[ji] = junctions[ji]
                else:
                    if trackers[ji] >= len(data.svs):
                        continue
                    assembled[ji] = data.svs[trackers[ji]]
                trackers[ji] += 1
                is_write = True
            if not is_write:
                break
            # when some junctions exhausted, reuse their last assembled sv
            for ji in range(junction_count):
                if assembled[ji] is None:
                    data = mj_assembly_data[ji]
                    assembled[ji] = junctions[ji] if not data.svs \
                        else data.svs[min(trackers[ji], len(data.svs)) - 1]
            if junction_count > 1 and any_small_assembler:
                for ji in range(junction_count):
                    filtered = [True] * junction_count
                    filtered[ji] = False
                    self._score_and_write(edge, svfinder_groups,
                                          mj_assembly_data, assembled,
                                          filtered)
            else:
                self._score_and_write(edge, svfinder_groups,
                                      mj_assembly_data, assembled,
                                      [False] * junction_count)

    def _check_junctions_to_filter(self, mj_junctions, mj_assembly_data,
                                   filtered):
        """(reference: checkJunctionsToFilter:99-180)."""
        junction_count = len(mj_junctions)
        min_junction_spanning = min(2, self.opt.min_candidate_spanning_count)
        candidate_span_fail = True
        for ji in range(junction_count):
            data = mj_assembly_data[ji]
            sv = mj_junctions[ji]
            spanning = data.is_candidate_spanning

            def post_assembly_spanning_count():
                if (not self.opt.is_rna) and sv.is_imprecise:
                    return sv.bp1.get_pair_count()
                return sv.bp1.get_spanning_count()

            junction_span_fail = False
            if spanning:
                if post_assembly_spanning_count() < \
                        self.opt.min_candidate_spanning_count:
                    junction_span_fail = True
            if not junction_span_fail:
                candidate_span_fail = False
            if spanning:
                if post_assembly_spanning_count() < min_junction_spanning:
                    filtered[ji] = True
                    continue
            else:
                if sv.is_imprecise:
                    filtered[ji] = True
                    continue
            if is_sv_below_min_size(sv, self.opt.min_candidate_variant_size):
                filtered[ji] = True
                continue
        if candidate_span_fail:
            for ji in range(junction_count):
                filtered[ji] = True

    def _score_and_write(self, edge, svfinder_groups, mj_assembly_data,
                         mj_junctions, input_filtered):
        """(reference: scoreAndWriteSV:221-268)."""
        candidate_filtered = list(input_filtered)
        self._check_junctions_to_filter(mj_junctions, mj_assembly_data,
                                        candidate_filtered)
        if all(candidate_filtered):
            return
        junction_count = len(mj_junctions)
        sv_ids = [make_sv_id(edge, sv, self.opt.is_rna)
                  for sv in mj_junctions]
        scored_filtered = list(candidate_filtered)
        model_infos = [ModelScoreInfo() for _ in range(junction_count)]
        joint_info = ModelScoreInfo()
        is_mj_event = False
        if not self.opt.is_skip_scoring:
            for ji in range(junction_count):
                if scored_filtered[ji]:
                    continue
                if is_sv_below_min_size(mj_junctions[ji],
                                        self.opt.min_scored_variant_size):
                    scored_filtered[ji] = True
            if not all(scored_filtered):
                from ..workflow.stats import TimeBlock
                if self.edge_tracker is not None:
                    unfiltered = sum(1 for f in scored_filtered if not f)
                    self.edge_tracker.update_junction_counts(
                        self._is_self_edge, unfiltered,
                        is_complex_sv(mj_junctions[0]))
                tb = TimeBlock()
                with tb:
                    model_infos, joint_info, is_mj_event = \
                        self.scorer.score_sv(
                            svfinder_groups, mj_assembly_data, mj_junctions,
                            scored_filtered, self.is_somatic,
                            self.is_tumor_only, sv_ids=sv_ids,
                            support=self.edge_support)
                self.scoring_time.merge(tb.times)
        self.writer.write_sv(
            mj_assembly_data, mj_junctions, candidate_filtered,
            scored_filtered, sv_ids, model_infos, joint_info, is_mj_event)


class SVWriter:
    """Output fan-out (reference: GenerateSVCandidates/SVWriter.cpp)."""

    def __init__(self, cand_writer, diploid_writer=None, somatic_writer=None,
                 tumor_writer=None, rna_writer=None,
                 diploid_sample_count: int = 1,
                 min_output_alt_score: int = 10,
                 min_output_somatic_score: int = 10,
                 is_skip_scoring: bool = False):
        self.cand_writer = cand_writer
        self.diploid_writer = diploid_writer
        self.somatic_writer = somatic_writer
        self.tumor_writer = tumor_writer
        self.rna_writer = rna_writer
        self.diploid_sample_count = diploid_sample_count
        self.min_output_alt_score = min_output_alt_score
        self.min_output_somatic_score = min_output_somatic_score
        self.is_skip_scoring = is_skip_scoring

    def write_sv(self, mj_assembly_data, mj_junctions, candidate_filtered,
                 scored_filtered, sv_ids, model_infos, joint_info,
                 is_mj_event):
        junction_count = len(mj_junctions)
        for ji in range(junction_count):
            if candidate_filtered[ji]:
                continue
            self.cand_writer.write_sv(mj_assembly_data[ji], mj_junctions[ji],
                                      sv_ids[ji])
        if self.is_skip_scoring:
            return
        if all(scored_filtered):
            return
        unfiltered_count = sum(1 for f in scored_filtered if not f)

        is_mj_diploid_event = is_mj_event
        event = EventInfo(junction_count=unfiltered_count)
        mj_write_diploid = False
        mj_write_somatic = False
        junction_sample_check_fail = [False] * self.diploid_sample_count

        if is_mj_event:
            for si in range(self.diploid_sample_count):
                joint_sample = joint_info.diploid.samples[si]
                joint_gt = joint_sample.gt
                joint_pprob = joint_sample.pprob[joint_gt]
                if joint_gt == DGT_REF:
                    junction_sample_check_fail[si] = True
                    continue
                for ji in range(junction_count):
                    if scored_filtered[ji]:
                        continue
                    s = model_infos[ji].diploid.samples[si]
                    single_gt = s.gt
                    single_pprob = s.pprob[single_gt]
                    delta = joint_pprob - s.pprob[joint_gt]
                    if joint_gt != single_gt and delta > 0.9 and \
                            single_pprob > 0.9:
                        junction_sample_check_fail[si] = True
                        break
            if all(junction_sample_check_fail):
                is_mj_diploid_event = False
            for ji in range(junction_count):
                if scored_filtered[ji]:
                    continue
                if not event.label:
                    event.label = sv_ids[ji].local_id
                mi = model_infos[ji]
                if len(joint_info.diploid.filters) > len(mi.diploid.filters):
                    is_mj_diploid_event = False
                elif joint_info.diploid.alt_score < mi.diploid.alt_score:
                    is_mj_diploid_event = False
                if joint_info.somatic.somatic_score >= \
                        self.min_output_somatic_score or \
                        mi.somatic.somatic_score >= \
                        self.min_output_somatic_score:
                    mj_write_somatic = True
            if is_mj_diploid_event:
                mj_write_diploid = joint_info.diploid.alt_score >= \
                    self.min_output_alt_score

        non_event = EventInfo()
        for ji in range(junction_count):
            if scored_filtered[ji]:
                continue
            data = mj_assembly_data[ji]
            sv = mj_junctions[ji]
            mi = model_infos[ji]
            sv_id = sv_ids[ji]
            base = mi.base
            if self.tumor_writer is not None:
                self.tumor_writer.write_sv(data, sv, sv_id, base, mi.tumor,
                                           non_event)
                continue
            if self.rna_writer is not None:
                self.rna_writer.write_sv(data, sv, sv_id, base, mi.rna,
                                         non_event)
                continue
            if self.diploid_writer is not None:
                d_event = event if is_mj_diploid_event else non_event
                score_info = joint_info if is_mj_diploid_event else mi
                import copy
                diploid_info = copy.deepcopy(score_info.diploid)
                if is_mj_diploid_event:
                    for si in range(self.diploid_sample_count):
                        if junction_sample_check_fail[si]:
                            diploid_info.samples[si] = \
                                mi.diploid.samples[si]
                if is_mj_diploid_event:
                    write_diploid = mj_write_diploid
                else:
                    write_diploid = mi.diploid.alt_score >= \
                        self.min_output_alt_score
                if write_diploid:
                    self.diploid_writer.write_sv(
                        data, sv, sv_id, base, diploid_info, d_event,
                        mi.diploid)
            if self.somatic_writer is not None:
                s_event = event if is_mj_event else non_event
                score_info = joint_info if is_mj_event else mi
                if is_mj_event:
                    write_somatic = mj_write_somatic
                else:
                    write_somatic = mi.somatic.somatic_score >= \
                        self.min_output_somatic_score
                if write_somatic:
                    self.somatic_writer.write_sv(
                        data, sv, sv_id, base, score_info.somatic, s_event,
                        mi.somatic)
