"""Run observability artifacts: graph stats, edge stats, stats summary.

Behavioral ports of the reference's default stats outputs:
- write_graph_stats -> svLocusGraphStats.tsv
  (reference: SummarizeSVLoci --global / SVLocusSet::dumpStats,
  svgraph/SVLocusSet.cpp:1137-1214 + SVLocusSampleCounts.cpp writers)
- write_alignment_stats_summary -> alignmentStatsSummary.txt
  (reference: SummarizeAlignmentStats.cpp:37-81)
- GSCEdgeStats/EdgeStatsTracker -> svCandidateGenerationStats.tsv
  (reference: appstats/GSCEdgeStats.cpp report methods +
  GenerateSVCandidates/GSCEdgeStatsManager.hpp update hooks). The
  companion .xml uses a plain field dump rather than
  boost-serialization xml framing.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass, field

from ..core.sizedist import SizeDistribution
from ..core.svmodel import EV_LABELS, EV_SIZE


# ---------------------------------------------------------------------------
# timing

@dataclass
class CpuTimes:
    wall: float = 0.0
    user: float = 0.0
    system: float = 0.0

    def scaled(self, f: float) -> "CpuTimes":
        return CpuTimes(self.wall * f, self.user * f, self.system * f)

    def merge(self, o: "CpuTimes"):
        self.wall += o.wall
        self.user += o.user
        self.system += o.system

    def difference(self, o: "CpuTimes"):
        self.wall -= o.wall
        self.user -= o.user
        self.system -= o.system

    def report(self, factor: float, label: str) -> str:
        """(reference: blt_util/time_util.cpp CpuTimes::report)."""
        fwall = self.wall * factor
        fuser = self.user * factor
        fsystem = self.system * factor
        total = fuser + fsystem
        perc = 100 * total / fwall if fwall != 0 else 0.0
        return (f"{fwall:.4f}{label} wall, {fuser:.4f}{label} user + "
                f"{fsystem:.4f}{label} system = {total:.4f}{label} "
                f"CPU ({perc:.2f}%)")

    def report_hr(self) -> str:
        return self.report(1.0 / 3600.0, "h")


class TimeBlock:
    """Accumulates wall + process cpu time over with-blocks."""

    def __init__(self):
        self.times = CpuTimes()

    def __enter__(self):
        self._w = time.perf_counter()
        t = os.times()
        self._u, self._s = t.user, t.system
        return self

    def __exit__(self, *exc):
        t = os.times()
        self.times.wall += time.perf_counter() - self._w
        self.times.user += t.user - self._u
        self.times.system += t.system - self._s
        return False


# ---------------------------------------------------------------------------
# edge stats (GSCEdgeStats)

class SimpleHist:
    def __init__(self, size: int):
        self.histdata = [0] * size

    def increment(self, val: int):
        self.histdata[min(val, len(self.histdata) - 1)] += 1

    def merge(self, o: "SimpleHist"):
        for i, v in enumerate(o.histdata):
            self.histdata[i] += v

    def report(self) -> list[str]:
        out = []
        for i, v in enumerate(self.histdata):
            suffix = "+" if i + 1 == len(self.histdata) else ""
            out.append(f"{i}{suffix}\t{v}\n")
        return out


@dataclass
class FinderStatsView:
    edge_filter: int = 0
    semi_mapped_filter: int = 0
    complex_low_count_filter: int = 0
    complex_low_signal_filter: int = 0
    unmatched_read_pair_filter: int = 0

    def merge_from(self, s):
        self.edge_filter += s.edge_filter
        self.semi_mapped_filter += s.semi_mapped_filter
        self.complex_low_count_filter += s.complex_low_count_filter
        self.complex_low_signal_filter += s.complex_low_signal_filter
        self.unmatched_read_pair_filter += s.unmatched_read_pair_filter

    def report(self) -> list[str]:
        return [
            f"EdgeFilter\t{self.edge_filter}\n",
            f"SemiMappedFilter\t{self.semi_mapped_filter}\n",
            f"ComplexLowCountFilter\t{self.complex_low_count_filter}\n",
            f"ComplexLowSignalFilter\t{self.complex_low_signal_filter}\n",
            f"UnmatchedReadPairFilter\t{self.unmatched_read_pair_filter}\n",
        ]


class GSCEdgeGroupStats:
    def __init__(self):
        self.total_input_edge_count = 0
        self.total_candidate_count = 0
        self.total_complex_candidate = 0
        self.total_spanning_candidate_filter = 0
        self.total_junction_assembly_overlap_skips = 0
        self.total_junction_count = 0
        self.total_complex_junction_count = 0
        self.total_assembly_candidates = 0
        self.total_spanning_assembly_candidates = 0
        self.candidates_per_edge = SimpleHist(6)
        self.assembly_candidates_per_junction = SimpleHist(6)
        self.breaks_per_junction = SimpleHist(4)
        self.finder_stats = FinderStatsView()
        self.total_time = CpuTimes()
        self.cand_time = CpuTimes()
        self.assembly_time = CpuTimes()
        self.scoring_time = CpuTimes()

    def merge(self, o: "GSCEdgeGroupStats"):
        for f in ("total_input_edge_count", "total_candidate_count",
                  "total_complex_candidate",
                  "total_spanning_candidate_filter",
                  "total_junction_assembly_overlap_skips",
                  "total_junction_count", "total_complex_junction_count",
                  "total_assembly_candidates",
                  "total_spanning_assembly_candidates"):
            setattr(self, f, getattr(self, f) + getattr(o, f))
        self.candidates_per_edge.merge(o.candidates_per_edge)
        self.assembly_candidates_per_junction.merge(
            o.assembly_candidates_per_junction)
        self.breaks_per_junction.merge(o.breaks_per_junction)
        self.finder_stats.merge_from(o.finder_stats)
        self.total_time.merge(o.total_time)
        self.cand_time.merge(o.cand_time)
        self.assembly_time.merge(o.assembly_time)
        self.scoring_time.merge(o.scoring_time)

    def _report_time(self, label: str, t: CpuTimes) -> list[str]:
        def safe_frac(b):
            return 1.0 / b if b != 0 else 0.0
        return [
            f"{label}Hours\t{t.report_hr()}\n",
            f"{label}SecsPerEdge\t"
            f"{t.report(safe_frac(self.total_input_edge_count), 's')}\n",
            f"{label}SecsPerCand\t"
            f"{t.report(safe_frac(self.total_candidate_count), 's')}\n",
        ]

    def report(self) -> list[str]:
        cat = CpuTimes()
        cat.merge(self.cand_time)
        cat.merge(self.assembly_time)
        cat.merge(self.scoring_time)
        nocat = CpuTimes(self.total_time.wall, self.total_time.user,
                         self.total_time.system)
        nocat.difference(cat)
        out = [f"InputEdgeCount\t{self.total_input_edge_count}\n",
               "InputEdgeCandidatesPerEdge:\n"]
        out += self.candidates_per_edge.report()
        out += [f"CandidateCount\t{self.total_candidate_count}\n",
                f"ComplexCandidateCount\t{self.total_complex_candidate}\n"]
        out += self.finder_stats.report()
        out += [
            "SpanningComplexCandidateFiltered\t"
            f"{self.total_spanning_candidate_filter}\n",
            "JunctionAssemblyOverlapSkipped\t"
            f"{self.total_junction_assembly_overlap_skips}\n",
            f"JunctionCount\t{self.total_junction_count}\n",
            f"ComplexJunctionCount\t{self.total_complex_junction_count}\n",
            "BreaksPerJunction:\n"]
        out += self.breaks_per_junction.report()
        out += [
            f"TotalAssemblyCandidates\t{self.total_assembly_candidates}\n",
            "TotalSpanningAssemblyCandidates\t"
            f"{self.total_spanning_assembly_candidates}\n",
            "AssemblyCandidatesPerJunction:\n"]
        out += self.assembly_candidates_per_junction.report()
        out += self._report_time("total", self.total_time)
        out += self._report_time("candi", self.cand_time)
        out += self._report_time("assem", self.assembly_time)
        out += self._report_time("score", self.scoring_time)
        out += self._report_time("nocat", nocat)
        return out


class EdgeStatsTracker:
    """(reference: GSCEdgeStatsManager.hpp) — self vs remote edge stats
    accumulation plus the run lifetime clock."""

    def __init__(self):
        self.self_edges = GSCEdgeGroupStats()
        self.remote_edges = GSCEdgeGroupStats()
        self.life = TimeBlock()
        self.life.__enter__()
        self._life_times: CpuTimes | None = None

    def life_times(self) -> CpuTimes:
        """Close this tracker's lifetime clock (idempotent) and return
        it. Bin workers call this before pickling so the recorded
        lifetime is the WORKER's, not garbage measured against the
        merging parent's process clock."""
        # getattr: bin-result pickles written before _life_times existed
        # (resumed via the digest-matched cache) must still merge cleanly
        if getattr(self, "_life_times", None) is None:
            self.life.__exit__()
            self._life_times = self.life.times
        return self._life_times

    def merge_stats_from(self, o: "EdgeStatsTracker"):
        """Reference GSCEdgeStatsData::merge — edge groups merge and
        lifetimes SUM across processes (GSCEdgeStats.hpp:139-144), so
        the merged SVGenTotalHours is total process time, mirroring
        the reference's per-process stats file merge."""
        self.self_edges.merge(o.self_edges)
        self.remote_edges.merge(o.remote_edges)
        self.life_times().merge(o.life_times())

    def _group(self, is_self_edge: bool) -> GSCEdgeGroupStats:
        return self.self_edges if is_self_edge else self.remote_edges

    def update_edge_candidates(self, is_self_edge, cand_count, finder_stats):
        g = self._group(is_self_edge)
        g.total_input_edge_count += 1
        g.total_candidate_count += cand_count
        g.candidates_per_edge.increment(cand_count)
        g.finder_stats.merge_from(finder_stats)

    def update_mj_filter(self, is_self_edge, complex_count, spanning_filter):
        g = self._group(is_self_edge)
        g.total_complex_candidate += complex_count
        g.total_spanning_candidate_filter += spanning_filter

    def update_junction_counts(self, is_self_edge, junction_count,
                               is_complex):
        g = self._group(is_self_edge)
        g.total_junction_count += junction_count
        if is_complex:
            g.total_complex_junction_count += junction_count
        g.breaks_per_junction.increment(junction_count)

    def update_assembly_count(self, is_self_edge, assembly_count,
                              is_spanning, is_overlap_skip=False):
        g = self._group(is_self_edge)
        g.total_assembly_candidates += assembly_count
        if is_spanning:
            g.total_spanning_assembly_candidates += assembly_count
        if is_overlap_skip:
            g.total_junction_assembly_overlap_skips += 1
        else:
            g.assembly_candidates_per_junction.increment(assembly_count)

    def add_times(self, is_self_edge, total, cand, assembly, scoring):
        g = self._group(is_self_edge)
        g.total_time.merge(total)
        g.cand_time.merge(cand)
        g.assembly_time.merge(assembly)
        g.scoring_time.merge(scoring)

    def report(self) -> list[str]:
        """(reference: GSCEdgeStatsData::report + GSCEdgeStats::report)."""
        life = self.life_times()
        all_edges = GSCEdgeGroupStats()
        all_edges.merge(self.remote_edges)
        all_edges.merge(self.self_edges)
        non_edge = CpuTimes(life.wall, life.user, life.system)
        non_edge.difference(all_edges.total_time)
        out = ["EdgeStatsReport\n",
               f"SVGenTotalHours\t{life.report_hr()}\n",
               f"NonEdgeHours\t{non_edge.report_hr()}\n",
               "\n[AllEdges]\n"]
        out += all_edges.report()
        out += ["\n[RemoteEdges]\n"]
        out += self.remote_edges.report()
        out += ["\n[SelfEdges]\n"]
        out += self.self_edges.report()
        return out

    def save_xml(self, path: str):
        """Plain xml field dump (the reference uses boost-serialization
        xml; the tsv report above is the parity surface)."""
        with open(path, "w") as f:
            f.write("<edgeData>\n")
            for name, g in (("selfEdges", self.self_edges),
                            ("remoteEdges", self.remote_edges)):
                f.write(f" <{name}>\n")
                f.write(f"  <totalInputEdgeCount>{g.total_input_edge_count}"
                        f"</totalInputEdgeCount>\n")
                f.write(f"  <totalCandidateCount>{g.total_candidate_count}"
                        f"</totalCandidateCount>\n")
                f.write(f"  <totalJunctionCount>{g.total_junction_count}"
                        f"</totalJunctionCount>\n")
                f.write(f" </{name}>\n")
            f.write("</edgeData>\n")


# ---------------------------------------------------------------------------
# graph stats

def _fmt_frac(val: float, total: float) -> str:
    if total == 0:
        return "N/A"
    return f"{val / total:.4f}"


def write_graph_stats(locus_set, path: str,
                      build_time: CpuTimes | None = None,
                      merge_time: CpuTimes | None = None):
    """(reference: SVLocusSet::dumpStats, SVLocusSet.cpp:1137-1214)."""
    build_time = build_time or CpuTimes()
    merge_time = merge_time or CpuTimes()
    out = [
        f"GraphBuildTime\t{build_time.report_hr()}\n",
        f"GraphMergeTime\t{merge_time.report_hr()}\n",
        f"disjointSubgraphs\t{locus_set.non_empty_size()}\n",
        f"nodes\t{locus_set.total_node_count()}\n",
        f"directedEdges\t{locus_set.total_edge_count()}\n",
        f"selfEdges\t{locus_set.self_edge_count()}\n",
        f"totalGraphEvidence\t{locus_set.total_observation_count()}\n",
        f"totalCleaned\t{locus_set.total_cleaned}\n",
        f"highestSearchCount\t{locus_set.highest_search_count}\n",
        f"isMaxSearchCount\t{int(locus_set.is_max_search_count)}\n",
        f"highestSearchDensity\t{locus_set.highest_search_density:g}\n",
        f"isMaxSearchDensity\t{int(locus_set.is_max_search_density)}\n",
    ]

    # per-sample read counts (reference: SVLocusSampleCounts.cpp)
    counts = getattr(locus_set, "sample_counts", None) or []
    if counts and isinstance(counts[0], dict):
        from ..graph.finder import SampleCounts
        counts = [SampleCounts.from_dict(d) for d in counts]
    for si, c in enumerate(counts):
        out.append(f"\n[Sample{si}]\n")
        out.append(f"Source\t{getattr(c, 'source', '')}\n")
        dtotal = c.total + c.min_mapq
        for label, val in (
                ("MinMapqFiltered", c.min_mapq),
                ("NotFiltered", c.total),
                ("NotFilteredAndIgnored", c.ignored),
                ("NotFilteredAndAnomalousPair", c.anom),
                ("NotFilteredAndAnomalousPairRemotes",
                 getattr(c, "remote_recovery_candidates", 0)),
                ("NotFilteredAndSplitRead", c.split),
                ("NotFilteredAndSplitReadInAnomalousPair", c.anom_and_split)):
            out.append(f"{label}\t{val:.0f}\t{_fmt_frac(val, dtotal)}\n")
        out.append("NotFilteredAndSplitReadSupplementarySegments\t"
                   f"{getattr(c, 'split_supplementary_segment', 0):.0f}\t"
                   "N/A\n")
        for label, val in (("NotFilteredAndLargeIndel", c.indel),
                           ("NotFilteredAndSemiAligned", c.assm)):
            out.append(f"{label}\t{val:.0f}\t{_fmt_frac(val, dtotal)}\n")
        e_type = getattr(c, "e_type", None) or [0] * EV_SIZE
        etotal = float(sum(e_type))
        for i in range(EV_SIZE):
            frac = e_type[i] / etotal if etotal else 0.0
            out.append(f"EvidenceType_{EV_LABELS[i]}\t{e_type[i]}\t"
                       f"{frac:.4f}\n")
        out.append(f"ClosePairs\t{getattr(c, 'close_count', 0)}\n")
    out.append("\n")

    node_size = SizeDistribution()
    for locus in locus_set.loci:
        for node in locus.nodes:
            node_size.add_observation(node.end - node.beg)
    out.append("NodeRegionSizequantile:\n")
    for q in (0.25, 0.5, 0.75, 0.9, 0.95, 0.99):
        out.append(f"{q:g}\t{node_size.quantile(q)}\n")

    max_edge_count = 10
    edge_count = [0] * max_edge_count
    max_obs_count = 30
    obs_count = [0] * max_obs_count
    for locus in locus_set.loci:
        for node in locus.nodes:
            edge_count[min(node.size(), max_edge_count - 1)] += 1
            obs_count[min(node.out_count(), max_obs_count - 1)] += 1
    out.append("NodeEdgeCount:\n")
    for i in range(max_edge_count):
        suffix = "+" if i + 1 == max_edge_count else ""
        out.append(f"{i}{suffix}\t{edge_count[i]}\n")
    out.append("NodeObservationCount:\n")
    for i in range(max_obs_count):
        suffix = "+" if i + 1 == max_obs_count else ""
        out.append(f"{i}{suffix}\t{obs_count[i]}\n")

    with open(path, "w") as f:
        f.writelines(out)


# ---------------------------------------------------------------------------
# alignment stats summary

def write_alignment_stats_summary(stats_set, path: str):
    """(reference: SummarizeAlignmentStats.cpp:37-81)."""
    quants = (0.01, 0.05, 0.10, 0.25, 0.50, 0.75, 0.90, 0.95, 0.99)
    out = []
    for label in stats_set.labels:
        rgs = stats_set.get_stats(label)
        out.append(f"group:\t{label}\n")
        out.append("fragment length observations:\t"
                   f"{rgs.frag_stats.total_observations}\n")
        out.append("fragment length quantiles:\n")
        for q in quants:
            out.append(f"{q:g}\t{rgs.frag_stats.quantile(q)}\n")
        cnt = rgs.counter
        total = cnt.paired + cnt.unpaired
        out.append(f"Total sampled reads:\t{total}\n")
        out.append(f"Total sampled paired reads:\t{cnt.paired}\n")
        out.append(f"Total sampled unpaired reads:\t{cnt.unpaired}\n")
        out.append("Total sampled paired reads with low MAPQ:\t"
                   f"{cnt.paired_low_mapq}\n")
        out.append("Total sampled high-confidence read pairs passing all "
                   f"filters:\t{cnt.high_confidence_pairs}\n")
        out.append("\n")
    with open(path, "w") as f:
        f.writelines(out)
