"""Multi-junction (reciprocal-pair) candidate grouping.

Behavioral parity with the reference findMultiJunctionCandidates
(reference: manta/MultiJunctionUtil.cpp:158-260): opposite-orientation
breakend pairing within 1000b, junction alignment checks, spanning-count
filtration.
"""

from __future__ import annotations

from ..core.svmodel import (
    SVCandidate, get_sv_type, SV_INDEL, SV_TANDUP,
    is_complex_sv, is_spanning_sv, is_simple_breakend,
)

FAR = 1 << 62


def _interval_dist(a, b) -> int:
    if a.tid != b.tid:
        return FAR
    return abs(a.center_pos() - b.center_pos())


def _is_bp_group_candidate(bpa, bpb, group_range=1000) -> bool:
    if not (is_simple_breakend(bpa.state) and is_simple_breakend(bpb.state)
            and bpa.state != bpb.state):
        return False
    return _interval_dist(bpa.interval, bpb.interval) < group_range


def _max_interval_distance(sva, svb, is11: bool) -> int:
    if is11:
        return max(_interval_dist(sva.bp1.interval, svb.bp1.interval),
                   _interval_dist(sva.bp2.interval, svb.bp2.interval))
    return max(_interval_dist(sva.bp1.interval, svb.bp2.interval),
               _interval_dist(sva.bp2.interval, svb.bp1.interval))


def _junction_bp_alignment(sva, svb) -> int:
    d11 = _interval_dist(sva.bp1.interval, svb.bp1.interval)
    d12 = _interval_dist(sva.bp1.interval, svb.bp2.interval)
    d21 = _interval_dist(sva.bp2.interval, svb.bp1.interval)
    d22 = _interval_dist(sva.bp2.interval, svb.bp2.interval)
    if d11 < d12 and d11 < d21 and d22 < d12 and d22 < d21:
        return 1
    if d12 < d11 and d12 < d22 and d21 < d11 and d21 < d22:
        return -1
    return 0


def _is_mj_excluded(sv) -> bool:
    t = get_sv_type(sv)
    if t not in (SV_INDEL, SV_TANDUP):
        return False
    return _interval_dist(sv.bp1.interval, sv.bp2.interval) < 100000


def _is_filter_mj_candidate(min_spanning_count, junctions) -> bool:
    count_filter = True
    single_filter = True
    for sv in junctions:
        if is_spanning_sv(sv):
            if sv.bp1.get_spanning_count() >= min_spanning_count:
                count_filter = False
            if not getattr(sv, "is_single_junction_filter", False):
                single_filter = False
    return count_filter or single_filter


def find_multi_junction_candidates(svs: list, min_spanning_count: int,
                                   is_rna: bool):
    """Returns list of junction groups (each a list of SVCandidates)."""
    complex_svs = [sv for sv in svs if is_complex_sv(sv)]
    spanning_svs = [sv for sv in svs if not is_complex_sv(sv)]
    span_count = len(spanning_svs)
    # partner state: (type, partner_id) per spanning sv
    NONE, SAME, FLIP = 0, 1, 2
    partners = [(NONE, 0)] * span_count
    if not is_rna:
        has_multi = False
        for a in range(span_count - 1):
            sva = spanning_svs[a]
            if _is_mj_excluded(sva):
                continue
            for b in range(a + 1, span_count):
                svb = spanning_svs[b]
                if _is_mj_excluded(svb):
                    continue
                same = (_is_bp_group_candidate(sva.bp1, svb.bp1)
                        and _is_bp_group_candidate(sva.bp2, svb.bp2))
                flip = (_is_bp_group_candidate(sva.bp1, svb.bp2)
                        and _is_bp_group_candidate(sva.bp2, svb.bp1))
                group = False
                if same or flip:
                    if same:
                        group = _junction_bp_alignment(sva, svb) > 0
                    else:
                        group = _junction_bp_alignment(sva, svb) < 0
                if not group:
                    continue
                new_type = SAME if same else FLIP
                if partners[a][0] == NONE and partners[b][0] == NONE:
                    partners[a] = (new_type, b)
                    partners[b] = (new_type, a)
                else:
                    has_multi = True
                    partners = [(NONE, 0)] * span_count
                    break
            if has_multi:
                break

    out = []
    for idx in range(span_count):
        junction = [spanning_svs[idx]]
        ptype, pid = partners[idx]
        if ptype in (SAME, FLIP):
            if pid < idx:
                continue
            junction.append(spanning_svs[pid])
        if _is_filter_mj_candidate(min_spanning_count, junction):
            continue
        out.append(junction)
    for sv in complex_svs:
        out.append([sv])
    return out
