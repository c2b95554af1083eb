"""Phase-1 entry: scan genome-segment reads into the breakend graph.

Behavioral parity with the reference EstimateSVLoci application
(reference: src/c++/lib/applications/EstimateSVLoci/
SVLocusSetFinder.cpp:79-170, SVLocusSetFinderActiveRegionManager.cpp,
EstimateSVLociRunner.cpp:53-110): per-read core filters, non-tumor
depth tracking with high-depth skips, the fast SV-evidence pre-filter,
rolling region denoising at a 5kb protected border, and per-read graph
locus insertion.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..core.readfilter import (
    has_sa_tag, is_read_unmapped_or_filtered_core,
)
from ..core.svmodel import EV_SIZE
from ..io.bam import ReadBatch, open_alignment_reader
from ..scan.scanner import WEIGHT_CLOSE_READ_PAIR, SVScanner
from .locusgraph import SVLocus, SVLocusSet, SVLocusSetOptions

# phase-1 scan streaming grain: regions larger than this are fetched
# and processed in position-partitioned sub-windows so a segment's
# reads never sit fully parsed in memory (peak ~ depth x 2 Mb instead
# of depth x 12 Mb; partitioning cannot change results — see the
# streaming comment in estimate_sv_loci)
_SCAN_SUBWINDOW = 2 << 20

DENOISE_BORDER = 5000
MIN_DENOISE_REGION_SIZE = 1000
DEPTH_COMPRESSION = 16


class DepthBuffer:
    """Compressed per-position depth estimate
    (reference: blt_util/depth_buffer.hpp:82-119)."""

    def __init__(self, compression: int = DEPTH_COMPRESSION):
        self.c = compression
        self.bins: dict[int, int] = {}

    def inc(self, pos: int, length: int):
        end = pos + length
        while pos < end:
            b = pos // self.c
            block_end = min((b + 1) * self.c, end)
            self.bins[b] = self.bins.get(b, 0) + (block_end - pos)
            pos = block_end

    def val(self, pos: int) -> int:
        return (self.bins.get(pos // self.c, 0) + self.c // 2) // self.c

    def clear_below(self, pos: int):
        """Free bins fully below pos (memory management only)."""
        b = pos // self.c
        for k in [k for k in self.bins if k < b]:
            del self.bins[k]


@dataclass
class SampleCounts:
    """Per-sample input/evidence statistics (observability parity with
    SampleReadInputCounts / SampleEvidenceCounts; used downstream for
    candidate noise rates, SVFinder.cpp:39-62)."""
    total: int = 0
    min_mapq: int = 0
    not_filtered: int = 0
    evidence: int = 0
    anom: int = 0
    split: int = 0
    anom_and_split: int = 0
    indel: int = 0
    assm: int = 0
    ignored: int = 0
    remote_recovery_candidates: int = 0
    split_supplementary_segment: int = 0
    close_count: int = 0
    e_type: list = field(default_factory=lambda: [0] * EV_SIZE)
    source: str = ""

    def to_dict(self):
        d = self.__dict__.copy()
        d["e_type"] = list(d["e_type"])
        return d

    @classmethod
    def from_dict(cls, d):
        c = cls()
        c.__dict__.update(d)
        return c


class SVLocusSetFinder:
    """Builds graph evidence from one scan region's position-sorted reads."""

    def __init__(self, scanner: SVScanner, locus_set: SVLocusSet,
                 tid: int, beg: int, end: int,
                 is_tumor: list[bool],
                 max_depth: float | None = None,
                 refseq: np.ndarray | None = None, ref_offset: int = 0):
        self.scanner = scanner
        self.locus_set = locus_set
        self.tid, self.beg, self.end = tid, beg, end
        self.is_tumor = is_tumor
        self.max_depth = max_depth
        self.refseq = refseq
        self.ref_offset = ref_offset
        self.depth = DepthBuffer()
        self.counts = [SampleCounts() for _ in is_tumor]
        # denoise region: scan region shrunk by the protected border on
        # any edge adjacent to another scan segment
        dn_beg = beg + DENOISE_BORDER if beg > 0 else beg
        chrom_len = scanner.chrom_lengths[tid]
        dn_end = end - DENOISE_BORDER if end < chrom_len else end
        self.dn_beg, self.dn_end = dn_beg, dn_end
        self._in_denoise_region = False
        self._denoise_start = 0
        self._head = None  # highest head position processed

    # ------------------------------------------------------------------
    # rolling denoise (stage_manager emulation at offset DENOISE_BORDER)

    def _handle_new_pos(self, pos: int):
        if self._head is not None and pos <= self._head:
            return
        self._head = pos
        self._process_denoise_up_to(pos - DENOISE_BORDER)
        self.depth.clear_below(pos - 10)

    def _process_denoise_up_to(self, d_max: int):
        if d_max < self.dn_beg:
            return
        if not self._in_denoise_region and d_max < self.dn_end:
            self._in_denoise_region = True
            self._denoise_start = self.dn_beg
        if self._in_denoise_region:
            # fire at every d = start + (MIN_SIZE-1) crossing within region
            limit = min(d_max, self.dn_end - 1)
            step = MIN_DENOISE_REGION_SIZE
            count = (limit - (self._denoise_start + step - 1)) // step + 1
            if count > 0:
                stride = getattr(self.locus_set, "clean_stride", None)
                if stride is not None:
                    stride(self.tid, self._denoise_start, step, count)
                else:
                    for k in range(count):
                        s = self._denoise_start + k * step
                        self.locus_set.clean_region(self.tid, s, s + step)
                self._denoise_start += count * step
        if d_max >= self.dn_end:
            if self._in_denoise_region:
                if self.dn_end - self._denoise_start > 0:
                    self.locus_set.clean_region(
                        self.tid, self._denoise_start, self.dn_end)
                    self._denoise_start = self.dn_end
                self._in_denoise_region = False

    def flush(self):
        """Process all remaining positions (stage_manager::reset)."""
        self._process_denoise_up_to(self.end - 1)

def merge_sorted_batches(batches: list[ReadBatch]):
    """K-way position-merge across per-sample batches: returns
    (sample_index, read_index) arrays in position order (reference:
    input_stream_handler, blt_util/input_stream_handler.hpp:105)."""
    if not batches:
        return (np.zeros(0, np.int32), np.zeros(0, np.int64))
    pos = np.concatenate([b.pos for b in batches])
    si = np.concatenate([np.full(b.n, k, np.int32)
                         for k, b in enumerate(batches)])
    ri = np.concatenate([np.arange(b.n, dtype=np.int64) for b in batches])
    # stable sort by (pos, sample); within ties read order is ascending
    # because the per-sample segments are appended in read order
    order = np.lexsort((si, pos))
    return (si[order], ri[order])


MIN_SEGMENT_GROUP_SIZE = 200_000


def group_segments(regions: list[tuple[int, int, int]],
                   min_group_size: int = MIN_SEGMENT_GROUP_SIZE):
    """Clump consecutive small scan segments into groups of cumulative
    size <= min_group_size, never reordering (reference:
    workflowUtil.py:329-365 getGenomeSegmentGroups). Each group is
    scanned into ONE shared graph by one phase-1 task; ordinary 12 Mb
    whole-genome segments exceed the threshold and stay singletons."""
    groups: list[list[tuple[int, int, int]]] = []
    group: list[tuple[int, int, int]] = []
    head_size = 0
    for seg in regions:
        size = seg[2] - seg[1]
        if head_size + size <= min_group_size:
            group.append(seg)
            head_size += size
        else:
            if group:
                groups.append(group)
            group = [seg]
            head_size = size
    if group:
        groups.append(group)
    return groups


def estimate_sv_loci(bam_paths: list[str], is_tumor: list[bool],
                     scanner: SVScanner, graph_opt: SVLocusSetOptions,
                     regions: list[tuple[int, int, int]], fasta,
                     chrom_depths: dict[str, float] | None = None,
                     max_depth_factor: float = 12.0,
                     readers: list | None = None,
                     as_native: bool = False) -> SVLocusSet:
    """Run phase-1 graph construction over the given scan regions.

    Regions are clumped by the reference's 200 kb grouping rule; every
    region in a group scans incrementally into ONE shared graph (the
    reference's per-task SVLocusSet shared across
    estimateSVLociForSingleRegion calls, EstimateSVLociRunner.cpp:50-64),
    and group graphs merge sequentially into the master set (reference:
    per-group EstimateSVLoci tasks + ordered MergeSVLoci reduce,
    MergeSVLoci.cpp, mantaWorkflow.py:252-299). Grouping is a pure
    function of the region sequence and resets at group boundaries, so
    serial and process-parallel execution stay bit-identical as long as
    workers receive whole groups."""
    from .native_set import NativeLocusSet
    if readers is None:
        # callers driving many estimate_sv_loci calls (one per group)
        # should pass readers to avoid re-opening + re-parsing the BAI
        # per call
        readers = [open_alignment_reader(p, fasta) for p in bam_paths]
    names = readers[0].header.ref_names
    lengths = readers[0].header.ref_lengths
    # the first group's graph is ADOPTED as the merge base — the
    # reference initializes the merged set from graph file 0 and only
    # merge()s files 1..N-1 (MergeSVLoci.cpp:48-62); running merge()
    # against an empty base is NOT a no-op (locus consolidation can
    # renumber nodes), so adoption is required for node-index parity
    master = None
    sample_counts: list[dict] = [{} for _ in bam_paths]

    for group in group_segments(regions):
        part = NativeLocusSet(graph_opt, len(names))
        for (tid, beg, end) in group:
            chrom = names[tid]
            ref_off = max(0, beg - 500)
            refseq = fasta.fetch_arr(chrom, ref_off, end + 500)
            max_depth = None
            if chrom_depths is not None and chrom in chrom_depths:
                max_depth = chrom_depths[chrom] * max_depth_factor
            finder = SVLocusSetFinder(
                scanner, part, tid, beg, end, is_tumor,
                max_depth=max_depth, refseq=refseq, ref_offset=ref_off)
            # keep reads that OVERLAP the region but start before it:
            # the reference streams them through depth tracking and the
            # input/evidence counters, and only the scan-region check
            # after those steps blocks their graph insertion
            # (SVLocusSetFinder.cpp:88-142); _run_merged applies the
            # same in-loop position gate before inserting loci.
            # Reads reaching below the 500 bp ref pad are still exact:
            # the reference's segment accessor returns 'N' outside its
            # own +/-500 window (reference_contig_segment.hpp get_base)
            # and the semi-aligned test counts 'N' as a match
            # (SVLocusScannerSemiAligned.cpp:45-50), matching our
            # scanner's out-of-window handling.
            #
            # The region streams through the finder in position-
            # partitioned sub-windows (the reference's bam iterator
            # streams one record at a time, so a 12 Mb segment never
            # sits in memory at once; an eager whole-segment parse
            # peaks at GBs on deep data). Window 0 keeps the overlap
            # fetch (pos < w1 and end > beg, admitting reads starting
            # before the region); later windows keep pos in [wk, wk+1)
            # only, so the union and the stream order are exactly the
            # whole-region fetch's.
            w0 = beg
            first = True
            while w0 < end or first:
                w1 = min(end, w0 + _SCAN_SUBWINDOW)
                batches = [r.fetch(tid, beg if first else w0, w1)
                           for r in readers]
                if not first:
                    batches = [b.subset(b.pos >= w0)
                               if b.n and b.pos[0] < w0 else b
                               for b in batches]
                # interleave samples by position (the reference's k-way
                # merge order)
                _run_merged(finder, batches, merge_sorted_batches(batches))
                first = False
                w0 = w1
            finder.flush()
            for si, c in enumerate(finder.counts):
                merged = sample_counts[si]
                for k, v in c.to_dict().items():
                    if isinstance(v, list):
                        prev = merged.get(k, [0] * len(v))
                        merged[k] = [a + b2 for a, b2 in zip(prev, v)]
                    elif isinstance(v, str):
                        merged[k] = v or merged.get(k, "")
                    else:
                        merged[k] = merged.get(k, 0) + v
                merged["source"] = bam_paths[si]
        # compact = the reference's per-group save/load boundary (empty
        # locus slots dropped before any merge; see
        # NativeLocusSet.compact)
        part = part.compact()
        if master is None:
            master = part
        else:
            master.merge_native(part)
            part.free()
    if master is None:
        master = NativeLocusSet(graph_opt, len(names))
    if as_native:
        # parallel phase-1 workers persist parts straight from the
        # native engine (NativeLocusSet.save_npz); skipping the Python
        # objectification halves the per-part save cost
        return master, names, lengths, sample_counts
    out = master.to_locus_set(names, lengths, len(bam_paths))
    master.free()
    out.sample_counts = sample_counts
    return out


def _depth_gate_batch(finder: SVLocusSetFinder,
                      batches: list[ReadBatch],
                      osi: np.ndarray, oi: np.ndarray,
                      core_bads: list[np.ndarray]) -> np.ndarray:
    """Vectorized exact replay of the streaming high-depth gate.

    Scalar semantics being replayed (reference: depth_buffer.hpp:82-119
    driven from SVLocusSetFinder::update): reads arrive position-
    sorted; each unfiltered NORMAL-sample read first adds its sequence
    length to a compression-C bin buffer (DepthBuffer.inc), then every
    unfiltered read of any sample is dropped when the buffer value at
    its own start position exceeds max_depth — inc before test, so a
    read's own contribution counts against it.

    Vectorization: bin depth only grows while a batch streams, so a
    read whose query bin FINISHES the batch below the threshold can
    never have observed it above. The final per-bin added coverage is
    one bincount difference histogram; only bins whose final depth
    (plus depth carried in from earlier batches of the same stream)
    crosses the threshold need an exact prefix replay — per such bin,
    contributor stream indices vs query stream indices via
    searchsorted(side='right') reproduce the inc-before-test order
    exactly. On non-pathological WGS zero bins are ambiguous; the
    satellite pileups of the --repeats workload take the replay path.
    Returns a stream-aligned bool array (False for filtered reads).

    Assumptions: (a) successive calls for one finder form a single
    non-regressing merged stream (asserted below — the end-of-batch
    bin trim is only sound under it); (b) the dense difference
    histogram allocates O(batch position extent) int64s — bounded to
    ~17 MB by the 2 MB _SCAN_SUBWINDOW chunking in scan_region; a
    caller passing a sparse many-Mb batch would need a per-bin
    sparse fallback instead.
    """
    import math

    C = finder.depth.c
    kd = math.floor(finder.max_depth)
    # val(pos) > max_depth  ⇔  (v + C//2) // C >= kd + 1  ⇔  v >= vthresh
    vthresh = C * (kd + 1) - C // 2
    n = osi.shape[0]
    out = np.zeros(n, bool)
    if n == 0:
        return out
    gate_floor = getattr(finder, "_gate_floor", None)
    pos = np.zeros(n, np.int64)
    ln = np.zeros(n, np.int64)
    bad = np.ones(n, bool)
    is_norm = np.zeros(n, bool)
    for si, b in enumerate(batches):
        m = osi == si
        if not m.any():
            continue
        idx = oi[m]
        pos[m] = b.pos[idx]
        ln[m] = np.diff(b.seq_off)[idx]      # == b.read_len(i)
        bad[m] = core_bads[si][idx]
        is_norm[m] = not finder.is_tumor[si]
    if gate_floor is not None and int(pos[0]) < gate_floor:
        raise AssertionError(
            "depth-gate batches must form a non-regressing stream: "
            f"batch starts at {int(pos[0])} below trim floor {gate_floor}")
    cont = (~bad) & is_norm & (ln > 0)
    query = ~bad
    if not query.any():
        return out
    hi = pos + ln
    qpos = pos[query]
    has_cont = bool(cont.any())
    base0 = int(qpos.min())
    if has_cont:
        base0 = min(base0, int(pos[cont].min()))
    base0 -= base0 % C
    end0 = int(qpos.max()) + 1
    if has_cont:
        end0 = max(end0, int(hi[cont].max()))
    span = end0 - base0
    nbins = (span + C - 1) // C
    if has_cont:
        d_plus = np.bincount(pos[cont] - base0, minlength=span + 1)
        d_minus = np.bincount(hi[cont] - base0, minlength=span + 1)
        basecov = np.cumsum(d_plus[:span] - d_minus[:span])
        pad = nbins * C - span
        if pad:
            basecov = np.concatenate(
                [basecov, np.zeros(pad, np.int64)])
        final = basecov.reshape(nbins, C).sum(axis=1)
    else:
        final = np.zeros(nbins, np.int64)
    b0 = base0 // C
    carried = finder.depth.bins
    for k, v in carried.items():
        j = k - b0
        if 0 <= j < nbins:
            final[j] += v
    qbin_rel = (qpos // C) - b0
    hot = final[qbin_rel] >= vthresh
    pass_q = ~hot
    if hot.any():
        maxlen = int(ln[cont].max()) if has_cont else 0
        qidx = np.nonzero(query)[0]
        cidx = np.nonzero(cont)[0]
        cpos = pos[cidx]
        chi = hi[cidx]
        for gb in np.unique(qbin_rel[hot]).tolist():
            gb_abs = gb + b0
            w_lo = gb_abs * C
            w_hi = w_lo + C
            a = np.searchsorted(cpos, w_lo - maxlen, side="left")
            z = np.searchsorted(cpos, w_hi, side="left")
            ov = (np.minimum(chi[a:z], w_hi)
                  - np.maximum(cpos[a:z], w_lo))
            sel = ov > 0
            c_stream = cidx[a:z][sel]
            baseline = carried.get(gb_abs, 0)
            csum = np.concatenate(
                [[baseline], baseline + np.cumsum(ov[sel])])
            qm = hot & (qbin_rel == gb)
            ins = np.searchsorted(c_stream, qidx[qm], side="right")
            pass_q[qm] = csum[ins] < vthresh
    out[query] = pass_q
    # persist the batch-final bins for the next batch of this stream
    # (identical to the scalar end state; clear_below is memory
    # management only and still runs from the evidence tail)
    newbins = {k: v for k, v in carried.items()
               if not (0 <= k - b0 < nbins)}
    for j in np.nonzero(final)[0].tolist():
        newbins[b0 + j] = int(final[j])
    # trim bins no future read can touch (positions are nondecreasing
    # across batches, so bins strictly below (last_pos-10)//C are
    # never inc'd or read again — the scalar clear_below invariant)
    cut = (int(pos[-1]) - 10) // C
    finder.depth.bins = {k: v for k, v in newbins.items() if k >= cut}
    finder._gate_floor = cut * C
    return out


def _run_merged(finder: SVLocusSetFinder, batches: list[ReadBatch],
                order: list[tuple[int, int]]):
    """Process a position-merged multi-sample stream."""
    # Precompute per-sample vectorized filters once
    sas = [has_sa_tag(b) for b in batches]
    core_bads = [is_read_unmapped_or_filtered_core(b, s)
                 for b, s in zip(batches, sas)]
    min_mapq = finder.scanner.opt.min_mapq
    ev_masks = []
    type_masks = []
    for si, b in enumerate(batches):
        survivors = ~core_bads[si] & (b.mapq >= min_mapq)
        ev = np.zeros(b.n, dtype=bool)
        tm = None
        if survivors.any():
            masks = finder.scanner.sv_evidence_masks(
                b, si, finder.refseq, finder.ref_offset,
                sa=sas[si], sel=survivors)
            ev = masks["evidence"]
            tm = {k: masks[k] for k in ("anom", "split", "indel", "assm")}
        type_masks.append(tm)
        ev_masks.append(ev)

    supplementary = [
        ((b.flag & 0x800) != 0) | (((b.flag & 0x100) != 0) & sas[si])
        for si, b in enumerate(batches)]
    osi, oi = order

    from ..core.readfilter import mate_insertion_candidates_mask
    if finder.max_depth is None:
        ok_masks = [~cb for cb in core_bads]
    else:
        # the sequential inc-then-test depth gate, replayed vectorized
        # with identical stream semantics (see _depth_gate_batch)
        depth_pass = _depth_gate_batch(finder, batches, osi, oi,
                                       core_bads)
        ok_masks = []
        for si, b in enumerate(batches):
            dp = np.zeros(b.n, bool)
            m = osi == si
            if m.any():
                dp[oi[m]] = depth_pass[m]
            ok_masks.append(dp)

    # Every counter is a pure reduction over the gated masks; only
    # evidence reads need the per-read walk below. Count semantics
    # (SVLocusScanner.cpp:1457-1479): min_mapq tested after the depth
    # gate, supplemental split segments excluded from "normal" counts.
    for si, b in enumerate(batches):
        if b.n == 0:
            continue
        counts = finder.counts[si]
        ok = ok_masks[si]
        lowq = ok & (b.mapq < min_mapq)
        counts.min_mapq += int(lowq.sum())
        base = ok & ~lowq
        sup = base & supplementary[si]
        counts.split_supplementary_segment += int(sup.sum())
        norm = base & ~supplementary[si]
        counts.total += int(norm.sum())
        tm = type_masks[si]
        if tm is not None:
            anom = norm & tm["anom"]
            counts.anom += int(anom.sum())
            counts.remote_recovery_candidates += int(
                (anom & mate_insertion_candidates_mask(
                    b, sas[si], min_mapq)).sum())
            counts.split += int((norm & tm["split"]).sum())
            counts.anom_and_split += int(
                (anom & tm["split"]).sum())
            counts.indel += int((norm & tm["indel"]).sum())
            counts.assm += int((norm & tm["assm"]).sum())
        ev = ev_masks[si]
        counts.ignored += int((base & ~ev).sum())
        counts.evidence += int((base & ev).sum())
    # compress the merged stream to surviving evidence reads
    keep = np.zeros(len(osi), bool)
    for si, b in enumerate(batches):
        m = osi == si
        if m.any():
            surv = ev_masks[si] & ok_masks[si] & (b.mapq >= min_mapq)
            keep[m] = surv[oi[m]]
    osi, oi = osi[keep], oi[keep]

    for (si, i) in zip(osi.tolist(), oi.tolist()):
        b = batches[si]
        counts = finder.counts[si]
        pos = int(b.pos[i])
        if not (finder.beg <= pos < finder.end):
            continue
        finder._handle_new_pos(pos)
        loci_data = finder.scanner.get_read_loci_data(
            b, i, si, finder.refseq, finder.ref_offset)
        for (bp1, bp2, w1, w2, ev_range, is_complex) in loci_data:
            # evidence-type stats (SVLocusScanner.cpp:1208-1231)
            for j in range(EV_SIZE):
                counts.e_type[j] += int(bp1.evidence[j])
            if w1 == WEIGHT_CLOSE_READ_PAIR and \
                    bp1.get_any_non_pair_count() == 0 and \
                    bp1.get_local_pair_count() != 0:
                counts.close_count += 1
            ls = finder.locus_set
            if hasattr(ls, "insert_read_locus"):  # native engine
                if is_complex:
                    ls.insert_read_locus(
                        bp1.interval.tid, bp1.interval.beg,
                        bp1.interval.end, ev_range[0], ev_range[1], w1,
                        True)
                else:
                    ls.insert_read_locus(
                        bp1.interval.tid, bp1.interval.beg,
                        bp1.interval.end, ev_range[0], ev_range[1], w1,
                        False, bp2.interval.tid, bp2.interval.beg,
                        bp2.interval.end, w2)
                continue
            locus = SVLocus()
            n1 = locus.add_node(bp1.interval.tid, bp1.interval.beg,
                                bp1.interval.end)
            locus.set_node_evidence(n1, ev_range[0], ev_range[1])
            if is_complex:
                locus.link_nodes(n1, n1, w1)
            else:
                n2 = locus.add_node(bp2.interval.tid, bp2.interval.beg,
                                    bp2.interval.end)
                locus.link_nodes(n1, n2, w1, w2)
                locus.merge_self_overlap()
            if not locus.empty():
                finder.locus_set.merge_locus(locus)
