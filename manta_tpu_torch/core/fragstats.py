"""Phase-0 fragment-size statistics estimation.

Behavioral parity with the reference's GetAlignmentStats pipeline
(reference: src/c++/lib/manta/ReadGroupStatsUtil.cpp: convergent
chromosome-cycling sampling with buffered abnormal-region rejection,
orientation consensus voting, and 0.9995-quantile tail filtering;
spec docs/methods/primary/methods.tex:91).

Persistence uses JSON instead of boost xml; the content (histogram,
orientation, read counts) is equivalent.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field

import numpy as np

from ..io.bam import (
    C_N,
    C_S,
    C_M,
    C_EQ,
    C_X,
    FLAG_PAIRED,
    FLAG_READ1,
    FLAG_REVERSE,
    ReadBatch,
    open_alignment_reader,
)
from .readfilter import (
    ORIENT_RP, has_sa_tag, is_mapped_chrom_pair, is_non_strict_supplement,
    is_read_filtered_core, pair_orientation,
)
from .sizedist import SizeDistribution

ORIENT_LABELS = ["UNKNOWN", "Fm", "Fp", "Rm", "Rp"]


@dataclass
class ReadCounter:
    total: int = 0
    paired: int = 0
    unpaired: int = 0
    paired_low_mapq: int = 0
    high_confidence_pairs: int = 0

    def to_dict(self):
        return self.__dict__.copy()

    @classmethod
    def from_dict(cls, d):
        rc = cls()
        rc.__dict__.update(d)
        return rc

    def add(self, other: "ReadCounter"):
        for k in self.__dict__:
            self.__dict__[k] += other.__dict__[k]


@dataclass
class ReadGroupStats:
    frag_stats: SizeDistribution = field(default_factory=SizeDistribution)
    rel_orient: int = ORIENT_RP
    counter: ReadCounter = field(default_factory=ReadCounter)

    def to_dict(self):
        return {
            "fragmentSizeDistribution": self.frag_stats.to_dict(),
            "pairOrientation": ORIENT_LABELS[self.rel_orient],
            "readCount": self.counter.to_dict(),
        }

    @classmethod
    def from_dict(cls, d):
        return cls(
            frag_stats=SizeDistribution.from_dict(d["fragmentSizeDistribution"]),
            rel_orient=ORIENT_LABELS.index(d["pairOrientation"]),
            counter=ReadCounter.from_dict(d["readCount"]),
        )


class ReadGroupStatsSet:
    """Per-(alignment file, read group) stats collection (reference:
    manta/ReadGroupStatsSet.hpp keyed by ReadGroupLabel =
    (bamFilename, RG tag); an empty RG refers to the file's default
    group). Labels are "path" for a file's single/default group and
    "path\\t<RG>" for per-read-group entries."""

    SEP = "\t"

    def __init__(self):
        self._stats: dict[str, ReadGroupStats] = {}

    @staticmethod
    def label_for(path: str, rg: str = "") -> str:
        return f"{path}{ReadGroupStatsSet.SEP}{rg}" if rg else path

    def set_stats(self, label: str, stats: ReadGroupStats):
        self._stats[label] = stats

    def set_file_stats(self, path: str, per_rg: dict):
        """Store one entry per read group of a file (insertion order =
        estimation order, first group is the file's representative)."""
        for rg, stats in per_rg.items():
            self._stats[self.label_for(path, rg)] = stats

    def file_groups(self, path: str) -> list[tuple[str, ReadGroupStats]]:
        """All (rg, stats) entries of one file, in insertion order."""
        out = []
        prefix = path + self.SEP
        for k, v in self._stats.items():
            if k == path:
                out.append(("", v))
            elif k.startswith(prefix):
                out.append((k[len(prefix):], v))
        return out

    def get_stats(self, label_or_index) -> ReadGroupStats:
        """Representative stats for a file (its first group; reference
        consumers index one CachedReadGroupStats per alignment file,
        SVLocusScanner.cpp:1495), or an entry by exact label/index."""
        if isinstance(label_or_index, int):
            return list(self._stats.values())[label_or_index]
        hit = self._stats.get(label_or_index)
        if hit is not None:
            return hit
        groups = self.file_groups(label_or_index)
        if not groups:
            raise KeyError(label_or_index)
        return groups[0][1]

    @property
    def labels(self) -> list[str]:
        return list(self._stats)

    def merge(self, other: "ReadGroupStatsSet"):
        for k, v in other._stats.items():
            self._stats[k] = v

    def save(self, path: str):
        with open(path, "w") as f:
            json.dump({k: v.to_dict() for k, v in self._stats.items()}, f, indent=1)

    @classmethod
    def load(cls, path: str) -> "ReadGroupStatsSet":
        out = cls()
        with open(path) as f:
            for k, v in json.load(f).items():
                out._stats[k] = ReadGroupStats.from_dict(v)
        return out


# ---------------------------------------------------------------------------
# estimation

def _cigar_ops_lens(batch: ReadBatch, i: int):
    cg = batch.cigar_arr(i)
    return (cg & 0xF), (cg >> 4)


def _refskip_lens(batch: ReadBatch) -> np.ndarray:
    """Per-read total N (refskip) length, vectorized."""
    ops = (batch.cigar & 0xF).astype(np.int64)
    lens = (batch.cigar >> 4).astype(np.int64)
    contrib = np.where(ops == C_N, lens, 0)
    csum = np.concatenate([[0], np.cumsum(contrib)])
    return (csum[batch.cigar_off[1:]] - csum[batch.cigar_off[:-1]]).astype(np.int64)


def _align_shape_ok(batch: ReadBatch) -> np.ndarray:
    """Keep only conservative alignments {X}M({Z}N{X2}M)?({Y}S)? with the
    op order reversed for reverse-strand reads
    (reference: ReadAlignFilter, ReadGroupStatsUtil.cpp:525-558).
    Returns True where the read is KEPT.

    Vectorized restatement of the scalar state machine: only M/=/X, one
    N at most, at least one M, and (in scan direction) no M after the
    first soft-clip. Ops past a failure point cannot rescue a read, so
    order-independent counting plus the M-vs-S index constraint is
    equivalent.
    """
    n = batch.n
    out = np.zeros(n, dtype=bool)
    if n == 0 or len(batch.cigar) == 0:
        return out
    ops = (batch.cigar & 0xF).astype(np.int32)
    idx = np.arange(len(ops), dtype=np.int64)
    c0 = batch.cigar_off[:-1]
    nseg = batch.cigar_off[1:] - c0
    nonempty = nseg > 0
    # clip keeps reduceat indices in range and monotone; empty segments
    # produce single-element garbage that `nonempty` masks out
    starts = np.minimum(c0, len(ops) - 1)

    is_m = (ops == C_M) | (ops == C_EQ) | (ops == C_X)
    is_n = ops == C_N
    is_s = ops == C_S
    is_other = ~(is_m | is_n | is_s)

    def seg_sum(vals):
        return np.add.reduceat(vals.astype(np.int64), starts)

    def seg_min(vals, fill):
        v = np.where(vals[0], vals[1], fill)
        return np.minimum.reduceat(v, starts)

    big = np.int64(1 << 60)
    m_count = seg_sum(is_m)
    n_count = seg_sum(is_n)
    other = seg_sum(is_other)
    m_min = seg_min((is_m, idx), big)
    m_max = -seg_min((is_m, -idx), big)
    s_min = seg_min((is_s, idx), big)
    s_max = -seg_min((is_s, -idx), big)

    rev = (batch.flag & FLAG_REVERSE) != 0
    # forward: last M before first S; reverse: first M after last S
    order_ok = np.where(rev, m_min > s_max, m_max < s_min)
    no_s = seg_sum(is_s) == 0
    order_ok |= no_s
    out = nonempty & (other == 0) & (n_count <= 1) & (m_count > 0) & \
        order_ok
    return out


def simplified_frag_size(size: int) -> int:
    """Zero all but the top 4 decimal digits (histogram compression;
    reference: ReadGroupStatsUtil.cpp:87-99)."""
    steps = 0
    while size > 1000:
        size //= 10
        steps += 1
    return size * (10 ** steps)


def _is_stat_set_match(a: SizeDistribution, b: SizeDistribution) -> bool:
    """Convergence: all deciles within 1 and cdf within 0.001
    (reference: ReadGroupStatsUtil.cpp:44-62)."""
    prob = np.float32(0.05)
    while prob < 1:
        if abs(a.quantile(float(prob)) - b.quantile(float(prob))) >= 1:
            return False
        fs = b.quantile(float(prob))
        if abs(a.cdf(fs) - b.cdf(fs)) >= 0.001:
            return False
        prob = np.float32(prob + np.float32(0.1))
    return True


class _Tracker:
    """Sequential estimation state for one read group."""

    MIN_OBS = 100
    CHECK_CNT = 100000
    MAX_RECORDS = 5000000

    def __init__(self):
        self.stats = ReadGroupStats()
        self.orient_counts = np.zeros(5, np.int64)
        self.total_orient = 0
        self.converged = False
        self.checked = False
        self._old: SizeDistribution | None = None
        # buffer (columnar: per-add_batch orientation/size arrays)
        self.buf_ori: list[np.ndarray] = []
        self.buf_sz: list[np.ndarray] = []
        self.buf_rp = 0
        self.buf_abnormal = 0

    def add_batch(self, oris: np.ndarray, szs: np.ndarray) -> bool:
        """Vectorized add for one native-scan return; returns False if
        the buffered region looked abnormal. The native scan stops at
        the exact RP-buffer boundary (mt_frag_scan is handed the
        remaining capacity), so a commit or abnormal check can only
        trigger on the batch's final observation — intermediate
        observations just accumulate, matching the reference's
        per-observation loop."""
        if len(oris) == 0:
            return True
        rp = oris == ORIENT_RP
        self.buf_ori.append(oris)
        self.buf_sz.append(szs)
        self.buf_rp += int(rp.sum())
        self.buf_abnormal += int((szs[rp] >= 5000).sum())
        normal = True
        if self.buf_rp >= 1000:
            if self.buf_abnormal / self.buf_rp < 0.01:
                self._commit()
                if self.stats.frag_stats.total_observations % self.CHECK_CNT == 0:
                    self.checked = True
            else:
                normal = False
            self.buf_ori.clear()
            self.buf_sz.clear()
            self.buf_rp = 0
            self.buf_abnormal = 0
        return normal

    def _commit(self):
        if not self.buf_ori:
            return
        oris = np.concatenate(self.buf_ori)
        szs = np.concatenate(self.buf_sz)
        # orientation votes: first (100000 - total_orient) non-unknown
        # observations in stream order (the reference caps the counter,
        # so truncation order matters)
        nz = np.flatnonzero(oris != 0)
        room = 100000 - self.total_orient
        if room > 0 and len(nz):
            take = oris[nz[:room]]
            self.orient_counts += np.bincount(
                take.astype(np.int64), minlength=5)
            self.total_orient += len(take)
        self.stats.counter.high_confidence_pairs += len(oris)
        self.stats.frag_stats.add_observations(szs[oris == ORIENT_RP])

    def update_convergence(self):
        if self._old is not None and self._old.total_observations > 0:
            self.converged = _is_stat_set_match(self._old, self.stats.frag_stats)
        self._old = SizeDistribution.from_dict(self.stats.frag_stats.to_dict())

    def finalize(self, label: str, default_stats_path: str | None = None):
        if self.buf_rp > 0 and self.buf_abnormal / self.buf_rp < 0.01:
            self._commit()
        self.buf_ori.clear()
        self.buf_sz.clear()
        if default_stats_path and (
                self.total_orient < self.MIN_OBS or
                self.stats.frag_stats.total_observations < self.MIN_OBS):
            # fall back to user-provided stats when direct estimation
            # fails (reference: ReadGroupStatsUtil.cpp:429-450
            # --default-stats-file; the first entry substitutes)
            import sys
            print(f"Can't generate pair statistics for {label}; using "
                  f"existing stats as default: {default_stats_path}",
                  file=sys.stderr)
            self.stats = ReadGroupStatsSet.load(
                default_stats_path).get_stats(0)
            return
        if self.total_orient < self.MIN_OBS:
            raise RuntimeError(
                f"Too few high-confidence read pairs ({self.total_orient}) to "
                f"determine pair orientation for {label}; at least "
                f"{self.MIN_OBS} required."
            )
        max_idx = int(np.argmax(self.orient_counts))
        if self.orient_counts[max_idx] < 0.9 * self.total_orient:
            raise RuntimeError(
                f"Can't determine consensus pair orientation of {label}."
            )
        self.stats.rel_orient = max_idx
        if max_idx != ORIENT_RP:
            raise RuntimeError(
                f"Unexpected consensus read orientation for {label}: only "
                f"paired-end (FR) reads are supported."
            )
        if not self.converged:
            if self.stats.frag_stats.total_observations < self.MIN_OBS:
                raise RuntimeError(
                    f"Can't generate pair statistics for {label}: only "
                    f"{self.stats.frag_stats.total_observations} observations."
                )
            if not self.checked:
                self.update_convergence()
        self.stats.frag_stats.filter_observations_over_quantile(0.9995)


def batch_rg_keep_mask(batch, rg: str) -> "np.ndarray":
    """Per-read mask: read's RG tag == rg (absent tag matches '');
    one native pass over the batch's tag blob (mt_tag_zmatch)."""
    from .._native import get_lib, i64p, u8p
    lib = get_lib()
    out = np.empty(batch.n, np.uint8)
    tags = np.frombuffer(batch.tags, np.uint8) if batch.n else \
        np.zeros(0, np.uint8)
    want = np.frombuffer(rg.encode(), np.uint8)
    tag_off = np.ascontiguousarray(batch.tag_off, np.int64)
    lib.mt_tag_zmatch(
        batch.n, tag_off.ctypes.data_as(i64p), tags.ctypes.data_as(u8p),
        b"R", b"G", want.ctypes.data_as(u8p), len(want),
        out.ctypes.data_as(u8p))
    return out.astype(bool)


def extract_read_group_stats_set(bam_path: str,
                                 chunk_size: int = 4_000_000,
                                 reference: str | None = None,
                                 default_stats: str | None = None,
                                 per_read_group: bool = True) -> dict:
    """Per-read-group fragment statistics for one alignment file
    (reference: ReadGroupStatsUtil.cpp ReadGroupManager — one
    ReadGroupTracker per RG with its own convergence, orientation vote,
    and counters; note the reference ships with READ_GROUPS undefined,
    ReadGroupStatsUtil.cpp:855-898, so its production binaries pool one
    default group per file). Files with at most one @RG line keep the
    single-pass default-group path (label ""); multi-RG files run one
    independent convergent-sampling pass per group. When any group has
    too few high-confidence pairs to stand alone (common for files
    merely split into sequencing lanes), the whole file falls back to
    the pooled per-file estimate — the reference's shipped behavior."""
    reader = open_alignment_reader(bam_path, reference)
    rgs = reader.header.read_group_ids() if per_read_group else []
    if len(rgs) <= 1:
        return {"": extract_read_group_stats(
            bam_path, chunk_size, reference, default_stats)}
    out = {}
    try:
        for rg in rgs:
            out[rg] = extract_read_group_stats(
                bam_path, chunk_size, reference, rg=rg)
    except RuntimeError as e:
        import sys
        print(f"Per-read-group stats unavailable for {bam_path} "
              f"({e}); pooling all read groups", file=sys.stderr)
        return {"": extract_read_group_stats(
            bam_path, chunk_size, reference, default_stats)}
    return out


def extract_read_group_stats(bam_path: str, chunk_size: int = 65_536,
                             reference: str | None = None,
                             default_stats: str | None = None,
                             rg: str | None = None
                             ) -> ReadGroupStats:
    """Estimate fragment stats for one BAM by convergent sampling.

    Mirrors extractReadGroupStatsFromAlignmentFile
    (reference: ReadGroupStatsUtil.cpp:833-947): cycle chromosomes,
    streaming reads from the highest position seen; per-region abnormal
    buffers cause a chromSize/100 skip; stop when the distribution
    converges (deciles stable over 100k observations) or 5M observations.
    """
    import ctypes

    from .._native import get_lib, i32p, i64p, u8p
    i8p = ctypes.POINTER(ctypes.c_int8)

    reader = open_alignment_reader(bam_path, reference)
    chrom_count = len(reader.header.ref_names)
    chrom_size = list(reader.header.ref_lengths)
    highest = [-1] * chrom_count

    tracker = _Tracker()
    # ReadPairDepthFilter state lives in the native scan handle
    lib = get_lib()
    frag_state = lib.mt_frag_new()
    try:
        return _extract_loop(bam_path, reader, chrom_count, chrom_size,
                             highest, tracker, lib, frag_state, chunk_size,
                             i8p, i32p, i64p, u8p, ctypes, default_stats,
                             rg=rg)
    finally:
        lib.mt_frag_free(frag_state)


_WINDOW_TARGET_READS = 6000
# floor at the BAI linear-index granularity (16 kb): on ultra-deep data
# (FFPE/panels/tiled stress runs at ~300x) a 64 kb floor inflates ~50x
# more bytes than the sampler consumes per commit; 16 kb keeps window
# fetches aligned with what the index can address without over-reading
_WINDOW_MIN = 16384
_WINDOW_MAX = 8_000_000


class _ChunkWindows:
    """Per-chromosome parsed-window cache for the convergent-sampling
    scan. The slice loop restarts from highest+1 after every tracker
    commit, which would otherwise re-fetch and re-parse the same
    region each visit (the reference's streaming bam iterator makes
    restarts cheap; an eager batch parser must cache instead). The
    observation stream is partition-invariant, so window boundaries
    only affect speed, never results; window sizes adapt to read
    density so one window holds a few visits' worth of reads."""

    def __init__(self, reader, init_size: int):
        self.reader = reader
        # First-visit window cap: before any density estimate exists,
        # a caller-sized multi-Mb window parses ~1.4 M reads (~200 MB)
        # per chromosome and briefly holds GBs across a many-chrom
        # genome — measured 2.3 GB peak on a 24-chrom 35x WGS BAM,
        # the whole workflow's memory high-water mark. 256 kb still
        # yields ~90k reads at 35x (≫ the 6k target) for the first
        # density estimate, and sparse data just grows the next
        # window; boundaries never change the observation stream.
        self.init_size = min(init_size, 262_144)
        # two windows per chrom: slice scans that run past a window
        # boundary and then restart behind it would otherwise thrash a
        # single-entry cache (empty-region probing alternates windows)
        self.win: dict[int, list] = {}
        self.size: dict[int, int] = {}
        # per-tid [first, last) read-start bounds from the BAI linear
        # index: headers often declare full chromosome lengths while
        # the data covers a small region, and probing the empty
        # remainder window-by-window costs a BAI query + coarse-bin
        # parse per window
        self._bounds: dict[int, tuple[int, int]] = {}

    def _tid_bounds(self, ci: int) -> tuple[int, int]:
        hit = self._bounds.get(ci)
        if hit is None:
            idx = getattr(self.reader, "index", None)
            if idx is not None and hasattr(idx, "last_indexed_end"):
                hit = (idx.first_indexed_pos(ci), idx.last_indexed_end(ci))
            else:
                hit = (0, 1 << 62)
            self._bounds[ci] = hit
        return hit

    def get(self, ci: int, beg: int, chrom_end: int):
        """Reads with pos in [beg, win_end) in file order, as
        (batch, win_end)."""
        ents = self.win.setdefault(ci, [])
        ent = None
        for e in ents:
            if e[0] <= beg < e[1]:
                ent = e
                break
        if ent is None:
            w = self.size.get(ci, self.init_size)
            we = min(beg + w, chrom_end)
            lo, hi = self._tid_bounds(ci)
            if beg >= hi or we <= lo:
                # provably empty per the index — same result as the
                # fetch (an empty batch) without issuing it (a real
                # fetch here would also pollute the shared cover
                # cache); window sizing sees density 0 either way
                from ..io.bam import _empty_batch
                raw = _empty_batch()
            else:
                raw = self.reader.fetch(ci, beg, we)
            ent = (beg, we, raw)
            if len(ents) >= 2:
                ents.pop(0)
            ents.append(ent)
            density = raw.n / max(1, we - beg)
            nxt = int(_WINDOW_TARGET_READS / max(density, 1e-9))
            self.size[ci] = min(_WINDOW_MAX, max(_WINDOW_MIN, nxt))
        wb, we, raw = ent
        if raw.n:
            keep = (raw.pos >= beg) & (raw.pos < we)
            batch = raw if keep.all() else raw.subset(keep)
        else:
            batch = raw
        return batch, we


def _extract_loop(bam_path, reader, chrom_count, chrom_size, highest,
                  tracker, lib, frag_state, chunk_size,
                  i8p, i32p, i64p, u8p, ctypes, default_stats=None,
                  rg=None):
    stop = False
    active = True
    windows = _ChunkWindows(reader, chunk_size)
    while active and not stop:
        active = False
        for ci in range(chrom_count):
            if stop:
                break
            finished_slice = False
            while not finished_slice:
                start = highest[ci] + 1
                if start >= chrom_size[ci]:
                    break
                # stream this slice in chunks (semantically a single
                # region query to the chromosome end)
                got_any = False
                break_slice = False
                chunk_beg = start
                while chunk_beg < chrom_size[ci] and not break_slice:
                    batch, chunk_end = windows.get(ci, chunk_beg,
                                                   chrom_size[ci])
                    if batch.n == 0:
                        chunk_beg = chunk_end
                        continue
                    got_any = True
                    sa = has_sa_tag(batch)
                    core_bad = is_read_filtered_core(batch, sa)
                    nss = is_non_strict_supplement(batch, sa)
                    chrom_pair = is_mapped_chrom_pair(batch)
                    orient = pair_orientation(batch)
                    skip_len = _refskip_lens(batch)
                    align_ok = _align_shape_ok(batch)
                    is_paired = (batch.flag & FLAG_PAIRED) != 0

                    # native scan inputs (CoreInsertStatsReadFilter mask
                    # + depth-filter fields); the sequential mate-bank
                    # walk runs in C (mt_frag_scan), returning at each
                    # tracker buffer boundary so commit/convergence
                    # decisions happen at the exact scalar read
                    rg_keep = None if rg is None \
                        else batch_rg_keep_mask(batch, rg)
                    skip = core_bad | nss | ~chrom_pair | \
                        (batch.mapq == 0) | sa | ~align_ok
                    if rg_keep is not None:
                        skip |= ~rg_keep
                    skip_mask = np.ascontiguousarray(skip, dtype=np.uint8)
                    orient8 = np.ascontiguousarray(orient, np.int8)
                    skip32 = np.ascontiguousarray(skip_len, np.int32)
                    first8 = np.ascontiguousarray(
                        (batch.flag & FLAG_READ1) != 0, dtype=np.uint8)
                    obs_ori = np.empty(batch.n, np.int8)
                    obs_frag = np.empty(batch.n, np.int32)
                    c_nobs = ctypes.c_int64()
                    c_inext = ctypes.c_int64()
                    i0 = 0
                    while i0 < batch.n:
                        rc = lib.mt_frag_scan(
                            frag_state, i0, batch.n,
                            batch.refid.ctypes.data_as(i32p),
                            batch.pos.ctypes.data_as(i32p),
                            batch.tlen.ctypes.data_as(i32p),
                            batch.next_pos.ctypes.data_as(i32p),
                            first8.ctypes.data_as(u8p),
                            skip_mask.ctypes.data_as(u8p),
                            orient8.ctypes.data_as(i8p),
                            skip32.ctypes.data_as(i32p),
                            batch.name_off.ctypes.data_as(i64p),
                            batch.name.ctypes.data_as(u8p),
                            0 if tracker.converged else 1,
                            1000 - tracker.buf_rp,
                            obs_ori.ctypes.data_as(i8p),
                            obs_frag.ctypes.data_as(i32p),
                            ctypes.byref(c_nobs), ctypes.byref(c_inext))
                        k = int(c_inext.value)
                        if k > i0:
                            active = True
                            highest[ci] = int(batch.pos[k - 1])
                            cnt = tracker.stats.counter
                            if rg_keep is None:
                                n_tot = k - i0
                                pr = is_paired[i0:k]
                            else:
                                # per-RG pass: count only this group's
                                # records in its ReadCounter
                                n_tot = int(rg_keep[i0:k].sum())
                                pr = is_paired[i0:k] & rg_keep[i0:k]
                            n_pr = int(pr.sum())
                            cnt.total += n_tot
                            cnt.paired += n_pr
                            cnt.unpaired += n_tot - n_pr
                            cnt.paired_low_mapq += int(
                                (pr & (batch.mapq[i0:k] == 0)).sum())
                        if rc != 0:
                            raw = abs(int(batch.tlen[k])) - int(skip32[k])
                            raise RuntimeError(
                                f"Unexpected fragment size ({raw}) in "
                                f"{bam_path}")
                        nobs = int(c_nobs.value)
                        last_normal = tracker.add_batch(
                            obs_ori[:nobs].copy(), obs_frag[:nobs].copy())
                        # only the boundary (last) observation can flag
                        # an abnormal buffer or arm a convergence check
                        if not last_normal:
                            highest[ci] = int(batch.pos[k - 1]) + \
                                max(1, chrom_size[ci] // 100)
                            break_slice = True
                            break
                        if tracker.checked:
                            tracker.update_convergence()
                            tracker.checked = False
                            finished_slice = True
                            stop = tracker.converged or (
                                tracker.stats.frag_stats.total_observations
                                > tracker.MAX_RECORDS
                            )
                            break_slice = True
                            break
                        i0 = k
                    chunk_beg = chunk_end
                if not got_any and not break_slice:
                    highest[ci] = start + max(1, chrom_size[ci] // 100) - 1
                elif highest[ci] <= start and not break_slice:
                    highest[ci] += max(1, chrom_size[ci] // 100)
                if finished_slice or stop:
                    break

    tracker.finalize(bam_path, default_stats)
    return tracker.stats
