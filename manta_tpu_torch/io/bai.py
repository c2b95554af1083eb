"""BAI/CSI (BAM index) parsers and region query.

Implements the UCSC-style R-tree binning index from the SAM/BAM spec
(section 5): 5-level bins over 512Mb, 16kb linear index — plus the CSI
generalization (CSIv1 spec): configurable min_shift/depth so
chromosomes longer than 512 Mb index correctly, per-bin loffset in
place of the separate linear index, BGZF-compressed container. Used
for region-restricted read fetches; the reader falls back bai→csi as
the reference does (reference analogue: htslib index lookup behind
bam_streamer::resetRegion, htsapi/bam_streamer.hpp:69-76 and the
`.bai`/`.csi`/`.crai` acceptance at bam_streamer.cpp:131).
"""

from __future__ import annotations

import struct

PSEUDO_BIN = 37450


def reg2bins(beg: int, end: int) -> list[int]:
    """All bins that may overlap 0-based half-open [beg, end)."""
    if beg >= end:
        return []
    end -= 1
    bins = [0]
    for shift, off in ((26, 1), (23, 9), (20, 73), (17, 585), (14, 4681)):
        bins.extend(range(off + (beg >> shift), off + (end >> shift) + 1))
    return bins


class BaiIndex:
    def __init__(self, path: str):
        with open(path, "rb") as f:
            data = f.read()
        if data[:4] != b"BAI\x01":
            raise ValueError(f"{path}: not a BAI index")
        (n_ref,) = struct.unpack_from("<i", data, 4)
        off = 8
        self.refs = []
        for _ in range(n_ref):
            (n_bin,) = struct.unpack_from("<i", data, off)
            off += 4
            bins: dict[int, list[tuple[int, int]]] = {}
            meta = None
            for _ in range(n_bin):
                b, n_chunk = struct.unpack_from("<Ii", data, off)
                off += 8
                chunks = list(
                    struct.unpack_from(f"<{2 * n_chunk}Q", data, off)
                )
                off += 16 * n_chunk
                pairs = [(chunks[i], chunks[i + 1]) for i in range(0, len(chunks), 2)]
                if b == PSEUDO_BIN:
                    meta = pairs
                else:
                    bins[b] = pairs
            (n_intv,) = struct.unpack_from("<i", data, off)
            off += 4
            ioff = struct.unpack_from(f"<{n_intv}Q", data, off)
            off += 8 * n_intv
            self.refs.append((bins, list(ioff), meta))

    def first_indexed_pos(self, tid: int) -> int:
        """Inclusive lower bound on read start positions for tid: a
        BGZF virtual offset of 0 is the file header, so a leading
        linear-index window with offset 0 cannot contain an alignment
        start. (Index writers that backfill leading windows with the
        first read's offset just make this bound conservative.)"""
        if tid < 0 or tid >= len(self.refs):
            return 0
        _, linear, _ = self.refs[tid]
        for i, off in enumerate(linear):
            if off != 0:
                return i << 14
        return len(linear) << 14

    def last_indexed_end(self, tid: int) -> int:
        """Exclusive upper bound on read start positions for tid: the
        16 kb linear index only extends to the window of the last
        indexed read, so no read starts at or beyond
        n_intv << 14. Lets scans skip declared-but-empty chromosome
        tails (e.g. a header that declares the full chromosome while
        the data covers a small region)."""
        if tid < 0 or tid >= len(self.refs):
            return 0
        _, linear, _ = self.refs[tid]
        return len(linear) << 14

    def query(self, tid: int, beg: int, end: int) -> list[tuple[int, int]]:
        """Merged (voffset_start, voffset_end) chunk list overlapping region."""
        if tid < 0 or tid >= len(self.refs):
            return []
        bins, linear, _ = self.refs[tid]
        min_off = 0
        if linear:
            w = min(beg >> 14, len(linear) - 1)
            min_off = linear[w]
        chunks = []
        for b in reg2bins(beg, end):
            for cb, ce in bins.get(b, ()):
                if ce > min_off:
                    chunks.append((max(cb, min_off), ce))
        return _merge_chunks(chunks)


def _merge_chunks(chunks: list[tuple[int, int]]) -> list[tuple[int, int]]:
    chunks.sort()
    merged: list[tuple[int, int]] = []
    for cb, ce in chunks:
        if merged and cb <= merged[-1][1]:
            if ce > merged[-1][1]:
                merged[-1] = (merged[-1][0], ce)
        else:
            merged.append((cb, ce))
    return merged


def reg2bins_csi(beg: int, end: int, min_shift: int,
                 depth: int) -> list[int]:
    """All CSI bins that may overlap 0-based half-open [beg, end) for
    an index with the given min_shift/depth (the BAI geometry is
    min_shift=14, depth=5)."""
    if beg >= end:
        return []
    end -= 1
    bins = [0]
    level_off = 0
    for level in range(1, depth + 1):
        level_off = (level_off << 3) + 1
        shift = min_shift + 3 * (depth - level)
        bins.extend(range(level_off + (beg >> shift),
                          level_off + (end >> shift) + 1))
    return bins


def reg2bin_csi(beg: int, end: int, min_shift: int, depth: int) -> int:
    """Smallest CSI bin fully containing 0-based half-open [beg, end)."""
    end -= 1
    level_off = ((1 << (3 * depth)) - 1) // 7
    shift = min_shift
    for _ in range(depth, 0, -1):
        if (beg >> shift) == (end >> shift):
            return level_off + (beg >> shift)
        shift += 3
        level_off = (level_off - 1) >> 3
    return 0


def csi_bin_interval(b: int, min_shift: int, depth: int) -> tuple[int, int]:
    """Genomic [start, end) interval covered by CSI bin b."""
    level_off, level = 0, 0
    while True:
        next_off = (level_off << 3) + 1
        if level == depth or b < next_off:
            break
        level_off = next_off
        level += 1
    shift = min_shift + 3 * (depth - level)
    return (b - level_off) << shift, ((b - level_off) + 1) << shift


class CsiIndex:
    """CSI v1 index (.csi): the BAI R-tree with configurable
    min_shift/depth and per-bin loffset virtual-offset floors. The
    container is BGZF (gzip-member) compressed."""

    def __init__(self, path: str):
        import gzip
        with gzip.open(path, "rb") as f:
            data = f.read()
        if data[:4] != b"CSI\x01":
            raise ValueError(f"{path}: not a CSI index")
        self.min_shift, self.depth, l_aux = struct.unpack_from(
            "<iii", data, 4)
        self.aux = bytes(data[16:16 + l_aux])
        off = 16 + l_aux
        # bins 0..n_bins-1 are real; n_bins+1 is the pseudo bin
        self.n_bins = ((1 << (3 * (self.depth + 1))) - 1) // 7
        (n_ref,) = struct.unpack_from("<i", data, off)
        off += 4
        self.refs = []
        for _ in range(n_ref):
            (n_bin,) = struct.unpack_from("<i", data, off)
            off += 4
            bins: dict[int, list[tuple[int, int]]] = {}
            loff: dict[int, int] = {}
            meta = None
            for _ in range(n_bin):
                b, lo, n_chunk = struct.unpack_from("<IQi", data, off)
                off += 16
                chunks = list(
                    struct.unpack_from(f"<{2 * n_chunk}Q", data, off))
                off += 16 * n_chunk
                pairs = [(chunks[i], chunks[i + 1])
                         for i in range(0, len(chunks), 2)]
                if b > self.n_bins:
                    meta = pairs  # pseudo bin: unmapped/meta counts
                else:
                    bins[b] = pairs
                    loff[b] = lo
            self.refs.append((bins, loff, meta))

    def _bin_bounds(self, tid: int) -> tuple[int, int]:
        """Conservative (first_pos, last_end) from bin genomic spans."""
        bins, _, _ = self.refs[tid]
        lo, hi = None, 0
        for b in bins:
            s, e = csi_bin_interval(b, self.min_shift, self.depth)
            lo = s if lo is None else min(lo, s)
            hi = max(hi, e)
        return (0 if lo is None else lo), hi

    def first_indexed_pos(self, tid: int) -> int:
        """Inclusive lower bound on read start positions for tid
        (conservative: the start of the earliest occupied bin)."""
        if tid < 0 or tid >= len(self.refs):
            return 0
        return self._bin_bounds(tid)[0]

    def last_indexed_end(self, tid: int) -> int:
        """Exclusive upper bound on read start positions for tid
        (conservative: the end of the latest occupied bin)."""
        if tid < 0 or tid >= len(self.refs):
            return 0
        return self._bin_bounds(tid)[1]

    def query(self, tid: int, beg: int, end: int) -> list[tuple[int, int]]:
        """Merged (voffset_start, voffset_end) chunk list overlapping
        region; pruned by the loffset of the nearest indexed bin at or
        above the leaf containing beg (the CSI linear-index analogue)."""
        if tid < 0 or tid >= len(self.refs):
            return []
        bins, loff, _ = self.refs[tid]
        # walk from the leaf containing beg up to the root; the first
        # bin present gives the virtual-offset floor
        min_off = 0
        b = ((1 << (3 * self.depth)) - 1) // 7 + (beg >> self.min_shift)
        while True:
            if b in loff:
                min_off = loff[b]
                break
            if b == 0:
                break
            b = (b - 1) >> 3
        chunks = []
        for b in reg2bins_csi(beg, end, self.min_shift, self.depth):
            for cb, ce in bins.get(b, ()):
                if ce > min_off:
                    chunks.append((max(cb, min_off), ce))
        return _merge_chunks(chunks)


def open_index(bam_path: str):
    """Load the BAM's index, preferring `.bai` and falling back to
    `.csi` (reference: bam_streamer.cpp:131 accepts either); returns
    None when neither exists."""
    try:
        return BaiIndex(bam_path + ".bai")
    except FileNotFoundError:
        pass
    try:
        return CsiIndex(bam_path + ".csi")
    except FileNotFoundError:
        return None
