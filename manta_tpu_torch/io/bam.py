"""BAM alignment-file reader producing packed struct-of-arrays batches.

Implemented from the SAM/BAM specification (SAMv1). Capability parity
with the reference's htsapi bam_streamer/bam_record layer
(reference: src/c++/lib/htsapi/bam_streamer.hpp:53, bam_record.hpp), but
batch-oriented: a region query yields a ReadBatch whose fixed-width
fields are numpy arrays ready to be shipped to device, with ragged
cigar/seq/qual/tag payloads carried as offset-indexed blobs.
"""

from __future__ import annotations

import os
import struct
from dataclasses import dataclass, field

import numpy as np

from .bgzf import BgzfReader
from .bai import open_index

# SAM flag bits
FLAG_PAIRED = 0x1
FLAG_PROPER_PAIR = 0x2
FLAG_UNMAPPED = 0x4
FLAG_MATE_UNMAPPED = 0x8
FLAG_REVERSE = 0x10
FLAG_MATE_REVERSE = 0x20
FLAG_READ1 = 0x40
FLAG_READ2 = 0x80
FLAG_SECONDARY = 0x100
FLAG_QCFAIL = 0x200
FLAG_DUP = 0x400
FLAG_SUPPLEMENTARY = 0x800

# BAM 4-bit seq code -> ASCII base
SEQ_DECODE = np.frombuffer(b"=ACMGRSVTWYHKDBN", dtype=np.uint8)

# CIGAR op codes: MIDNSHP=X
CIGAR_OPS = b"MIDNSHP=X"
C_M, C_I, C_D, C_N, C_S, C_H, C_P, C_EQ, C_X = range(9)

_FIXED = struct.Struct("<iiBBHHHiiii")  # refID pos lqn mapq bin ncig flag lseq nref npos tlen


@dataclass
class ReadBatch:
    """Struct-of-arrays batch of BAM records.

    Fixed-width per-read fields are numpy arrays of shape (n,); ragged
    payloads (cigar/seq/qual/name/tags) use CSR-style offset arrays of
    shape (n+1,) into flat blobs.
    """

    n: int
    refid: np.ndarray         # int32
    pos: np.ndarray           # int32, 0-based leftmost
    mapq: np.ndarray          # uint8
    flag: np.ndarray          # uint16
    next_refid: np.ndarray    # int32
    next_pos: np.ndarray      # int32
    tlen: np.ndarray          # int32
    cigar_off: np.ndarray     # int64 (n+1,)
    cigar: np.ndarray         # uint32 flat: len<<4|op
    seq_off: np.ndarray       # int64 (n+1,)
    seq: np.ndarray           # uint8 ASCII flat
    qual_off: np.ndarray      # int64 (n+1,)
    qual: np.ndarray          # uint8 flat (0xFF-filled if absent)
    name_off: np.ndarray      # int64 (n+1,)
    name: np.ndarray          # uint8 flat (no NUL)
    tag_off: np.ndarray       # int64 (n+1,)
    tags: bytes               # raw tag blob
    # lazily computed
    _aligned_len: np.ndarray | None = field(default=None, repr=False)

    def seq_str(self, i: int) -> str:
        return self.seq[self.seq_off[i]:self.seq_off[i + 1]].tobytes().decode()

    def qual_arr(self, i: int) -> np.ndarray:
        return self.qual[self.qual_off[i]:self.qual_off[i + 1]]

    def name_str(self, i: int) -> str:
        return self.name_bytes(i).decode()

    def name_blob(self) -> bytes:
        """The flat qname blob as bytes, converted once per batch: the
        scoring/evidence passes key fragments by qname for most reads of
        a batch, so per-read numpy tobytes() slices dominate without
        this memo. Batches are immutable after parse."""
        blob = self.__dict__.get("_name_blob")
        if blob is None:
            blob = self.name.tobytes()
            self.__dict__["_name_blob"] = blob
        return blob

    def name_bytes(self, i: int) -> bytes:
        """Raw qname; preferred as a dict key on hot paths (no decode)."""
        return self.name_blob()[int(self.name_off[i]):
                                int(self.name_off[i + 1])]

    def cigar_arr(self, i: int) -> np.ndarray:
        return self.cigar[self.cigar_off[i]:self.cigar_off[i + 1]]

    def cigar_ops_lens(self, i: int) -> tuple[np.ndarray, np.ndarray]:
        """(ops, lens) int32 views for read i; the whole batch's cigar
        blob is decoded once and sliced per read."""
        dec = getattr(self, "_cigar_decoded", None)
        if dec is None:
            dec = ((self.cigar & 0xF).astype(np.int32),
                   (self.cigar >> 4).astype(np.int32))
            self._cigar_decoded = dec
        c0 = self.cigar_off[i]
        c1 = self.cigar_off[i + 1]
        return dec[0][c0:c1], dec[1][c0:c1]

    def read_len(self, i: int) -> int:
        return int(self.seq_off[i + 1] - self.seq_off[i])

    def approx_bytes(self) -> int:
        """Approximate resident size of this batch's columns, used for
        byte-budgeted cache accounting (ragged blobs + ~64 B/read of
        fixed columns and offsets)."""
        return (int(self.cigar_off[-1]) * 4 + int(self.seq_off[-1]) * 2 +
                int(self.name_off[-1]) + int(self.tag_off[-1]) +
                self.n * 64)

    @property
    def aligned_lengths(self) -> np.ndarray:
        """Reference-consumed length per read (M/D/N/=/X), vectorized."""
        if self._aligned_len is None:
            ops = (self.cigar & 0xF).astype(np.int64)
            lens = (self.cigar >> 4).astype(np.int64)
            consumes_ref = (
                (ops == C_M) | (ops == C_D) | (ops == C_N) | (ops == C_EQ) | (ops == C_X)
            )
            contrib = np.where(consumes_ref, lens, 0)
            csum = np.concatenate([[0], np.cumsum(contrib)])
            self._aligned_len = (
                csum[self.cigar_off[1:]] - csum[self.cigar_off[:-1]]
            ).astype(np.int32)
        return self._aligned_len

    @property
    def end_pos(self) -> np.ndarray:
        """0-based exclusive reference end position per read."""
        return self.pos + self.aligned_lengths

    def get_tag(self, i: int, tag: bytes):
        """Fetch a tag value ('SA', 'NM', ...) for read i; None if absent."""
        blob = self.tags[self.tag_off[i]:self.tag_off[i + 1]]
        return _find_tag(blob, tag)

    def slice_rows(self, lo: int, hi: int) -> "ReadBatch":
        """Near-zero-copy row-range slice [lo, hi): per-read columns and
        numpy blobs are views with rebased offsets; derived per-read
        caches are projected through, so window re-slices of one parsed
        superwindow share all expensive per-batch computations."""
        def rag(off, blob):
            return off[lo:hi + 1] - off[lo], blob[int(off[lo]):int(off[hi])]

        co, cgb = rag(self.cigar_off, self.cigar)
        so, sq = rag(self.seq_off, self.seq)
        qo, ql = rag(self.qual_off, self.qual)
        no, nm = rag(self.name_off, self.name)
        to, tg = rag(self.tag_off, self.tags)
        out = ReadBatch(
            n=hi - lo, refid=self.refid[lo:hi], pos=self.pos[lo:hi],
            mapq=self.mapq[lo:hi], flag=self.flag[lo:hi],
            next_refid=self.next_refid[lo:hi], next_pos=self.next_pos[lo:hi],
            tlen=self.tlen[lo:hi],
            cigar_off=co, cigar=cgb, seq_off=so, seq=sq,
            qual_off=qo, qual=ql, name_off=no, name=nm, tag_off=to, tags=tg)
        if self._aligned_len is not None:
            out._aligned_len = self._aligned_len[lo:hi]
        dec = getattr(self, "_cigar_decoded", None)
        if dec is not None:
            c0, c1 = int(self.cigar_off[lo]), int(self.cigar_off[hi])
            out._cigar_decoded = (dec[0][c0:c1], dec[1][c0:c1])
        om = getattr(self, "_overlap_mask", None)
        if om is not None:
            out._overlap_mask = om[lo:hi]
        sam = getattr(self, "_sa_mask", None)
        if sam is not None:
            out._sa_mask = sam[lo:hi]
        return out

    def compact_copy(self) -> "ReadBatch":
        """Owned copy of every column: slice_rows views pin their source
        batch's full blobs, so long-lived consumers (the fetch cache)
        compact to keep resident memory equal to accounted bytes."""
        def own(a):
            if isinstance(a, bytes):
                return a
            return a.copy() if a.base is not None else a
        out = ReadBatch(
            n=self.n, refid=own(self.refid), pos=own(self.pos),
            mapq=own(self.mapq), flag=own(self.flag),
            next_refid=own(self.next_refid), next_pos=own(self.next_pos),
            tlen=own(self.tlen), cigar_off=own(self.cigar_off),
            cigar=own(self.cigar), seq_off=own(self.seq_off),
            seq=own(self.seq), qual_off=own(self.qual_off),
            qual=own(self.qual), name_off=own(self.name_off),
            name=own(self.name), tag_off=own(self.tag_off),
            tags=self.tags if isinstance(self.tags, bytes)
            else own(self.tags))
        if self._aligned_len is not None:
            out._aligned_len = own(self._aligned_len)
        for attr in ("_cigar_decoded", "_overlap_mask", "_sa_mask"):
            v = getattr(self, attr, None)
            if v is not None:
                setattr(out, attr,
                        tuple(own(x) for x in v) if isinstance(v, tuple)
                        else own(v))
        return out

    def subset(self, idx: np.ndarray) -> "ReadBatch":
        """Gather a sub-batch (keeps ragged payloads; reindexes offsets)."""
        idx = np.asarray(idx)
        if idx.dtype == np.bool_:
            idx = np.flatnonzero(idx)
        n = len(idx)
        if n and int(idx[-1]) - int(idx[0]) + 1 == n and \
                bool((np.diff(idx) == 1).all()):
            return self.slice_rows(int(idx[0]), int(idx[-1]) + 1)

        # one native memcpy pass per column (mt_gather_ragged) replaces
        # the per-run Python copy loop
        from .._native import get_lib, i64p, u8p
        lib = get_lib()
        idx64 = np.ascontiguousarray(idx, dtype=np.int64)

        def ragged(off, blob):
            off = np.ascontiguousarray(off, dtype=np.int64)
            lens = off[idx64 + 1] - off[idx64]
            new_off = np.zeros(n + 1, dtype=np.int64)
            np.cumsum(lens, out=new_off[1:])
            total = int(new_off[-1])
            if total == 0:
                return new_off, (b"" if isinstance(blob, bytes)
                                 else blob[:0])
            if isinstance(blob, bytes):
                arr, elem = np.frombuffer(blob, np.uint8), 1
            else:
                arr = np.ascontiguousarray(blob)
                elem = arr.dtype.itemsize
            out = np.empty(total, dtype=arr.dtype)
            lib.mt_gather_ragged(
                n, idx64.ctypes.data_as(i64p), off.ctypes.data_as(i64p),
                arr.ctypes.data_as(u8p), elem,
                new_off.ctypes.data_as(i64p), out.ctypes.data_as(u8p))
            if isinstance(blob, bytes):
                return new_off, out.tobytes()
            return new_off, out

        co, cg = ragged(self.cigar_off, self.cigar)
        so, sq = ragged(self.seq_off, self.seq)
        qo, ql = ragged(self.qual_off, self.qual)
        no, nm = ragged(self.name_off, self.name)
        to, tg = ragged(self.tag_off, self.tags)
        return ReadBatch(
            n=n, refid=self.refid[idx], pos=self.pos[idx], mapq=self.mapq[idx],
            flag=self.flag[idx], next_refid=self.next_refid[idx],
            next_pos=self.next_pos[idx], tlen=self.tlen[idx],
            cigar_off=co, cigar=cg, seq_off=so, seq=sq, qual_off=qo, qual=ql,
            name_off=no, name=nm, tag_off=to, tags=tg,
        )

    @staticmethod
    def concat(batches: list["ReadBatch"]) -> "ReadBatch":
        batches = [b for b in batches if b.n]
        if not batches:
            return _empty_batch()

        def cat_ragged(offs, blobs):
            total = np.zeros(sum(len(o) - 1 for o in offs) + 1, dtype=np.int64)
            pos = 0
            base = 0
            for o in offs:
                k = len(o) - 1
                total[pos + 1 : pos + 1 + k] = base + o[1:]
                pos += k
                base += o[-1]
            if isinstance(blobs[0], bytes):
                return total, b"".join(blobs)
            return total, np.concatenate(blobs)

        co, cg = cat_ragged([b.cigar_off for b in batches], [b.cigar for b in batches])
        so, sq = cat_ragged([b.seq_off for b in batches], [b.seq for b in batches])
        qo, ql = cat_ragged([b.qual_off for b in batches], [b.qual for b in batches])
        no, nm = cat_ragged([b.name_off for b in batches], [b.name for b in batches])
        to, tg = cat_ragged([b.tag_off for b in batches], [b.tags for b in batches])
        return ReadBatch(
            n=sum(b.n for b in batches),
            refid=np.concatenate([b.refid for b in batches]),
            pos=np.concatenate([b.pos for b in batches]),
            mapq=np.concatenate([b.mapq for b in batches]),
            flag=np.concatenate([b.flag for b in batches]),
            next_refid=np.concatenate([b.next_refid for b in batches]),
            next_pos=np.concatenate([b.next_pos for b in batches]),
            tlen=np.concatenate([b.tlen for b in batches]),
            cigar_off=co, cigar=cg, seq_off=so, seq=sq, qual_off=qo, qual=ql,
            name_off=no, name=nm, tag_off=to, tags=tg,
        )


def _empty_batch() -> ReadBatch:
    z32 = np.zeros(0, np.int32)
    off = np.zeros(1, np.int64)
    return ReadBatch(
        n=0, refid=z32, pos=z32.copy(), mapq=np.zeros(0, np.uint8),
        flag=np.zeros(0, np.uint16), next_refid=z32.copy(), next_pos=z32.copy(),
        tlen=z32.copy(), cigar_off=off, cigar=np.zeros(0, np.uint32),
        seq_off=off.copy(), seq=np.zeros(0, np.uint8), qual_off=off.copy(),
        qual=np.zeros(0, np.uint8), name_off=off.copy(), name=np.zeros(0, np.uint8),
        tag_off=off.copy(), tags=b"",
    )


_TAG_SIZE = {
    ord("A"): 1, ord("c"): 1, ord("C"): 1, ord("s"): 2, ord("S"): 2,
    ord("i"): 4, ord("I"): 4, ord("f"): 4,
}


def _find_tag(blob: bytes, tag: bytes):
    """Scan a BAM aux blob for a 2-char tag; decode its value."""
    i = 0
    n = len(blob)
    while i + 3 <= n:
        t = blob[i : i + 2]
        typ = blob[i + 2]
        i += 3
        if typ in _TAG_SIZE:
            sz = _TAG_SIZE[typ]
            if t == tag:
                if typ == ord("A"):
                    return chr(blob[i])
                fmt = {ord("c"): "<b", ord("C"): "<B", ord("s"): "<h", ord("S"): "<H",
                       ord("i"): "<i", ord("I"): "<I", ord("f"): "<f"}[typ]
                return struct.unpack_from(fmt, blob, i)[0]
            i += sz
        elif typ in (ord("Z"), ord("H")):
            end = blob.index(0, i)
            if t == tag:
                return blob[i:end].decode()
            i = end + 1
        elif typ == ord("B"):
            sub = blob[i]
            cnt = struct.unpack_from("<I", blob, i + 1)[0]
            sz = _TAG_SIZE[sub] * cnt
            if t == tag:
                fmt = {ord("c"): "b", ord("C"): "B", ord("s"): "h", ord("S"): "H",
                       ord("i"): "i", ord("I"): "I", ord("f"): "f"}[sub]
                return list(struct.unpack_from(f"<{cnt}{fmt}", blob, i + 5))
            i += 5 + sz
        else:
            raise ValueError(f"unknown tag type {chr(typ)}")
    return None


def parse_records_multi(bufs: list[bytes],
                        want_overlap: tuple[int, int, int] | None
                        ) -> ReadBatch:
    """Parse the records of several uncompressed chunk buffers into ONE
    batch, applying the region-overlap filter during the native walk
    (native/manta_core.cpp mt_bam_{size,fill}_multi). Equivalent to
    concatenating per-chunk parse_records(want_overlap=...) results."""
    import ctypes
    from .._native import get_lib, i32p, i64p, u8p, u16p, u32p
    lib = get_lib()
    bufs = [b for b in bufs if len(b) >= 4]
    nb = len(bufs)
    if nb == 0:
        return _empty_batch()
    arrs = [np.frombuffer(b, np.uint8) for b in bufs]
    ptrs = (ctypes.c_void_p * nb)(*[a.ctypes.data for a in arrs])
    lens = np.array([len(b) for b in bufs], np.int64)
    starts = np.zeros(nb, np.int64)
    if want_overlap is not None:
        do_filter, (tid, beg, iend) = 1, want_overlap
    else:
        do_filter, tid, beg, iend = 0, 0, 0, 0
    c_n = ctypes.c_int64()
    c_cig = ctypes.c_int64()
    c_seq = ctypes.c_int64()
    c_name = ctypes.c_int64()
    c_tags = ctypes.c_int64()
    lib.mt_bam_size_multi(
        nb, ptrs, lens.ctypes.data_as(i64p), starts.ctypes.data_as(i64p),
        do_filter, tid, beg, iend,
        ctypes.byref(c_n), ctypes.byref(c_cig), ctypes.byref(c_seq),
        ctypes.byref(c_name), ctypes.byref(c_tags))
    n = int(c_n.value)
    if n == 0:
        return _empty_batch()
    refid = np.empty(n, np.int32); pos = np.empty(n, np.int32)
    mapq = np.empty(n, np.uint8); flag = np.empty(n, np.uint16)
    nrefid = np.empty(n, np.int32); npos = np.empty(n, np.int32)
    tlen = np.empty(n, np.int32)
    cigar_off = np.zeros(n + 1, np.int64); seq_off = np.zeros(n + 1, np.int64)
    qual_off = np.zeros(n + 1, np.int64); name_off = np.zeros(n + 1, np.int64)
    tag_off = np.zeros(n + 1, np.int64)
    cigar = np.empty(int(c_cig.value), np.uint32)
    seq = np.empty(int(c_seq.value), np.uint8)
    qual = np.empty(int(c_seq.value), np.uint8)
    name = np.empty(int(c_name.value), np.uint8)
    tags_arr = np.empty(int(c_tags.value), np.uint8)
    rc = lib.mt_bam_fill_multi(
        nb, ptrs, lens.ctypes.data_as(i64p), starts.ctypes.data_as(i64p),
        do_filter, tid, beg, iend, n,
        refid.ctypes.data_as(i32p), pos.ctypes.data_as(i32p),
        mapq.ctypes.data_as(u8p), flag.ctypes.data_as(u16p),
        nrefid.ctypes.data_as(i32p), npos.ctypes.data_as(i32p),
        tlen.ctypes.data_as(i32p),
        cigar_off.ctypes.data_as(i64p), cigar.ctypes.data_as(u32p),
        seq_off.ctypes.data_as(i64p), seq.ctypes.data_as(u8p),
        qual_off.ctypes.data_as(i64p), qual.ctypes.data_as(u8p),
        name_off.ctypes.data_as(i64p), name.ctypes.data_as(u8p),
        tag_off.ctypes.data_as(i64p), tags_arr.ctypes.data_as(u8p))
    assert rc == 0, "mt_bam_fill_multi failed"
    return ReadBatch(
        n=n, refid=refid, pos=pos, mapq=mapq, flag=flag,
        next_refid=nrefid, next_pos=npos, tlen=tlen,
        cigar_off=cigar_off, cigar=cigar,
        seq_off=seq_off, seq=seq,
        qual_off=qual_off, qual=qual,
        name_off=name_off, name=name,
        tag_off=tag_off, tags=tags_arr.tobytes(),
    )


def parse_records(buf: bytes, start: int = 0, end: int | None = None,
                  want_overlap: tuple[int, int, int] | None = None) -> ReadBatch:
    """Parse BAM records from an uncompressed byte buffer.

    want_overlap=(tid,beg,end): keep only reads overlapping the 0-based
    half-open interval (cheap pos prefilter; precise CIGAR-span filter is
    applied on the aligned length afterwards).
    """
    if end is not None and end < len(buf):
        buf = buf[:end]
    # native single-pass extraction (native/manta_core.cpp mt_bam_*)
    import ctypes
    from .._native import get_lib, i32p, i64p, u8p, u16p, u32p
    lib = get_lib()
    c_n = ctypes.c_int64()
    c_cig = ctypes.c_int64()
    c_seq = ctypes.c_int64()
    c_name = ctypes.c_int64()
    c_tags = ctypes.c_int64()
    lib.mt_bam_size(buf, len(buf), start, ctypes.byref(c_n),
                    ctypes.byref(c_cig), ctypes.byref(c_seq),
                    ctypes.byref(c_name), ctypes.byref(c_tags))
    n = int(c_n.value)
    if n == 0:
        return _empty_batch()

    refid = np.empty(n, np.int32); pos = np.empty(n, np.int32)
    mapq = np.empty(n, np.uint8); flag = np.empty(n, np.uint16)
    nrefid = np.empty(n, np.int32); npos = np.empty(n, np.int32)
    tlen = np.empty(n, np.int32)
    cigar_off = np.zeros(n + 1, np.int64); seq_off = np.zeros(n + 1, np.int64)
    qual_off = np.zeros(n + 1, np.int64); name_off = np.zeros(n + 1, np.int64)
    tag_off = np.zeros(n + 1, np.int64)
    cigar = np.empty(int(c_cig.value), np.uint32)
    seq = np.empty(int(c_seq.value), np.uint8)
    qual = np.empty(int(c_seq.value), np.uint8)
    name = np.empty(int(c_name.value), np.uint8)
    tags_arr = np.empty(int(c_tags.value), np.uint8)
    rc = lib.mt_bam_fill(
        buf, len(buf), start, n,
        refid.ctypes.data_as(i32p), pos.ctypes.data_as(i32p),
        mapq.ctypes.data_as(u8p), flag.ctypes.data_as(u16p),
        nrefid.ctypes.data_as(i32p), npos.ctypes.data_as(i32p),
        tlen.ctypes.data_as(i32p),
        cigar_off.ctypes.data_as(i64p), cigar.ctypes.data_as(u32p),
        seq_off.ctypes.data_as(i64p), seq.ctypes.data_as(u8p),
        qual_off.ctypes.data_as(i64p), qual.ctypes.data_as(u8p),
        name_off.ctypes.data_as(i64p), name.ctypes.data_as(u8p),
        tag_off.ctypes.data_as(i64p), tags_arr.ctypes.data_as(u8p))
    assert rc == 0, "mt_bam_fill failed"

    batch = ReadBatch(
        n=n, refid=refid, pos=pos, mapq=mapq, flag=flag,
        next_refid=nrefid, next_pos=npos, tlen=tlen,
        cigar_off=cigar_off, cigar=cigar,
        seq_off=seq_off, seq=seq,
        qual_off=qual_off, qual=qual,
        name_off=name_off, name=name,
        tag_off=tag_off, tags=tags_arr.tobytes(),
    )
    if want_overlap is not None:
        tid, beg, iend = want_overlap
        # zero-aligned-length records (e.g. unmapped shadow reads placed at
        # their mate's position) are treated as 1-base intervals, matching
        # htslib region-query semantics
        end_pos = np.maximum(batch.end_pos, batch.pos + 1)
        keep = (batch.refid == tid) & (batch.pos < iend) & (end_pos > beg)
        if not keep.all():
            batch = batch.subset(keep)
    return batch


class BamHeader:
    def __init__(self, text: str, ref_names: list[str], ref_lengths: list[int]):
        self.text = text
        self.ref_names = ref_names
        self.ref_lengths = ref_lengths
        self.name_to_tid = {nm: i for i, nm in enumerate(ref_names)}

    def read_groups(self) -> list[str]:
        rgs = []
        for line in self.text.splitlines():
            if line.startswith("@RG"):
                for f in line.split("\t"):
                    if f.startswith("ID:"):
                        rgs.append(f[3:])
        return rgs

    def sample_names(self) -> list[str]:
        out = []
        for line in self.text.splitlines():
            if line.startswith("@RG"):
                for f in line.split("\t"):
                    if f.startswith("SM:") and f[3:] not in out:
                        out.append(f[3:])
        return out

    def read_group_ids(self) -> list[str]:
        """@RG ID values in header order (reference: ReadGroupLabel —
        a read group is (bamFilename, RG tag))."""
        out = []
        for line in self.text.splitlines():
            if line.startswith("@RG"):
                for f in line.split("\t"):
                    if f.startswith("ID:") and f[3:] not in out:
                        out.append(f[3:])
        return out


class BamReader:
    """Indexed BAM reader: whole-file or region-query access.

    Reference analogue: bam_streamer (htsapi/bam_streamer.hpp:53) with
    resetRegion/next, but returning batched records.
    """

    def __init__(self, path: str):
        self.path = path
        with open(path, "rb") as f:
            magic4 = f.read(4)
        if magic4 == b"CRAM":
            raise ValueError(
                f"{path}: CRAM input must be opened with "
                "open_alignment_reader(path, reference=ref_fasta)")
        self._bgzf = BgzfReader(path)
        # parse header from the start of the uncompressed stream
        hdr_bytes = self._read_prefix(1 << 16)
        if hdr_bytes[:4] != b"BAM\x01":
            raise ValueError(f"{path}: not a BAM file")
        (l_text,) = struct.unpack_from("<I", hdr_bytes, 4)
        need = 8 + l_text + 4
        if len(hdr_bytes) < need + 8:
            hdr_bytes = self._read_prefix(need + (1 << 20))
        text = hdr_bytes[8 : 8 + l_text].split(b"\x00")[0].decode()
        off = 8 + l_text
        (n_ref,) = struct.unpack_from("<I", hdr_bytes, off)
        off += 4
        names, lengths = [], []
        for _ in range(n_ref):
            while off + 8 > len(hdr_bytes):
                hdr_bytes = self._read_prefix(2 * len(hdr_bytes))
            (l_name,) = struct.unpack_from("<I", hdr_bytes, off)
            while off + 8 + l_name > len(hdr_bytes):
                hdr_bytes = self._read_prefix(2 * len(hdr_bytes))
            names.append(hdr_bytes[off + 4 : off + 4 + l_name - 1].decode())
            (l_ref,) = struct.unpack_from("<I", hdr_bytes, off + 4 + l_name)
            lengths.append(l_ref)
            off += 8 + l_name
        self.header = BamHeader(text, names, lengths)
        self._records_ustart = off  # uncompressed offset where records begin
        self.index = open_index(path)

    def _read_prefix(self, nbytes: int) -> bytes:
        out = []
        got = 0
        coff = 0
        while got < nbytes and coff < self._bgzf.size:
            payload, coff = self._bgzf.block_at(coff)
            out.append(payload)
            got += len(payload)
        return b"".join(out)

    def read_all(self) -> ReadBatch:
        buf = self._bgzf.decompress_all()
        return parse_records(buf, self._records_ustart)

    # parsed-batch cache tiers follow the BGZF block LRU
    # (bgzf._default_cache_blocks): small reference-like budgets by
    # default — the node-scaled large tiers measured strictly worse on
    # the WGS shape and at parity on deep exomes — with
    # MANTA_TPU_NODE_GB ≥ 64 opting back up
    try:
        from .bgzf import configured_node_gb
        _gb = configured_node_gb()
        _MEM_GB = 8.0 if _gb is None else _gb
    except (ValueError, OSError, AttributeError):
        _MEM_GB = 8.0
    # byte budgets, not entry counts: parsed-batch entry sizes scale
    # with sequencing depth, so a count cap lets deep data (FFPE,
    # high-depth panels) blow past any memory expectation while a byte
    # budget keeps the caller's peak bounded regardless of depth
    _FETCH_CACHE_BYTES = (1 << 30) if _MEM_GB >= 64 else (96 << 20)
    _COVER_CACHE_BYTES = (3 << 29) if _MEM_GB >= 64 else (128 << 20)
    # per-process defaults, rescaled by fork fan-out (see
    # set_worker_cache_budget); secondary entry caps bound the
    # containment scan on shallow data where byte budgets admit tens of
    # thousands of tiny entries
    _FETCH_CACHE_BYTES_BASE = _FETCH_CACHE_BYTES
    _COVER_CACHE_BYTES_BASE = _COVER_CACHE_BYTES
    _CACHE_MAX_ENTRIES = 4096
    _FETCH_COVER_PAD = 4096
    _FETCH_COVER_MAX_SPAN = 65536

    # parsed-batch caches are process-wide (keyed by file identity):
    # the pipeline opens many readers over the same alignment file
    # (assembly, pair scoring, split scoring, evidence output), and
    # their fetch patterns overlap heavily around each breakend.
    # Values are (batch, approx_bytes); *_SZ boxes hold running totals.
    # The cover cache keeps a (file, tid) bucket index so the
    # containment lookup walks only same-chromosome candidates.
    _FETCH_CACHE: dict = {}
    _FETCH_CACHE_SZ = [0]
    _COVER_CACHE: dict = {}
    _COVER_CACHE_SZ = [0]
    _COVER_BUCKETS: dict = {}

    @classmethod
    def set_worker_cache_budget(cls, n_workers: int):
        """Divide the parsed-batch cache budgets across forked workers
        (mirrors bgzf.set_worker_io_threads): the caches are per-process
        and every forked child inherits its own copy, so without this a
        wide fork fan-out multiplies the nominal budget by n_jobs."""
        n = max(1, int(n_workers))
        cls._FETCH_CACHE_BYTES = cls._FETCH_CACHE_BYTES_BASE // n
        cls._COVER_CACHE_BYTES = cls._COVER_CACHE_BYTES_BASE // n

    @staticmethod
    def _cache_put(cache, size_box, budget, key, batch):
        nbytes = batch.approx_bytes()
        if nbytes > budget:
            return  # a single over-budget batch would evict everything
        while cache and (size_box[0] + nbytes > budget or
                         len(cache) >= BamReader._CACHE_MAX_ENTRIES):
            k = next(iter(cache))  # oldest insertion
            size_box[0] -= cache.pop(k)[1]
            if cache is BamReader._COVER_CACHE:
                BamReader._COVER_BUCKETS.get(k[:2], {}).pop(k, None)
        cache[key] = (batch, nbytes)
        size_box[0] += nbytes
        if cache is BamReader._COVER_CACHE:
            BamReader._COVER_BUCKETS.setdefault(key[:2], {})[key] = None

    def fetch(self, ref: str | int, beg: int, end: int) -> ReadBatch:
        """All reads overlapping [beg, end) (0-based half-open).

        Recently fetched regions are cached: phase-2 edge processing
        re-fetches the same breakend neighborhoods for assembly, pair
        scoring, and split scoring. Returned batches are treated as
        immutable by all callers."""
        tid = ref if isinstance(ref, int) else self.header.name_to_tid[ref]
        cache = BamReader._FETCH_CACHE
        fk = self._bgzf._key
        key = (fk, tid, beg, end)
        hit = cache.get(key)
        if hit is not None:
            return hit[0]
        # covering-window cache: phase-2 edge processing issues many
        # slightly-different fetches around each breakend (assembly,
        # pair support, split support), so exact keys rarely repeat.
        # Parse one padded superwindow and derive exact requests from
        # it with the same overlap predicate parse_records applies
        # (pos < end and max(end_pos, pos+1) > beg), which yields a
        # bit-identical batch in file order.
        if end - beg > self._FETCH_COVER_MAX_SPAN:
            # large scans (phase-1 segments, depth estimation, stats
            # chunks) are one-shot: caching them would only pin memory
            return self._fetch_uncached(tid, beg, end)
        # all records have pos >= 0, so a negative beg is equivalent to
        # 0 for both the overlap predicate and window coverage
        cov_beg = max(0, beg)
        covers = BamReader._COVER_CACHE
        sup = None
        for (cfk, ctid, cbeg, cend) in \
                BamReader._COVER_BUCKETS.get((fk, tid), ()):
            if cbeg <= cov_beg and cend >= end:
                sup = covers[(cfk, ctid, cbeg, cend)][0]
                break
        if sup is None:
            # quantize cover bounds to a coarse grid: the per-edge fetch
            # families (assembly / pair / split windows) differ by a few
            # hundred bases, so unquantized covers miss for every
            # variant while quantized ones collapse to one superwindow
            q = self._FETCH_COVER_PAD
            cbeg = max(0, cov_beg - self._FETCH_COVER_PAD) // q * q
            cend = -(-(end + self._FETCH_COVER_PAD) // q) * q
            sup = self._fetch_uncached(tid, cbeg, cend)
            BamReader._cache_put(covers, BamReader._COVER_CACHE_SZ,
                                 self._COVER_CACHE_BYTES,
                                 (fk, tid, cbeg, cend), sup)
        end_pos = np.maximum(sup.end_pos, sup.pos + 1)
        keep = (sup.pos < end) & (end_pos > beg)
        out = sup if keep.all() else sup.subset(keep)
        # contiguous-run subsets come back as slice views pinning the
        # whole superwindow's blobs; cache an owned compact copy so the
        # byte accounting stays honest after the cover entry is evicted
        if out is not sup and out.seq.base is not None:
            out = out.compact_copy()
        BamReader._cache_put(cache, BamReader._FETCH_CACHE_SZ,
                             self._FETCH_CACHE_BYTES, key, out)
        return out

    def fetch_depth_cols(self, tid: int, beg: int, end: int):
        """(pos, flag, l_seq) int32/uint16/int32 columns of reads whose
        START position lies in [beg, end) — the depth estimator's
        chunked segment visits (core/chromdepth.py). Start-position
        windowing gives exact dedup across chunk boundaries, and the
        light native walk (mt_bam_depth_cols) skips every blob copy
        the full record parse pays for."""
        import ctypes
        from .._native import get_lib, i64p, i32p, u16p
        if self.index is None:
            b = self.fetch(tid, beg, end)
            keep = (b.pos >= beg) & (b.pos < end)
            lseq = (b.seq_off[1:] - b.seq_off[:-1]).astype(np.int32)
            return (b.pos[keep].astype(np.int32), b.flag[keep],
                    lseq[keep])
        chunks = self.index.query(tid, beg, end)
        bufs = [self._bgzf.read_range_arr(vs, ve) for vs, ve in chunks]
        bufs = [np.frombuffer(b, np.uint8) if not isinstance(b, np.ndarray)
                else b for b in bufs]
        bufs = [b for b in bufs if len(b) >= 4]
        nb = len(bufs)
        if nb == 0:
            return (np.zeros(0, np.int32), np.zeros(0, np.uint16),
                    np.zeros(0, np.int32))
        cap = sum(len(b) for b in bufs) // 36 + 1
        pos = np.empty(cap, np.int32)
        flag = np.empty(cap, np.uint16)
        lseq = np.empty(cap, np.int32)
        ptrs = (ctypes.c_void_p * nb)(*[b.ctypes.data for b in bufs])
        lens = np.array([len(b) for b in bufs], np.int64)
        lib = get_lib()
        n = lib.mt_bam_depth_cols(
            nb, ptrs, lens.ctypes.data_as(i64p), tid, beg, end,
            pos.ctypes.data_as(i32p), flag.ctypes.data_as(u16p),
            lseq.ctypes.data_as(i32p))
        return pos[:n].copy(), flag[:n].copy(), lseq[:n].copy()

    def _fetch_uncached(self, tid: int, beg: int, end: int) -> ReadBatch:
        if self.index is None:
            buf = self._bgzf.decompress_all()
            return parse_records(buf, self._records_ustart,
                                 want_overlap=(tid, beg, end))
        chunks = self.index.query(tid, beg, end)
        # chunk ranges from the index are merged/disjoint, so records
        # cannot repeat across chunks; one native pass parses + filters
        # them all into a single batch. Large spans (phase-0/1 scans,
        # same cutoff as the one-shot fetch-cache rule above) inflate
        # straight into one buffer (read_range_arr: no per-block
        # split/re-join, no LRU churn); small spans keep the block LRU
        # warm for phase 2's repeated breakend-neighborhood reads.
        rd = self._bgzf.read_range_arr \
            if end - beg > self._FETCH_COVER_MAX_SPAN \
            else self._bgzf.read_range
        return parse_records_multi(
            [rd(vs, ve) for vs, ve in chunks], (tid, beg, end))


def open_alignment_reader(path: str, reference=None):
    """Open a BAM or CRAM alignment file with a uniform reader interface
    (header / read_all / fetch), dispatching on the file magic.

    Reference analogue: bam_streamer's format-transparent open
    (reference: htsapi/bam_streamer.cpp — htslib dispatches BAM vs CRAM
    internally; CRAM additionally needs the reference FASTA).

    reference: path to the reference FASTA (or a FastaReader); required
    to decode CRAM sequences unless the file embeds its reference.
    """
    with open(path, "rb") as f:
        magic4 = f.read(4)
    if magic4 == b"CRAM":
        from .cram import CramReader
        ref = getattr(reference, "path", reference)
        return CramReader(path, reference=ref)
    return BamReader(path)
