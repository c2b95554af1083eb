"""Sorted BAM output for the benchmark's generator: numpy and zlib only.

The same bytes as the port's in-memory ``io.bamwriter.BamWriter``: each
record encoded as the native encoder does (``mt_bam_encode``), a stable
sort by (reference, position) with unmapped records last, the stream cut
into BGZF blocks of 65,280 bytes and deflated at zlib level 6, and a BAI
index (R-tree bins with chunks, 16 kb linear index). Records are encoded
in bulk with ragged numpy gathers, and the blocks deflated on a thread
pool (zlib releases the interpreter lock), so a sample of ten million
reads takes seconds where a loop a record takes minutes.
"""

from __future__ import annotations

import concurrent.futures
import os
import struct
import zlib
from dataclasses import dataclass

import numpy as np

BLOCK = 0xFF00
LEVEL = 6
# records gathered into the stream at a time
_GATHER = 1 << 18
BGZF_EOF = bytes.fromhex(
    "1f8b08040000000000ff0600424302001b0003000000000000000000")
OP_CHARS = "MIDNSHP=X"
# 4-bit base codes: "=ACMGRSVTWYHKDBN"
_NIB = np.full(256, 15, np.uint8)
for _i, _b in enumerate(b"=ACMGRSVTWYHKDBN"):
    _NIB[_b] = _i
    _NIB[ord(chr(_b).lower())] = _i


@dataclass
class ReadBatch:
    """Struct-of-arrays batch of alignment records: fixed-width fields
    (n,), ragged payloads as CSR offsets (n + 1,) into flat blobs."""
    n: int
    refid: np.ndarray
    pos: np.ndarray
    mapq: np.ndarray
    flag: np.ndarray
    next_refid: np.ndarray
    next_pos: np.ndarray
    tlen: np.ndarray
    cigar_off: np.ndarray
    cigar: np.ndarray
    seq_off: np.ndarray
    seq: np.ndarray
    qual_off: np.ndarray
    qual: np.ndarray
    name_off: np.ndarray
    name: np.ndarray
    tag_off: np.ndarray
    tags: bytes


def string_to_arrays(s: str) -> tuple[np.ndarray, np.ndarray]:
    """CIGAR string -> (op codes, lengths) int32."""
    ops, lens = [], []
    num = 0
    for ch in s:
        if ch.isdigit():
            num = num * 10 + int(ch)
        else:
            ops.append(OP_CHARS.index(ch))
            lens.append(num)
            num = 0
    return np.array(ops, np.int32), np.array(lens, np.int32)


def reg2bin(beg: np.ndarray, end: np.ndarray) -> np.ndarray:
    """Smallest BAI bin holding [beg, end), vectorised."""
    beg = beg.astype(np.int64)
    end = end.astype(np.int64) - 1
    out = np.zeros(len(beg), np.int64)
    done = np.zeros(len(beg), bool)
    for shift, base in ((14, 4681), (17, 585), (20, 73), (23, 9), (26, 1)):
        hit = ~done & ((beg >> shift) == (end >> shift))
        out[hit] = base + (beg[hit] >> shift)
        done |= hit
    return out


def _ragged(lens: np.ndarray):
    """(row of each element, offset of each element within its row)."""
    lens = lens.astype(np.int64)
    total = int(lens.sum())
    row = np.repeat(np.arange(len(lens)), lens)
    start = np.zeros(len(lens), np.int64)
    np.cumsum(lens[:-1], out=start[1:])
    return row, np.arange(total, dtype=np.int64) - start[row]


def _rows(flat: np.ndarray, off: np.ndarray, rows: np.ndarray,
          width: int) -> np.ndarray:
    """(len(rows), width) array of flat[off[r]:off[r] + width]; a plain
    reshape where every row of the batch is ``width`` long."""
    n = len(off) - 1
    if width == 0:
        return np.zeros((len(rows), 0), flat.dtype)
    if off[0] == 0 and len(flat) == n * width and off[-1] == len(flat):
        return flat.reshape(n, width)[rows]
    return flat[off[rows][:, None] + np.arange(width)]


def encode(b: ReadBatch):
    """Every record of ``b`` as a length-prefixed BAM alignment block, as
    ``mt_bam_encode`` lays it out. Records of one shape (name, CIGAR,
    sequence and tag lengths) are built together as the rows of one
    array. Returns (buffers: one bytes object a shape, buffer of each
    record int64 (n,), its offset there (n,), its size (n,), its
    reference end (n,))."""
    n = b.n
    lname = np.diff(b.name_off)
    ncig = np.diff(b.cigar_off)
    lseq = np.diff(b.seq_off)
    ltag = np.diff(b.tag_off)
    size = 36 + lname + 1 + 4 * ncig + (lseq + 1) // 2 + lseq + ltag
    # reference span: M D N = X (ops 0, 2, 3, 7, 8)
    cig = b.cigar.astype(np.int64)
    ref_op = np.isin(cig & 0xF, (0, 2, 3, 7, 8))
    ref_len = np.bincount(np.repeat(np.arange(n), ncig),
                          weights=np.where(ref_op, cig >> 4, 0),
                          minlength=n).astype(np.int64)
    pos = b.pos.astype(np.int64)
    end = pos + np.maximum(ref_len, 1)
    head = np.zeros(n, np.dtype([
        ("bs", "<u4"), ("refid", "<i4"), ("pos", "<i4"), ("lname", "u1"),
        ("mapq", "u1"), ("bin", "<u2"), ("ncig", "<u2"), ("flag", "<u2"),
        ("lseq", "<i4"), ("nref", "<i4"), ("npos", "<i4"),
        ("tlen", "<i4")]))
    head["bs"] = size - 4
    head["refid"] = b.refid
    head["pos"] = b.pos
    head["lname"] = lname + 1
    head["mapq"] = b.mapq
    head["bin"] = reg2bin(pos, end)
    head["ncig"] = ncig
    head["flag"] = b.flag
    head["lseq"] = lseq
    head["nref"] = b.next_refid
    head["npos"] = b.next_pos
    head["tlen"] = b.tlen
    head = head.view(np.uint8).reshape(n, 36)
    cig_bytes = b.cigar.astype("<u4").view(np.uint8)
    tags = np.frombuffer(b.tags, np.uint8)
    # one key a shape; every length is under 2^16 in a BAM record
    key = (lname << 48) | (ncig << 32) | (lseq << 16) | ltag
    kinds, kind_of = np.unique(key, return_inverse=True)
    by_kind = np.argsort(kind_of, kind="stable")
    first = np.searchsorted(kind_of[by_kind], np.arange(len(kinds) + 1))
    bufs: list[bytes] = []
    offset = np.zeros(n, np.int64)
    for k, kk in enumerate(kinds.tolist()):
        ln, nc, ls, lt = (kk >> 48, (kk >> 32) & 0xFFFF, (kk >> 16) & 0xFFFF,
                          kk & 0xFFFF)
        rows = by_kind[first[k]:first[k + 1]]
        width = 36 + ln + 1 + 4 * nc + (ls + 1) // 2 + ls + lt
        rec = np.zeros((len(rows), width), np.uint8)
        rec[:, :36] = head[rows]
        at = 36
        rec[:, at:at + ln] = _rows(b.name, b.name_off, rows, ln)
        at += ln + 1                          # the name's NUL is a zero
        rec[:, at:at + 4 * nc] = _rows(cig_bytes, 4 * b.cigar_off, rows,
                                       4 * nc)
        at += 4 * nc
        # sequence: two bases a byte, high nibble first
        nib = _NIB[_rows(b.seq, b.seq_off, rows, ls)]
        if ls % 2:
            nib = np.concatenate(
                [nib, np.zeros((len(rows), 1), np.uint8)], axis=1)
        rec[:, at:at + (ls + 1) // 2] = (nib[:, 0::2] << 4) | nib[:, 1::2]
        at += (ls + 1) // 2
        rec[:, at:at + ls] = _rows(b.qual, b.qual_off, rows, ls)
        at += ls
        rec[:, at:at + lt] = _rows(tags, b.tag_off, rows, lt)
        bufs.append(rec.tobytes())
        offset[rows] = np.arange(len(rows), dtype=np.int64) * width
    return bufs, kind_of.reshape(-1).astype(np.int64), offset, size, end


def _deflate(payload: bytes) -> bytes:
    co = zlib.compressobj(LEVEL, zlib.DEFLATED, -15)
    comp = co.compress(payload) + co.flush()
    hdr = (b"\x1f\x8b\x08\x04" + b"\x00" * 5 + b"\xff" + struct.pack("<H", 6)
           + b"BC" + struct.pack("<HH", 2, len(comp) + 25))
    return hdr + comp + struct.pack("<II", zlib.crc32(payload) & 0xFFFFFFFF,
                                    len(payload))


class BamWriter:
    """Banks whole batches; ``close()`` encodes, sorts, writes the BAM
    and its ``.bai``."""

    def __init__(self, path: str, header_text: str, ref_names: list[str],
                 ref_lengths: list[int]):
        self.path = path
        self.header_text = header_text
        self.ref_names = ref_names
        self.ref_lengths = ref_lengths
        self.n_reads = 0
        self._batches: list[ReadBatch] = []

    def add_batch(self, batch: ReadBatch) -> None:
        self._batches.append(batch)
        self.n_reads += batch.n

    def _header(self) -> bytes:
        text = self.header_text.encode()
        parts = [b"BAM\x01", struct.pack("<i", len(text)), text,
                 struct.pack("<i", len(self.ref_names))]
        for name, length in zip(self.ref_names, self.ref_lengths):
            nb = name.encode() + b"\x00"
            parts += [struct.pack("<i", len(nb)), nb,
                      struct.pack("<i", length)]
        return b"".join(parts)

    def close(self, log=None) -> None:
        """Encode, sort, write; ``log`` gets a line at each stage."""
        log = log or (lambda msg: None)
        bufs, kinds, offs, sizes, tids, poss, ends = [], [], [], [], [], [], []
        for b in self._batches:
            buf, kind, off, size, end = encode(b)
            kinds.append(kind + len(bufs))
            bufs += buf
            offs.append(off)
            sizes.append(size)
            ends.append(end)
            tids.append(b.refid.astype(np.int64))
            poss.append(b.pos.astype(np.int64))
        self._batches = []
        log("records encoded")

        def cat(parts):
            return np.concatenate(parts) if parts else np.zeros(0, np.int64)

        tid, pos, end, size = cat(tids), cat(poss), cat(ends), cat(sizes)
        kind, off = cat(kinds), cat(offs)
        # unmapped (tid < 0) records sort last; ties keep the add order
        order = np.lexsort((pos, np.where(tid < 0, 1 << 30, tid)))
        head = self._header()
        at = np.zeros(len(order) + 1, np.int64)
        np.cumsum(size[order], out=at[1:])
        at += len(head)
        # the sorted stream in BGZF blocks of BLOCK bytes, the last one
        # shorter: blocks are deflated on the pool while the next records
        # are gathered
        kind_s, off_s, size_s = kind[order], off[order], size[order]
        pending = bytearray(head)
        with concurrent.futures.ThreadPoolExecutor(
                max_workers=os.cpu_count() or 2) as pool:
            futures = []
            for lo in range(0, len(order), _GATHER):
                pending += b"".join([
                    bufs[k][o:o + z] for k, o, z in zip(
                        kind_s[lo:lo + _GATHER].tolist(),
                        off_s[lo:lo + _GATHER].tolist(),
                        size_s[lo:lo + _GATHER].tolist())])
                full = len(pending) - len(pending) % BLOCK
                futures += [pool.submit(_deflate, bytes(pending[c:c + BLOCK]))
                            for c in range(0, full, BLOCK)]
                del pending[:full]
            if pending:
                futures.append(pool.submit(_deflate, bytes(pending)))
            log(f"stream gathered, {len(futures)} BGZF blocks")
            blocks = [f.result() for f in futures]
        del bufs
        log("blocks deflated")
        coff = np.zeros(len(blocks) + 1, np.int64)
        np.cumsum([len(x) for x in blocks], out=coff[1:])
        with open(self.path, "wb") as f:
            for x in blocks:
                f.write(x)
            f.write(BGZF_EOF)
        vbeg = (coff[at[:-1] // BLOCK] << 16) | (at[:-1] % BLOCK)
        vend = (coff[at[1:] // BLOCK] << 16) | (at[1:] % BLOCK)
        self._write_bai(tid[order], pos[order], end[order], vbeg, vend)

    def _write_bai(self, tid, pos, end, vbeg, vend) -> None:
        keep = tid >= 0
        tid, pos, end = tid[keep], pos[keep], end[keep]
        vbeg, vend = vbeg[keep], vend[keep]
        bins = reg2bin(pos, end)
        out = bytearray(b"BAI\x01")
        out += struct.pack("<i", len(self.ref_names))
        for t in range(len(self.ref_names)):
            m = tid == t
            b, vb, ve = bins[m], vbeg[m], vend[m]
            p, e = pos[m], end[m]
            # a chunk is a run of consecutive records of one bin
            new = np.ones(len(b), bool)
            new[1:] = b[1:] != b[:-1]
            starts = np.flatnonzero(new)
            stops = np.append(starts[1:], len(b)) - 1
            run_bin = b[starts]
            by_bin = np.argsort(run_bin, kind="stable")
            uniq, first, count = np.unique(run_bin[by_bin], return_index=True,
                                           return_counts=True)
            out += struct.pack("<i", len(uniq))
            for k, bn in enumerate(uniq.tolist()):
                runs = by_bin[first[k]:first[k] + count[k]]
                out += struct.pack("<Ii", bn, len(runs))
                out += np.stack([vb[starts[runs]], ve[stops[runs]]],
                                axis=1).astype("<u8").tobytes()
            # linear index: the first record (least offset) touching each
            # 16 kb window, carried forward over empty windows
            w0, w1 = p >> 14, (e - 1) >> 14
            row, j = _ragged(w1 - w0 + 1)
            win = w0[row] + j
            n_intv = int(win.max()) + 1 if len(win) else 0
            lin = np.full(n_intv, -1, np.int64)
            # records come in offset order: a window's first is its least
            uniq_win, first_at = np.unique(win, return_index=True)
            lin[uniq_win] = vb[row[first_at]]
            if n_intv:
                filled = np.maximum.accumulate(
                    np.where(lin >= 0, np.arange(n_intv), -1))
                lin = np.where(filled >= 0, lin[np.maximum(filled, 0)], 0)
            out += struct.pack("<i", n_intv)
            out += lin.astype("<u8").tobytes()
        with open(self.path + ".bai", "wb") as f:
            f.write(bytes(out))
