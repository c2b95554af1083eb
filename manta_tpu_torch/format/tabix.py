"""Tabix (.tbi) index construction for bgzip-compressed VCF output.

The reference pipeline runs the bundled htslib tools
(reference: mantaWorkflow.py sortAllVcfs: `bgzip -c > out.vcf.gz` then
`tabix -f -p vcf out.vcf.gz`); here the same .vcf.gz + .tbi pair is
produced natively with the BGZF codec (io/bgzf.py). The .tbi layout
follows the tabix spec: R-tree binning identical to BAI plus a 16 kb
linear index, VCF preset (format=2, seq/beg columns 1/2, meta '#').
"""

from __future__ import annotations

import struct

from ..io.bgzf import BgzfWriter


def reg2bin(beg: int, end: int) -> int:
    """Smallest bin containing [beg, end), 0-based half-open."""
    end -= 1
    if beg >> 14 == end >> 14:
        return ((1 << 15) - 1) // 7 + (beg >> 14)
    if beg >> 17 == end >> 17:
        return ((1 << 12) - 1) // 7 + (beg >> 17)
    if beg >> 20 == end >> 20:
        return ((1 << 9) - 1) // 7 + (beg >> 20)
    if beg >> 23 == end >> 23:
        return ((1 << 6) - 1) // 7 + (beg >> 23)
    if beg >> 26 == end >> 26:
        return ((1 << 3) - 1) // 7 + (beg >> 26)
    return 0


def _vcf_record_span(line: str) -> tuple[str, int, int]:
    """(chrom, beg0, end0) half-open span of one VCF record, using END
    when present (htslib vcf preset end logic)."""
    w = line.split("\t", 8)
    chrom = w[0]
    pos = int(w[1])
    end = pos + len(w[3]) - 1
    info = w[7] if len(w) > 7 else ""
    for field in info.split(";"):
        if field.startswith("END="):
            try:
                end = int(field[4:])
            except ValueError:
                pass
            break
    return chrom, pos - 1, max(end, pos)


class TabixIndexer:
    """Accumulates (chrom, span, virtual-offset range) per record."""

    def __init__(self):
        self.names: list[str] = []
        self._name_idx: dict[str, int] = {}
        # per ref: {bin: [(vbeg, vend), ...]}, linear [(win, voff)]
        self._bins: list[dict[int, list[tuple[int, int]]]] = []
        self._linear: list[dict[int, int]] = []

    def add(self, chrom: str, beg: int, end: int, vbeg: int, vend: int):
        if chrom not in self._name_idx:
            self._name_idx[chrom] = len(self.names)
            self.names.append(chrom)
            self._bins.append({})
            self._linear.append({})
        ri = self._name_idx[chrom]
        b = reg2bin(beg, end)
        chunks = self._bins[ri].setdefault(b, [])
        # merge adjacent chunks
        if chunks and chunks[-1][1] == vbeg:
            chunks[-1] = (chunks[-1][0], vend)
        else:
            chunks.append((vbeg, vend))
        lin = self._linear[ri]
        for w in range(beg >> 14, ((max(end, beg + 1) - 1) >> 14) + 1):
            if w not in lin or vbeg < lin[w]:
                lin[w] = vbeg

    def write(self, path: str):
        payload = bytearray()
        payload += b"TBI\x01"
        payload += struct.pack("<8i", len(self.names), 2, 1, 2, 0,
                               ord("#"), 0,
                               sum(len(n) + 1 for n in self.names))
        for n in self.names:
            payload += n.encode() + b"\x00"
        for ri in range(len(self.names)):
            bins = self._bins[ri]
            payload += struct.pack("<i", len(bins))
            for b in sorted(bins):
                chunks = bins[b]
                payload += struct.pack("<Ii", b, len(chunks))
                for vbeg, vend in chunks:
                    payload += struct.pack("<QQ", vbeg, vend)
            lin = self._linear[ri]
            n_intv = (max(lin) + 1) if lin else 0
            payload += struct.pack("<i", n_intv)
            prev = 0
            for w in range(n_intv):
                if w in lin:
                    prev = lin[w]
                payload += struct.pack("<Q", prev)
        with open(path, "wb") as f:
            wr = BgzfWriter(f)
            wr.write(bytes(payload))
            wr.close()


class TabixReader:
    """Region queries over a tabix-indexed bgzip text file
    (reference: htsapi vcf/bed streamers over htslib tabix)."""

    def __init__(self, path: str):
        from ..io.bai import reg2bins
        from ..io.bgzf import BgzfReader
        self._reg2bins = reg2bins
        self._bgzf = BgzfReader(path)
        idx_path = path + ".tbi"
        raw = BgzfReader(idx_path).decompress_all()
        assert raw[:4] == b"TBI\x01", "not a tabix index"
        (n_ref, self.fmt, self.col_seq, self.col_beg, self.col_end,
         self.meta, self.skip, l_nm) = struct.unpack_from("<8i", raw, 4)
        off = 36
        names_blob = raw[off:off + l_nm]
        self.names = [n.decode() for n in names_blob.split(b"\x00") if n]
        off += l_nm
        self._bins = []
        self._linear = []
        for _ in range(n_ref):
            (n_bin,) = struct.unpack_from("<i", raw, off)
            off += 4
            bins = {}
            for _ in range(n_bin):
                b, n_chunk = struct.unpack_from("<Ii", raw, off)
                off += 8
                chunks = []
                for _ in range(n_chunk):
                    cb, ce = struct.unpack_from("<QQ", raw, off)
                    off += 16
                    chunks.append((cb, ce))
                bins[b] = chunks
            (n_intv,) = struct.unpack_from("<i", raw, off)
            off += 4
            lin = struct.unpack_from(f"<{n_intv}Q", raw, off)
            off += 8 * n_intv
            self._bins.append(bins)
            self._linear.append(lin)
        self._name_idx = {n: i for i, n in enumerate(self.names)}

    def fetch(self, chrom: str, beg: int, end: int) -> list[str]:
        """Record lines overlapping [beg, end) (0-based half-open)."""
        ri = self._name_idx.get(chrom)
        if ri is None:
            return []
        lin = self._linear[ri]
        min_off = lin[beg >> 14] if (beg >> 14) < len(lin) else 0
        chunks = []
        for b in self._reg2bins(beg, end):
            for cb, ce in self._bins[ri].get(b, []):
                if ce > min_off:
                    chunks.append((max(cb, min_off), ce))
        chunks.sort()
        out = []
        for cb, ce in chunks:
            data = self._bgzf.read_range(cb, ce)
            for line in data.decode().splitlines():
                if not line or line[0] == chr(self.meta):
                    continue
                c, rb, re_ = _vcf_record_span(line)
                if c == chrom and rb < end and re_ > beg:
                    out.append(line)
        # chunks may overlap; dedupe while preserving order
        seen = set()
        uniq = []
        for line in out:
            if line not in seen:
                seen.add(line)
                uniq.append(line)
        return uniq


def write_vcf_gz(lines: list[str], out_path: str, build_index: bool = True):
    """Write VCF lines as BGZF .vcf.gz and a .tbi index alongside."""
    indexer = TabixIndexer() if build_index else None
    with open(out_path, "wb") as f:
        wr = BgzfWriter(f)
        for line in lines:
            if not line.endswith("\n"):
                line += "\n"
            if indexer is not None and not line.startswith("#"):
                vbeg = wr.tell_virtual()
                wr.write(line.encode())
                vend = wr.tell_virtual()
                chrom, beg, end = _vcf_record_span(line)
                indexer.add(chrom, beg, end, vbeg, vend)
            else:
                wr.write(line.encode())
        wr.close()
    if indexer is not None:
        indexer.write(out_path + ".tbi")
