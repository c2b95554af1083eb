"""BAM output: record encoding, sorted writing, BAI indexing.

Native replacement for the reference's evidence-BAM output stack
(reference: htsapi/bam_dumper.hpp + SynchronizedBamWriter.hpp for
writing, redist samtools sort/merge/index tasks in mantaWorkflow.py:331-346
and :441-460 for sort/merge/index). Records are buffered as
struct-of-arrays (batch, row-index) references, batch-encoded to raw
alignment blocks by the native core at close (mt_bam_encode,
native/manta_core.cpp), position-sorted, and indexed with the same
R-tree binning used by the tabix writer (format/tabix.py).
"""

from __future__ import annotations

import os
import struct

import numpy as np

from .bgzf import BgzfWriter

# 4-bit base codes: "=ACMGRSVTWYHKDBN"
_NIB = np.full(256, 15, np.uint8)
for _i, _b in enumerate(b"=ACMGRSVTWYHKDBN"):
    _NIB[_b] = _i
    _NIB[ord(chr(_b).lower())] = _i


def reg2bin(beg: int, end: int) -> int:
    from ..format.tabix import reg2bin as _r
    return _r(beg, end)


def reg2bin_csi(beg: int, end: int, min_shift: int, depth: int) -> int:
    from .bai import reg2bin_csi as _r
    return _r(beg, end, min_shift, depth)


def encode_record(batch, i: int, extra_tags: bytes = b"") -> bytes:
    """Encode one ReadBatch row as a raw BAM alignment block (without
    the leading block_size). Pure-Python reference implementation; the
    production path is the native batch encoder (_encode_group)."""
    name = batch.name[batch.name_off[i]:batch.name_off[i + 1]].tobytes()
    cigar = batch.cigar[batch.cigar_off[i]:batch.cigar_off[i + 1]]
    seq = batch.seq[batch.seq_off[i]:batch.seq_off[i + 1]]
    qual = batch.qual[batch.qual_off[i]:batch.qual_off[i + 1]]
    tags = batch.tags[batch.tag_off[i]:batch.tag_off[i + 1]]

    l_seq = len(seq)
    pos = int(batch.pos[i])
    # reference span from cigar for the index bin
    ref_len = 0
    for c in cigar.tolist():
        op = c & 0xF
        if op in (0, 2, 3, 7, 8):  # M D N = X
            ref_len += c >> 4
    end = pos + max(ref_len, 1)

    nib = _NIB[seq]
    packed = np.zeros((l_seq + 1) // 2, np.uint8)
    packed |= nib[0::2] << 4
    if l_seq > 1:
        packed[:l_seq // 2] |= nib[1::2]

    head = struct.pack(
        "<iiBBHHHiiii",
        int(batch.refid[i]), pos,
        len(name) + 1, int(batch.mapq[i]), reg2bin(pos, end),
        len(cigar), int(batch.flag[i]), l_seq,
        int(batch.next_refid[i]), int(batch.next_pos[i]),
        int(batch.tlen[i]))
    return (head + name + b"\x00" + cigar.astype("<u4").tobytes() +
            packed.tobytes() + qual.tobytes() + tags + extra_tags)


def _encode_group(batch, idx_list, extras):
    """Batch-encode rows `idx_list` of `batch` (with per-row extra tag
    blobs) into one contiguous buffer of length-prefixed alignment
    blocks via the native core. Returns (blob u8[], out_off i64[n+1],
    end i32[n])."""
    import ctypes
    from .._native import get_lib, i32p, i64p, u8p, u16p, u32p
    lib = get_lib()
    n = len(idx_list)
    idx = np.asarray(idx_list, np.int64)
    lname = batch.name_off[idx + 1] - batch.name_off[idx]
    ncig = batch.cigar_off[idx + 1] - batch.cigar_off[idx]
    lseq = batch.seq_off[idx + 1] - batch.seq_off[idx]
    ltag = batch.tag_off[idx + 1] - batch.tag_off[idx]
    extra_off = np.zeros(n + 1, np.int64)
    np.cumsum([len(e) for e in extras], out=extra_off[1:])
    extra = np.frombuffer(b"".join(extras), np.uint8)
    sizes = (4 + 32 + lname + 1 + 4 * ncig + (lseq + 1) // 2 + lseq +
             ltag + (extra_off[1:] - extra_off[:-1]))
    out_off = np.zeros(n + 1, np.int64)
    np.cumsum(sizes, out=out_off[1:])
    out = np.empty(int(out_off[-1]), np.uint8)
    out_end = np.empty(n, np.int32)
    tags = np.frombuffer(batch.tags, np.uint8)

    def p(a, t):
        return a.ctypes.data_as(t)

    rc = lib.mt_bam_encode(
        n, p(idx, i64p),
        p(batch.refid, i32p), p(batch.pos, i32p), p(batch.mapq, u8p),
        p(batch.flag, u16p), p(batch.next_refid, i32p),
        p(batch.next_pos, i32p), p(batch.tlen, i32p),
        p(batch.name_off, i64p), p(batch.name, u8p),
        p(batch.cigar_off, i64p), p(batch.cigar, u32p),
        p(batch.seq_off, i64p), p(batch.seq, u8p),
        p(batch.qual_off, i64p), p(batch.qual, u8p),
        p(batch.tag_off, i64p), p(tags, u8p),
        p(extra_off, i64p), p(extra, u8p),
        p(out_off, i64p), p(out, u8p), p(out_end, i32p))
    assert rc == 0, "mt_bam_encode failed"
    return out, out_off, out_end


class BamWriter:
    """Buffered, sorted BAM writer with BAI index output.

    add_record() only banks a (batch, row) reference; encoding happens
    in one native pass per source batch at close()."""

    def __init__(self, path: str, header_text: str, ref_names: list[str],
                 ref_lengths: list[int], index: str = "bai",
                 csi_min_shift: int = 14, csi_depth: int = 5):
        self.path = path
        self.header_text = header_text
        self.ref_names = ref_names
        self.ref_lengths = ref_lengths
        # index flavor: "bai" (default) or "csi" (CSI v1 with the given
        # min_shift/depth — required for chromosomes >512 Mb, matching
        # the reference's .bai/.csi acceptance, bam_streamer.cpp:131)
        self.index = index
        self.csi_min_shift = csi_min_shift
        self.csi_depth = csi_depth
        # groups of consecutive adds from the same source batch:
        # [batch, [row indices], [extra tag blobs]]
        self._groups: list[list] = []

    def add_record(self, batch, i: int, extra_tags: bytes = b""):
        g = self._groups
        if not g or g[-1][0] is not batch:
            g.append([batch, [], []])
        g[-1][1].append(i)
        g[-1][2].append(extra_tags)

    def close(self):
        # encode every group natively, then globally position-sort
        blobs = []
        tid_all, pos_all, end_all, gid_all, off0_all, off1_all = \
            [], [], [], [], [], []
        for gi, (batch, idx_list, extras) in enumerate(self._groups):
            blob, out_off, out_end = _encode_group(batch, idx_list, extras)
            blobs.append(memoryview(blob))
            idx = np.asarray(idx_list, np.int64)
            tid_all.append(batch.refid[idx].astype(np.int64))
            pos_all.append(batch.pos[idx].astype(np.int64))
            end_all.append(out_end.astype(np.int64))
            gid_all.append(np.full(len(idx), gi, np.int64))
            off0_all.append(out_off[:-1])
            off1_all.append(out_off[1:])
        self._groups = []
        if blobs:
            tid = np.concatenate(tid_all)
            pos = np.concatenate(pos_all)
            end = np.concatenate(end_all)
            gid = np.concatenate(gid_all)
            off0 = np.concatenate(off0_all)
            off1 = np.concatenate(off1_all)
            # unmapped (tid<0) records sort last, as in samtools sort
            order = np.lexsort((pos, np.where(tid < 0, 1 << 30, tid)))
        else:
            order = np.empty(0, np.int64)
        # bins per ref for the BAI
        bins: dict[int, dict[int, list[tuple[int, int]]]] = {}
        linear: dict[int, dict[int, int]] = {}
        with open(self.path, "wb") as f:
            wr = BgzfWriter(f)
            text = self.header_text.encode()
            wr.write(b"BAM\x01" + struct.pack("<i", len(text)) + text)
            wr.write(struct.pack("<i", len(self.ref_names)))
            for name, length in zip(self.ref_names, self.ref_lengths):
                nb = name.encode() + b"\x00"
                wr.write(struct.pack("<i", len(nb)) + nb +
                         struct.pack("<i", length))
            for r in order.tolist():
                vbeg = wr.tell_virtual()
                wr.write(blobs[gid[r]][off0[r]:off1[r]])
                vend = wr.tell_virtual()
                t = int(tid[r])
                if t < 0:
                    continue
                p, e = int(pos[r]), int(end[r])
                if self.index == "csi":
                    bin_ = reg2bin_csi(p, e, self.csi_min_shift,
                                       self.csi_depth)
                else:
                    bin_ = reg2bin(p, e)
                rbins = bins.setdefault(t, {})
                chunks = rbins.setdefault(bin_, [])
                if chunks and chunks[-1][1] == vbeg:
                    chunks[-1] = (chunks[-1][0], vend)
                else:
                    chunks.append((vbeg, vend))
                if self.index != "csi":
                    lin = linear.setdefault(t, {})
                    for w in range(p >> 14, ((e - 1) >> 14) + 1):
                        if w not in lin or vbeg < lin[w]:
                            lin[w] = vbeg
            wr.close()
        if self.index == "csi":
            self._write_csi(bins)
        else:
            self._write_bai(bins, linear)

    def _write_bai(self, bins, linear):
        out = bytearray(b"BAI\x01")
        out += struct.pack("<i", len(self.ref_names))
        for tid in range(len(self.ref_names)):
            rbins = bins.get(tid, {})
            out += struct.pack("<i", len(rbins))
            for b in sorted(rbins):
                chunks = rbins[b]
                out += struct.pack("<Ii", b, len(chunks))
                for vb, ve in chunks:
                    out += struct.pack("<QQ", vb, ve)
            lin = linear.get(tid, {})
            n_intv = (max(lin) + 1) if lin else 0
            out += struct.pack("<i", n_intv)
            prev = 0
            for w in range(n_intv):
                if w in lin:
                    prev = lin[w]
                out += struct.pack("<Q", prev)
        with open(self.path + ".bai", "wb") as f:
            f.write(bytes(out))

    def _write_csi(self, bins):
        """CSI v1 index: R-tree bins with per-bin loffset floors in a
        BGZF container (replaces the 16 kb linear index). Records are
        written position-sorted, so a bin's earliest chunk start is its
        loffset."""
        out = bytearray(b"CSI\x01")
        out += struct.pack("<iii", self.csi_min_shift, self.csi_depth, 0)
        out += struct.pack("<i", len(self.ref_names))
        for tid in range(len(self.ref_names)):
            rbins = bins.get(tid, {})
            out += struct.pack("<i", len(rbins))
            for b in sorted(rbins):
                chunks = rbins[b]
                loffset = min(vb for vb, _ in chunks)
                out += struct.pack("<IQi", b, loffset, len(chunks))
                for vb, ve in chunks:
                    out += struct.pack("<QQ", vb, ve)
        with open(self.path + ".csi", "wb") as f:
            wr = BgzfWriter(f)
            wr.write(bytes(out))
            wr.close()


# ---------------------------------------------------------------------------
# External-merge sorted BAM output at WGS scale.
#
# BamWriter banks every record in memory until close(), which is right
# for evidence BAMs (small) but caps a whole-genome writer at node RAM.
# The external path spills position-sorted runs (raw length-prefixed
# record streams + sidecar sort columns) and merges them with fully
# vectorized machinery: one global lexsort over the sidecars, native
# ragged gathers from mmapped runs, threaded native BGZF deflation
# (mt_bgzf_deflate_batch) with deterministic 65280-byte blocking so
# every record's virtual offset — and from it the whole BAI — is
# computed as array math instead of a per-record Python loop.
# (reference analogue: samtools sort's temp-file merge as orchestrated
# by mantaWorkflow.py:331-346; redesigned columnar here.)

_BGZF_PAYLOAD = 0xFF00


def reg2bin_vec(beg: np.ndarray, end: np.ndarray) -> np.ndarray:
    """Vectorized UCSC R-tree bin (same math as format/tabix.reg2bin)."""
    e = end - 1
    out = np.zeros(len(beg), np.int64)
    done = np.zeros(len(beg), bool)
    for shift, offset in ((14, 4681), (17, 585), (20, 73), (23, 9),
                          (26, 1)):
        m = ~done & ((beg >> shift) == (e >> shift))
        out[m] = offset + (beg[m] >> shift)
        done |= m
    return out


class _BgzfBlockStream:
    """Feeds bytes through fixed 65280-byte blocks compressed in
    threaded native batches; records every block's compressed size so
    virtual offsets are array math."""

    def __init__(self, f, level: int = 2, n_threads: int = 2,
                 flush_blocks: int = 512):
        self._f = f
        self._level = level
        self._nt = n_threads
        self._flush = flush_blocks * _BGZF_PAYLOAD
        self._pend: list[np.ndarray] = []
        self._pend_n = 0
        self.comp_sizes: list[np.ndarray] = []

    def write(self, data):
        a = np.frombuffer(data, np.uint8) if not isinstance(
            data, np.ndarray) else data
        self._pend.append(a)
        self._pend_n += len(a)
        if self._pend_n >= self._flush:
            self._drain(final=False)

    def _drain(self, final: bool):
        import ctypes
        from .._native import get_lib, i32p, i64p, u8p
        buf = self._pend[0] if len(self._pend) == 1 else \
            np.concatenate(self._pend)
        n_full = len(buf) // _BGZF_PAYLOAD
        take = len(buf) if final else n_full * _BGZF_PAYLOAD
        if not final:
            rest = buf[take:]
            self._pend = [rest] if len(rest) else []
            self._pend_n = len(rest)
        else:
            self._pend, self._pend_n = [], 0
        if take == 0:
            return
        chunk = np.ascontiguousarray(buf[:take])
        nb = -(-take // _BGZF_PAYLOAD)
        off = np.minimum(
            np.arange(nb + 1, dtype=np.int64) * _BGZF_PAYLOAD, take)
        stride = _BGZF_PAYLOAD + 1024
        out = np.empty(nb * stride, np.uint8)
        sizes = np.zeros(nb, np.int32)
        lib = get_lib()
        rc = lib.mt_bgzf_deflate_batch(
            nb, chunk.ctypes.data_as(u8p), off.ctypes.data_as(i64p),
            self._level, out.ctypes.data_as(u8p), stride,
            sizes.ctypes.data_as(i32p), self._nt)
        assert rc == 0, f"mt_bgzf_deflate_batch failed: {rc}"
        # compact: blocks are at fixed stride with variable sizes
        dst = np.zeros(nb + 1, np.int64)
        np.cumsum(sizes, out=dst[1:])
        packed = np.empty(int(dst[-1]), np.uint8)
        src_off = np.arange(nb, dtype=np.int64) * stride
        for k in range(nb):
            packed[dst[k]:dst[k + 1]] = out[src_off[k]:src_off[k]
                                            + sizes[k]]
        packed.tofile(self._f)
        self.comp_sizes.append(sizes)

    def close(self):
        from .bgzf import BGZF_EOF
        self._drain(final=True)
        self._f.write(BGZF_EOF)
        self._f.flush()

    def block_offsets(self) -> np.ndarray:
        """File offset of each 65280-payload block (int64, n_blocks+1)."""
        if self.comp_sizes:
            sizes = np.concatenate(self.comp_sizes).astype(np.int64)
        else:
            sizes = np.zeros(0, np.int64)
        out = np.zeros(len(sizes) + 1, np.int64)
        np.cumsum(sizes, out=out[1:])
        return out


def spill_run(writer: BamWriter, run_prefix: str) -> int:
    """Encode + position-sort the records banked in `writer` and write
    them as an external run: `<prefix>.bin` (raw length-prefixed
    alignment blocks in sorted order) + `<prefix>.npz` sidecar columns
    (tid/pos/end int32, record offsets int64). Frees the writer's
    banked groups. Returns the record count."""
    blobs, tid_a, pos_a, end_a, gid_a, off0_a, off1_a, lidx_a = \
        [], [], [], [], [], [], [], []
    for gi, (batch, idx_list, extras) in enumerate(writer._groups):
        blob, out_off, out_end = _encode_group(batch, idx_list, extras)
        blobs.append(blob)
        idx = np.asarray(idx_list, np.int64)
        tid_a.append(batch.refid[idx].astype(np.int64))
        pos_a.append(batch.pos[idx].astype(np.int64))
        end_a.append(out_end.astype(np.int64))
        gid_a.append(np.full(len(idx), gi, np.int64))
        off0_a.append(out_off[:-1])
        off1_a.append(out_off[1:])
        lidx_a.append(np.arange(len(idx), dtype=np.int64))
    writer._groups = []
    if not blobs:
        np.savez(run_prefix + ".npz",
                 tid=np.zeros(0, np.int32), pos=np.zeros(0, np.int32),
                 end=np.zeros(0, np.int32), off=np.zeros(1, np.int64))
        open(run_prefix + ".bin", "wb").close()
        return 0
    tid = np.concatenate(tid_a)
    pos = np.concatenate(pos_a)
    end = np.concatenate(end_a)
    gid = np.concatenate(gid_a)
    off0 = np.concatenate(off0_a)
    off1 = np.concatenate(off1_a)
    lidx = np.concatenate(lidx_a)
    order = np.lexsort((pos, np.where(tid < 0, 1 << 30, tid)))
    rec_len = (off1 - off0)[order]
    dst = np.zeros(len(order) + 1, np.int64)
    np.cumsum(rec_len, out=dst[1:])
    out = np.empty(int(dst[-1]), np.uint8)

    import ctypes
    from .._native import get_lib, i64p, u8p
    lib = get_lib()
    g_sorted = gid[order]
    l_sorted = lidx[order]
    for gi, blob in enumerate(blobs):
        sel = np.flatnonzero(g_sorted == gi)
        if not len(sel):
            continue
        # group-local ragged offsets for the gather (records within a
        # group blob are contiguous, so off0/off1 reassemble cumsum)
        gm = gid == gi
        n_g = int(gm.sum())
        goff = np.zeros(n_g + 1, np.int64)
        goff[:-1] = off0[gm]
        goff[-1] = off1[gm][-1]
        rc = lib.mt_gather_ragged(
            len(sel), np.ascontiguousarray(
                l_sorted[sel]).ctypes.data_as(i64p),
            goff.ctypes.data_as(i64p), blob.ctypes.data_as(u8p), 1,
            np.ascontiguousarray(dst[sel]).ctypes.data_as(i64p),
            out.ctypes.data_as(u8p))
        assert rc == 0
    # runs are BGZF-compressed (fast level-1): at WGS scale raw runs
    # would need ~the uncompressed BAM's footprint in scratch disk.
    # Sorted runs + sorted merge order mean every merge chunk touches
    # a CONTIGUOUS record range per run, so block-range inflation is
    # sequential.
    with open(run_prefix + ".bin", "wb") as f:
        st = _BgzfBlockStream(f, level=1, n_threads=os.cpu_count() or 2)
        st.write(out)
        st.close()
        zoff = st.block_offsets()
    np.savez(run_prefix + ".npz",
             tid=tid[order].astype(np.int32),
             pos=pos[order].astype(np.int32),
             end=end[order].astype(np.int32), off=dst, zoff=zoff)
    return len(order)


def merge_runs_to_bam(run_prefixes: list[str], path: str,
                      header_text: str, ref_names: list[str],
                      ref_lengths: list[int], level: int = 2,
                      n_threads: int = 2,
                      chunk_records: int = 2_000_000):
    """K-way merge of spilled runs into one sorted, BAI-indexed BAM.

    All per-record work is array math: a global lexsort over the runs'
    sidecar columns orders the output; native ragged gathers pull
    record bytes from mmapped runs in merged order; the deterministic
    block stream yields every record's virtual offset vectorially, from
    which the BAI bins / linear index are built by run-length grouping."""
    # Load sidecars with tight dtypes and free aggressively: at 840 M
    # records every full-length int64 column is 6.7 GB, and a merge that
    # holds many of them at once runs out of memory. int32 columns +
    # uint8 run ids + on-demand virtual offsets keep the peak to a few
    # such columns.
    sides = []
    for p in run_prefixes:
        z = np.load(p + ".npz")
        # off/zoff stay per-run (the chunk loop slices them); the
        # int32 position columns concatenate below and are then freed
        sides.append({k: z[k] for k in ("tid", "pos", "end", "off",
                                        "zoff")})
    mms = [np.memmap(p + ".bin", dtype=np.uint8, mode="r")
           if os.path.getsize(p + ".bin") else np.zeros(0, np.uint8)
           for p in run_prefixes]
    tid = np.concatenate([s["tid"] for s in sides])          # int32
    pos = np.concatenate([s["pos"] for s in sides])          # int32
    end = np.concatenate([s["end"] for s in sides])          # int32
    rid_dt = np.uint8 if len(sides) <= 255 else np.uint16
    run_id = np.concatenate([np.full(len(s["tid"]), ri, rid_dt)
                             for ri, s in enumerate(sides)])
    lidx = np.concatenate([np.arange(len(s["tid"]), dtype=np.int32)
                           for s in sides])
    rec_len = np.concatenate(
        [np.diff(s["off"]).astype(np.int32) for s in sides])
    for s in sides:
        del s["tid"], s["pos"], s["end"]
    # unmapped (tid = -1) sorts last under an unsigned view of the key
    order = np.lexsort((pos, tid.view(np.uint32)))
    n = len(order)

    import ctypes
    from .._native import get_lib, i64p, u8p
    lib = get_lib()

    with open(path, "wb") as f:
        st = _BgzfBlockStream(f, level=level, n_threads=n_threads)
        text = header_text.encode()
        head = bytearray(b"BAM\x01" + struct.pack("<i", len(text)) + text)
        head += struct.pack("<i", len(ref_names))
        for nm, ln in zip(ref_names, ref_lengths):
            nb = nm.encode() + b"\x00"
            head += struct.pack("<i", len(nb)) + nb + struct.pack("<i", ln)
        st.write(bytes(head))
        hlen = len(head)

        # uncompressed stream offset of every record, in merged order
        u = np.zeros(n + 1, np.int64)
        np.cumsum(rec_len[order], out=u[1:])
        u += hlen
        del rec_len

        from .._native import i32p
        for c0 in range(0, n, chunk_records):
            sel = order[c0:min(n, c0 + chunk_records)]
            # merged-order record lengths come straight from u
            dst = u[c0:c0 + len(sel) + 1] - int(u[c0])
            buf = np.empty(int(dst[-1]), np.uint8)
            rids = run_id[sel]
            for ri in range(len(run_prefixes)):
                m = np.flatnonzero(rids == ri)
                if not len(m):
                    continue
                # the run-local record range this chunk needs is
                # contiguous (stable sort over sorted runs): inflate
                # just its covering BGZF block range, sequentially
                loc = lidx[sel[m]]
                lo, hi = int(loc[0]), int(loc[-1])
                off = sides[ri]["off"]
                zoff = sides[ri]["zoff"].astype(np.int64)
                u0, u1 = int(off[lo]), int(off[hi + 1])
                kb0 = u0 // _BGZF_PAYLOAD
                kb1 = (u1 - 1) // _BGZF_PAYLOAD + 1
                nblk = kb1 - kb0
                total_u = int(off[-1])
                usz = np.full(nblk, _BGZF_PAYLOAD, np.int64)
                if kb1 * _BGZF_PAYLOAD > total_u:
                    usz[-1] = total_u - (kb1 - 1) * _BGZF_PAYLOAD
                uoff = np.zeros(nblk + 1, np.int64)
                np.cumsum(usz, out=uoff[1:])
                raw = np.empty(int(uoff[-1]), np.uint8)
                comp_off = zoff[kb0:kb1] + 18
                comp_len = (np.diff(zoff[kb0:kb1 + 1]) - 26).astype(
                    np.int32)
                rc = lib.mt_bgzf_inflate_batch(
                    nblk, mms[ri].ctypes.data_as(u8p),
                    np.ascontiguousarray(comp_off).ctypes.data_as(i64p),
                    np.ascontiguousarray(comp_len).ctypes.data_as(i32p),
                    raw.ctypes.data_as(u8p),
                    uoff.ctypes.data_as(i64p), n_threads)
                assert rc == 0, f"run inflate failed: {rc}"
                base = kb0 * _BGZF_PAYLOAD
                rc = lib.mt_gather_ragged(
                    len(m),
                    (loc - lo).astype(np.int64).ctypes.data_as(i64p),
                    np.ascontiguousarray(
                        off[lo:hi + 2] - base).ctypes.data_as(i64p),
                    raw.ctypes.data_as(u8p), 1,
                    np.ascontiguousarray(dst[m]).ctypes.data_as(i64p),
                    buf.ctypes.data_as(u8p))
                assert rc == 0
            st.write(buf)
        st.close()
        boff = st.block_offsets()

    tid_s = tid[order]
    pos_s = pos[order]
    end_s = end[order]
    del tid, pos, end, run_id, lidx, order

    def voff_at(idx):
        """Virtual offsets for record-boundary indices into u (chunked
        callers pass small index sets; full-array temps at 840 M
        records are 6.7 GB each)."""
        ui = u[idx]
        return (boff[ui // _BGZF_PAYLOAD] << 16) | (ui % _BGZF_PAYLOAD)

    # full vbeg is needed once for the linear index minimum-scatter;
    # build it chunked to avoid the // and % int64 temps
    vbeg = np.empty(n, np.int64)
    for c0 in range(0, n, 50_000_000):
        c1 = min(n, c0 + 50_000_000)
        ui = u[c0:c1]
        vbeg[c0:c1] = (boff[ui // _BGZF_PAYLOAD] << 16) | \
            (ui % _BGZF_PAYLOAD)
    mapped = tid_s >= 0
    bins_arr = np.zeros(n, np.int32)
    bins_arr[mapped] = reg2bin_vec(pos_s[mapped],
                                   end_s[mapped]).astype(np.int32)

    # chunk runs: consecutive mapped records sharing (tid, bin)
    bins: dict[int, dict[int, list[tuple[int, int]]]] = {}
    linear: dict[int, dict[int, int]] = {}
    if mapped.any():
        mi = np.flatnonzero(mapped)
        t_m, b_m = tid_s[mi], bins_arr[mi]
        brk = np.flatnonzero((t_m[1:] != t_m[:-1])
                             | (b_m[1:] != b_m[:-1])) + 1
        starts = np.concatenate(([0], brk))
        ends = np.concatenate((brk, [len(mi)]))
        vend_ends = voff_at(mi[ends - 1] + 1)
        for gi_, (s0, s1) in enumerate(zip(starts.tolist(),
                                           ends.tolist())):
            t = int(t_m[s0])
            bins.setdefault(t, {}).setdefault(int(b_m[s0]), []).append(
                (int(vbeg[mi[s0]]), int(vend_ends[gi_])))
        # linear 16kb index: min vbeg over records covering each window
        w_lo = pos_s[mi] >> 14
        w_hi = (end_s[mi] - 1) >> 14
        for t in np.unique(t_m).tolist():
            tm = t_m == t
            nw = int(w_hi[tm].max()) + 1
            lin = np.full(nw, np.iinfo(np.int64).max, np.int64)
            span = int((w_hi[tm] - w_lo[tm]).max())
            for k in range(span + 1):
                mk = tm & (w_lo + k <= w_hi)
                np.minimum.at(lin, (w_lo[mk] + k), vbeg[mi[mk]])
            ld = {}
            for w in np.flatnonzero(
                    lin != np.iinfo(np.int64).max).tolist():
                ld[w] = int(lin[w])
            linear[int(t)] = ld

    shim = BamWriter(path, header_text, ref_names, ref_lengths)
    shim._write_bai(bins, linear)
    return n
