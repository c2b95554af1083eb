"""The benchmark's frozen copy of the port's planted-truth generator.

A WGS-shaped germline sample: N chromosomes of random sequence, two
haplotypes per sample as segment mosaics over the reference (deletions,
novel insertions, tandem duplications, inversions, reciprocal
translocations; het or hom), paired-end reads drawn uniformly from each
haplotype and written as the alignments a mapper would give (soft clips
at junctions, BWA-style SA supplementary records, shadow mates inside
insertions, a low rate of mismapped-pair noise), a coordinate-sorted BAM
with its BAI, the reference FASTA with its FAI, and the truth TSV.

Copied from ``manta_tpu_torch/tools/wgs_workload.py`` (itself the JAX
package's ``benchmarks/wgs_workload.py``) so that the yardstick cannot
move with the program: the same seed and parameters give the same bytes
as the port's generator on the in-memory path (under 30 M reads a
sample), which ``svbench/tests/test_svbench_workload.py`` checks where
the port is importable. It imports nothing of the port: BAM records are
encoded and compressed by ``svbench/bamout.py`` (numpy and zlib).
"""

from __future__ import annotations

import time
from types import SimpleNamespace

import numpy as np

from .bamout import BamWriter, ReadBatch, string_to_arrays

READ_LEN = 100
# mutable module-level fragment-size model: frag_mean/frag_sd
# override for wide-insert (FFPE-like) library shapes, whose wide
# breakend CIs drive large contig-alignment windows in phase 2
FRAG_MEAN, FRAG_SD, FRAG_LO, FRAG_HI = 300, 30, 200, 450
MIN_ANCHOR = 20          # min aligned bases to anchor a junction read
BASES = np.frombuffer(b"ACGT", np.uint8)
_RC = np.zeros(256, np.uint8)
for _a, _b in zip(b"ACGTN", b"TGCAN"):
    _RC[_a] = _b


def revcomp(a: np.ndarray) -> np.ndarray:
    return _RC[a[::-1]]


# --------------------------------------------------------------- genome

def make_truth(rng, chrom_lens, spacing_kb=100, n_transloc=2):
    """Plan the SV truth set. Returns (svs, translocs).

    svs: list of dict(chrom_i, pos, type, size, gt, ins_seq)
    translocs: list of dict(chrom_a, pos_a, chrom_b, pos_b, gt)
    """
    svs = []
    types = ["DEL", "INS", "DUP", "INV"]
    probs = [0.35, 0.25, 0.20, 0.20]
    for ci, clen in enumerate(chrom_lens):
        spacing = spacing_kb * 1000
        pos = 20000
        while pos < clen - 30000:
            p = pos + int(rng.integers(0, spacing // 2))
            typ = rng.choice(types, p=probs)
            # log-uniform sizes, 100 b .. 8 kb
            size = int(np.exp(rng.uniform(np.log(100), np.log(8000))))
            gt = "het" if rng.random() < 0.6 else "hom"
            ins_seq = BASES[rng.integers(0, 4, size)] if typ == "INS" \
                else None
            if p + size < clen - 25000:
                svs.append(dict(chrom_i=ci, pos=p, type=typ, size=size,
                                gt=gt, ins_seq=ins_seq))
            pos += spacing + (size if typ != "INS" else 0)
    translocs = []
    nc = len(chrom_lens)
    for k in range(min(n_transloc, nc // 2)):
        ca, cb = 2 * k, 2 * k + 1
        pa = int(chrom_lens[ca] * rng.uniform(0.35, 0.65))
        pb = int(chrom_lens[cb] * rng.uniform(0.35, 0.65))
        translocs.append(dict(chrom_a=ca, pos_a=pa, chrom_b=cb, pos_b=pb,
                              gt="het"))
    return svs, translocs


class DerivedChrom:
    """One haplotype chromosome: a mosaic of reference segments and
    novel sequence. Segments: (hap_beg, tid, ref_beg, ref_end, strand)
    with tid = -1 for novel segments (ref_beg indexes novel_blob)."""

    def __init__(self):
        self.segs = []              # rows appended then frozen to arrays
        self.novel = []             # list of uint8 arrays
        self._hap_len = 0

    def add_ref(self, tid, beg, end, strand=1):
        if end <= beg:
            return
        self.segs.append((self._hap_len, tid, beg, end, strand))
        self._hap_len += end - beg

    def add_novel(self, seq):
        off = sum(len(s) for s in self.novel)
        self.novel.append(seq)
        self.segs.append((self._hap_len, -1, off, off + len(seq), 1))
        self._hap_len += len(seq)

    def freeze(self, ref_seqs):
        self.hap_beg = np.array([s[0] for s in self.segs], np.int64)
        self.tid = np.array([s[1] for s in self.segs], np.int32)
        self.ref_beg = np.array([s[2] for s in self.segs], np.int64)
        self.ref_end = np.array([s[3] for s in self.segs], np.int64)
        self.strand = np.array([s[4] for s in self.segs], np.int8)
        self.hap_len = self._hap_len
        novel_blob = (np.concatenate(self.novel) if self.novel
                      else np.zeros(0, np.uint8))
        parts = []
        for _, tid, beg, end, strand in self.segs:
            chunk = (novel_blob[beg:end] if tid < 0
                     else ref_seqs[tid][beg:end])
            parts.append(revcomp(chunk) if strand < 0 else chunk)
        self.seq = (np.concatenate(parts) if parts
                    else np.zeros(0, np.uint8))
        return self


def build_haplotypes(ref_seqs, chrom_lens, svs, translocs):
    """Two haplotypes as lists of DerivedChrom."""
    haps = []
    for h in (0, 1):
        # chromosome arms after translocation surgery (het: hap 0 only)
        # derived chrom plan: per source chrom, the (tid, cut) rewiring
        joined = {}           # ci -> (tail_tid, tail_cut) after cut
        cuts = {}             # ci -> cut position (own arm ends there)
        for tr in translocs:
            if tr["gt"] == "het" and h != 0:
                continue
            cuts[tr["chrom_a"]] = tr["pos_a"]
            cuts[tr["chrom_b"]] = tr["pos_b"]
            joined[tr["chrom_a"]] = (tr["chrom_b"], tr["pos_b"])
            joined[tr["chrom_b"]] = (tr["chrom_a"], tr["pos_a"])

        per_chrom_svs = {}
        for sv in svs:
            if sv["gt"] == "het" and h != 0:
                continue
            per_chrom_svs.setdefault(sv["chrom_i"], []).append(sv)

        def emit_ref_span(dc, tid, beg, end):
            """Append [beg,end) of source chrom tid, applying its SVs."""
            cursor = beg
            for sv in sorted(per_chrom_svs.get(tid, []),
                             key=lambda s: s["pos"]):
                p, size = sv["pos"], sv["size"]
                if p < beg or p + size > end:
                    continue
                typ = sv["type"]
                if typ == "DEL":
                    dc.add_ref(tid, cursor, p)
                    cursor = p + size
                elif typ == "INS":
                    dc.add_ref(tid, cursor, p)
                    dc.add_novel(sv["ins_seq"])
                    cursor = p
                elif typ == "DUP":
                    dc.add_ref(tid, cursor, p + size)
                    dc.add_ref(tid, p, p + size)      # second copy
                    cursor = p + size
                elif typ == "INV":
                    dc.add_ref(tid, cursor, p)
                    dc.add_ref(tid, p, p + size, strand=-1)
                    cursor = p + size
            dc.add_ref(tid, cursor, end)

        out = []
        for ci, clen in enumerate(chrom_lens):
            dc = DerivedChrom()
            if ci in cuts:
                emit_ref_span(dc, ci, 0, cuts[ci])
                jt, jc = joined[ci]
                emit_ref_span(dc, jt, jc, chrom_lens[jt])
            else:
                emit_ref_span(dc, ci, 0, clen)
            out.append(dc.freeze(ref_seqs))
        haps.append(out)
    return haps


# -------------------------------------------------------------- repeats

def apply_repeat_structure(rng, ref_seqs, svs, min_anchored: int = 0):
    """--repeats: write adversarial repeat content into the reference
    BEFORE haplotype construction (carried SVs inherit it), returning
    family annotations for the read-level mismap model and the checker.

    Reference-motivated content (the graph's complexity aborts exist
    because of exactly this — SVLocusSetOptions.hpp:50-54; the
    flank-uniqueness contig filter because of this — methods.tex:406):
      - tandem satellite arrays (unit 5-40 bp, 2-8 kb), a third written
        AROUND a planted SV so its junction sits inside the array;
      - dispersed segmental-duplication families: 5-15 kb donor copied
        at ~1% divergence to 2-4 acceptor sites, cross-chrom allowed;
      - low-complexity homopolymer / dinucleotide runs (0.2-1 kb)."""
    families = []
    nC = len(ref_seqs)
    lens = [len(s) for s in ref_seqs]

    def rand_pos(tid, width):
        return int(rng.integers(width, lens[tid] - 2 * width))

    n_tand = max(2, sum(lens) // 2_000_000)
    anchors = [sv for sv in svs if sv["type"] in ("DEL", "DUP", "INS")]
    rng.shuffle(anchors)
    n_anchored = max(1, n_tand // 3) if anchors else 0
    if min_anchored and anchors:
        # statistical-power mode (--repeat-anchors): plant at least this
        # many SV junctions inside satellite arrays so repeat-proximal
        # recall is measured on n>=100, not anecdotes (round-5 verdict)
        n_anchored = min(max(n_anchored, min_anchored), len(anchors))
        n_tand = max(n_tand, n_anchored * 3 // 2)
    for k in range(n_tand):
        unit = int(rng.integers(5, 41))
        span = int(rng.integers(2000, 8001))
        if k < n_anchored and k < len(anchors):
            sv = anchors[k]
            tid = sv["chrom_i"]
            beg = max(1000, sv["pos"] - span // 2)
        else:
            tid = int(rng.integers(0, nC))
            beg = rand_pos(tid, span + 1000)
        end = min(beg + span, lens[tid] - 1000)
        motif = BASES[rng.integers(0, 4, unit)]
        ref_seqs[tid][beg:end] = np.tile(
            motif, -(-(end - beg) // unit))[:end - beg]
        families.append(dict(type="tandem", copies=[(tid, beg, end)],
                             unit=unit))

    for _ in range(max(2, sum(lens) // 3_000_000)):
        tid = int(rng.integers(0, nC))
        span = int(rng.integers(200, 1001))
        beg = rand_pos(tid, span + 1000)
        end = beg + span
        if rng.random() < 0.5:
            ref_seqs[tid][beg:end] = BASES[int(rng.integers(0, 4))]
        else:
            ref_seqs[tid][beg:end] = np.tile(
                BASES[rng.integers(0, 4, 2)], span // 2 + 1)[:span]
        families.append(dict(type="lowc", copies=[(tid, beg, end)],
                             unit=1))

    for _ in range(max(1, sum(lens) // 8_000_000)):
        dlen = int(rng.integers(5000, 15001))
        dt = int(rng.integers(0, nC))
        db = rand_pos(dt, dlen + 2000)
        donor = ref_seqs[dt][db:db + dlen].copy()
        copies = [(dt, db, db + dlen)]
        for _c in range(int(rng.integers(1, 4))):
            at = int(rng.integers(0, nC))
            ab = rand_pos(at, dlen + 2000)
            cp = donor.copy()
            ndiv = rng.binomial(dlen, 0.01)
            ai = rng.integers(0, dlen, ndiv)
            cp[ai] = BASES[(rng.integers(1, 4, ndiv) +
                            np.searchsorted(BASES, cp[ai])) % 4]
            ref_seqs[at][ab:ab + dlen] = cp
            copies.append((at, ab, ab + dlen))
        families.append(dict(type="segdup", copies=copies, unit=0))
    return families


class MismapModel:
    """Read-level mapper-confusion model over repeat families.

    A real aligner, not the simulator's omniscient placement, is what
    turns repeats into graph pressure: reads from one segdup copy map
    confidently into another (anomalous pairs = dense noise edges),
    and reads inside satellite/low-complexity arrays come back MAPQ 0
    or shifted by whole repeat units. This applies those effects
    vectorially to mapped (tid, pos) read columns."""

    def __init__(self, families, n_tids,
                 p_move=0.08, p_move_hi_mapq=0.3, p_mq0=0.4,
                 p_jit=0.3, p_attract=0.004):
        self.p_move = p_move
        self.p_move_hi = p_move_hi_mapq
        self.p_mq0 = p_mq0
        self.p_jit = p_jit
        # satellite attractor: reads from unassembled repeat copies
        # genome-wide pile into the few assembled array copies with
        # scattered mates — the real-data source of the graph's
        # noise-node pressure (SVLocusSet.cpp:536+ abort machinery)
        self.p_attract = p_attract
        self.arrays = [(t, b, e) for fam in families
                       if fam["type"] == "tandem"
                       for (t, b, e) in fam["copies"]]
        sd = {t: [] for t in range(n_tids)}
        rp = {t: [] for t in range(n_tids)}
        self.fam_copies = []
        for fi, fam in enumerate(families):
            if fam["type"] == "segdup":
                self.fam_copies.append(np.array(fam["copies"], np.int64))
                for ci, (t, b, e) in enumerate(fam["copies"]):
                    sd[t].append((b, e, len(self.fam_copies) - 1, ci))
            else:
                for (t, b, e) in fam["copies"]:
                    rp[t].append((b, e, max(fam["unit"], 1)))
        self.sd = {t: np.array(sorted(v), np.int64).reshape(-1, 4)
                   for t, v in sd.items() if v}
        self.rp = {t: np.array(sorted(v), np.int64).reshape(-1, 3)
                   for t, v in rp.items() if v}

    def _inside(self, table, t, p, L):
        """(row_index, inside_mask) for reads fully inside an interval."""
        idx = np.full(len(p), -1, np.int64)
        for tid, arr in table.items():
            m = t == tid
            if not m.any():
                continue
            j = np.searchsorted(arr[:, 0], p[m], "right") - 1
            ok = (j >= 0)
            jj = np.clip(j, 0, len(arr) - 1)
            ok &= (p[m] >= arr[jj, 0]) & (p[m] + L <= arr[jj, 1])
            sub = np.where(ok, jj, -1)
            idx[m] = sub
        return idx

    def apply(self, rng, t, p):
        """Returns (t', p', mapq) for mapped read columns."""
        L = READ_LEN
        t = t.astype(np.int64).copy()
        p = p.copy()
        mapq = np.full(len(p), 60, np.uint8)

        # segdup teleportation (masks against the PRE-move columns: a
        # read teleported into tid X must not be re-selected by X's
        # interval table)
        t0, p0 = t.copy(), p.copy()
        idx = self._inside(self.sd, t0, p0, L)
        hit = idx >= 0
        if hit.any():
            move = hit & (rng.random(len(p)) < self.p_move)
            for tid, arr in self.sd.items():
                m = move & (t0 == tid)
                if not m.any():
                    continue
                rows = arr[idx[m]]
                off = p0[m] - rows[:, 0]
                fam = rows[:, 2]
                cur = rows[:, 3]
                # pick a random OTHER copy per read
                new_t = np.empty(int(m.sum()), np.int64)
                new_p = np.empty(int(m.sum()), np.int64)
                for u, (f, c, o) in enumerate(zip(fam, cur, off)):
                    cps = self.fam_copies[int(f)]
                    j = int(rng.integers(0, len(cps) - 1))
                    if j >= int(c):
                        j += 1
                    new_t[u] = cps[j, 0]
                    new_p[u] = cps[j, 1] + int(o)
                t[m] = new_t
                p[m] = new_p
            # confident-wrong vs low-mapq mismaps
            lowq = move & (rng.random(len(p)) >= self.p_move_hi)
            mapq[lowq] = rng.integers(3, 30, int(lowq.sum()))
            # unmoved in-segdup reads: MAPQ0 fraction
            mq0 = hit & ~move & (rng.random(len(p)) < self.p_mq0)
            mapq[mq0] = 0

        # satellite / low-complexity: MAPQ0 + unit jitter
        idx = self._inside(self.rp, t, p, L)
        hit = idx >= 0
        if hit.any():
            mq0 = hit & (rng.random(len(p)) < self.p_mq0)
            mapq[mq0] = 0
            jit = hit & (rng.random(len(p)) < self.p_jit)
            for tid, arr in self.rp.items():
                m = jit & (t == tid)
                if not m.any():
                    continue
                rows = arr[idx[m]]
                unit = rows[:, 2]
                k = rng.integers(1, 4, int(m.sum())) * \
                    np.where(rng.random(int(m.sum())) < 0.5, -1, 1)
                np2 = p[m] + k * unit
                np2 = np.clip(np2, rows[:, 0], rows[:, 1] - L)
                p[m] = np2

        # attractor: non-repeat reads teleported INTO a satellite array
        # at a random offset; half keep confident MAPQ (the graph-edge
        # noise), half come back MAPQ0
        if self.arrays and self.p_attract > 0:
            att = (idx < 0) & (rng.random(len(p)) < self.p_attract)
            na = int(att.sum())
            if na:
                ai = rng.integers(0, len(self.arrays), na)
                t_att = np.empty(na, np.int64)
                p_att = np.empty(na, np.int64)
                for u, a in enumerate(ai):
                    at, ab, ae = self.arrays[int(a)]
                    t_att[u] = at
                    p_att[u] = int(rng.integers(ab, max(ab + 1,
                                                        ae - L)))
                t[att] = t_att
                p[att] = p_att
                mq_att = np.where(rng.random(na) < 0.5, 60,
                                  rng.integers(0, 20, na))
                mapq[att] = mq_att.astype(np.uint8)
        return t, p, mapq


# ------------------------------------------------------------ simulation

def _map_regular(dc, seg, start, L):
    """(tid, refpos, refstrand) for reads fully inside ref segment."""
    off = start - dc.hap_beg[seg]
    fwd = dc.strand[seg] > 0
    pos = np.where(fwd, dc.ref_beg[seg] + off,
                   dc.ref_end[seg] - off - L)
    return dc.tid[seg], pos.astype(np.int64), ~fwd


def _names(prefix: bytes, ids: np.ndarray):
    """Flat name blob + offsets for b'{prefix}{id}' names."""
    s = np.char.add(prefix.decode(), ids.astype("U10"))
    joined = "".join(s.tolist()).encode()
    lens = np.char.str_len(s).astype(np.int64)
    off = np.zeros(len(ids) + 1, np.int64)
    np.cumsum(lens, out=off[1:])
    return np.frombuffer(joined, np.uint8), off


def _bulk_batch(ref_seqs, tid1, pos1, rev1, tid2, pos2, rev2,
                frag_ids, err_rate, rng, mapq1=None, mapq2=None):
    """Vectorized ReadBatch for regular (full-match) pairs."""
    n = len(tid1)
    L = READ_LEN
    tid = np.empty(2 * n, np.int32)
    pos = np.empty(2 * n, np.int64)
    rev = np.empty(2 * n, bool)
    tid[0::2], tid[1::2] = tid1, tid2
    pos[0::2], pos[1::2] = pos1, pos2
    rev[0::2], rev[1::2] = rev1, rev2

    # flags
    flag = np.full(2 * n, 0x1, np.uint16)
    flag[0::2] |= 0x40
    flag[1::2] |= 0x80
    flag |= np.where(rev, 0x10, 0).astype(np.uint16)
    mrev = np.empty(2 * n, bool)
    mrev[0::2], mrev[1::2] = rev[1::2], rev[0::2]
    flag |= np.where(mrev, 0x20, 0).astype(np.uint16)

    # tlen (leftmost-forward convention) + proper-pair flag
    same = tid1 == tid2
    lo = np.minimum(pos1, pos2)
    hi = np.maximum(pos1, pos2) + L
    span = np.where(same, hi - lo, 0)
    s1 = np.where(same, np.where(pos1 <= pos2, span, -span), 0)
    # FR innie: leftmost mate forward, rightmost reverse
    left_rev = np.where(pos1 <= pos2, rev1, rev2)
    right_rev = np.where(pos1 <= pos2, rev2, rev1)
    proper = same & (~left_rev) & right_rev & (span < 1200) & (span >= L)
    tlen = np.empty(2 * n, np.int32)
    tlen[0::2], tlen[1::2] = s1, -s1
    flag |= np.where(np.repeat(proper, 2), 0x2, 0).astype(np.uint16)

    # seq gather: ref-forward bases per read, chunked per chromosome
    seq = np.empty(2 * n * L, np.uint8).reshape(2 * n, L)
    for t in np.unique(tid):
        m = tid == t
        seq[m] = ref_seqs[t][pos[m, None] + np.arange(L)[None, :]]
    if err_rate > 0:
        nerr = rng.binomial(2 * n * L, err_rate)
        if nerr:
            flat = seq.reshape(-1)
            at = rng.integers(0, flat.size, nerr)
            flat[at] = BASES[(rng.integers(1, 4, nerr) +
                              np.searchsorted(BASES, flat[at])) % 4]

    name, name_off = _names(b"w", np.repeat(frag_ids, 2))
    k = np.arange(2 * n, dtype=np.int64)
    nref = np.empty(2 * n, np.int32)
    npos = np.empty(2 * n, np.int64)
    nref[0::2], nref[1::2] = tid2, tid1
    npos[0::2], npos[1::2] = pos2, pos1
    mq = np.full(2 * n, 60, np.uint8)
    if mapq1 is not None:
        mq[0::2] = mapq1
    if mapq2 is not None:
        mq[1::2] = mapq2
    return ReadBatch(
        n=2 * n, refid=tid, pos=pos.astype(np.int32),
        mapq=mq, flag=flag,
        next_refid=nref, next_pos=npos.astype(np.int32), tlen=tlen,
        cigar_off=np.arange(2 * n + 1, dtype=np.int64),
        cigar=np.full(2 * n, (L << 4) | 0, np.uint32),
        seq_off=np.arange(2 * n + 1, dtype=np.int64) * L,
        seq=seq.reshape(-1),
        qual_off=np.arange(2 * n + 1, dtype=np.int64) * L,
        qual=np.full(2 * n * L, 35, np.uint8),
        name_off=name_off, name=name,
        tag_off=np.zeros(2 * n + 1, np.int64), tags=b"")


SA_MIN_CLIP = 30     # min clipped-segment length a mapper would rescue
                     # as a supplementary alignment (BWA seed scale)


def _map_piece(dc, lo, ln):
    """Map hap range [lo, lo+ln) iff it lies inside ONE reference-backed
    segment: returns (tid, ref_pos, piece_rev) or None."""
    s = int(np.searchsorted(dc.hap_beg, lo, "right") - 1)
    seg_end = (dc.hap_beg[s + 1] if s + 1 < len(dc.hap_beg)
               else dc.hap_len)
    if dc.tid[s] < 0 or lo + ln > seg_end:
        return None
    off = lo - dc.hap_beg[s]
    if dc.strand[s] > 0:
        return int(dc.tid[s]), int(dc.ref_beg[s] + off), False
    return int(dc.tid[s]), int(dc.ref_end[s] - off - ln), True


def _map_irregular(dc, start):
    """Scalar mapping of one read at hap pos `start`: returns
    (tid, pos, cigar_str, rev, stored_seq, supp) or None if
    unmappable. Anchors on whichever end has >= MIN_ANCHOR ref bases
    in one segment; the remainder is soft-clipped. When the clipped
    remainder itself maps inside one segment and is >= SA_MIN_CLIP
    long, `supp` carries (clip_lo, clip_len, tid2, pos2, piece_rev2)
    describing the supplementary alignment a mapper would emit for it
    (reference input expectation: BWA-style SA split reads,
    SVLocusScanner.cpp getSACandidatesFromRead)."""
    L = READ_LEN
    sa = int(np.searchsorted(dc.hap_beg, start, "right") - 1)
    sb = int(np.searchsorted(dc.hap_beg, start + L - 1, "right") - 1)
    hap_seq = dc.seq[start:start + L]

    def seg_end(s):
        return (dc.hap_beg[s + 1] if s + 1 < len(dc.hap_beg)
                else dc.hap_len)

    def supp_of(clip_lo, clip_len):
        if clip_len < SA_MIN_CLIP:
            return None
        m = _map_piece(dc, clip_lo, clip_len)
        if m is None:
            return None
        return (clip_lo - start, clip_len) + m

    # left anchor
    left_len = min(seg_end(sa), start + L) - start
    if dc.tid[sa] >= 0 and left_len >= MIN_ANCHOR:
        off = start - dc.hap_beg[sa]
        clip = L - left_len
        supp = supp_of(start + left_len, clip) if clip else None
        if dc.strand[sa] > 0:
            cig = f"{left_len}M{clip}S" if clip else f"{L}M"
            return (int(dc.tid[sa]), int(dc.ref_beg[sa] + off), cig,
                    False, hap_seq, supp)
        cig = f"{clip}S{left_len}M" if clip else f"{L}M"
        return (int(dc.tid[sa]),
                int(dc.ref_end[sa] - off - left_len), cig,
                True, revcomp(hap_seq), supp)
    # right anchor
    right_len = start + L - max(dc.hap_beg[sb], start)
    if dc.tid[sb] >= 0 and right_len >= MIN_ANCHOR:
        clip = L - right_len
        supp = supp_of(start, clip) if clip else None
        if dc.strand[sb] > 0:
            cig = f"{clip}S{right_len}M" if clip else f"{L}M"
            return (int(dc.tid[sb]), int(dc.ref_beg[sb] +
                                         (start + L - dc.hap_beg[sb]) -
                                         right_len), cig, False, hap_seq,
                    supp)
        off_end = start + L - dc.hap_beg[sb]
        cig = f"{right_len}M{clip}S" if clip else f"{L}M"
        return (int(dc.tid[sb]),
                int(dc.ref_end[sb] - off_end), cig,
                True, revcomp(hap_seq), supp)
    return None


def _irregular_reads(dc, starts1, starts2, frag_ids):
    """Scalar path: read dicts for fragments near junctions."""
    rows = []
    for p1, p2, fid in zip(starts1.tolist(), starts2.tolist(),
                           frag_ids.tolist()):
        m1 = _map_irregular(dc, p1)
        m2 = _map_irregular(dc, p2)
        if m1 is None and m2 is None:
            continue
        name = f"w{fid}"
        recs = []
        for mi, (m, other, first) in enumerate(
                (((m1), m2, True), ((m2), m1, False))):
            hap_start = p1 if first else p2
            phys_rev = not first          # r2 sequenced hap-reverse
            if m is None:                 # shadow at mate
                o_tid, o_pos = other[0], other[1]
                seq = dc.seq[hap_start:hap_start + READ_LEN]
                # mappers store an unmapped read's RAW sequenced bases:
                # the physically-reverse mate (r2 of an FR pair) carries
                # the reverse complement of the haplotype-forward
                # segment. Manta's assembler re-normalizes via the
                # anchor's strand (SVCandidateAssembler shadow
                # reversal), so emitting hap-forward here poisoned
                # insertion assembly with RC'd k-mers (round-5 fix).
                if phys_rev:
                    seq = revcomp(seq)
                recs.append(dict(refid=o_tid, pos=o_pos, mapq=0,
                                 cigar="", seq=seq,
                                 flag=0x1 | 0x4 | (0x40 if first else 0x80),
                                 rev=False, next_refid=o_tid,
                                 next_pos=o_pos, name=name))
                continue
            tid, pos, cig, seg_rev, seq, supp = m
            rev = seg_rev ^ phys_rev
            # stored seq orientation: ref-forward. m returns seq for a
            # hap-forward read; physical r2 reverse does not change the
            # ref-forward stored bases.
            rec = dict(refid=tid, pos=pos, mapq=60, cigar=cig,
                       seq=seq, rev=rev,
                       flag=0x1 | (0x40 if first else 0x80) |
                       (0x10 if rev else 0), name=name)
            if supp is not None:
                # a mapper rescues the clipped remainder as a
                # supplementary alignment; emit the SA tag pair + the
                # 0x800 record like BWA would
                clip_lo, cl, tid2, pos2, piece_rev2 = supp
                L = READ_LEN
                pre, post = clip_lo, L - clip_lo - cl
                supp_rev = piece_rev2 ^ phys_rev
                if not piece_rev2:
                    scig = (f"{pre}S" if pre else "") + f"{cl}M" + \
                        (f"{post}S" if post else "")
                    sseq = dc.seq[hap_start:hap_start + L]
                else:
                    scig = (f"{post}S" if post else "") + f"{cl}M" + \
                        (f"{pre}S" if pre else "")
                    sseq = revcomp(dc.seq[hap_start:hap_start + L])
                sa_of_supp = (f"{dc.names[tid2]},{pos2 + 1},"
                              f"{'-' if supp_rev else '+'},{scig},60,0;")
                sa_of_prim = (f"{dc.names[tid]},{pos + 1},"
                              f"{'-' if rev else '+'},{cig},60,0;")
                rec["tags"] = b"SAZ" + sa_of_supp.encode() + b"\x00"
                rec["supp"] = dict(
                    refid=tid2, pos=pos2, mapq=60, cigar=scig,
                    seq=sseq, rev=supp_rev,
                    flag=0x1 | 0x800 | (0x40 if first else 0x80) |
                    (0x10 if supp_rev else 0), name=name,
                    tags=b"SAZ" + sa_of_prim.encode() + b"\x00")
            recs.append(rec)
        # cross-link mates
        if len(recs) == 2:
            a, b = recs
            a["next_refid"], a["next_pos"] = b["refid"], b["pos"]
            b["next_refid"], b["next_pos"] = a["refid"], a["pos"]
            a["flag"] |= 0x20 if (b["flag"] & 0x10) else 0
            b["flag"] |= 0x20 if (a["flag"] & 0x10) else 0
            if (a["flag"] | b["flag"]) & 0x4:
                a["flag"] |= 0x8 if (b["flag"] & 0x4) else 0
                b["flag"] |= 0x8 if (a["flag"] & 0x4) else 0
                a["tlen"] = b["tlen"] = 0
            elif a["refid"] == b["refid"]:
                # aligned span from cigar
                def span(r):
                    ops, lens = string_to_arrays(r["cigar"])
                    return int(lens[(ops == 0) | (ops == 2)].sum())
                lo = min(a["pos"], b["pos"])
                hi = max(a["pos"] + span(a), b["pos"] + span(b))
                s = hi - lo
                first_left = a["pos"] <= b["pos"]
                a["tlen"] = s if first_left else -s
                b["tlen"] = -a["tlen"]
            else:
                a["tlen"] = b["tlen"] = 0
        supps = []
        for r in recs:
            s = r.pop("supp", None)
            if s is not None:
                # supplementary carries the primary's mate linkage
                s["next_refid"] = r.get("next_refid", -1)
                s["next_pos"] = r.get("next_pos", -1)
                s["flag"] |= r["flag"] & (0x8 | 0x20)
                s["tlen"] = r.get("tlen", 0)
                supps.append(s)
        rows.extend(recs)
        rows.extend(supps)
    return rows


def _rows_to_batch(rows):
    n = len(rows)
    if n == 0:
        return None
    refid = np.zeros(n, np.int32); pos = np.zeros(n, np.int32)
    mapq = np.zeros(n, np.uint8); flag = np.zeros(n, np.uint16)
    nref = np.zeros(n, np.int32); npos = np.zeros(n, np.int32)
    tlen = np.zeros(n, np.int32)
    cig_off = np.zeros(n + 1, np.int64)
    seq_off = np.zeros(n + 1, np.int64)
    name_off = np.zeros(n + 1, np.int64)
    tag_off = np.zeros(n + 1, np.int64)
    cigs, seqs, names = [], [], []
    tag_blobs = []
    for i, r in enumerate(rows):
        refid[i] = r["refid"]; pos[i] = r["pos"]
        mapq[i] = r["mapq"]; flag[i] = r["flag"]
        nref[i] = r.get("next_refid", -1)
        npos[i] = r.get("next_pos", -1)
        tlen[i] = r.get("tlen", 0)
        tag_blobs.append(r.get("tags", b""))
        tag_off[i + 1] = tag_off[i] + len(tag_blobs[-1])
        if r["cigar"]:
            ops, lens = string_to_arrays(r["cigar"])
            cigs.append((lens.astype(np.uint32) << 4) |
                        ops.astype(np.uint32))
        else:
            cigs.append(np.zeros(0, np.uint32))
        seqs.append(np.asarray(r["seq"], np.uint8))
        names.append(np.frombuffer(r["name"].encode(), np.uint8))
        cig_off[i + 1] = cig_off[i] + len(cigs[-1])
        seq_off[i + 1] = seq_off[i] + len(seqs[-1])
        name_off[i + 1] = name_off[i] + len(names[-1])
    seq = np.concatenate(seqs) if seqs else np.zeros(0, np.uint8)
    return ReadBatch(
        n=n, refid=refid, pos=pos, mapq=mapq, flag=flag,
        next_refid=nref, next_pos=npos, tlen=tlen,
        cigar_off=cig_off,
        cigar=(np.concatenate(cigs) if cigs else np.zeros(0, np.uint32)),
        seq_off=seq_off, seq=seq,
        qual_off=seq_off.copy(), qual=np.full(len(seq), 35, np.uint8),
        name_off=name_off,
        name=(np.concatenate(names) if names else np.zeros(0, np.uint8)),
        tag_off=tag_off, tags=b"".join(tag_blobs))


def simulate(rng, ref_seqs, haps, writer, depth, err_rate=0.001,
             noise_rate=1e-4, chunk_frags=400_000, log=print,
             mismap=None):
    """Stream reads from both haplotypes into `writer`."""
    next_fid = 0
    for h, dchroms in enumerate(haps):
        for dc in dchroms:
            if dc.hap_len < FRAG_HI + 2:
                continue
            n_frags = int(depth / 2 * dc.hap_len / (2 * READ_LEN))
            done = 0
            while done < n_frags:
                n = min(chunk_frags, n_frags - done)
                done += n
                frag = rng.normal(FRAG_MEAN, FRAG_SD, n)
                frag = np.clip(frag, FRAG_LO, FRAG_HI).astype(np.int64)
                p1 = rng.integers(0, dc.hap_len - frag - 1)
                p2 = p1 + frag - READ_LEN
                fids = np.arange(next_fid, next_fid + n)
                next_fid += n

                sa1 = np.searchsorted(dc.hap_beg, p1, "right") - 1
                sb1 = np.searchsorted(dc.hap_beg, p1 + READ_LEN - 1,
                                      "right") - 1
                sa2 = np.searchsorted(dc.hap_beg, p2, "right") - 1
                sb2 = np.searchsorted(dc.hap_beg, p2 + READ_LEN - 1,
                                      "right") - 1
                reg = ((sa1 == sb1) & (sa2 == sb2) &
                       (dc.tid[sa1] >= 0) & (dc.tid[sa2] >= 0))

                # noise: a small fraction of regular pairs get the
                # mate teleported (mismapping), making sparse
                # anomalous-pair noise for the denoiser
                noise = reg & (rng.random(n) < noise_rate)
                regn = reg & ~noise

                t1, q1, r1 = _map_regular(dc, sa1[regn], p1[regn],
                                          READ_LEN)
                t2, q2, r2 = _map_regular(dc, sa2[regn], p2[regn],
                                          READ_LEN)
                # physical orientation: r1 hap-forward, r2 hap-reverse
                r1 = r1 ^ False
                r2 = ~r2
                if mismap is not None:
                    t1, q1, mq1 = mismap.apply(rng, t1, q1)
                    t2, q2, mq2 = mismap.apply(rng, t2, q2)
                else:
                    mq1 = mq2 = None
                batch = _bulk_batch(ref_seqs, t1, q1, r1, t2, q2, r2,
                                    fids[regn], err_rate, rng,
                                    mapq1=mq1, mapq2=mq2)
                writer.add_batch(batch)

                if noise.any():
                    nt1, nq1, nr1 = _map_regular(
                        dc, sa1[noise], p1[noise], READ_LEN)
                    nn = int(noise.sum())
                    nt2 = rng.integers(0, len(ref_seqs), nn)
                    nq2 = np.array(
                        [rng.integers(0, len(ref_seqs[t]) - READ_LEN)
                         for t in nt2], np.int64)
                    nr2 = rng.random(nn) < 0.5
                    nb = _bulk_batch(ref_seqs, nt1, nq1, nr1 ^ False,
                                     nt2, nq2, nr2, fids[noise],
                                     err_rate, rng)
                    writer.add_batch(nb)

                irr = ~reg
                if irr.any():
                    rows = _irregular_reads(dc, p1[irr], p2[irr],
                                            fids[irr])
                    b = _rows_to_batch(rows)
                    if b is not None:
                        writer.add_batch(b)
            log(f"hap{h} chrom len={dc.hap_len}: {n_frags} fragments")


def write_fasta(path, names, seqs):
    with open(path, "w") as f, open(path + ".fai", "w") as fi:
        off = 0
        for name, seq in zip(names, seqs):
            f.write(f">{name}\n")
            off += len(name) + 2
            fi.write(f"{name}\t{len(seq)}\t{off}\t70\t71\n")
            b = bytes(seq)
            for i in range(0, len(b), 70):
                f.write(b[i:i + 70].decode() + "\n")
            off += len(b) + (len(b) + 69) // 70



def generate(out: str, chroms: int, mb: int, depth: int = 35,
             spacing_kb: int = 100, translocs: int = 2,
             err_rate: float = 0.001, noise_rate: float = 1e-4,
             seed: int = 7, frag_mean: int = 300, frag_sd: int = 30,
             repeats: bool = False, repeat_anchors: int = 0,
             samples: int = 1, log=print) -> dict:
    """Write ``out.fa`` (+ .fai), ``out.truth.tsv`` and the BAM(s):
    ``out.bam`` for one sample, ``out.s<k>.bam`` for several. Returns
    {"reads": reads per BAM, "bams": paths}."""
    args = SimpleNamespace(
        out=out, chroms=chroms, mb=mb, depth=depth, spacing_kb=spacing_kb,
        translocs=translocs, err_rate=err_rate, noise_rate=noise_rate,
        seed=seed, frag_mean=frag_mean, frag_sd=frag_sd, repeats=repeats,
        repeat_anchors=repeat_anchors, samples=samples)
    return _generate(args, log)


def _generate(args, log):
    global FRAG_MEAN, FRAG_SD, FRAG_LO, FRAG_HI
    mean = getattr(args, "frag_mean", 300)
    sd = getattr(args, "frag_sd", 30)
    FRAG_MEAN, FRAG_SD = mean, sd
    FRAG_LO, FRAG_HI = max(READ_LEN + 10, mean - 5 * sd), mean + 5 * sd
    rng = np.random.default_rng(args.seed)
    nC = args.chroms
    chrom_lens = [args.mb * 1_000_000] * nC
    names = [f"chr{i + 1}" for i in range(nC)]
    t0 = time.time()
    ref_seqs = [BASES[rng.integers(0, 4, L)] for L in chrom_lens]
    log(f"[{time.time() - t0:6.1f}s] reference built "
        f"({sum(chrom_lens) / 1e6:.0f} Mb)")

    svs, translocs = make_truth(rng, chrom_lens,
                                spacing_kb=args.spacing_kb,
                                n_transloc=args.translocs)
    n_smp = args.samples
    # per-sample genotypes over the shared truth set: sample 0 keeps
    # the planned genotype (so every SV has at least one carrier),
    # further samples re-roll ref/het/hom independently — the joint
    # germline shape of the reference's up-to-~10-diploid-sample mode
    # (reference: docs/userGuide/README.md:50-69)
    for sv in svs:
        sv["gts"] = [sv["gt"]] + [
            ("ref", "het", "hom")[rng.choice(3, p=(0.35, 0.40, 0.25))]
            for _ in range(n_smp - 1)]
    for tr in translocs:
        tr["gts"] = [tr["gt"]] + [
            ("ref", "het")[rng.choice(2, p=(0.5, 0.5))]
            for _ in range(n_smp - 1)]
    with open(args.out + ".truth.tsv", "w") as f:
        f.write("chrom\tpos\ttype\tsize\tgt\n")
        for sv in svs:
            f.write(f"{names[sv['chrom_i']]}\t{sv['pos']}\t{sv['type']}"
                    f"\t{sv['size']}\t{','.join(sv['gts'])}\n")
        for tr in translocs:
            f.write(f"{names[tr['chrom_a']]}\t{tr['pos_a']}\tBND\t0\t"
                    f"{','.join(tr['gts'])}:{names[tr['chrom_b']]}:"
                    f"{tr['pos_b']}\n")
    log(f"[{time.time() - t0:6.1f}s] truth: {len(svs)} SVs + "
        f"{len(translocs)} translocations x {n_smp} sample(s)")

    mismap = None
    if getattr(args, "repeats", False):
        fams = apply_repeat_structure(
            rng, ref_seqs, svs,
            min_anchored=getattr(args, "repeat_anchors", 0))
        with open(args.out + ".repeats.tsv", "w") as f:
            f.write("type\tunit\tcopies\n")
            for fam in fams:
                cps = ";".join(f"{names[t]}:{b}-{e}"
                               for t, b, e in fam["copies"])
                f.write(f"{fam['type']}\t{fam['unit']}\t{cps}\n")
        mismap = MismapModel(fams, nC)
        n_sd = sum(1 for x in fams if x["type"] == "segdup")
        log(f"[{time.time() - t0:6.1f}s] repeats: {len(fams)} "
            f"families ({n_sd} segdup)")

    write_fasta(args.out + ".fa", names, ref_seqs)
    reads, bams = [], []
    for smp in range(n_smp):
        svs_k = [dict(sv, gt=sv["gts"][smp]) for sv in svs
                 if sv["gts"][smp] != "ref"]
        tr_k = [dict(tr, gt=tr["gts"][smp]) for tr in translocs
                if tr["gts"][smp] != "ref"]
        haps = build_haplotypes(ref_seqs, chrom_lens, svs_k, tr_k)
        for dchroms in haps:
            for dc in dchroms:
                dc.names = names    # for SA-tag rname fields
        log(f"[{time.time() - t0:6.1f}s] sample {smp}: haplotypes "
            f"built ({len(svs_k)} carried SVs)")
        bam = args.out + (".bam" if n_smp == 1 else f".s{smp}.bam")
        header = "@HD\tVN:1.6\tSO:coordinate\n" + "".join(
            f"@SQ\tSN:{n}\tLN:{L}\n" for n, L in zip(names, chrom_lens)
        ) + f"@RG\tID:rg1\tSM:WGS{smp + 1}\n"
        w = BamWriter(bam, header, names, chrom_lens)
        simulate(rng, ref_seqs, haps, w, args.depth,
                 err_rate=args.err_rate, noise_rate=args.noise_rate,
                 log=lambda m: log(f"[{time.time() - t0:6.1f}s] {m}"),
                 mismap=mismap)
        log(f"[{time.time() - t0:6.1f}s] encoding + sorting "
            f"{w.n_reads} reads")
        w.close(log=lambda m: log(f"[{time.time() - t0:6.1f}s] {m}"))
        reads.append(w.n_reads)
        bams.append(bam)
        log(f"[{time.time() - t0:6.1f}s] wrote {bam} "
            f"({w.n_reads} reads, {args.depth}x nominal)")
    return {"reads": reads, "bams": bams}
