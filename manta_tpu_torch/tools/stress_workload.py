"""High-spanning-contig stress workload: the demo junction, tiled.

Tiles the demo HCC1954 junction neighborhoods (chr8 10 kb + chr11 25 kb
windows of the demo tumor BAM) N times onto a synthetic two-chromosome
genome, shifting both mates of every pair per tile so spanning and
split evidence stay valid. Each tile reproduces the demo's junctions.

At ``depth_frac=0.2`` (~58x a junction) with ``strip_sa`` (no SA tags,
no supplementary records) every candidate is pair-only and IMPRECISE,
so the refiner aligns its contigs against breakend-CI-wide reference
windows: about three contigs a junction, the shape whose phase-2 cost
concentrates in contig jump scoring.

The same arguments give the same bytes as the JAX package's generator
(benchmarks/stress_workload.py); this copy reads and writes through
the port's own io.bam, io.bamwriter and io.fasta. It generates only.

Usage:
    python -m manta_tpu_torch.tools.stress_workload --tiles 512 \\
        --out /tmp/hspan --depth-frac 0.2 --strip-sa
"""

from __future__ import annotations

import argparse
import copy
import os
import re
import zlib

import numpy as np

from .. import native_core
from ..io.bam import BamReader
from ..io.bamwriter import BamWriter
from ..io.fasta import FastaReader

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DEMO = os.path.join(REPO, "tests", "data", "demo")
TUMOR = os.path.join(DEMO, "G15512.HCC1954.1.COST16011_region.bam")
# the demo reference as tests/conftest.py and chip_smoke.py extract it
DEMO_FA = os.path.join(REPO, ".testdata",
                       "Homo_sapiens_assembly19.COST16011_region.fa")



def ensure_demo_fasta(path: str = DEMO_FA) -> str:
    """The demo reference at ``path``, extracted from the repo's tarball
    (tests/data/demo) where it is not there yet, as tests/conftest.py
    and chip_smoke.py extract it."""
    import shutil
    import tarfile
    name = os.path.basename(path)
    if not os.path.exists(path):
        work = os.path.dirname(path)
        os.makedirs(work, exist_ok=True)
        with tarfile.open(os.path.join(DEMO, name + ".tar.bz2")) as tf:
            tf.extractall(work, filter="data")
        if not os.path.exists(path):
            for root, _dirs, files in os.walk(work):
                if name in files:
                    os.rename(os.path.join(root, name), path)
                    break
    if not os.path.exists(path + ".fai"):
        shutil.copy(os.path.join(DEMO, name + ".fai"), path + ".fai")
    return path


W8 = (107650000, 107660000)
W11 = (94970000, 94995000)
SPAN8, SPAN11 = 12000, 27000


_TAG_SIZE = {ord("A"): 1, ord("c"): 1, ord("C"): 1, ord("s"): 2,
             ord("S"): 2, ord("i"): 4, ord("I"): 4, ord("f"): 4}


def _strip_sa(b):
    """Rebuild the batch's aux blob with every SA:Z tag removed."""
    blobs = []
    off = np.zeros(b.n + 1, np.int64)
    for i in range(b.n):
        blob = b.tags[b.tag_off[i]:b.tag_off[i + 1]]
        out = bytearray()
        j = 0
        while j + 3 <= len(blob):
            tag = blob[j:j + 2]
            typ = blob[j + 2]
            j0 = j
            j += 3
            if typ in _TAG_SIZE:
                j += _TAG_SIZE[typ]
            elif typ in (ord("Z"), ord("H")):
                e = blob.index(b"\x00", j)
                j = e + 1
            elif typ == ord("B"):
                st = blob[j]
                (cnt,) = np.frombuffer(blob[j + 1:j + 5], "<u4")
                j += 5 + int(cnt) * _TAG_SIZE[st]
            else:
                break
            if tag != b"SA":
                out += blob[j0:j]
        blobs.append(bytes(out))
        off[i + 1] = off[i] + len(blobs[-1])
    nb = copy.copy(b)
    nb.tag_off = off
    nb.tags = b"".join(blobs)
    return nb


def generate(tiles: int, out_prefix: str, depth_frac: float = 1.0,
             strip_sa: bool = False, demo_fasta: str = DEMO_FA):
    """Tile the demo COST16011 somatic junction ``tiles`` times into
    ``out_prefix``.bam and ``out_prefix``.fa (+ .fai). Returns (BAM
    path, FASTA path, reads written).

    ``depth_frac`` subsamples fragments per tile (the demo junction is
    ~290x; 0.2 gives a ~58x shape); ``strip_sa`` removes SA tags and
    supplementary records so candidates are pair-only and IMPRECISE;
    ``demo_fasta`` is the extracted demo reference."""
    src = BamReader(TUMOR)
    fa = FastaReader(demo_fasta)
    t8 = src.header.name_to_tid["8"]
    t11 = src.header.name_to_tid["11"]
    b8 = src.fetch(t8, *W8)
    b11 = src.fetch(t11, *W11)

    def keep_mask(b):
        m8 = (b.next_refid == t8) & (b.next_pos >= W8[0]) & \
            (b.next_pos < W8[1])
        m11 = (b.next_refid == t11) & (b.next_pos >= W11[0]) & \
            (b.next_pos < W11[1])
        return m8 | m11 | ((b.flag & 0x8) != 0)

    b8 = b8.subset(keep_mask(b8))
    b11 = b11.subset(keep_mask(b11))

    if strip_sa:
        # drop supplementary records and strip SA tags so no split-read
        # evidence survives: candidates become pair-only and IMPRECISE
        b8 = _strip_sa(b8.subset((b8.flag & 0x800) == 0))
        b11 = _strip_sa(b11.subset((b11.flag & 0x800) == 0))
    if depth_frac < 1.0:
        # fragment-level subsample, qname-keyed (stable crc32 so both
        # mates share one draw and runs are reproducible)
        def frag_keep(b):
            keep = np.zeros(b.n, bool)
            for i in range(b.n):
                keep[i] = (zlib.crc32(b.name_bytes(i)) & 0xFFFF) < \
                    depth_frac * 0x10000
            return keep
        b8 = b8.subset(frag_keep(b8))
        b11 = b11.subset(frag_keep(b11))

    # synthetic fasta: N-padded tiled windows
    fa_path = out_prefix + ".fa"
    with open(fa_path, "w") as f:
        for name, window, span in (("8", W8, SPAN8), ("11", W11, SPAN11)):
            seg = fa.fetch(name, *window).decode()
            f.write(f">{name}\n")
            seq = "N" * 1000 + "".join(
                seg + "N" * (span - len(seg)) for _ in range(tiles)) + \
                "N" * 1000
            for i in range(0, len(seq), 60):
                f.write(seq[i:i + 60] + "\n")
    # .fai
    entries = []
    with open(fa_path) as f:
        byte = 0
        name = None
        ln = 0
        start = 0
        for line in f:
            if line.startswith(">"):
                if name is not None:
                    entries.append((name, ln, start))
                name = line[1:].strip()
                byte += len(line)
                start = byte
                ln = 0
            else:
                ln += len(line.rstrip("\n"))
                byte += len(line)
        entries.append((name, ln, start))
    with open(fa_path + ".fai", "w") as f:
        for name, ln, start in entries:
            f.write(f"{name}\t{ln}\t{start}\t60\t61\n")

    def shift(b, base, span, tile):
        out = copy.copy(b)
        out.pos = (b.pos - base + 1000 + tile * span).astype(b.pos.dtype)
        m8 = b.next_refid == t8
        np_new = np.where(
            m8, b.next_pos - W8[0] + 1000 + tile * SPAN8,
            b.next_pos - W11[0] + 1000 + tile * SPAN11)
        out.next_pos = np_new.astype(b.next_pos.dtype)
        return out

    bam_path = out_prefix + ".bam"
    # declared reference lengths must cover the tiled layout: reusing
    # the source header's hg19 lengths silently clips tiles whose
    # positions land past the declared chromosome end (chr11 at 135 Mb
    # caps out at 5000 tiles of SPAN11) -- the scanner plans segments
    # from the header, so clipped tiles are never scanned
    tiled_lengths = []
    for name, old_len in zip(src.header.ref_names,
                             src.header.ref_lengths):
        span = SPAN8 if name == "8" else SPAN11 if name == "11" else None
        tiled_lengths.append(
            old_len if span is None else 2000 + span * tiles)
    text = src.header.text
    for name, ln in zip(src.header.ref_names, tiled_lengths):
        text = re.sub(rf"(@SQ\tSN:{re.escape(name)}\tLN:)\d+",
                      rf"\g<1>{ln}", text)
    w = BamWriter(bam_path, text, src.header.ref_names, tiled_lengths)
    total = 0
    for tile in range(tiles):
        s8 = shift(b8, W8[0], SPAN8, tile)
        for i in range(b8.n):
            w.add_record(s8, i)
        s11 = shift(b11, W11[0], SPAN11, tile)
        for i in range(b11.n):
            w.add_record(s11, i)
        total += b8.n + b11.n
    w.close()
    print(f"generated {bam_path}: {total} reads across {tiles} tiles")
    return bam_path, fa_path, total


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="Tile the demo junction into <out>.bam and <out>.fa")
    ap.add_argument("--tiles", type=int, default=32)
    ap.add_argument("--out", required=True)
    ap.add_argument("--depth-frac", type=float, default=1.0,
                    help="fraction of fragments kept a tile (0.2: ~58x)")
    ap.add_argument("--strip-sa", action="store_true",
                    help="drop supplementary records and SA tags "
                         "(pair-only, IMPRECISE candidates)")
    ap.add_argument("--demo-fasta", default=DEMO_FA,
                    help="the extracted demo reference")
    args = ap.parse_args(argv)
    native_core.load()
    generate(args.tiles, args.out, args.depth_frac, args.strip_sa,
             args.demo_fasta)


if __name__ == "__main__":
    main()
