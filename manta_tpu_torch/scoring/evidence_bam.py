"""Evidence-BAM output: supporting reads annotated with SV IDs.

Behavioral port of the reference evidence-BAM subsystem
(reference: GenerateSVCandidates/SVEvidenceWriter.{hpp,cpp}): during
scoring, fragments that support an SV's alt allele are recorded per
sample with their support type (PR spanning pair, SR split read, SRM
split-read mate); after each edge, the original reads are re-fetched
around the supporting positions and written with a ZM tag listing
"svId|type[|type][,svId2|...]" to per-sample evidence BAMs
(results/evidence/evidence_<i>.<prefix>.bam), sorted + BAI-indexed at
close (reference runs samtools sort/merge/index instead).
"""

from __future__ import annotations

from ..io.bam import open_alignment_reader
from ..io.bamwriter import BamWriter

FLAG_READ1 = 0x40


class SupportRead:
    __slots__ = ("tid", "pos", "svs")

    def __init__(self):
        self.tid = -1
        self.pos = 0
        self.svs: dict[str, set] = {}

    def add_new_sv(self, sv_id: str, support_type: str):
        self.svs.setdefault(sv_id, set()).add(support_type)


class SupportFragment:
    """(reference: SVEvidenceWriterReadPair)."""
    __slots__ = ("read1", "read2")

    def __init__(self):
        self.read1 = SupportRead()
        self.read2 = SupportRead()

    def set_reads(self, batch, i: int):
        if batch.flag[i] & FLAG_READ1:
            self.read1.tid = int(batch.refid[i])
            self.read1.pos = int(batch.pos[i])
            self.read2.tid = int(batch.next_refid[i])
            self.read2.pos = int(batch.next_pos[i])
        else:
            self.read1.tid = int(batch.next_refid[i])
            self.read1.pos = int(batch.next_pos[i])
            self.read2.tid = int(batch.refid[i])
            self.read2.pos = int(batch.pos[i])

    def add_spanning_support(self, sv_id: str):
        self.read1.add_new_sv(sv_id, "PR")
        self.read2.add_new_sv(sv_id, "PR")

    def add_split_support(self, is_read1: bool, sv_id: str):
        if is_read1:
            self.read1.add_new_sv(sv_id, "SR")
            self.read2.add_new_sv(sv_id, "SRM")
        else:
            self.read2.add_new_sv(sv_id, "SR")
            self.read1.add_new_sv(sv_id, "SRM")


class SupportSamples:
    """(reference: SVEvidenceWriterData) — per-sample fragment banks."""

    def __init__(self, sample_count: int):
        self.samples: list[dict[str, SupportFragment]] = \
            [{} for _ in range(sample_count)]

    def get_fragment(self, bam_index: int, batch, i: int) -> SupportFragment:
        qname = batch.name_bytes(i)
        frags = self.samples[bam_index]
        if qname not in frags:
            frag = SupportFragment()
            frag.set_reads(batch, i)
            frags[qname] = frag
        return frags[qname]

    def get_fragment_from_pair(self, bam_index: int,
                               fragment) -> SupportFragment:
        """(reference: getSupportFragment(SVCandidateSetSequenceFragment))."""
        r = fragment.read1 if fragment.read1 is not None else fragment.read2
        return self.get_fragment(bam_index, r.batch, r.index)


def _zm_string(read: SupportRead) -> str:
    parts = []
    for sv_id in read.svs:
        s = sv_id
        for t in read.svs[sv_id]:
            s += "|" + t
        parts.append(s)
    return ",".join(parts)


class SVEvidenceWriter:
    """(reference: SVEvidenceWriter + SynchronizedBamWriter)."""

    def __init__(self, bam_paths: list[str], out_paths: list[str],
                 reference: str | None = None):
        self.readers = [open_alignment_reader(p, reference)
                        for p in bam_paths]
        self.writers = []
        for reader, out in zip(self.readers, out_paths):
            h = reader.header
            self.writers.append(
                BamWriter(out, h.text, h.ref_names, h.ref_lengths))

    def write(self, support: SupportSamples):
        """Re-fetch and tag supporting reads for one edge
        (reference: SVEvidenceWriter::writeSupportBam)."""
        for si, frags in enumerate(support.samples):
            if not frags:
                continue
            reads = []
            for frag in frags.values():
                reads.append(frag.read1)
                reads.append(frag.read2)
            reads.sort(key=lambda r: (r.tid, r.pos))
            # merge nearby read starts into fetch intervals (0-based
            # half-open [first_start, last_start+1))
            read_distance = 100
            intervals: list[list[int]] = []
            for r in reads:
                if intervals and intervals[-1][0] == r.tid and \
                        intervals[-1][2] + read_distance >= r.pos + 1:
                    intervals[-1][2] = r.pos + 1
                else:
                    intervals.append([r.tid, r.pos, r.pos + 1])
            writer = self.writers[si]
            reader = self.readers[si]
            for tid, beg, end in intervals:
                if tid < 0:
                    continue
                batch = reader.fetch(tid, max(0, beg), end)
                for i in range(batch.n):
                    qname = batch.name_bytes(i)
                    frag = frags.get(qname)
                    if frag is None:
                        continue
                    is_first = bool(batch.flag[i] & FLAG_READ1)
                    read = frag.read1 if is_first else frag.read2
                    if int(batch.refid[i]) != read.tid or \
                            int(batch.pos[i]) != read.pos:
                        continue
                    zm = _zm_string(read).encode()
                    extra = b"ZMZ" + zm + b"\x00"
                    writer.add_record(batch, i, extra)

    def close(self):
        for w in self.writers:
            w.close()
