"""Host-side alignment-file and reference I/O.

Equivalent in capability to the reference's htsapi layer
(src/c++/lib/htsapi: bam_streamer, bam_record, fasta/tabix readers), but
implemented from the HTS format specifications, producing packed
struct-of-arrays read batches suited to feeding batched kernels instead of
per-record object streams.
"""

from .bgzf import BgzfReader, bgzf_compress_block, bgzf_decompress_all, BGZF_EOF
from .bam import BamReader, ReadBatch, open_alignment_reader, \
    FLAG_PAIRED, FLAG_PROPER_PAIR, FLAG_UNMAPPED, \
    FLAG_MATE_UNMAPPED, FLAG_REVERSE, FLAG_MATE_REVERSE, FLAG_READ1, FLAG_READ2, \
    FLAG_SECONDARY, FLAG_QCFAIL, FLAG_DUP, FLAG_SUPPLEMENTARY
from .cram import CramReader
from .fasta import FastaReader
