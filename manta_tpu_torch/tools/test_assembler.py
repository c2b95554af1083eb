"""Debug CLI: run the iterative assembler directly on BAM reads.

Equivalent of the reference TestAssembler application
(reference: applications/TestAssembler/TestAssembler.cpp:22-64 +
extractAssemblyReads.cpp:25-75; documented at
docs/developerGuide/testAssembler.md): core-filtered reads (shadow
reads reversed) from each input BAM are assembled and the contigs
written as FASTA.
"""

from __future__ import annotations

import argparse
import sys

from ..assembly.assembler import AssemblerOptions, run_iterative_assembler
from ..candidates.assembler_reads import revcomp
from ..core.readfilter import is_read_filtered_core, is_non_strict_supplement
from ..io.bam import (
    FLAG_MATE_REVERSE, FLAG_MATE_UNMAPPED, FLAG_PAIRED,
    FLAG_UNMAPPED, open_alignment_reader,
)


def extract_assembly_reads(bam_path: str, min_singleton_mapq: int = 15,
                           reference: str | None = None):
    """(reference: extractAssemblyReads.cpp)."""
    reader = open_alignment_reader(bam_path, reference)
    batch = reader.read_all()
    core_bad = is_read_filtered_core(batch)
    nss = is_non_strict_supplement(batch)
    reads = []
    last_mapped_qname = None
    last_mapped_mapq = 0
    for i in range(batch.n):
        if core_bad[i] or nss[i]:
            continue
        flag = int(batch.flag[i])
        # shadow: unmapped read whose mate (the preceding anchor) is
        # mapped at the same position with sufficient mapq
        is_shadow = False
        if (flag & FLAG_UNMAPPED) and (flag & FLAG_PAIRED) and \
                not (flag & FLAG_MATE_UNMAPPED):
            if last_mapped_qname == batch.name_str(i) and \
                    last_mapped_mapq >= min_singleton_mapq:
                is_shadow = True
        if not (flag & FLAG_UNMAPPED):
            last_mapped_qname = batch.name_str(i)
            last_mapped_mapq = int(batch.mapq[i])
        if not is_shadow and (flag & FLAG_UNMAPPED):
            continue
        seq = batch.seq_str(i)
        if is_shadow and not (flag & FLAG_MATE_REVERSE):
            seq = revcomp(seq)
        reads.append(seq)
    return reads


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="Assemble reads from BAM input (debug tool)")
    ap.add_argument("--align-file", dest="bams", action="append",
                    required=True)
    ap.add_argument("--ref", default=None)
    ap.add_argument("--output-file", required=True)
    ap.add_argument("--small", action="store_true",
                    help="use the legacy SmallAssembler algorithm")
    args = ap.parse_args(argv)
    from ..native_core import load as load_native_core
    load_native_core()
    reads = []
    for path in args.bams:
        print(f"[INFO] Extracting reads from file: '{path}'",
              file=sys.stderr)
        reads.extend(extract_assembly_reads(path, reference=args.ref))
    print("[INFO] Assembling read input.", file=sys.stderr)
    if args.small:
        from ..assembly.small_assembler import (
            SmallAssemblerOptions, run_small_assembler,
        )
        _read_info, contigs = run_small_assembler(
            SmallAssemblerOptions(), reads)
    else:
        contigs, _read_info = run_iterative_assembler(
            AssemblerOptions(), reads)
    print(f"[INFO] Assembly complete. Contig count: {len(contigs)}",
          file=sys.stderr)
    with open(args.output_file, "w") as f:
        for ci, contig in enumerate(contigs):
            f.write(f">Contig{ci}\n{contig.seq}\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
