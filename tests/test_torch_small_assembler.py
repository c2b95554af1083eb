"""The port's legacy SmallAssembler (manta_tpu_torch.assembly.small_assembler)
against manta_tpu's, on the golden cases of tests/test_small_assembler.py
(reference: src/c++/lib/assembly/test/SmallAssemblerTest.cpp).

Each case runs both packages on the same reads: every read's info and
every contig (sequence, support, conservative range) must be equal, and
the port's result must pass the golden checks of the JAX package's
test."""

from dataclasses import asdict

from manta_tpu.assembly import small_assembler as reference
from manta_tpu_torch.assembly.small_assembler import (
    SmallAssemblerOptions, run_small_assembler,
)


def _opt(options=SmallAssemblerOptions):
    return options(min_word_length=6, max_word_length=6, min_coverage=2,
                   min_seed_reads=3)


def _assemble(reads):
    """The port's (read_info, contigs), after checking them against the
    JAX package's on the same reads."""
    read_info, contigs = run_small_assembler(_opt(), reads)
    want_info, want_contigs = reference.run_small_assembler(
        _opt(reference.SmallAssemblerOptions), reads)
    assert [asdict(r) for r in read_info] == [asdict(r) for r in want_info]
    assert [asdict(c) for c in contigs] == [asdict(c) for c in want_contigs]
    return read_info, contigs


def test_small_assembler_basic():
    reads = ["ACGTGTATTACC", "GTGTATTACCTA", "ATTACCTAGTAC", "TACCTAGTACTC",
             "123456789123"]
    read_info, contigs = _assemble(reads)
    assert len(contigs) == 1
    assert contigs[0].seq == "GTGTATTACCTAGTAC"
    for i in range(4):
        assert read_info[i].is_used
        assert read_info[i].contig_ids[0] == 0
    assert not read_info[4].is_used


def test_poison_read():
    # a single low-complexity read must not kill the whole assembly
    reads = ["ACGTGTATTACC", "GTGTATTACCTA", "ATTACCTAGTAC", "TACCTAGTACTC",
             "AAAAAAAAAAAAAAAAAAAA"]
    read_info, contigs = _assemble(reads)
    assert len(contigs) == 1
    assert contigs[0].seq == "GTGTATTACCTAGTAC"
    for i in range(4):
        assert read_info[i].is_used
        assert read_info[i].contig_ids[0] == 0
    assert read_info[4].is_used
    assert read_info[4].is_filtered
    assert read_info[4].contig_ids == []


def test_supporting_read_consistency():
    # ACGTG must not extend left to AACGTG using reads whose suffix
    # after ACGTG differs (GCC); they form their own second contig
    reads = ["AAACGTGTATTA", "ACGTGTATTACC", "CGTGTATTACCT", "GTGTATTACCTA",
             "ATTACCTAGTAC", "TACCTAGTACTC", "CCCTTAGCTAAC", "CTTAGCTAACGT",
             "TAGCTAACGTGG", "GCTAACGTGGCC", "AACGTGGCCTAG"]
    read_info, contigs = _assemble(reads)
    assert len(contigs) == 2
    assert contigs[0].seq == "AACGTGTATTACCTAGTAC"
    assert contigs[1].seq == "CTTAGCTAACGTGGCC"
    for i in range(6):
        assert read_info[i].is_used
        assert read_info[i].contig_ids[0] == 0
    for i in range(6, 11):
        assert read_info[i].is_used
        assert read_info[i].contig_ids[0] == 1


def test_conservative_range():
    # with min_conservative_coverage=2, single-read overhangs at the
    # contig ends are excluded from the conservative sub-range
    reads = ["ACGTGTATTACC", "GTGTATTACCTA", "ATTACCTAGTAC", "TACCTAGTACTC"]
    _read_info, contigs = _assemble(reads)
    assert len(contigs) == 1
    c = contigs[0]
    assert 0 <= c.conservative_beg <= c.conservative_end <= len(c.seq)


def test_below_seed_reads_no_assembly():
    read_info, contigs = _assemble(["ACGTGTATTACC", "GTGTATTACCTA"])
    assert contigs == []
    assert not any(ri.is_used for ri in read_info)
