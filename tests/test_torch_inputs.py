"""The port's workflow on the inputs and options of the JAX package's
end-to-end suite (tests/test_workflow_e2e.py): --region and
--callRegions restriction, CRAM inputs, edge-chunk staging, the
semi-assembled large insertion and the small tandem duplication called
from SA splits, on the CPU (-j 2 against serial: test_torch_resume.py).

Each twin runs the port on the JAX test's input with device scoring
off, jump and exact (the plain forms of the kernels, device="cpu"),
asserts what the JAX test asserts, and holds the port's VCF body equal
to the demo oracle (somaticSV.vcf.gz) or, for the simulated inputs, to
the JAX package's body on the same files (one module-scoped run of the
JAX package with its default scoring, which is off without a TPU).
Tolerance: none, the bodies are text and equal byte for byte."""

import os

import numpy as np
import pytest

from manta_tpu.workflow.run import run_workflow as reference_run
from manta_tpu_torch.io.bam import BamReader
from manta_tpu_torch.io.bamwriter import BamWriter
from manta_tpu_torch.io.fasta import FastaReader
from manta_tpu_torch.tools import wgs_workload as W
from manta_tpu_torch.workflow.run import run_workflow

from simdata import make_insertion_dataset
from test_torch_splitscore import one_torch_thread  # noqa: F401  (autouse)
from test_torch_workflow import EXPECTED
from test_torch_workflow import _records as _body

MODES = ("off", "jump", "exact")
DEMO_REGIONS = ["8:107652000-107655000", "11:94974000-94989000"]


def _vcf(run_dir, name):
    return f"{run_dir}/results/variants/{name}"


def _port(mode, run_dir, normals, tumors, fasta, **kw):
    run_workflow(normals, tumors, fasta, str(run_dir),
                 use_device_scoring=mode, device="cpu", verbose=False, **kw)
    return str(run_dir)


def _somatic(mode, run_dir, demo_fasta, normal_bam, tumor_bam, **kw):
    _port(mode, run_dir, [normal_bam], [tumor_bam], demo_fasta,
          is_exome=True, **kw)
    return _body(_vcf(run_dir, "somaticSV.vcf.gz"))


@pytest.mark.parametrize("mode", MODES)
def test_region_restricted_matches_oracle(tmp_path, demo_fasta, normal_bam,
                                          tumor_bam, mode):
    """Twin of test_region_restricted_matches_oracle
    (tests/test_workflow_e2e.py:48): the reference demo's two --region
    restrictions with --exome."""
    got = _somatic(mode, tmp_path / "run", demo_fasta, normal_bam,
                   tumor_bam, regions=DEMO_REGIONS)
    assert got == _body(EXPECTED)


@pytest.mark.parametrize("mode", MODES)
def test_call_regions_bed_matches_oracle(tmp_path, demo_fasta, normal_bam,
                                         tumor_bam, mode):
    """Twin of test_call_regions_bed_matches_oracle
    (tests/test_workflow_e2e.py:65)."""
    bed = tmp_path / "call.bed"
    bed.write_text("track name=call\n8\t107651999\t107655000\n"
                   "11\t94973999\t94989000\n")
    got = _somatic(mode, tmp_path / "run", demo_fasta, normal_bam,
                   tumor_bam, call_regions=str(bed))
    assert got == _body(EXPECTED)


@pytest.mark.parametrize("mode", MODES)
def test_edge_chunk_staging_parity(tmp_path, demo_fasta, normal_bam,
                                   tumor_bam, monkeypatch, mode):
    """Twin of test_edge_chunk_staging_parity
    (tests/test_workflow_e2e.py:469): MANTA_TPU_EDGE_CHUNK=8 changes only
    the staging order."""
    monkeypatch.setenv("MANTA_TPU_EDGE_CHUNK", "8")
    got = _somatic(mode, tmp_path / "run", demo_fasta, normal_bam,
                   tumor_bam)
    assert got == _body(EXPECTED)


@pytest.fixture(scope="module")
def demo_crams(tmp_path_factory, demo_fasta, normal_bam, tumor_bam):
    """The demo BAMs converted losslessly to CRAM, as
    test_cram_inputs_match_oracle (tests/test_workflow_e2e.py:149) does,
    read with the port's readers."""
    from cramgen import CramRec, write_cram
    from test_cram import aux_split

    tmp = tmp_path_factory.mktemp("cram_inputs")
    ops = "MIDNSHP=X"
    crams = []
    for src_path in (normal_bam, tumor_bam):
        src = BamReader(src_path)
        b = src.read_all()
        fr = FastaReader(demo_fasta)
        ref_seqs = {tid: fr.fetch(nm, 0, fr.chrom_length(nm))
                    for tid, nm in enumerate(src.header.ref_names)
                    if nm in fr._index}
        recs = []
        for i in range(b.n):
            flag = int(b.flag[i])
            cigar = [(ops[int(c) & 0xF], int(c) >> 4)
                     for c in b.cigar_arr(i)]
            qual = bytes(b.qual_arr(i))
            if qual and qual[0] == 0xFF:
                qual = None
            mate = ("detached", int(b.next_refid[i]), int(b.next_pos[i]),
                    int(b.tlen[i])) if flag & 0x1 else None
            tags = aux_split(bytes(b.tags[b.tag_off[i]:b.tag_off[i + 1]]))
            recs.append(CramRec(
                b.name_str(i), flag, int(b.refid[i]), int(b.pos[i]),
                int(b.mapq[i]), cigar, b.seq_str(i).encode(), qual,
                tags=tags, mate=mate))
        extra = [ln for ln in src.header.text.splitlines()
                 if ln.startswith(("@RG", "@PG"))]
        out = str(tmp / os.path.basename(src_path).replace(".bam", ".cram"))
        write_cram(out, src.header.ref_names, src.header.ref_lengths,
                   ref_seqs, recs, compress="gzip", per_container=2000,
                   extra_header_lines=extra)
        crams.append(out)
    return crams


@pytest.mark.parametrize("mode", MODES)
def test_cram_inputs_match_oracle(tmp_path, demo_fasta, demo_crams, mode):
    """Twin of test_cram_inputs_match_oracle
    (tests/test_workflow_e2e.py:149)."""
    got = _somatic(mode, tmp_path / "run", demo_fasta, *demo_crams)
    assert got == _body(EXPECTED)


@pytest.fixture(scope="module")
def large_insertion(tmp_path_factory):
    d = tmp_path_factory.mktemp("large_ins")
    fa, bams, _names, ins_seq = make_insertion_dataset(d)
    ref = str(d / "reference")
    reference_run(bams, [], fa, ref, is_exome=True, verbose=False)
    return fa, bams, ins_seq, ref


@pytest.mark.parametrize("mode", MODES)
def test_large_insertion_semi_assembled(tmp_path, large_insertion, mode):
    """Twin of test_large_insertion_semi_assembled
    (tests/test_workflow_e2e.py:304): a 400 b novel insertion emitted as
    a PASS <INS> whose flanks are a prefix and a suffix of the planted
    sequence."""
    fa, bams, ins_seq, ref = large_insertion
    run_dir = _port(mode, tmp_path / "run", bams, [], fa, is_exome=True)
    records = _body(_vcf(run_dir, "diploidSV.vcf.gz"))
    assert records == _body(_vcf(ref, "diploidSV.vcf.gz"))
    ins = [r for r in records if "SVTYPE=INS" in r]
    assert ins, records
    rec = ins[0].rstrip("\n").split("\t")
    assert rec[4] == "<INS>"
    assert abs(int(rec[1]) - 10000) <= 2, rec[:2]
    assert rec[6] == "PASS", rec[6]
    info = dict(kv.split("=", 1) for kv in rec[7].split(";") if "=" in kv)
    left, right = info["LEFT_SVINSSEQ"], info["RIGHT_SVINSSEQ"]
    assert len(left) >= 20 and len(right) >= 20
    assert ins_seq.startswith(left) and ins_seq.endswith(right)


DUP_POS = 200_000


@pytest.fixture(scope="module")
def small_dup(tmp_path_factory):
    """The genome and 60x BAM of test_small_tandem_dup_called_from_sa_splits
    (tests/test_workflow_e2e.py:409), built with the port's generator
    (tools.wgs_workload) and BAM writer, and the JAX package's diploid
    body on them."""
    rng = np.random.default_rng(3)
    ref_len, dup_len = 400_000, 220
    ref = W.BASES[rng.integers(0, 4, ref_len)]
    svs = [dict(chrom_i=0, pos=DUP_POS, type="DUP", size=dup_len,
                gt="het", ins_seq=None)]
    haps = W.build_haplotypes([ref], [ref_len], svs, [])
    for dchroms in haps:
        for dc in dchroms:
            dc.names = ["chrS"]
    d = tmp_path_factory.mktemp("smalldup")
    fa, bam = str(d / "sim.fa"), str(d / "s1.bam")
    W.write_fasta(fa, ["chrS"], [ref])
    header = ("@HD\tVN:1.6\tSO:coordinate\n"
              f"@SQ\tSN:chrS\tLN:{ref_len}\n"
              "@RG\tID:rg1\tSM:S1\n")
    bw = BamWriter(bam, header, ["chrS"], [ref_len])
    W.simulate(rng, [ref], haps, W._BatchWriter(bw), depth=60, err_rate=0.0,
               noise_rate=0.0, log=lambda m: None)
    bw.close()
    reference_run([bam], [], fa, str(d / "reference"), verbose=False)
    return fa, bam, str(d / "reference")


@pytest.mark.parametrize("mode", MODES)
def test_small_tandem_dup_called_from_sa_splits(tmp_path, small_dup, mode):
    """Twin of test_small_tandem_dup_called_from_sa_splits: a ~220 bp
    tandem duplication called DUP:TANDEM, PASS, from SA split reads."""
    fa, bam, ref = small_dup
    run_dir = _port(mode, tmp_path / "run", [bam], [], fa)
    recs = _body(_vcf(run_dir, "diploidSV.vcf.gz"))
    assert recs == _body(_vcf(ref, "diploidSV.vcf.gz"))
    dups = [r.split("\t") for r in recs]
    dups = [r for r in dups if "DUP:TANDEM" in r[4]
            and abs(int(r[1]) - DUP_POS) <= 50 and r[6] == "PASS"]
    assert dups, "small tandem DUP not called from SA split evidence"
