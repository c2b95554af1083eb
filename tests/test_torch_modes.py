"""The port's workflow in the calling modes of the JAX package's
end-to-end suite (tests/test_workflow_e2e.py) beyond demo somatic: RNA
fusion, tumor-only and joint germline at 2, 5 and 10 samples, on the
CPU.

Each twin runs the port's run_workflow on the JAX test's input with
device scoring off (the native host paths), jump (the plain form of the
jump kernel) and exact (the plain form of the split-scan kernel), all
with device="cpu"; it asserts what the JAX test asserts, and that the
port's VCF body equals the JAX package's on the same input (one
module-scoped run of the JAX package a configuration, with its default
scoring, which is off without a TPU). Tolerance: none, the bodies are
text and equal byte for byte.

The last test holds the port's split-scan router at RNA's target
length: the refiner widens RNA reference windows by 25,000 bases a side
(candidates/refiner.py), so the scorer scans split reads against
targets of about 50,400 bases, scan tier 57,344."""

import gzip

import numpy as np
import pytest

from manta_tpu.scoring.device_scan import (
    DeviceScanContext as JaxDeviceScanContext,
)
from manta_tpu.workflow.run import run_workflow as reference_run
from manta_tpu_torch.io.bam import BamReader
from manta_tpu_torch.io.fasta import FastaReader
from manta_tpu_torch.scoring import device_scan
from manta_tpu_torch.scoring.evidence import QscoreSnp, split_read_scan_multi
from manta_tpu_torch.workflow.run import run_workflow

from simdata import make_deletion_dataset, make_fusion_dataset
from test_torch_splitscore import one_torch_thread  # noqa: F401  (autouse)
from test_torch_workflow import _records as _body

MODES = ("off", "jump", "exact")


def _lines(path):
    with gzip.open(path, "rt") as f:
        return f.readlines()


def _columns(path):
    header = next(ln for ln in _lines(path) if ln.startswith("#CHROM"))
    return header.rstrip("\n").split("\t")[9:]


def _vcf(run_dir, name):
    return f"{run_dir}/results/variants/{name}"


def _port(mode, run_dir, normals, tumors, fasta, **kw):
    run_workflow(normals, tumors, fasta, str(run_dir),
                 use_device_scoring=mode, device="cpu", verbose=False, **kw)
    return str(run_dir)


def _reference(run_dir, normals, tumors, fasta, **kw):
    reference_run(normals, tumors, fasta, str(run_dir), verbose=False, **kw)
    return str(run_dir)


# -- RNA fusion mode ------------------------------------------------------

@pytest.fixture(scope="module")
def rna_demo_reference(tmp_path_factory, demo_fasta, tumor_bam):
    return _reference(tmp_path_factory.mktemp("rna_ref"), [tumor_bam], [],
                      demo_fasta, is_rna=True)


@pytest.mark.parametrize("mode", ("off", "jump"))
def test_rna_mode_smoke(tmp_path, demo_fasta, tumor_bam, rna_demo_reference,
                        mode):
    """Twin of test_rna_mode_smoke (tests/test_workflow_e2e.py:126).

    No 'exact' here: in RNA mode the split scan runs against ~50 kb
    targets (scan tier 57,344), which the plain form takes minutes over
    on the CPU for the demo's calls of 109-678 reads, and the JAX
    package's XLA exact form runs out of memory on them (159.6 GB asked
    for one call). test_rna_split_scan_router_at_rna_length holds the
    exact route at that length instead, and the fusion twin below runs
    exact end to end."""
    run_dir = _port(mode, tmp_path / "run", [tumor_bam], [], demo_fasta,
                    is_rna=True)
    recs = _body(_vcf(run_dir, "rnaSV.vcf.gz"))
    assert len(recs) >= 4
    assert any("RNA_CONTIG=" in r for r in recs)
    assert any("RNA_FIRST" in r for r in recs)
    assert recs == _body(_vcf(rna_demo_reference, "rnaSV.vcf.gz"))


@pytest.fixture(scope="module")
def fusion(tmp_path_factory):
    d = tmp_path_factory.mktemp("rna_fusion")
    fa, bam, junction = make_fusion_dataset(d)
    ref = _reference(d / "reference", [bam], [], fa, is_rna=True)
    return fa, bam, junction, ref


def _info(rec):
    return dict(kv.split("=", 1) for kv in rec[7].split(";") if "=" in kv)


@pytest.mark.parametrize("mode", MODES)
def test_rna_fusion_e2e(tmp_path, fusion, mode):
    """Twin of test_rna_fusion_e2e (tests/test_workflow_e2e.py:337)."""
    fa, bam, (c1, p1, c2, p2), ref = fusion
    run_dir = _port(mode, tmp_path / "run", [bam], [], fa, is_rna=True)
    body = _body(_vcf(run_dir, "rnaSV.vcf.gz"))
    assert body == _body(_vcf(ref, "rnaSV.vcf.gz"))
    records = [ln.rstrip("\n").split("\t") for ln in body]
    assert len(records) == 2, records
    by_chrom = {r[0]: r for r in records}
    ra, rb = by_chrom[c1], by_chrom[c2]
    assert int(ra[1]) == p1 and abs(int(rb[1]) - p2) <= 1
    assert ra[6] == "PASS" and rb[6] == "PASS"
    ia, ib = _info(ra), _info(rb)
    assert ia["MATEID"] == rb[2] and ib["MATEID"] == ra[2]
    assert "RNA_FIRST" in ra[7] and "RNA_FIRST" not in rb[7]
    support = dict(zip(ra[8].split(":"), ra[9].split(":")))
    assert int(support["PR"].split(",")[1]) > 10
    assert int(support["SR"].split(",")[1]) > 10


# -- tumor-only -----------------------------------------------------------

@pytest.fixture(scope="module")
def tumor_only_reference(tmp_path_factory, demo_fasta, tumor_bam):
    return _reference(tmp_path_factory.mktemp("tumor_only_ref"), [],
                      [tumor_bam], demo_fasta, is_exome=True)


@pytest.mark.parametrize("mode", MODES)
def test_tumor_only_mode_smoke(tmp_path, demo_fasta, tumor_bam,
                               tumor_only_reference, mode):
    """Twin of test_tumor_only_mode_smoke (tests/test_workflow_e2e.py:138)."""
    run_dir = _port(mode, tmp_path / "run", [], [tumor_bam], demo_fasta,
                    is_exome=True)
    recs = _body(_vcf(run_dir, "tumorSV.vcf.gz"))
    assert len(recs) >= 4
    assert all("PR:" in r.split("\t")[8] or r.split("\t")[8] == "PR"
               for r in recs)
    assert recs == _body(_vcf(tumor_only_reference, "tumorSV.vcf.gz"))


# -- joint germline -------------------------------------------------------

@pytest.fixture(scope="module")
def joint2_reference(tmp_path_factory, demo_fasta, normal_bam, tumor_bam):
    return _reference(tmp_path_factory.mktemp("joint_ref"),
                      [normal_bam, tumor_bam], [], demo_fasta, is_exome=True)


@pytest.mark.parametrize("mode", MODES)
def test_joint_multi_sample_germline(tmp_path, demo_fasta, normal_bam,
                                     tumor_bam, joint2_reference, mode):
    """Twin of test_joint_multi_sample_germline
    (tests/test_workflow_e2e.py:203)."""
    run_dir = _port(mode, tmp_path / "run", [normal_bam, tumor_bam], [],
                    demo_fasta, is_exome=True)
    diploid = _vcf(run_dir, "diploidSV.vcf.gz")
    assert _columns(diploid) == ["HCC1954_BL", "HCC1954"]
    assert len(_body(_vcf(run_dir, "candidateSV.vcf.gz"))) == 6
    for name in ("diploidSV.vcf.gz", "candidateSV.vcf.gz"):
        assert _body(_vcf(run_dir, name)) == \
            _body(_vcf(joint2_reference, name)), name
    assert _columns(diploid) == \
        _columns(_vcf(joint2_reference, "diploidSV.vcf.gz"))


# (samples, carriers): the JAX tests' datasets, copies of the deletion
# per sample (0/0, 0/1, 1/1)
JOINT = {5: (1, 1, 1, 0, 0), 10: (1, 1, 2, 0, 0, 1, 2, 0, 1, 0)}


@pytest.fixture(scope="module", params=sorted(JOINT))
def joint(request, tmp_path_factory):
    n = request.param
    d = tmp_path_factory.mktemp(f"joint{n}")
    carriers = JOINT[n]
    kw = {} if n == 5 else {"carriers": carriers}
    fa, bams, names = make_deletion_dataset(d, **kw)
    assert len(bams) == n
    ref = _reference(d / "reference", bams, [], fa, is_exome=True)
    return n, carriers, fa, bams, names, ref


@pytest.mark.parametrize("mode", MODES)
def test_joint_germline_genotypes(tmp_path, joint, mode):
    """Twins of test_five_sample_joint_germline_genotypes and
    test_ten_sample_joint_germline_genotypes
    (tests/test_workflow_e2e.py:238, :271): a 500 b deletion, each
    sample's genotype as planted."""
    n, carriers, fa, bams, names, ref = joint
    run_dir = _port(mode, tmp_path / "run", bams, [], fa, is_exome=True)
    diploid = _vcf(run_dir, "diploidSV.vcf.gz")
    assert _columns(diploid) == names
    assert _columns(diploid) == _columns(_vcf(ref, "diploidSV.vcf.gz"))
    records = _body(diploid)
    assert records == _body(_vcf(ref, "diploidSV.vcf.gz"))
    dels = [r for r in records if "SVTYPE=DEL" in r]
    assert dels, f"no deletion called: {records}"
    rec = dels[0].rstrip("\n").split("\t")
    assert abs(int(rec[1]) - 10000) < 50, rec[:8]
    gt_i = rec[8].split(":").index("GT")
    gts = [rec[9 + si].split(":")[gt_i] for si in range(n)]
    want = {0: "0/0", 1: "0/1", 2: "1/1"}
    assert gts == [want[c] for c in carriers], gts


# -- the split-scan router at RNA's target length -------------------------

RNA_FLANK = 25_000          # the refiner's RNA window widening a side
RNA_READS = 12
JAX_READS = 2               # its exact form gathers (rows, 57,344, 256)


def _rna_length_call(demo_fasta, tumor_bam):
    """A split scan as RNA mode hands it to the router: demo tumor reads
    of 8:107652000-107655000 against two 50,400-base targets of the demo
    reference, one around those reads (they score there) and one on
    chromosome 11, each with a breakend range at its middle."""
    batch = BamReader(tumor_bam).fetch("8", 107652000, 107655000)
    fasta = FastaReader(demo_fasta)
    targets, ranges = [], []
    for chrom, centre, micro in (("8", 107653500, 0), ("11", 94981000, 4)):
        seq = fasta.fetch(chrom, centre - RNA_FLANK - 200,
                          centre + RNA_FLANK + 200)
        targets.append(np.frombuffer(seq, np.uint8).copy())
        mid = len(seq) // 2
        ranges.append((mid, mid + micro))
    step = batch.n // RNA_READS
    read_idx = np.arange(RNA_READS, dtype=np.int64) * step
    return batch, read_idx, targets, ranges


def test_rna_split_scan_router_at_rna_length(demo_fasta, tumor_bam):
    """The port's DeviceScanContext.scan_multi on the CPU (the plain form
    of the split-scan kernel) at scan tier 57,344: winners and
    ln-likelihoods bit-identical to the native host scan on 12 reads,
    and to the JAX package's exact XLA route on 2 (its (rows, n_scan,
    read tier) gather takes ~470 MB there)."""
    batch, read_idx, targets, ranges = _rna_length_call(demo_fasta,
                                                        tumor_bam)
    assert [len(t) for t in targets] == [50_400, 50_400]
    assert device_scan._bucket(max(map(len, targets)) + 1) == 57_344
    qconv = QscoreSnp(1e-3)
    ctx = device_scan.DeviceScanContext(device="cpu")
    before = device_scan.SCAN_STATS["exact"]
    best, pos = ctx.scan_multi(50, batch, read_idx, qconv, targets, ranges)
    assert device_scan.SCAN_STATS["exact"] == before + 1
    native_b, native_p = split_read_scan_multi(50, batch, read_idx, qconv,
                                               targets, ranges)
    assert best.shape == pos.shape == (RNA_READS, 2)
    assert np.array_equal(best, native_b) and np.array_equal(pos, native_p)
    assert np.isfinite(best).all()
    # the reads lie in the first target: some score better there
    assert (best[:, 0] > best[:, 1]).any()
    few = read_idx[:JAX_READS]
    jb, jp = JaxDeviceScanContext().scan_multi(50, batch, few, qconv,
                                               targets, ranges)
    assert np.array_equal(jb, best[:JAX_READS])
    assert np.array_equal(jp, pos[:JAX_READS])
