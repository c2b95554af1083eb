"""The port's user tools (manta_tpu_torch.tools.convert_inversion,
denovo_scoring, svloci) against manta_tpu's, on the cases of
tests/test_tools.py: the same input through both packages gives the
same output, and the port's passes that test's checks."""

import io
import os
import subprocess
import sys

import pytest

from manta_tpu.tools import convert_inversion as ref_inversion
from manta_tpu.tools import denovo_scoring as ref_denovo
from manta_tpu_torch.tools.convert_inversion import convert_inversions
from manta_tpu_torch.tools.denovo_scoring import check_genotype, process_vcf

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
R8 = "8:107600000-107700000"
R11 = "11:94900000-95050000"


def test_convert_inversion_inv3_pair(tmp_path, demo_fasta):
    # self-contained same-chromosome INV3 BND pair
    hdr = ("##fileformat=VCFv4.1\n"
           "##FORMAT=<ID=GT,Number=1,Type=String,Description=\"x\">\n"
           "##ALT=<ID=DEL,Description=\"Deletion\">\n"
           "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\tS\n")
    b1 = ("11\t1000\tMantaBND:0:1:2:0:0:0:0\tT\tT]11:2000]\t30\tPASS\t"
          "SVTYPE=BND;MATEID=MantaBND:0:1:2:0:0:0:1;CIPOS=0,2;HOMLEN=2;"
          "HOMSEQ=AT;BND_DEPTH=5\tGT\t0/1\n")
    b2 = ("11\t2000\tMantaBND:0:1:2:0:0:0:1\tA\tA]11:1000]\t30\tPASS\t"
          "SVTYPE=BND;MATEID=MantaBND:0:1:2:0:0:0:0;CIPOS=0,2;HOMLEN=2;"
          "HOMSEQ=GC;BND_DEPTH=5\tGT\t0/1\n")
    vcf = tmp_path / "t.vcf"
    vcf.write_text(hdr + b1 + b2)
    out, want = io.StringIO(), io.StringIO()
    convert_inversions(demo_fasta, str(vcf), out=out)
    ref_inversion.convert_inversions(demo_fasta, str(vcf), out=want)
    assert out.getvalue() == want.getvalue()
    lines = out.getvalue().splitlines()
    recs = [ln for ln in lines if not ln.startswith("#")]
    assert len(recs) == 1
    w = recs[0].split("\t")
    assert w[2] == "MantaINV:0:1:2:0:0:0"
    assert w[4] == "<INV>"
    assert "END=2000" in w[7] and "SVTYPE=INV" in w[7]
    assert "SVLEN=1000" in w[7] and "INV3" in w[7]
    assert "CIEND=-2,0" in w[7]
    assert "MATEID" not in w[7] and "BND_DEPTH" not in w[7]
    # INV3/INV5 header lines added before ##ALT / after ##FORMAT
    assert any(ln.startswith("##INFO=<ID=INV3") for ln in lines)
    assert any(ln.startswith("##ALT=<ID=INV") for ln in lines)


def test_check_genotype():
    gts = ("0/0", "0/1", "1/1", "./.", "0|1", "1")
    for kid in gts:
        for dad in gts:
            for mom in gts:
                assert check_genotype(kid, dad, mom) == \
                    ref_denovo.check_genotype(kid, dad, mom), (kid, dad, mom)
    assert check_genotype("0/1", "0/0", "1/1")
    assert check_genotype("0/1", "0/1", "0/0")
    assert not check_genotype("1/1", "0/0", "0/0")
    assert not check_genotype("0/1", "0/0", "0/0")


def test_denovo_scoring(tmp_path):
    hdr = ("##fileformat=VCFv4.1\n"
           "##FORMAT=<ID=GT,Number=1,Type=String,Description=\"x\">\n"
           "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\t"
           "KID\tDAD\tMOM\n")
    ok = "1\t100\tV1\tT\t<DEL>\t30\tPASS\tSVTYPE=DEL\tGT\t0/1\t0/1\t0/0\n"
    dn = "1\t200\tV2\tT\t<DEL>\t30\tPASS\tSVTYPE=DEL\tGT\t0/1\t0/0\t0/0\n"
    bad = "1\t300\tV3\tT\t<DEL>\t30\tMinQUAL\tSVTYPE=DEL\tGT\t1/1\t0/0\t0/0\n"
    written = {}
    for name, fn in (("port", process_vcf), ("ref", ref_denovo.process_vcf)):
        (tmp_path / name).mkdir()
        vcf = tmp_path / name / "trio.vcf"
        vcf.write_text(hdr + ok + dn + bad)
        written[name] = [open(p).read() for p in fn(str(vcf), "KID", "DAD",
                                                     "MOM")]
    assert written["port"] == written["ref"]
    out, stats = written["port"]
    recs = [ln for ln in out.splitlines() if not ln.startswith("#")]
    assert recs[0].split("\t")[9] == "0/1:0"
    assert recs[0].split("\t")[10] == "0/1:."
    assert recs[1].split("\t")[9] == "0/1:60"
    assert "# of passed SVs: 1" in stats
    assert "# of filtered SVs: 1" in stats
    assert "0/1-0/0-0/0\t1" in stats


def _cli(package, *argv):
    proc = subprocess.run([sys.executable, "-m", f"{package}.tools.{argv[0]}",
                           *argv[1:]], capture_output=True, text=True,
                          timeout=300, cwd=REPO)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return proc.stdout


@pytest.fixture(scope="module")
def demo_graph(tmp_path_factory, demo_fasta, normal_bam, tumor_bam):
    """A breakend graph of the demo's two regions, made by the port's
    phase workers."""
    d = tmp_path_factory.mktemp("graph")
    _cli("manta_tpu_torch", "workers", "get-stats", "--align-file",
         normal_bam, "--align-file", tumor_bam, "--output-file",
         str(d / "stats.json"))
    _cli("manta_tpu_torch", "workers", "estimate-loci", "--align-file",
         normal_bam, "--align-file", tumor_bam, "--tumor-index", "1",
         "--align-stats", str(d / "stats.json"), "--ref", demo_fasta,
         "--region", R8, "--region", R11, "--output-file",
         str(d / "graph.npz"))
    return d / "graph.npz"


def test_svloci_cli_roundtrip(tmp_path, demo_graph):
    """check, dump (whole graph, one locus, a region) and summarize give
    the JAX package's output on the same graph."""
    got = {}
    for package in ("manta_tpu_torch", "manta_tpu"):
        summary = tmp_path / f"{package}.tsv"
        got[package] = [
            _cli(package, "svloci", "check", "--graph-file", str(demo_graph)),
            _cli(package, "svloci", "dump", "--graph-file", str(demo_graph)),
            _cli(package, "svloci", "dump", "--graph-file", str(demo_graph),
                 "--locus-index", "0"),
            _cli(package, "svloci", "dump", "--graph-file", str(demo_graph),
                 "--region", R8),
            _cli(package, "svloci", "summarize", "--graph-file",
                 str(demo_graph), "--output-file", str(summary))
            + summary.read_text()]
    assert got["manta_tpu_torch"] == got["manta_tpu"]
    check, dump, one, region, summary = got["manta_tpu_torch"]
    assert check.startswith("graph OK: ") and not check.startswith(
        "graph OK: 0 loci")
    assert dump.count("LOCUS BEGIN") >= 1 and "EdgeTo" in dump
    assert one.startswith("LOCUS BEGIN INDEX 0")
    assert region.count("LOCUS BEGIN") >= 1 and summary


@pytest.mark.parametrize("small", (True, False))
def test_assembler_cli_matches_reference(tmp_path, demo_fasta, normal_bam,
                                         small):
    """python -m ...tools.test_assembler, the legacy SmallAssembler
    (--small) and the iterative one, on the demo normal BAM: the same
    contigs as the JAX package's tool."""
    got = {}
    for package in ("manta_tpu_torch", "manta_tpu"):
        out = tmp_path / f"{package}.fa"
        _cli(package, "test_assembler", "--align-file", normal_bam, "--ref",
             demo_fasta, "--output-file", str(out),
             *(["--small"] if small else []))
        got[package] = out.read_text()
    assert got["manta_tpu_torch"] == got["manta_tpu"]
    assert got["manta_tpu_torch"].startswith(">Contig0\n")


def test_inversion_and_denovo_command_lines(tmp_path, demo_fasta):
    """Both command lines run, print their usage without arguments, and
    write what the JAX package's do."""
    vcf = tmp_path / "trio.vcf"
    vcf.write_text(
        "##fileformat=VCFv4.1\n"
        "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\tKID\tDAD\t"
        "MOM\n"
        "11\t1000\tMantaBND:0:1:2:0:0:0:0\tT\tT]11:2000]\t30\tPASS\t"
        "SVTYPE=BND;MATEID=MantaBND:0:1:2:0:0:0:1\tGT\t0/1\t0/0\t0/0\n"
        "11\t2000\tMantaBND:0:1:2:0:0:0:1\tA\tA]11:1000]\t30\tPASS\t"
        "SVTYPE=BND;MATEID=MantaBND:0:1:2:0:0:0:0\tGT\t0/1\t0/0\t0/0\n")
    for tool in ("convert_inversion", "denovo_scoring"):
        proc = subprocess.run(
            [sys.executable, "-m", f"manta_tpu_torch.tools.{tool}"],
            capture_output=True, text=True, timeout=300, cwd=REPO)
        assert proc.returncode == 1
        assert f"python -m manta_tpu_torch.tools.{tool}" in proc.stderr
    inv = {p: _cli(p, "convert_inversion", demo_fasta, str(vcf))
           for p in ("manta_tpu_torch", "manta_tpu")}
    assert inv["manta_tpu_torch"] == inv["manta_tpu"]
    assert "<INV>" in inv["manta_tpu_torch"]
    written = {}
    for package in ("manta_tpu_torch", "manta_tpu"):
        _cli(package, "denovo_scoring", str(vcf), "KID", "DAD", "MOM")
        written[package] = {p: (tmp_path / p).read_text()
                            for p in ("trio.de_novo.vcf",
                                      "trio.de_novo.stats.txt")}
    assert written["manta_tpu_torch"] == written["manta_tpu"]
    assert "# of passed SVs: 2" in \
        written["manta_tpu_torch"]["trio.de_novo.stats.txt"]
