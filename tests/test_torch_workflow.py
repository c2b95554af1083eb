"""The port's workflow (manta_tpu_torch.workflow.run) on the CPU.

The demo somatic VCF body must equal the oracle byte for byte (with
the 'mxu' split scan, ~1e-6 relative score error, at call level), and a
small WGS-shaped germline workload must give the same diploid VCF body
with the port's jump scorer and exact split scan as with the native
host paths (exact: the DP is int32, the exact scan adds float32 terms
in the native order, and the VCF is text)."""

import gzip
import os
import re
import subprocess
import sys

import pytest
import torch

from manta_tpu.workflow.run import main as reference_main
from manta_tpu_torch.align import cuda_jumpscore
from manta_tpu_torch.align import device_jumpscore as dj
from manta_tpu_torch.scoring.device_scan import SCAN_STATS, DeviceScanContext
from manta_tpu_torch.scoring.scorer import TorchSVScorer
from manta_tpu_torch.workflow import run as port

from test_torch_splitscore import one_torch_thread  # noqa: F401  (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXPECTED = os.path.join(REPO, "tests", "data", "demo", "expectedResults",
                        "somaticSV.vcf.gz")


def _records(path):
    with gzip.open(path, "rt") as f:
        return [ln for ln in f if not ln.startswith("#")]


def _no_cuda():
    if torch.cuda.device_count() > 0:
        pytest.skip("a CUDA device is present")


def _demo(run_dir, fasta, normal_bam, tumor_bam, **kw):
    port.run_workflow([normal_bam], [tumor_bam], fasta, str(run_dir),
                      is_exome=True, verbose=False, **kw)
    return _records(f"{run_dir}/results/variants/somaticSV.vcf.gz")


def test_demo_jump_on_cpu_matches_oracle(tmp_path, demo_fasta, normal_bam,
                                         tumor_bam):
    got = _demo(tmp_path / "run", demo_fasta, normal_bam, tumor_bam,
                use_device_scoring="jump", device="cpu")
    assert got == _records(EXPECTED)


def test_demo_edge_chunk_24_matches_oracle(tmp_path, demo_fasta,
                                           normal_bam, tumor_bam,
                                           monkeypatch):
    """MANTA_TPU_EDGE_CHUNK changes only the staging order (mirrors
    test_workflow_e2e.py:469-483)."""
    monkeypatch.setenv("MANTA_TPU_EDGE_CHUNK", "24")
    got = _demo(tmp_path / "run", demo_fasta, normal_bam, tumor_bam,
                use_device_scoring="jump", device="cpu")
    assert got == _records(EXPECTED)


def test_cli_demo_matches_oracle(tmp_path, demo_fasta, normal_bam,
                                 tumor_bam):
    run_dir = tmp_path / "cli"
    port.main(["--normal-bam", normal_bam, "--tumor-bam", tumor_bam,
               "--reference", demo_fasta, "--run-dir", str(run_dir),
               "--exome", "--device-scoring", "off"])
    got = _records(f"{run_dir}/results/variants/somaticSV.vcf.gz")
    assert got == _records(EXPECTED)


@pytest.fixture(scope="module")
def wgs_small(tmp_path_factory):
    """A seeded germline WGS-shaped workload (benchmarks/wgs_workload.py)
    small enough for the CPU, yet with spanning junctions that have
    several contigs, so phase 2 calls the jump scorer."""
    out = str(tmp_path_factory.mktemp("wgs") / "w")
    subprocess.run(
        [sys.executable, os.path.join(REPO, "benchmarks", "wgs_workload.py"),
         "--out", out, "--chroms", "1", "--mb", "2", "--depth", "20",
         "--seed", "7"], check=True, capture_output=True, timeout=300)
    return out


def test_wgs_jump_on_cpu_matches_native(tmp_path, wgs_small):
    bodies = {}
    for mode in ("off", "jump"):
        dj.DISPATCH_STATS["jobs"] = 0
        port.run_workflow([wgs_small + ".bam"], [], wgs_small + ".fa",
                          str(tmp_path / mode), use_device_scoring=mode,
                          device="cpu", verbose=False)
        bodies[mode] = _records(
            f"{tmp_path / mode}/results/variants/diploidSV.vcf.gz")
    assert dj.DISPATCH_STATS["jobs"] > 0
    assert bodies["jump"] == bodies["off"]
    assert len(bodies["off"]) > 10


def test_wgs_exact_on_cpu_matches_native(tmp_path, wgs_small):
    """The exact split scan (plain form on the CPU) and the jump scorer
    give the native run's diploid VCF body."""
    bodies = {}
    for mode in ("off", "exact"):
        before = SCAN_STATS["exact"]
        port.run_workflow([wgs_small + ".bam"], [], wgs_small + ".fa",
                          str(tmp_path / mode), use_device_scoring=mode,
                          device="cpu", verbose=False)
        scans = SCAN_STATS["exact"] - before
        bodies[mode] = _records(
            f"{tmp_path / mode}/results/variants/diploidSV.vcf.gz")
    assert scans > 0
    assert bodies["exact"] == bodies["off"]
    assert len(bodies["off"]) > 10


def test_jump_without_cuda_raises(tmp_path, demo_fasta, normal_bam,
                                  tumor_bam):
    _no_cuda()
    launches = cuda_jumpscore.KERNEL_LAUNCHES["jump_score"]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _demo(tmp_path / "run", demo_fasta, normal_bam, tumor_bam,
              use_device_scoring="jump")
    assert cuda_jumpscore.KERNEL_LAUNCHES["jump_score"] == launches


@pytest.mark.parametrize("mode", ("exact", "mxu"))
def test_split_scan_modes_without_cuda_raise(tmp_path, demo_fasta,
                                             normal_bam, tumor_bam, mode):
    _no_cuda()
    assert port.resolve_device(mode, "cpu") == torch.device("cpu")
    before = dict(SCAN_STATS)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _demo(tmp_path / "run", demo_fasta, normal_bam, tumor_bam,
              use_device_scoring=mode)
    assert SCAN_STATS == before


def test_auto_resolves_off_without_cuda():
    _no_cuda()
    assert port.resolve_device_scoring("auto") is None
    assert port.resolve_device(None, None) is None
    assert port.resolve_device_scoring("jump") == "jump"
    assert port.resolve_device("jump", "cpu") == torch.device("cpu")


def _calls(line):
    """The call-level fields of a VCF record: CHROM POS REF ALT FILTER,
    and GT and SOMATICSCORE."""
    f = line.rstrip("\n").split("\t")
    info = dict(kv.partition("=")[::2] for kv in f[7].split(";"))
    gts = [s.split(":")[0] for s in f[9:]]
    return (f[0], f[1], f[3], f[4], f[6], info.get("SOMATICSCORE"), gts)


@pytest.mark.parametrize("mode", ("exact", "mxu"))
def test_demo_split_scan_modes_on_cpu(tmp_path, demo_fasta, normal_bam,
                                      tumor_bam, mode):
    """'exact' gives the oracle byte for byte; 'mxu' (~1e-6 relative
    score error) gives it at call level. Both run the port's split scan
    on the CPU."""
    route = "exact" if mode == "exact" else "mxu"
    before = SCAN_STATS[route]
    got = _demo(tmp_path / "run", demo_fasta, normal_bam, tumor_bam,
                use_device_scoring=mode, device="cpu")
    assert SCAN_STATS[route] > before
    want = _records(EXPECTED)
    if mode == "exact":
        assert got == want
    else:
        assert [_calls(ln) for ln in got] == [_calls(ln) for ln in want]


def test_torch_scorer_binds_the_ports_split_scan():
    for mode in ("exact", "mxu", True):
        sc = TorchSVScorer(None, [], [], None, use_device_scoring=mode,
                           device="cpu")
        assert isinstance(sc._device_scan, DeviceScanContext)
        assert sc._device_scan._mxu == (mode == "mxu")
        assert sc._device_scan.device == torch.device("cpu")
    for mode in ("jump", None, False):
        assert TorchSVScorer(None, [], [], None, use_device_scoring=mode,
                             device="cpu")._device_scan is None
    with pytest.raises(ValueError, match="needs a device"):
        TorchSVScorer(None, [], [], None, use_device_scoring="exact")


def _options(main, capsys):
    with pytest.raises(SystemExit):
        main(["--help"])
    text = capsys.readouterr().out
    return set(re.findall(r"(?<![\w-])(--?[a-z][a-z-]*)", text))


def test_cli_options_match_reference(capsys):
    ours = _options(port.main, capsys)
    assert ours == _options(reference_main, capsys)
    assert {"--device-scoring", "--normal-bam", "-j", "--rescore"} <= ours
