"""The port's chromosome depth estimate (manta_tpu_torch.core.chromdepth)
vs manta_tpu.core.chromdepth, serial and forked.

The per-chromosome estimate is the JAX package's own, so the dicts must
be equal exactly, at every n_jobs, with and without JAX importable."""

import json
import os
import subprocess
import sys

import pytest

from manta_tpu.core.chromdepth import (
    estimate_chrom_depths as reference_estimate, parse_chrom_depth,
)
from manta_tpu_torch.core.chromdepth import estimate_chrom_depths
from manta_tpu_torch.workflow import run as port

from test_torch_nojax import _PRELUDE

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def wgs_two_chroms(tmp_path_factory):
    """A seeded germline workload with two chromosomes (the port's own
    generator, python -m manta_tpu_torch.tools.wgs_workload), so the
    fan-out has several jobs."""
    out = str(tmp_path_factory.mktemp("wgs2") / "w")
    subprocess.run(
        [sys.executable, "-m", "manta_tpu_torch.tools.wgs_workload",
         "--out", out, "--chroms", "2", "--mb", "1", "--depth", "10",
         "--seed", "7"], check=True, capture_output=True, timeout=300,
        cwd=REPO)
    return out


@pytest.fixture(params=("demo", "wgs"))
def depth_inputs(request, normal_bam, tumor_bam, demo_fasta):
    """(BAM paths, reference): the demo pair (two contigs each) or the
    two-chromosome workload."""
    if request.param == "demo":
        return [normal_bam, tumor_bam], demo_fasta
    w = request.getfixturevalue("wgs_two_chroms")
    return [w + ".bam"], w + ".fa"


def test_forked_estimate_matches_reference(depth_inputs):
    bams, fasta = depth_inputs
    got = estimate_chrom_depths(bams, reference=fasta, n_jobs=2)
    serial = reference_estimate(bams, reference=fasta, n_jobs=1)
    assert got == serial
    assert got == reference_estimate(bams, reference=fasta, n_jobs=2)
    assert len(got) >= 2 and all(v > 0 for v in got.values())


def test_forked_estimate_more_jobs_than_chromosomes(depth_inputs):
    bams, fasta = depth_inputs
    assert estimate_chrom_depths(bams, reference=fasta, n_jobs=5) == \
        estimate_chrom_depths(bams, reference=fasta, n_jobs=1)


_ESTIMATE = r"""
bams, fasta = sys.argv[2].split(","), sys.argv[3]
from manta_tpu_torch.core.chromdepth import estimate_chrom_depths
got = estimate_chrom_depths(bams, reference=fasta, n_jobs=2)
print(json.dumps({"got": got,
                  "jax": [m for m in sys.modules if m.startswith("jax")]}))
"""


def test_forked_estimate_without_jax(depth_inputs):
    bams, fasta = depth_inputs
    proc = subprocess.run(
        [sys.executable, "-c", _PRELUDE + _ESTIMATE, REPO, ",".join(bams),
         fasta], capture_output=True, text=True, timeout=300, cwd=REPO)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["jax"] == []
    assert out["got"] == reference_estimate(bams, reference=fasta, n_jobs=1)


def test_workflow_j2_writes_the_serial_chrom_depth(tmp_path, wgs_two_chroms):
    """Phase 0 at -j 2 runs the forked estimate and writes the file the
    serial run writes."""
    texts = {}
    for jobs in (1, 2):
        run_dir = tmp_path / f"j{jobs}"
        port.run_workflow([wgs_two_chroms + ".bam"], [],
                          wgs_two_chroms + ".fa", str(run_dir),
                          use_device_scoring="off", n_jobs=jobs,
                          stop_after="graph", verbose=False)
        path = run_dir / "workspace" / "chromDepth.txt"
        texts[jobs] = path.read_text()
        assert parse_chrom_depth(str(path)) == reference_estimate(
            [wgs_two_chroms + ".bam"], reference=wgs_two_chroms + ".fa")
    assert texts[2] == texts[1]
    assert len(texts[1].splitlines()) == 2
