"""The port's phase-worker CLI (python -m manta_tpu_torch.tools.workers)
against manta_tpu's, on the cases of tests/test_workers_cli.py:
scatter/gather must reproduce the one-shot result exactly, and every
artifact must equal the JAX package's workers' on the same input
(reference: GetAlignmentStats / MergeAlignmentStats / EstimateSVLoci /
MergeSVLoci / GetChromDepth, scheduled by mantaWorkflow.py)."""

import json
import os
import subprocess
import sys

import numpy as np

from manta_tpu_torch.core.chromdepth import (
    estimate_chrom_depths, parse_chrom_depth,
)
from manta_tpu_torch.graph.locusgraph import SVLocusSet

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
R8 = "8:107600000-107700000"
R11 = "11:94900000-95050000"


def _worker(*argv, package="manta_tpu_torch"):
    subprocess.run([sys.executable, "-m", f"{package}.tools.workers", *argv],
                   check=True, capture_output=True, timeout=300, cwd=REPO)


def _reference(*argv):
    _worker(*argv, package="manta_tpu")


def _npz_equal(a_path, b_path):
    a, b = np.load(a_path, allow_pickle=True), \
        np.load(b_path, allow_pickle=True)
    if sorted(a.files) != sorted(b.files):
        return False
    for k in a.files:
        va, vb = a[k], b[k]
        if va.dtype == object or vb.dtype == object:
            if str(va.tolist()) != str(vb.tolist()):
                return False
        elif not np.array_equal(va, vb):
            return False
    return True


def _json(path):
    with open(path) as f:
        return json.load(f)


def test_workers_scatter_gather_parity(tmp_path, demo_fasta, normal_bam,
                                       tumor_bam):
    d = tmp_path
    # phase 0: per-host stats scatter + merge vs one-shot
    _worker("get-stats", "--align-file", normal_bam,
            "--output-file", str(d / "s0.json"))
    _worker("get-stats", "--align-file", tumor_bam,
            "--output-file", str(d / "s1.json"))
    _worker("merge-stats", "--align-stats-file", str(d / "s0.json"),
            "--align-stats-file", str(d / "s1.json"),
            "--output-file", str(d / "merged.json"))
    _worker("get-stats", "--align-file", normal_bam,
            "--align-file", tumor_bam,
            "--output-file", str(d / "oneshot.json"))
    _reference("get-stats", "--align-file", normal_bam,
               "--align-file", tumor_bam,
               "--output-file", str(d / "reference.json"))
    assert _json(d / "merged.json") == _json(d / "oneshot.json") \
        == _json(d / "reference.json")

    _worker("summarize-stats", "--stats-file", str(d / "merged.json"),
            "--output-file", str(d / "summary.txt"))
    _reference("summarize-stats", "--stats-file", str(d / "merged.json"),
               "--output-file", str(d / "reference.txt"))
    summary = (d / "summary.txt").read_text()
    assert summary and summary == (d / "reference.txt").read_text()

    # phase 1: per-region graph scatter + merge vs one-shot
    common = ["--align-file", normal_bam, "--align-file", tumor_bam,
              "--tumor-index", "1", "--align-stats",
              str(d / "merged.json"), "--ref", demo_fasta]
    _worker("estimate-loci", *common, "--region", R8,
            "--output-file", str(d / "g8.npz"))
    _worker("estimate-loci", *common, "--region", R11,
            "--output-file", str(d / "g11.npz"))
    _worker("merge-loci", "--graph-file", str(d / "g8.npz"),
            "--graph-file", str(d / "g11.npz"),
            "--output-file", str(d / "scatter.npz"))
    _worker("estimate-loci", *common, "--region", R8, "--region", R11,
            "--output-file", str(d / "both.npz"))
    _worker("merge-loci", "--graph-file", str(d / "both.npz"),
            "--output-file", str(d / "oneshot.npz"))
    _reference("estimate-loci", *common, "--region", R8, "--region", R11,
               "--output-file", str(d / "ref_both.npz"))
    _reference("merge-loci", "--graph-file", str(d / "ref_both.npz"),
               "--output-file", str(d / "reference.npz"))
    assert _npz_equal(str(d / "scatter.npz"), str(d / "oneshot.npz"))
    assert _npz_equal(str(d / "scatter.npz"), str(d / "reference.npz"))

    # the merged graph is non-trivial (demo region has real breakends)
    g = SVLocusSet.load(str(d / "scatter.npz"))
    assert sum(len(locus.nodes) for locus in g.loci) > 0


def test_chrom_depth_scatter_gather(tmp_path, demo_fasta, tumor_bam):
    """get-chrom-depth per-chromosome fan-out + merge-chrom-depth must
    reproduce the one-shot estimate (reference: GetChromDepth chunks +
    libexec/mergeChromDepth.py), file for file the JAX package's."""
    d = tmp_path
    for chrom in ("8", "11"):
        args = ("get-chrom-depth", "--align-file", tumor_bam, "--ref",
                demo_fasta, "--chrom", chrom)
        _worker(*args, "--output-file", str(d / f"d{chrom}.txt"))
        _reference(*args, "--output-file", str(d / f"r{chrom}.txt"))
        assert (d / f"d{chrom}.txt").read_text() == \
            (d / f"r{chrom}.txt").read_text()
    _worker("merge-chrom-depth", "--in", str(d / "d8.txt"),
            "--output-file", str(d / "merged8.txt"))
    merged = dict(parse_chrom_depth(str(d / "d8.txt")))
    merged.update(parse_chrom_depth(str(d / "d11.txt")))
    assert parse_chrom_depth(str(d / "merged8.txt")) == \
        parse_chrom_depth(str(d / "d8.txt"))
    oneshot = estimate_chrom_depths([tumor_bam], reference=demo_fasta)
    for name in ("8", "11"):
        assert abs(merged[name] - oneshot[name]) < 1e-3, name
    # merging two copies doubles the depth (per-sample summation rule)
    _worker("merge-chrom-depth", "--in", str(d / "d8.txt"),
            "--in", str(d / "d8.txt"), "--output-file", str(d / "dbl.txt"))
    _reference("merge-chrom-depth", "--in", str(d / "d8.txt"),
               "--in", str(d / "d8.txt"), "--output-file",
               str(d / "ref_dbl.txt"))
    assert (d / "dbl.txt").read_text() == (d / "ref_dbl.txt").read_text()
    dbl = parse_chrom_depth(str(d / "dbl.txt"))
    assert abs(dbl["8"] - 2 * merged["8"]) < 1e-3
