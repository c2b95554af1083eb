"""The benchmark's frozen generator: determined by its seed, and the same
bytes as the port's own generator at a small size."""

from __future__ import annotations

import filecmp
import os

import pytest

from svbench.workload import generate

FILES = ("w.bam", "w.bam.bai", "w.fa", "w.fa.fai", "w.truth.tsv")


def _gen(d, seed, **kw):
    os.makedirs(d, exist_ok=True)
    return generate(os.path.join(d, "w"), chroms=2, mb=1, depth=10,
                    seed=seed, log=lambda m: None, **kw)


def test_same_seed_same_bytes_other_seed_other_bytes(tmp_path):
    a = _gen(tmp_path / "a", 2 ** 31 + 12345)
    b = _gen(tmp_path / "b", 2 ** 31 + 12345)
    c = _gen(tmp_path / "c", 2 ** 31 + 12346)
    assert a["reads"] == b["reads"]
    for f in FILES:
        assert filecmp.cmp(tmp_path / "a" / f, tmp_path / "b" / f,
                           shallow=False), f
    assert not filecmp.cmp(tmp_path / "a" / "w.bam", tmp_path / "c" / "w.bam",
                           shallow=False)


def test_samples_share_reference_and_truth(tmp_path):
    out = _gen(tmp_path / "t", 7, samples=3)
    assert [os.path.basename(p) for p in out["bams"]] == \
        ["w.s0.bam", "w.s1.bam", "w.s2.bam"]
    head = open(tmp_path / "t" / "w.truth.tsv").read().splitlines()[1]
    assert len(head.split("\t")[4].split(":")[0].split(",")) == 3


@pytest.mark.parametrize("kw", [{}, {"samples": 2}])
def test_equal_to_the_ports_generator(tmp_path, kw):
    from manta_tpu_torch.tools import wgs_workload
    ours = _gen(tmp_path / "ours", 11, **kw)
    os.makedirs(tmp_path / "port")
    argv = ["--out", str(tmp_path / "port" / "w"), "--chroms", "2", "--mb",
            "1", "--depth", "10", "--seed", "11"]
    if kw:
        argv += ["--samples", str(kw["samples"])]
    wgs_workload.main(argv)
    names = ["w.fa", "w.fa.fai", "w.truth.tsv"]
    for p in ours["bams"]:
        names += [os.path.basename(p), os.path.basename(p) + ".bai"]
    for f in names:
        assert filecmp.cmp(tmp_path / "ours" / f, tmp_path / "port" / f,
                           shallow=False), f
