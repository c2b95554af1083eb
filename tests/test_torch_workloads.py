"""The port's workload generators against the JAX package's.

manta_tpu_torch.tools.wgs_workload and manta_tpu_torch.tools.stress_workload
are the port's own copies of benchmarks/wgs_workload.py and
benchmarks/stress_workload.py (which import manta_tpu). For one seed at
small arguments each original runs in a subprocess of its own, and its
twin in a subprocess whose sys.meta_path refuses jax, jaxlib and
manta_tpu. Every file they write must be equal byte for byte: the BAM
and its index too, since both packages load the same native core
(native/libmanta_core.so) and so the same deflate library here. Where a
host's compressor differed, the decompressed BAM stream would be the
thing to compare; on this one the compressed bytes are."""

import os
import subprocess
import sys

import pytest

from test_torch_standalone import _PRELUDE

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WGS_ARGS = ("--chroms", "1", "--mb", "2", "--depth", "20", "--seed", "7")
STRESS = dict(tiles=4, depth_frac=0.2, strip_sa=True)

_TWIN = r"""
import runpy
sys.argv = sys.argv[2:]
runpy.run_module(sys.argv[0], run_name="__main__", alter_sys=True)
assert not foreign(), foreign()
"""

_STRESS_ORIGINAL = r"""
import sys
sys.path.insert(0, "benchmarks")
import stress_workload
out, tiles, frac = sys.argv[1], int(sys.argv[2]), float(sys.argv[3])
stress_workload.generate(tiles, out, depth_frac=frac, strip_sa=True)
"""


def _run(cmd):
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300,
                          cwd=REPO, env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert proc.returncode == 0, proc.stderr[-3000:]


def _twin(module, *args):
    _run([sys.executable, "-c", _PRELUDE + _TWIN, REPO, module, *args])


@pytest.fixture(scope="module")
def generated(tmp_path_factory, demo_fasta):
    """{generator: (original's prefix, twin's prefix)}, each made once."""
    d = tmp_path_factory.mktemp("workloads")
    out = {}
    ref, twin = str(d / "wgs_ref"), str(d / "wgs_twin")
    _run([sys.executable, os.path.join("benchmarks", "wgs_workload.py"),
          "--out", ref, *WGS_ARGS])
    _twin("manta_tpu_torch.tools.wgs_workload", "--out", twin, *WGS_ARGS)
    out["wgs"] = ref, twin
    ref, twin = str(d / "stress_ref"), str(d / "stress_twin")
    # the original reads the demo reference from .testdata, where the
    # demo_fasta fixture extracts it
    _run([sys.executable, "-c", _STRESS_ORIGINAL, ref,
          str(STRESS["tiles"]), str(STRESS["depth_frac"])])
    _twin("manta_tpu_torch.tools.stress_workload", "--out", twin,
          "--tiles", str(STRESS["tiles"]), "--depth-frac",
          str(STRESS["depth_frac"]), "--strip-sa", "--demo-fasta", demo_fasta)
    out["stress"] = ref, twin
    return out


@pytest.mark.parametrize("generator, suffix", [
    ("wgs", ".bam"), ("wgs", ".bam.bai"), ("wgs", ".fa"), ("wgs", ".fa.fai"),
    ("wgs", ".truth.tsv"),
    ("stress", ".bam"), ("stress", ".bam.bai"), ("stress", ".fa"),
    ("stress", ".fa.fai")])
def test_twin_writes_the_originals_bytes(generated, generator, suffix):
    ref, twin = generated[generator]
    with open(ref + suffix, "rb") as f:
        want = f.read()
    with open(twin + suffix, "rb") as f:
        got = f.read()
    assert len(want) > 0
    assert got == want


def test_the_twins_write_every_file_the_originals_do(generated):
    for ref, twin in generated.values():
        d = os.path.dirname(ref)
        names = sorted(os.listdir(d))
        ref_files = [n[len(os.path.basename(ref)):] for n in names
                     if n.startswith(os.path.basename(ref))]
        twin_files = [n[len(os.path.basename(twin)):] for n in names
                      if n.startswith(os.path.basename(twin))]
        assert ref_files == twin_files and ref_files
