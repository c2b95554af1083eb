"""manta_tpu_torch without JAX, as on a GPU host that has none.

tests/conftest.py imports JAX into the pytest process, so each check
runs in a subprocess whose sys.meta_path refuses jax and jaxlib before
anything else is imported."""

import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PRELUDE = r"""
import json, sys
sys.path.insert(0, sys.argv[1])


class _RefuseJax:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib"):
            raise ImportError(f"JAX refused: {name}")


sys.meta_path.insert(0, _RefuseJax())
"""

_IMPORT_ALL = r"""
import importlib, pkgutil
import manta_tpu_torch
names = ["manta_tpu_torch"] + [
    m.name for m in pkgutil.walk_packages(manta_tpu_torch.__path__,
                                          "manta_tpu_torch.")]
for n in names:
    importlib.import_module(n)
print(json.dumps({"modules": names,
                  "jax": [m for m in sys.modules if m.startswith("jax")]}))
"""

_SCORE = r"""
import numpy as np
from manta_tpu.align.aligners import AlignmentScores, jump_score_batch
from manta_tpu_torch.align.device_jumpscore import make_bucketed_scorer
rng = np.random.default_rng(7)
seq = lambda n: bytes(b"ACGT"[i] for i in rng.integers(0, 4, n))
jobs = []
for _ in range(5):
    r1, r2 = seq(int(rng.integers(60, 140))), seq(int(rng.integers(60, 140)))
    jobs.append((r1[-30:] + seq(3) + r2[:30], r1, r2))
scores = AlignmentScores(2, -8, -12, -1, -1)
got = make_bucketed_scorer(scores, -100, "cpu")(jobs)
print(json.dumps({"got": got.tolist(),
                  "native": jump_score_batch(jobs, scores, -100).tolist(),
                  "jax": [m for m in sys.modules if m.startswith("jax")]}))
"""

_DEMO = r"""
import gzip
normal, tumor, fasta, run_dir = sys.argv[2:6]
mode = sys.argv[6] if len(sys.argv) > 6 else "jump"
from manta_tpu_torch.scoring.device_scan import SCAN_STATS
from manta_tpu_torch.workflow.run import run_workflow
run_workflow([normal], [tumor], fasta, run_dir, is_exome=True,
             use_device_scoring=mode, device="cpu", verbose=False)
with gzip.open(run_dir + "/results/variants/somaticSV.vcf.gz", "rt") as f:
    body = [ln for ln in f if not ln.startswith("#")]
print(json.dumps({"body": body, "scans": SCAN_STATS,
                  "jax": [m for m in sys.modules if m.startswith("jax")]}))
"""


def _run(script, *args):
    # one torch thread: see test_torch_splitscore.one_torch_thread
    proc = subprocess.run(
        [sys.executable, "-c", _PRELUDE + script, REPO, *args],
        capture_output=True, text=True, timeout=300, cwd=REPO,
        env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


def test_every_module_imports_without_jax():
    out = _run(_IMPORT_ALL)
    assert out["jax"] == []
    for name in ("manta_tpu_torch.align.device_jumpscore",
                 "manta_tpu_torch.align.cuda_jumpscore",
                 "manta_tpu_torch.candidates.refiner",
                 "manta_tpu_torch.align.device_splitscore",
                 "manta_tpu_torch.align.cuda_splitscore",
                 "manta_tpu_torch.align.device_splitscore_mxu",
                 "manta_tpu_torch.scoring.device_scan",
                 "manta_tpu_torch.scoring.scorer",
                 "manta_tpu_torch.core.chromdepth",
                 "manta_tpu_torch.parallel.forkpool",
                 "manta_tpu_torch.workflow.run",
                 "manta_tpu_torch.native_core"):
        assert name in out["modules"]


def test_scoring_without_jax():
    out = _run(_SCORE)
    assert out["jax"] == []
    assert out["got"] == out["native"]


def _oracle():
    import gzip
    with gzip.open(os.path.join(REPO, "tests", "data", "demo",
                                "expectedResults", "somaticSV.vcf.gz"),
                   "rt") as f:
        return [ln for ln in f if not ln.startswith("#")]


def test_demo_workflow_without_jax(tmp_path, demo_fasta, normal_bam,
                                   tumor_bam):
    out = _run(_DEMO, normal_bam, tumor_bam, demo_fasta,
               str(tmp_path / "run"))
    assert out["jax"] == []
    want = _oracle()
    assert out["body"] == want
    assert len(want) == 6


def test_demo_exact_split_scan_without_jax(tmp_path, demo_fasta,
                                           normal_bam, tumor_bam):
    """--device-scoring exact: the port's split scan (its plain form on
    the CPU) replaces the JAX package's, which imports JAX."""
    out = _run(_DEMO, normal_bam, tumor_bam, demo_fasta,
               str(tmp_path / "run"), "exact")
    assert out["jax"] == []
    assert out["scans"]["exact"] > 0
    assert out["body"] == _oracle()
