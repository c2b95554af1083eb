"""The port's interrupted-run resume, --rescore and fork-parallel phases,
on the CPU: twins of tests/test_workflow_resume.py (completed tasks are
skipped on re-execution; reference: pyflow completed-task records,
docs/userGuide/README.md:631-633) and of the -j 2 cases of
tests/test_workflow_e2e.py.

The resume twins run the port's TaskTracker and run_workflow with
device scoring off, as the JAX tests run on a host without an
accelerator; the --rescore twin also with jump and exact (the plain
forms of the kernels, device="cpu"). Besides what the JAX test asserts,
each checks the port's VCF body: the demo oracle (somaticSV.vcf.gz)
where the JAX test runs the demo configuration, else the JAX package's
body on the same input and options. Tolerance: none, the bodies are
text and equal byte for byte.

The workflow's command line has no device option (its options equal
the JAX package's), so on a host without CUDA it scores 'off'; the -j 2
twin of jump and exact runs run_workflow(n_jobs=2, device="cpu") in a
child process instead, so that no fork copies this JAX-initialised
process."""

import glob
import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest

from manta_tpu.workflow.run import run_workflow as reference_run
from manta_tpu_torch.io.bam import BamReader
from manta_tpu_torch.workflow.run import run_workflow
from manta_tpu_torch.workflow.tasks import TaskTracker

from test_torch_splitscore import one_torch_thread  # noqa: F401  (autouse)
from test_torch_workflow import EXPECTED, REPO
from test_torch_workflow import _records as _body

MODES = ("off", "jump", "exact")


def _mtime(path):
    return os.stat(path).st_mtime_ns


def _vcf(run_dir, name):
    return f"{run_dir}/results/variants/{name}"


def test_tracker_roundtrip(tmp_path):
    """Twin of test_tracker_roundtrip (tests/test_workflow_resume.py)."""
    ws = str(tmp_path)
    t = TaskTracker(ws, {"a": 1})
    assert not t.is_done("x")
    art = os.path.join(ws, "artifact.txt")
    open(art, "w").close()
    t.mark_done("x", [art])
    assert TaskTracker(ws, {"a": 1}).is_done("x")
    os.remove(art)
    assert not TaskTracker(ws, {"a": 1}).is_done("x")
    open(art, "w").close()
    assert not TaskTracker(ws, {"a": 2}).is_done("x")


def test_tracker_clear_prefix(tmp_path):
    """Twin of test_tracker_clear_prefix."""
    t = TaskTracker(str(tmp_path), {})
    t.mark_done("hygen", [])
    t.mark_done("hygen.bin.0000.abc", [])
    t.mark_done("graph", [])
    t.clear("hygen")
    assert not t.is_done("hygen")
    assert not t.is_done("hygen.bin.0000.abc")
    assert t.is_done("graph")


def _demo(run_dir, inputs, mode="off", **kw):
    normal_bam, tumor_bam, demo_fasta = inputs
    run_workflow([normal_bam], [tumor_bam], demo_fasta, run_dir,
                 is_exome=True, use_device_scoring=mode, device="cpu",
                 verbose=False, **kw)
    return _body(_vcf(run_dir, "somaticSV.vcf.gz"))


@pytest.fixture(scope="module")
def resume_run(tmp_path_factory, demo_fasta, normal_bam, tumor_bam):
    run_dir = str(tmp_path_factory.mktemp("resume_run"))
    inputs = (normal_bam, tumor_bam, demo_fasta)
    assert _demo(run_dir, inputs) == _body(EXPECTED)
    return run_dir, inputs


def test_rerun_skips_completed_phases(resume_run):
    """Twin of test_rerun_skips_completed_phases."""
    run_dir, inputs = resume_run
    ws = os.path.join(run_dir, "workspace")
    stats = os.path.join(ws, "alignmentStats.json")
    graph = os.path.join(ws, "svLocusGraph.npz")
    cand = os.path.join(ws, "candidateSV.vcf")
    before = (_mtime(stats), _mtime(graph), _mtime(cand))
    assert _demo(run_dir, inputs) == _body(EXPECTED)
    assert (_mtime(stats), _mtime(graph), _mtime(cand)) == before
    with open(os.path.join(ws, "taskState.json")) as f:
        state = json.load(f)
    for name in ("alignmentStats", "graph", "hygen"):
        assert name in state["tasks"]


def test_rerun_after_artifact_loss_rebuilds(resume_run):
    """Twin of test_rerun_after_artifact_loss_rebuilds."""
    run_dir, inputs = resume_run
    ws = os.path.join(run_dir, "workspace")
    graph = os.path.join(ws, "svLocusGraph.npz")
    stats = os.path.join(ws, "alignmentStats.json")
    stats_before = _mtime(stats)
    os.remove(graph)
    assert _demo(run_dir, inputs) == _body(EXPECTED)
    assert os.path.exists(graph)
    assert _mtime(stats) == stats_before


def test_changed_parameters_invalidate_state(resume_run, tmp_path):
    """Twin of test_changed_parameters_invalidate_state: a changed
    calling parameter re-runs everything; the body is the JAX package's
    with the same parameter."""
    run_dir, (normal_bam, tumor_bam, demo_fasta) = resume_run
    graph = os.path.join(run_dir, "workspace", "svLocusGraph.npz")
    graph_before = _mtime(graph)
    got = _demo(run_dir, (normal_bam, tumor_bam, demo_fasta),
                min_candidate_variant_size=10)
    assert _mtime(graph) != graph_before
    ref = str(tmp_path / "reference")
    reference_run([normal_bam], [tumor_bam], demo_fasta, ref, is_exome=True,
                  min_candidate_variant_size=10, verbose=False)
    assert got == _body(_vcf(ref, "somaticSV.vcf.gz"))


@pytest.mark.parametrize("mode", MODES)
def test_rescore_reruns_phase2_only(resume_run, mode):
    """Twin of test_rescore_reruns_phase2_only, the rescore in each mode:
    phase 1's graph is kept, the candidates are written again, and the
    body is the oracle's."""
    run_dir, inputs = resume_run
    ws = os.path.join(run_dir, "workspace")
    # restore the original-parameter artifacts state
    assert _demo(run_dir, inputs) == _body(EXPECTED)
    graph = os.path.join(ws, "svLocusGraph.npz")
    cand = os.path.join(ws, "candidateSV.vcf")
    graph_before, cand_before = _mtime(graph), _mtime(cand)
    assert _demo(run_dir, inputs, mode, is_rescore=True) == _body(EXPECTED)
    assert _mtime(graph) == graph_before
    assert _mtime(cand) != cand_before


def test_use_existing_chrom_depths(tmp_path, demo_fasta, tumor_bam):
    """Twin of test_use_existing_chrom_depths: depth estimation is
    skipped and the pre-placed workspace/chromDepth.txt is used; a
    missing file raises. The tumor body is the JAX package's with the
    same file."""
    depths = "8\t30.0\n11\t30.0\n"
    bodies = []
    for name, run in (("run", run_workflow), ("reference", reference_run)):
        run_dir = str(tmp_path / name)
        kw = {"device": "cpu"} if run is run_workflow else {}
        with pytest.raises(FileNotFoundError):
            run([], [tumor_bam], demo_fasta, run_dir,
                use_existing_chrom_depths=True, verbose=False, **kw)
        os.makedirs(os.path.join(run_dir, "workspace"), exist_ok=True)
        with open(os.path.join(run_dir, "workspace", "chromDepth.txt"),
                  "w") as f:
            f.write(depths)
        run([], [tumor_bam], demo_fasta, run_dir,
            use_existing_chrom_depths=True, verbose=False, **kw)
        bodies.append(_body(_vcf(run_dir, "tumorSV.vcf.gz")))
    assert len(bodies[0]) >= 4
    assert bodies[0] == bodies[1]
# -- -j 2 against serial -------------------------------------------------

@pytest.fixture(scope="module")
def serial_run(tmp_path_factory, demo_fasta, normal_bam, tumor_bam):
    """The port's serial demo run with evidence BAMs (scoring off), as the
    demo_run fixture of tests/test_workflow_e2e.py."""
    run_dir = str(tmp_path_factory.mktemp("serial_run"))
    assert _demo(run_dir, (normal_bam, tumor_bam, demo_fasta),
                 generate_evidence_bam=True) == _body(EXPECTED)
    return run_dir


def test_outputs_exist(serial_run):
    """Twin of test_outputs_exist (tests/test_workflow_e2e.py:37): every
    VCF with its index, and the stats files."""
    for name in ("candidateSV.vcf.gz", "candidateSmallIndels.vcf.gz",
                 "diploidSV.vcf.gz", "somaticSV.vcf.gz"):
        assert os.path.exists(_vcf(serial_run, name))
        assert os.path.exists(_vcf(serial_run, name) + ".tbi")
    for name in ("alignmentStatsSummary.txt", "svLocusGraphStats.tsv",
                 "svCandidateGenerationStats.tsv"):
        assert os.path.exists(f"{serial_run}/results/stats/{name}")


_PARALLEL = """\
import sys
from manta_tpu_torch.workflow.run import run_workflow
normal, tumor, fasta, run_dir, mode = sys.argv[1:]
run_workflow([normal], [tumor], fasta, run_dir, is_exome=True, n_jobs=2,
             generate_evidence_bam=True, use_device_scoring=mode,
             device="cpu", verbose=False)
"""


def _child_env():
    # one torch thread a process: the plain split scan's planes would
    # spread over every core in each of the workers
    return dict(os.environ, OMP_NUM_THREADS="1")


def _demo_cli(run_dir, demo_fasta, normal_bam, tumor_bam, *extra):
    subprocess.run(
        [sys.executable, "-m", "manta_tpu_torch.workflow.run",
         "--normal-bam", normal_bam, "--tumor-bam", tumor_bam,
         "--reference", demo_fasta, "--run-dir", run_dir, "--exome",
         "-j", "2", *extra],
        check=True, capture_output=True, timeout=600, cwd=REPO,
        env=_child_env())


@pytest.mark.parametrize("mode", MODES)
def test_parallel_matches_serial(tmp_path, demo_fasta, normal_bam,
                                 tumor_bam, serial_run, mode):
    """Twin of test_parallel_matches_serial (tests/test_workflow_e2e.py:86):
    fork-parallel phases (-j 2) bit-identical to serial, evidence BAM
    records included. 'off' through the command line, as the JAX test;
    jump and exact through run_workflow(device="cpu") in a child."""
    run_dir = str(tmp_path / "par_run")
    if mode == "off":
        _demo_cli(run_dir, demo_fasta, normal_bam, tumor_bam,
                  "--generate-evidence-bam")
    else:
        subprocess.run([sys.executable, "-c", _PARALLEL, normal_bam,
                        tumor_bam, demo_fasta, run_dir, mode], check=True,
                       capture_output=True, timeout=600, cwd=REPO,
                       env=_child_env())
    for name in ("candidateSV.vcf.gz", "somaticSV.vcf.gz",
                 "diploidSV.vcf.gz"):
        assert _body(_vcf(run_dir, name)) == \
            _body(_vcf(serial_run, name)), name
    ser = sorted(glob.glob(f"{serial_run}/results/evidence/evidence_*.bam"))
    par = sorted(glob.glob(f"{run_dir}/results/evidence/evidence_*.bam"))
    assert [os.path.basename(p) for p in ser] == \
        [os.path.basename(p) for p in par] and len(ser) == 2
    for s, p in zip(ser, par):
        a, b = BamReader(s).read_all(), BamReader(p).read_all()
        assert a.n == b.n
        for k in vars(a):
            va = getattr(a, k)
            if isinstance(va, np.ndarray):
                assert np.array_equal(va, getattr(b, k)), (s, k)


def test_parallel_edge_stats_lifetimes_sum(tmp_path, demo_fasta, normal_bam,
                                           tumor_bam):
    """Twin of test_parallel_edge_stats_lifetimes_sum
    (tests/test_workflow_e2e.py:373): the merged phase-2 edge stats sum
    the bin workers' lifetimes (non-edge time never negative), and the
    -j 2 somatic body is the oracle's."""
    run_dir = str(tmp_path / "stats_run")
    _demo_cli(run_dir, demo_fasta, normal_bam, tumor_bam)
    assert _body(_vcf(run_dir, "somaticSV.vcf.gz")) == _body(EXPECTED)
    with open(f"{run_dir}/results/stats/svCandidateGenerationStats.tsv") as f:
        tsv = f.read()

    def hours(label):
        m = re.search(rf"{label}\t([-0-9.]+)h wall, ([-0-9.]+)h user \+ "
                      rf"([-0-9.]+)h system", tsv)
        assert m, label
        return tuple(float(g) for g in m.groups())

    gen_wall, _gen_user, _gen_sys = hours("SVGenTotalHours")
    ne_wall, ne_user, ne_sys = hours("NonEdgeHours")
    assert gen_wall > 0
    assert ne_wall >= 0 and ne_user >= -1e-9 and ne_sys >= -1e-9, \
        "non-edge time negative: lifetimes not summed across workers"
