"""The port's truth checker against the JAX package's.

``python -m manta_tpu_torch.tools.wgs_workload --check`` is the twin of
``benchmarks/wgs_workload.py --check``: it runs the port's workflow on a
generated workload and scores its calls against the planted truth. On
one seeded workload (1 chromosome x 2 Mb at 20x, the size of
test_torch_workloads.py; separate ones for two samples and for the
repeat content) the original runs in a subprocess and the twin in a
subprocess whose sys.meta_path refuses jax, jaxlib and manta_tpu. Their
JSON lines must be equal in every key but the run's wall, peak RSS and
run directory, and so must the misses and false positives that
``--verbose-misses`` lists. Tolerance: exact. Neither run has a CUDA
device, so both score with device scoring off, their default there."""

import gzip
import importlib.util
import json
import os
import subprocess
import sys

import pytest

from test_torch_standalone import _PRELUDE

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GEN = ("--chroms", "1", "--mb", "2", "--depth", "20", "--seed", "7")
# what is not the calls: the run's own wall, memory and directory
UNCOMPARED = ("wall_s", "peak_rss_gb", "run_dir")
WORKLOADS = {"single": (), "samples2": ("--samples", "2"),
             "repeats": ("--repeats", "--repeat-anchors", "4")}
CASES = {"germline": ("single", ()), "tumor": ("single", ("--mode", "tumor")),
         "samples2": ("samples2", ()), "repeats": ("repeats", ())}

_TWIN = r"""
import runpy
sys.argv = sys.argv[2:]
runpy.run_module(sys.argv[0], run_name="__main__", alter_sys=True)
assert not foreign(), foreign()
"""


def _run(cmd):
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600,
                          cwd=REPO, env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert proc.returncode == 0, proc.stderr[-3000:]
    return proc.stdout


def _twin(*args):
    return _run([sys.executable, "-c", _PRELUDE + _TWIN, REPO,
                 "manta_tpu_torch.tools.wgs_workload", *args])


@pytest.fixture(scope="module")
def workloads(tmp_path_factory):
    d = tmp_path_factory.mktemp("truth")
    out = {}
    for name, extra in WORKLOADS.items():
        out[name] = str(d / name)
        _twin("--out", out[name], *GEN, *extra)
    return out


def _compared(line):
    return {k: v for k, v in line.items() if k not in UNCOMPARED}


def _split(stdout):
    """(the JSON line, the MISS/FP lines after it)."""
    lines = stdout.strip().splitlines()
    at = max(i for i, ln in enumerate(lines) if ln.startswith("{"))
    return json.loads(lines[at]), lines[at + 1:]


@pytest.fixture(scope="module")
def checked(workloads, tmp_path_factory):
    """{case: (original's (json, misses), twin's)}, each run once."""
    d = tmp_path_factory.mktemp("runs")
    out = {}
    for case, (workload, extra) in CASES.items():
        args = ["--out", workloads[workload], "--check", "--jobs", "1",
                "--verbose-misses", *extra]
        ref = _split(_run([sys.executable,
                           os.path.join("benchmarks", "wgs_workload.py"),
                           *args, "--run-dir", str(d / f"{case}_ref")]))
        twin = _split(_twin(*args, "--run-dir", str(d / f"{case}_twin")))
        out[case] = ref, twin
    return out


@pytest.mark.parametrize("case", list(CASES))
def test_twin_prints_the_originals_line(checked, case):
    (ref, ref_misses), (twin, twin_misses) = checked[case]
    assert list(twin) == list(ref)              # key for key, in order
    assert _compared(twin) == _compared(ref)
    assert twin_misses == ref_misses
    assert ref["recall"] > 0 and ref["truth_n"] > 0
    if case == "repeats":
        assert "graph_highest_search_count" in ref
        assert ref["truth_in_repeat"] > 0
    if case == "tumor":
        assert ref["mode"] == "tumor"


def test_check_resumes_a_finished_run(checked, workloads, tmp_path):
    """On the original's finished run directory the twin only scores:
    the workflow resumes every task, and the line is the same."""
    (ref, _m), _twin_out = checked["germline"]
    run_dir = ref["run_dir"]
    with open(os.path.join(run_dir, "workspace", "workflow_log.txt")) as f:
        before = f.read()
    again, _misses = _split(_twin("--out", workloads["single"], "--check",
                                  "--jobs", "1", "--run-dir", run_dir))
    with open(os.path.join(run_dir, "workspace", "workflow_log.txt")) as f:
        added = f.read()[len(before):]
    for task in ("fragment-size statistics", "breakend graph",
                 "candidate generation and scoring results"):
        assert f"resume: reusing {task}" in added
    assert _compared(again) == _compared(ref)


def _original_module():
    spec = importlib.util.spec_from_file_location(
        "_original_wgs_workload",
        os.path.join(REPO, "benchmarks", "wgs_workload.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _twin_run_vcf(checked):
    _ref, (twin, _m) = checked["samples2"]
    return os.path.join(twin["run_dir"], "results", "variants",
                        "diploidSV.vcf.gz")


@pytest.mark.parametrize("which", ["demo_oracle", "two_sample_run"])
def test_parse_vcf_records_matches_the_original(checked, which):
    """Every field of every record, exact: the demo's somatic oracle
    (6 BND records, two samples) and a joint-called diploid VCF."""
    from manta_tpu_torch.tools.wgs_workload import parse_vcf_records
    path = (os.path.join(REPO, "tests", "data", "demo", "expectedResults",
                         "somaticSV.vcf.gz") if which == "demo_oracle"
            else _twin_run_vcf(checked))
    want = _original_module().parse_vcf_records(path)
    got = parse_vcf_records(path)
    assert got == want and len(got) > 0
    with gzip.open(path, "rt") as f:
        assert len(got) == sum(1 for ln in f if not ln.startswith("#"))
