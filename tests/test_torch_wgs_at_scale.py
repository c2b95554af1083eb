"""The port's at-scale measurement (manta_tpu_torch/tools/
bench_wgs_at_scale.py, twin of benchmarks/bench_wgs_at_scale.py) on the
CPU, on a seeded workload of 1 chromosome x 2 Mb at 20x.

With ``--device cpu --device-scoring jump`` the twin's artifact holds
every key of the original's and names its device; its diploid VCF body
equals the JAX package's ``run_workflow`` body on the same input
(exact); the process tree's Pss_Anon peak is positive; the contig jobs
of the run are counted where they ran (at ``-j 2`` in a worker, at
``-j 1`` in the tool's own process); and nothing is written under
benchmarks/. Without ``--device cpu`` it raises on a host without a
card. Each run is a subprocess that refuses jax, jaxlib and manta_tpu.
"""

import gzip
import json
import os
import subprocess
import sys

import pytest

from test_torch_standalone import _PRELUDE

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GEN = ("--chroms", "1", "--mb", "2", "--depth", "20", "--seed", "7")
# the keys of the original's artifact (benchmarks/bench_wgs_at_scale.py,
# main's ``out``)
ORIGINAL_KEYS = (
    "metric", "tag", "workload", "reads_m", "pct_of_840m", "cores",
    "device_scoring", "wall_s", "wall_min", "cpu_s", "peak_rss_gb",
    "peak_anon_gb", "peak_pss_anon_gb", "peak_anon_at_s",
    "peak_filepages_gb", "peak_tree_rss_gb", "peak_proc_anon_gb",
    "peak_proc_at_s", "peak_proc_role", "edges", "phase2_s", "edges_per_s",
    "serial_tail_s", "cpu_s_per_mread", "wgs840_20core_projection_min",
    "vs_baseline", "run_dir", "measured_utc")

_TWIN = r"""
import runpy
sys.argv = sys.argv[2:]
runpy.run_module(sys.argv[0], run_name="__main__", alter_sys=True)
assert not foreign(), foreign()
"""


def _twin(module, *args, check=True):
    proc = subprocess.run(
        [sys.executable, "-c", _PRELUDE + _TWIN, REPO, module, *args],
        capture_output=True, text=True, timeout=600, cwd=REPO,
        env=dict(os.environ, OMP_NUM_THREADS="1"))
    if check:
        assert proc.returncode == 0, proc.stderr[-3000:]
    return proc


def _tree(path):
    out = {}
    for root, _dirs, files in os.walk(path):
        for f in files:
            st = os.stat(os.path.join(root, f))
            out[os.path.join(root, f)] = (st.st_size, st.st_mtime_ns)
    return out


def _body(run_dir):
    with gzip.open(os.path.join(run_dir, "results", "variants",
                                "diploidSV.vcf.gz"), "rt") as f:
        return [ln for ln in f if not ln.startswith("#")]


@pytest.fixture(scope="module")
def measured(tmp_path_factory):
    """{jobs: (artifact, results dir, stderr)} of the twin with jump
    scoring on the CPU, and the tree of benchmarks/ before and after."""
    d = tmp_path_factory.mktemp("atscale")
    prefix = str(d / "w")
    gen = _twin("manta_tpu_torch.tools.wgs_workload", "--out", prefix, *GEN)
    # the generator's log, where the twin reads the read count
    with open(prefix + ".gen.log", "w") as f:
        f.write(gen.stdout)
    before = _tree(os.path.join(REPO, "benchmarks"))
    runs = {}
    for jobs in (2, 1):
        results = d / f"results_j{jobs}"
        proc = _twin("manta_tpu_torch.tools.bench_wgs_at_scale",
                     "--workload", prefix, "--device", "cpu",
                     "--device-scoring", "jump", "--jobs", str(jobs),
                     "--results-dir", str(results), "--run-dir",
                     str(d / f"run_j{jobs}"), "--tag", f"j{jobs}")
        art = json.loads(proc.stdout.strip().splitlines()[-1])
        runs[jobs] = art, results, proc.stderr
    return prefix, runs, before, _tree(os.path.join(REPO, "benchmarks"))


@pytest.mark.parametrize("jobs", [2, 1])
def test_artifact_has_the_originals_keys_and_its_device(measured, jobs):
    _prefix, runs, _b, _a = measured
    art, results, _err = runs[jobs]
    assert set(ORIGINAL_KEYS) <= set(art)
    assert art["device"] == "cpu"
    assert art["device_scoring"] == "jump"
    assert art["device_scoring_resolved"] == "jump"
    assert art["cores"] == jobs
    assert art["reads_m"] == round(398357 / 1e6, 2)
    assert art["edges"] > 0 and art["wall_s"] > 0 and art["cpu_s"] > 0
    with open(results / f"wgs_measured_j{jobs}.json") as f:
        assert json.load(f) == art
    with open(results / f"wgs_measured_j{jobs}.memtrace.json") as f:
        trace = json.load(f)
    assert trace["columns"] == ["t_s", "rss_anon_sum", "pss_anon_sum",
                                "nproc"] and trace["rows"]


@pytest.mark.parametrize("jobs", [2, 1])
def test_pss_anon_peak_is_positive(measured, jobs):
    art = measured[1][jobs][0]
    assert art["peak_pss_anon_gb"] > 0
    assert art["peak_anon_gb"] >= art["peak_proc_anon_gb"] > 0
    assert art["memory_sources"] == {"pss_anon": "smaps_rollup",
                                     "rss_anon": "status"}


def test_per_mapping_fallback_agrees_with_the_rollup():
    """Where a kernel gives no smaps_rollup or RssAnon, the sampler sums
    /proc/<pid>/smaps per mapping. Here, where all three exist, on a
    process holding 200 MB of its own: the sums lie between the
    kernel's own figures read just before and just after them (reading
    smaps allocates), to 1%."""
    import re

    from manta_tpu_torch.tools.bench_wgs_at_scale import RssSampler

    def kernel_figures():
        with open("/proc/self/smaps_rollup") as f:
            pss = int(re.search(r"Pss_Anon:\s+(\d+)", f.read()).group(1))
        with open("/proc/self/status") as f:
            anon = int(re.search(r"RssAnon:\s+(\d+)", f.read()).group(1))
        return pss * 1024, anon * 1024

    held = bytearray(b"x" * 200_000_000)
    before = kernel_figures()
    got = RssSampler._smaps(os.getpid())
    after = kernel_figures()
    assert len(held) and min(got) > 200e6
    for lo, value, hi in zip(before, got, after):
        assert 0.99 * min(lo, hi) <= value <= 1.01 * max(lo, hi)


@pytest.mark.parametrize("jobs", [2, 1])
def test_contig_jobs_are_counted_where_they_ran(measured, jobs):
    """On the CPU the plain form scores (no kernel launch); at -j 2 the
    jobs are in a worker's exit line, at -j 1 in the tool's process."""
    art, _results, err = measured[1][jobs]
    assert art["contig_jobs"] > 0
    assert art["dispatches"] > 0 and art["k1_launches"] == 0
    assert art["device_processes"] == 1
    worker_lines = [ln for ln in err.splitlines()
                    if "device-dispatch pid=" in ln]
    assert len(worker_lines) == 1
    # the process's own exit line, after the artifact, at -j 1
    assert f"{art['contig_jobs']} jobs" in worker_lines[0]


def test_body_equals_the_jax_packages(measured, tmp_path):
    from manta_tpu.workflow.run import run_workflow
    prefix, runs, _b, _a = measured
    run_workflow([prefix + ".bam"], [], prefix + ".fa", str(tmp_path / "ref"),
                 n_jobs=1, verbose=False, use_device_scoring=False)
    want = _body(str(tmp_path / "ref"))
    assert len(want) > 0
    for jobs in runs:
        assert _body(runs[jobs][0]["run_dir"]) == want


def test_nothing_is_written_under_benchmarks(measured):
    _prefix, _runs, before, after = measured
    assert after == before


def test_device_scoring_needs_a_card_unless_asked_for_the_cpu(measured,
                                                              tmp_path):
    import torch
    if torch.cuda.device_count() > 0:
        pytest.skip("a CUDA device is present")
    prefix = measured[0]
    proc = _twin("manta_tpu_torch.tools.bench_wgs_at_scale", "--workload",
                 prefix, "--device-scoring", "jump", "--results-dir",
                 str(tmp_path / "r"), check=False)
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr
    assert not (tmp_path / "r").exists()


@pytest.mark.parametrize("mode, libs", [
    ("jump", ["jump_score"]), ("exact", ["jump_score", "split_score"]),
    ("mxu", ["jump_score", "split_score"])])
def test_device_runs_build_their_kernels_before_forking(monkeypatch, mode,
                                                         libs):
    """The workflow builds the libraries a mode launches in its own
    process, so -j N workers load them instead of each compiling one
    (run W in PERF.md: eight concurrent builds of K1 in phase 2)."""
    from manta_tpu_torch import _build
    from manta_tpu_torch.workflow import run
    built = []
    monkeypatch.setattr(_build, "build", built.append)
    run.build_kernels(mode)
    assert built == libs
