"""The port's two-host accounting (manta_tpu_torch/tools/bench_2host.py,
twin of benchmarks/bench_2host.py) on the CPU, on a seeded workload of
1 chromosome x 2 Mb at 20x: each stage in a process of its own on the
port's parallel/distributed, host scoring only. The merged VCF body
equals the single host's (``vcf_parity``), the two hosts' edges add up
to the single host's, the line has the original's keys, and the JSON
goes to ``--results-dir``, never under benchmarks/."""

import json
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GEN = ("--chroms", "1", "--mb", "2", "--depth", "20", "--seed", "7")
# the keys of the original's line (benchmarks/bench_2host.py, ``res``)
ORIGINAL_KEYS = ["metric", "workload", "jobs_per_host", "bootstrap", "hosts",
                 "finalize", "single_host", "cpu_s_2host_total",
                 "overhead_pct", "edges_total", "vcf_parity"]
STAGE_KEYS = ["wall_s", "cpu_s", "peak_rss_gb"]


def _run(*args):
    proc = subprocess.run([sys.executable, "-m", *args], capture_output=True,
                          text=True, timeout=600, cwd=REPO,
                          env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert proc.returncode == 0, proc.stderr[-3000:]
    return proc.stdout


@pytest.fixture(scope="module")
def accounted(tmp_path_factory):
    d = tmp_path_factory.mktemp("twohost")
    prefix = str(d / "w")
    _run("manta_tpu_torch.tools.wgs_workload", "--out", prefix, *GEN)
    listing = sorted(os.listdir(os.path.join(REPO, "benchmarks", "results")))
    with open(os.path.join(REPO, "benchmarks", "results",
                           "2host_accounting.json"), "rb") as f:
        original_file = f.read()
    out = _run("manta_tpu_torch.tools.bench_2host", "--workload", prefix,
               "--jobs", "2", "--results-dir", str(d / "results"))
    with open(os.path.join(REPO, "benchmarks", "results",
                           "2host_accounting.json"), "rb") as f:
        untouched = f.read() == original_file
    return (json.loads(out.strip().splitlines()[-1]), d / "results",
            listing == sorted(os.listdir(os.path.join(
                REPO, "benchmarks", "results"))) and untouched)


def test_merged_vcf_equals_the_single_hosts(accounted):
    res = accounted[0]
    assert res["vcf_parity"] is True


def test_edges_add_up_to_the_single_hosts(accounted):
    res = accounted[0]
    assert [h["host"] for h in res["hosts"]] == [0, 1]
    assert all(h["edges"] > 0 for h in res["hosts"])
    assert res["edges_total"] == res["single_host"]["edges"] > 0


def test_line_has_the_originals_keys(accounted):
    res, results, _untouched = accounted
    assert list(res) == ORIGINAL_KEYS
    assert res["metric"] == "2host_accounting" and res["jobs_per_host"] == 2
    for stage in ("bootstrap", "finalize"):
        assert list(res[stage]) == STAGE_KEYS
    assert list(res["single_host"]) == STAGE_KEYS + ["edges"]
    assert all(list(h) == ["host", "wall_s", "cpu_s", "edges",
                           "edges_per_cpu_s"] for h in res["hosts"])
    assert res["cpu_s_2host_total"] > 0
    with open(results / "2host_accounting.json") as f:
        assert json.load(f) == res


def test_nothing_is_written_under_benchmarks(accounted):
    assert accounted[2]
