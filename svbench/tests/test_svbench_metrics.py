"""The metric arithmetic on fixed inputs: phase stamps, exit lines, the
roofline, device-time unions and idle gaps, call accuracy, and each
metric reader on a hand-made run."""

from __future__ import annotations

import datetime
import importlib.util
import json
import os

import pytest

from svbench import intervals, logs, roofline, run, truth

SVBENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

LOG = """\
[2026-01-02T03:04:05.000] estimating fragment-size statistics
[2026-01-02T03:04:06.500] building breakend graph
[2026-01-02T03:04:12.250] generating and scoring SV candidates
[2026-01-02T03:04:20.000] processed 1234 graph edges
[2026-01-02T03:04:21.000] workflow complete
"""

EXIT = (
    "[manta-tpu-torch] device-dispatch pid=11: 3 calls, 17 jobs, 24 padded "
    "rows, 0.0100s total, first 0.0050s (incl. kernel build), 3 kernel "
    "launches; calls by bucket (B, nq, nr1, nr2): {(8, 256, 1024, 1024): 3};"
    " work: 1000 useful cells, 5000 padded cells, 700 bytes\n"
    "[manta-tpu-torch] split-scan pid=11: 10 calls (exact 10, mxu 0, "
    "fallback 0), 400 rows, 0.05s total, 10 kernel launches; work: 9000 "
    "useful terms, 20000 padded terms, 3000 bytes; tiers (Lp, Tp): {}\n"
    "[manta-tpu-torch] split-scan pid=12: 5 calls (exact 5, mxu 0, "
    "fallback 0), 100 rows, 0.02s total, 5 kernel launches; work: 1000 "
    "useful terms, 2000 padded terms, 300 bytes; tiers (Lp, Tp): {}\n")


def _ts(text):
    return datetime.datetime.fromisoformat(text).timestamp()


def test_phases_from_stamps():
    p = logs.phases(LOG)
    assert p["graph_build_s"] == pytest.approx(7.25)
    assert p["phase2_s"] == pytest.approx(7.75)
    assert p["start"] == pytest.approx(_ts("2026-01-02T03:04:05"))
    assert p["end"] == pytest.approx(_ts("2026-01-02T03:04:21"))
    assert logs.phases("")["phase2_s"] is None


def test_exit_lines_summed():
    c = logs.exit_lines(EXIT)
    assert c == {"k1_calls": 3, "k1_jobs": 17, "k1_launches": 3,
                 "k3_calls": 15, "k3_launches": 15}


def test_roofline_share():
    # 1e9 useful cells at 14 ops against 16.73 Tops/s
    t = 1e9 * 14 / (132 * 64 * 1.98e9)
    assert roofline.bound_s("jump_score", 10 ** 9, 10 ** 6) == \
        pytest.approx(t)
    # half the launches traced, the device took 10x the bound for them
    share = roofline.share_pct("jump_score", 10 ** 9, 10 ** 6, 4, 5 * t, 2)
    assert share == pytest.approx(10.0)
    # bytes that might set the bound: no reading
    assert roofline.bound_s("split_score", 10, 10 ** 12) is None
    assert roofline.share_pct("split_score", 0, 0, 0, 0.0, 0) is None


def test_union_and_gaps():
    ev = [["a", 1_000_000_000, 500_000_000],     # 1.0-1.5 s
          ["b", 1_200_000_000, 500_000_000],     # 1.2-1.7 s
          ["c", 3_000_000_000, 1_000_000_000]]   # 3.0-4.0 s
    assert intervals.union_s(ev) == pytest.approx(1.7)
    phases = {"start": 0.5, "phase2_start": 2.0, "phase2_end": 4.5,
              "end": 5.0}
    gaps = intervals.idle_gaps(ev, 0.0, 5.0, phases)
    # [0, 1.0] cut at 0.5 (the log's start); [1.7, 3.0] at 2.0 (phase
    # 2's start); [4.0, 5.0] at 4.5 (phase 2's end)
    assert [(n.split(":")[0], round(g, 6)) for n, g in gaps] == [
        ("phase 2", 1.0), ("workflow start-up", 0.5),
        ("phases 0-1", 0.5), ("phase 2", 0.5),
        ("final VCF sort and index", 0.5), ("phases 0-1", 0.3)]


def test_truth_score():
    t = [dict(chrom="chr1", pos=1000, type="DEL", size=500, gt="het"),
         dict(chrom="chr1", pos=5000, type="INV", size=300, gt="hom"),
         dict(chrom="chr2", pos=100, type="BND", size=0,
              gt="het:chr3:700")]
    recs = [dict(chrom="chr1", pos=1010, id="a", svtype="DEL"),
            dict(chrom="chr1", pos=5300, id="b", svtype="BND"),   # INV end
            dict(chrom="chr1", pos=4990, id="c", svtype="BND"),
            dict(chrom="chr3", pos=690, id="d", svtype="BND"),    # mate
            dict(chrom="chr4", pos=1, id="e", svtype="DEL")]      # FP
    s = truth.score(t, recs)
    assert s["found"] == 2 and s["fp"] == 1 and s["records"] == 5
    assert s["recall"] == pytest.approx(2 / 3)
    assert s["precision"] == pytest.approx(4 / 5)
    assert s["f1"] == pytest.approx(2 * (2 / 3) * 0.8 / (2 / 3 + 0.8))


def _reader(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(SVBENCH, "metrics", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _run():
    sample = {"wall_s": 10.0, "error": None, "reads": 2_000_000,
              "phases": {"graph_build_s": 6.0, "phase2_s": 3.0},
              "exit": logs.exit_lines(EXIT)}
    sample2 = dict(sample, wall_s=12.0,
                   phases={"graph_build_s": 8.0, "phase2_s": 3.5})
    worker = {"cuda_startup_s": 0.5,
              "counts": {"launches": {"jump_score": 2, "split_score": 4},
                         "work": {"jump_score": {"useful": 10 ** 9,
                                                 "bytes": 10 ** 5},
                                  "split_score": {"useful": 10 ** 9,
                                                  "bytes": 10 ** 5}}},
              "events": [["void jump_systolic_kernel<3>", 0, 10 ** 6],
                         ["void jump_systolic_kernel<3>", 2 * 10 ** 6,
                          10 ** 6],
                         ["split_score_kernel(...)", 5 * 10 ** 6, 10 ** 5],
                         ["Memcpy HtoD", 6 * 10 ** 6, 10 ** 6]]}
    worker2 = dict(worker, cuda_startup_s=1.5)
    return {"samples": [sample, sample2], "window_s": 22.0,
            "cpu_s": 88.0, "reads": 4_000_000, "setup_s": 12.5,
            "calls": {"f1": 0.995},
            "armed": {"workers": [worker, worker2], "wall_s": 30.0}}


def test_metric_readers():
    r = _run()
    assert _reader("reads_per_s")(r) == pytest.approx(4e6 / 22)
    assert _reader("cpu_s_per_mread")(r) == pytest.approx(22.0)
    assert _reader("call_f1")(r) == 0.995
    assert _reader("setup_s")(r) == 12.5
    assert _reader("graph_build_s")(r) == pytest.approx(7.0)
    assert _reader("phase2_s")(r) == pytest.approx(3.25)
    assert _reader("worker_cuda_startup_s")(r) == pytest.approx(1.0)
    assert _reader("k3_launches_per_mread")(r) == pytest.approx(30 / 4)
    # four K1 launches counted, four traced, 4 ms: the bound of 2e9 cells
    k1 = 2e9 * 14 / (132 * 64 * 1.98e9)
    assert _reader("k1_roofline")(r) == pytest.approx(100 * k1 / 4e-3)
    k3 = 2e9 * 2 / 67e12
    assert _reader("k3_roofline")(r) == pytest.approx(
        100 * k3 * 2 / 8 / 2e-4)
    # busy 3.1 ms (overlaps merged across the two workers) of 11 s
    assert _reader("device_idle_pct")(r) == pytest.approx(
        100 * (1 - 3.1e-3 / 11.0))
    r["armed"] = None
    for name in ("worker_cuda_startup_s", "k1_roofline", "k3_roofline",
                 "device_idle_pct"):
        assert _reader(name)(r) is None


def test_metric_selection():
    """End-to-end metrics without a cell list apply to every cell; a
    per-layer metric goes to the cells it lists, or without a list to
    every cell that reports the end-to-end metric it moves."""
    bench = {"end_to_end": [{"name": "rate"},
                            {"name": "f1", "workloads": ["a"]}],
             "per_layer": [{"name": "k3", "moves": "rate", "workloads": ["a"]},
                           {"name": "idle", "moves": "rate"},
                           {"name": "only_f1", "moves": "f1"}]}
    names = [m["name"] for m in run.metric_names(bench, "b", False)]
    assert names == ["rate"]
    assert [m["name"] for m in run.metric_names(bench, "a", False)] == \
        ["rate", "f1"]
    assert [m["name"] for m in run.metric_names(bench, "a", True)] == \
        ["k3", "idle", "only_f1"]
    assert [m["name"] for m in run.metric_names(bench, "b", True)] == \
        ["idle"]
    real = json.load(open(os.path.join(os.path.dirname(SVBENCH),
                                       "BENCHMARK.json")))
    for cell in real["workloads"]:
        assert {m["name"] for m in run.metric_names(real, cell["name"],
                                                    True)}
