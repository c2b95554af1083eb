"""The trio cell's per-layer readers and what they read: ``score_sample_ms``
and ``score_genotype_s`` on hand-made worker records, the phase-2 span
names that ``phase2_score_s`` and ``k3_router_ms_per_call`` take self
times of, and the scorer's counter in a process that scored nothing."""

from __future__ import annotations

import importlib.util
import json
import os
import subprocess
import sys

import pytest

SVBENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(SVBENCH)
MS = 1_000_000


def _reader(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(SVBENCH, "metrics", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _worker(junctions, samples, evidence_ms, genotype_ms, spans=()):
    return {"counts": {"joint": {
        "junctions": junctions, "sample_junctions": junctions * samples,
        "fragments": [100 * junctions] * samples,
        "evidence_ns": evidence_ms * MS, "genotype_ns": genotype_ms * MS}},
        "spans": list(spans)}


def test_readers_on_hand_made_workers():
    # two trio workers: 10 and 30 junctions, 3 samples each; the first
    # opened its context and trace inside its first k3.route (250 and
    # 750 ms) while gathering evidence
    spans = [["chunk.score", 0, 2000 * MS, None, {"samples": 3}],
             ["k3.route", 10 * MS, 1100 * MS, 0, {"pairs": 4}],
             ["cuda.context", 20 * MS, 270 * MS, 1, {}],
             ["trace.start", 270 * MS, 1020 * MS, 1, {}],
             ["cuda.context", 1500 * MS, 1600 * MS, 0, {}]]
    run = {"armed": {"workers": [_worker(10, 3, 1300, 40, spans),
                                 _worker(30, 3, 600, 20)]}}
    # (1300 - 250 - 750 + 600) ms over 120 sample-junctions; the context
    # outside a k3.route is not the router's
    assert _reader("score_sample_ms")(run) == pytest.approx(900 / 120)
    assert _reader("score_genotype_s")(run) == pytest.approx(0.06)


def test_readers_find_nothing_without_the_counter():
    for name in ("score_sample_ms", "score_genotype_s"):
        read = _reader(name)
        assert read({"armed": None}) is None
        # a program before the counter: records without counts["joint"]
        assert read({"armed": {"workers": [
            {"counts": {"launches": {}}, "spans": []}, {}]}}) is None
        # no junction scored
        assert read({"armed": {"workers": [_worker(0, 3, 0, 0)]}}) is None


def test_benchmark_lists_the_trio_beside_the_germline_cell():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    cells = {w["name"]: w for w in bench["workloads"]}
    assert cells["trio35x.exact"]["config"] == "trio_wgs35x"
    assert cells["trio35x.exact"]["chips"] == 1
    for name in ("score_sample_ms", "score_genotype_s"):
        m = next(m for m in bench["per_layer"] if m["name"] == name)
        assert m["workloads"] == ["germline35x.exact", "trio35x.exact"]
        assert m["source"] == "program_counter"
    with open(os.path.join(SVBENCH, "configs", "trio_wgs35x.json")) as f:
        assert json.load(f)["samples"] == 3


def test_phase2_span_names_are_unchanged():
    """``phase2_score_s`` is the self time of ``chunk.score`` less its
    children: a span added under it would move the metric without the
    program getting faster. The joint work is counted, not spanned."""
    from manta_tpu_torch.parallel import worker_trace
    assert worker_trace.SPANS["phase2"] == (
        "worker", "worker.setup", "chunk.find", "chunk.assemble",
        "chunk.contig_align", "chunk.score", "worker.write")
    assert worker_trace.SPANS["device"] == (
        "k1.dispatch", "k3.route", "cuda.context", "trace.start",
        "trace.stop")


def test_joint_counts_are_zero_where_nothing_was_scored():
    code = """
import json, sys
sys.path.insert(0, sys.argv[1])
from manta_tpu_torch.parallel import worker_trace
before = worker_trace.counts()["joint"]
import manta_tpu_torch.scoring.scorer
print(json.dumps([before, worker_trace.counts()["joint"],
                  worker_trace.zero_counts()["joint"]]))
"""
    res = subprocess.run([sys.executable, "-c", code, ROOT],
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    before, after, zero = json.loads(res.stdout.strip().splitlines()[-1])
    assert before == after == zero == {
        "junctions": 0, "sample_junctions": 0, "fragments": [],
        "evidence_ns": 0, "genotype_ns": 0}
