"""The span metrics' arithmetic (``svbench/spans.py`` and the eight
readers of the program's spans) on hand-made records; the breakdown
named by span; and every per-layer metric the benchmark had before the
spans, read the same from records with and without them."""

from __future__ import annotations

import copy
import gzip
import importlib.util
import json
import os

import pytest

from svbench import run, spans

SVBENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
NEW = ("phase0_s", "phase1_segments_s", "phase1_merge_s", "phase2_find_s",
       "phase2_assembly_s", "phase2_score_s", "phase2_worker_skew",
       "k3_router_ms_per_call")
OLD = ("graph_build_s", "phase2_s", "worker_cuda_startup_s", "k1_roofline",
       "k3_roofline", "k3_launches_per_mread", "device_idle_pct")
MS = 1_000_000       # ns
T0 = 1_700_000_000 * 10 ** 9


def _reader(name):
    spec = importlib.util.spec_from_file_location(
        f"svbench_metric_{name}", os.path.join(SVBENCH, "metrics",
                                               f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _s(name, a_ms, b_ms, parent=None, **attrs):
    return [name, T0 + a_ms * MS,
            None if b_ms is None else T0 + b_ms * MS, parent, attrs]


# the workflow process's spans as a phase-2 worker's fork left them:
# phases 0 and 1 closed, "workflow" and "phase2" open
WORKFLOW = [_s("workflow", 0, None), _s("phase0.fragstats", 10, 1010, 0),
            _s("phase0.depth", 1010, 1510, 0),
            _s("phase1.segments", 1520, 4520, 0),
            _s("phase1.merge", 4520, 4720, 0),
            _s("phase1.finalize", 4720, 4820, 0),
            _s("phase1.save", 4820, 4920, 0), _s("phase1.load", 4920, 5020, 0),
            _s("phase2", 5030, None, 0)]


def _worker(pid, end_ms, trace_ms):
    """A phase-2 worker from 5100 ms: its context and trace start in its
    first router call (1000 ms and ``trace_ms``), two edges, a trace
    stop of 300 ms at its end."""
    t = 5100
    sp = [_s("worker", t, end_ms, bin=pid % 10),
          _s("worker.setup", t, t + 100, 0)]
    t += 100
    sp.append(_s("chunk.find", t, t + 200, 0))             # 2
    sp.append(_s("chunk.assemble", t + 200, t + 500, 0))   # 3
    sp.append(_s("chunk.contig_align", t + 500, t + 600, 0))
    sp.append(_s("k1.dispatch", t + 510, t + 590, 4))
    sp.append(_s("chunk.score", t + 600, t + 2900 + trace_ms, 0))  # 6
    sp.append(_s("k3.route", t + 700, t + 2720 + trace_ms, 6, pairs=8))
    sp.append(_s("cuda.context", t + 701, t + 1701, 7))
    sp.append(_s("trace.start", t + 1701, t + 1701 + trace_ms, 7))
    sp.append(_s("k3.route", t + 2750 + trace_ms, t + 2760 + trace_ms, 6,
                 pairs=2))
    sp.append(_s("worker.write", t + 2900 + trace_ms,
                 t + 3000 + trace_ms, 0))
    sp.append(_s("trace.stop", end_ms - 300, end_ms, 0))
    return {"pid": pid, "role": "phase2", "run": [100, T0], "bin": pid % 10,
            "finished": True, "touched": True, "cuda_startup_s": 1.0,
            "clock": "wall", "events": [], "spans": sp,
            "forked_from": {"pid": 100, "role": "workflow",
                            "spans": copy.deepcopy(WORKFLOW)}}


def _records():
    # worker 11: its trace starts in 7 s; worker 12 in 12 s and ends 2 s
    # later than the first besides
    return [_worker(11, 5100 + 3000 + 7000 + 400, 7000),
            _worker(12, 5100 + 3000 + 12000 + 2400, 12000)]


def _run(recs):
    return {"samples": [], "reads": 0, "armed": {"workers": recs}}


def test_processes_and_self_time():
    procs = spans.processes(_records())
    assert sorted(procs) == [11, 12, 100]
    assert procs[100]["role"] == "workflow"
    own = spans.self_ns(procs[11]["spans"])
    # chunk.score: 2300 + 7000 ms less its two router calls
    assert own[6] == (2300 + 7000 - 2020 - 7000 - 10) * MS
    # the first router call: less its context and its trace's start
    assert own[7] == (2020 + 7000 - 1000 - 7000) * MS
    assert own[0] is not None and own[1] == 100 * MS
    assert spans.self_ns(procs[100]["spans"])[0] is None     # left open


def test_each_new_metric_on_hand_made_records():
    r = _run(_records())
    got = {n: _reader(n)(r) for n in NEW}
    assert got["phase0_s"] == pytest.approx(1.5)
    assert got["phase1_segments_s"] == pytest.approx(3.0)
    assert got["phase1_merge_s"] == pytest.approx(0.5)
    assert got["phase2_find_s"] == pytest.approx(0.4)
    assert got["phase2_assembly_s"] == pytest.approx(0.6)
    assert got["phase2_score_s"] == pytest.approx(2 * (2300 - 2030) / 1e3)
    # worker 11: 10.4 s less 7 s and 0.3 s; worker 12: 17.4 s less 12.3 s
    assert got["phase2_worker_skew"] == pytest.approx(5.1 / ((5.1 + 3.1) / 2))
    # four router calls: 1020 ms and 10 ms of their own each two times
    assert got["k3_router_ms_per_call"] == pytest.approx(
        (2 * 1020 + 2 * 10) / 4)


def test_new_metrics_are_none_without_spans():
    """The parent's records (no spans, no role) and a run without a
    traced sample: every new metric reads nothing."""
    old = [{k: v for k, v in w.items()
            if k not in ("spans", "role", "run", "forked_from")}
           for w in _records()]
    for name in NEW:
        assert _reader(name)(_run(old)) is None
        assert _reader(name)({"armed": None}) is None
        assert _reader(name)(_run([])) is None


def test_worker_and_seam_coverage():
    (w, _w2) = _records()
    assert spans.worker_coverage(w["spans"]) == pytest.approx(1.0)
    # a stage that no span covers: its 0.2 s of the worker's 10.4 s
    w["spans"][2][0] = "elsewhere"
    assert spans.worker_coverage(w["spans"]) == pytest.approx(
        1 - 200 / 10400)
    w["events"] = [["void jump_systolic_kernel<3>", T0 + 5715 * MS, 10],
                   ["split_score_kernel(...)", T0 + 5100 * MS + 9719 * MS,
                    10],
                   ["split_score_kernel(...)", T0 + 9 * MS, 10],
                   ["Memcpy HtoD", T0 + 9 * MS, 10]]
    assert spans.seam_coverage(w) == (2, 3)


def _armed(recs, events):
    return {"workers": recs, "start_s": T0 / 1e9, "end_s": T0 / 1e9 + 20,
            "wall_s": 20.0, "phases": {
                "start": T0 / 1e9 + 0.01, "phase2_start": T0 / 1e9 + 5.03,
                "phase2_end": T0 / 1e9 + 18.0, "end": T0 / 1e9 + 19.0}}


def test_idle_gaps_named_by_the_span_open_in_most_processes():
    recs = _records()
    armed = _armed(recs, [])
    pieces = spans.breakdown(armed)["idle_gaps"]
    gaps: dict = {}
    for n, d in spans.idle_gaps([], armed["start_s"], armed["end_s"],
                                armed["phases"], spans.processes(recs)):
        gaps[n] = gaps.get(n, 0.0) + d
    p2 = "phase 2: candidates, assembly and scoring"
    # both workers start their traces at 6.901 s: 7 s on both; worker
    # 11's router call, then its stages, tie with worker 12's trace and
    # go first by name until its write (15.1 s); worker 12's trace is
    # the only vote from worker 11's end (15.5 s) to phase 2's (18 s)
    assert pieces[0] == [f"{p2} / trace.start", pytest.approx(7.0)]
    assert gaps[f"{p2} / trace.start"] == pytest.approx(7.0 + 2.9)
    assert gaps[f"{p2} / k3.route"] == pytest.approx(0.001 + 1.019 + 0.01)
    assert gaps[f"{p2} / cuda.context"] == pytest.approx(1.0)
    assert gaps[p2] == pytest.approx(0.07)
    # in the fan-out the workflow process only waits: no vote, the phase
    assert gaps["phases 0-1: statistics and graph build"] == \
        pytest.approx(3.0)
    assert gaps[
        "phases 0-1: statistics and graph build / phase0.fragstats"] == \
        pytest.approx(1.0)
    # without spans: what the run's own breakdown returns
    bare = [{k: v for k, v in w.items() if k != "spans"} for w in recs]
    assert spans.breakdown(_armed(bare, [])) == run.breakdown(
        _armed(bare, []))


def test_ties_go_to_the_first_name():
    a = {"pid": 1, "role": "phase2",
         "spans": [_s("chunk.score", 0, 100), _s("chunk.find", 100, 200)]}
    b = {"pid": 2, "role": "phase2",
         "spans": [_s("chunk.find", 0, 100), _s("chunk.score", 100, 200)]}
    procs = spans.processes([a, b])
    gaps = spans.idle_gaps([], T0 / 1e9, T0 / 1e9 + 0.2, {}, procs)
    assert gaps == [("workflow start-up / chunk.find", pytest.approx(0.2))]


def _recorded():
    """A traced sample of ``germline35x.exact`` as the card recorded it,
    its records' spans, role, run and ``forked_from`` taken out."""
    with gzip.open(os.path.join(DATA, "traced_sample.json.gz"), "rt") as f:
        return json.load(f)


def test_breakdown_of_a_recorded_sample_without_spans_is_unchanged():
    armed = _recorded()
    assert armed["workers"] and all("spans" not in w
                                    for w in armed["workers"])
    assert spans.breakdown(armed) == run.breakdown(armed)


def test_existing_metrics_read_the_same_with_and_without_spans(tmp_path):
    """The metrics the benchmark had before the spans, on the recorded
    sample's records as they were, and with spans, a role and the run's
    identifier added and the other processes' ``trace.*.json`` files
    beside them in the trace directory."""
    armed = _recorded()
    samples = [{"wall_s": 11.0, "error": None, "reads": 11_200_000,
                "phases": {"graph_build_s": 5.2, "phase2_s": 4.9},
                "exit": {"k3_launches": 780}}]
    before = {"samples": samples, "reads": 11_200_000, "armed": armed}
    plain = {n: _reader(n)(before) for n in OLD}
    assert all(v is not None for v in plain.values())
    d = tmp_path / "trace"
    d.mkdir()
    for w in armed["workers"]:
        rec = dict(w, role="phase2", run=[100, T0],
                   spans=_records()[0]["spans"])
        (d / f"device_trace.{w['pid']}.json").write_text(json.dumps(rec))
    for pid, role in ((100, "workflow"), (101, "phase0"), (102, "phase1")):
        (d / f"trace.{pid}.json").write_text(json.dumps(
            {"role": role, "pid": pid, "run": [100, T0], "spans": [],
             "forked_from": None}))
    workers = run.read_worker_traces(str(d))
    assert len(workers) == len(armed["workers"])
    after = dict(before, armed=dict(armed, workers=workers))
    assert {n: _reader(n)(after) for n in OLD} == plain
