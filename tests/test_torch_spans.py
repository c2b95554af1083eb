"""The spans of an armed workflow run (``parallel/worker_trace``), on the
CPU.

Held here: a span's parent and self time; unarmed, ``span`` is one
shared object that reads no clock and allocates nothing, and a -j 2 run
records no span and writes no file; armed at -j 2, the workflow process,
each phase-1 segment worker and each phase-2 worker write a record with
the run's identifier; each phase-2 stage span lies in its worker's
``worker`` span; the stage spans' walls are those the edge statistics
(``svCandidateGenerationStats.tsv``) report; the ``phase2`` span lies on
the workflow log's stamps; at -j 1 the stage spans nest under
``phase2``.

The runs are on the seeded WGS-shaped workload of 1 chromosome x 2 Mb
at 20x of ``test_torch_worker_trace.py``, scanned in 1 Mb segments so
that phase 1 forks its workers, and scored on the CPU."""

import datetime
import glob
import json
import os
import re
import subprocess
import sys
import time
import tracemalloc

import pytest

from manta_tpu_torch.parallel import worker_trace

from test_torch_kernel_work import GEN
from test_torch_standalone import _PRELUDE

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from svbench import spans as span_math  # noqa: E402

STAGES = ("chunk.find", "chunk.assemble", "chunk.contig_align",
          "chunk.score")


@pytest.fixture(scope="module")
def prefix(tmp_path_factory):
    d = tmp_path_factory.mktemp("sp")
    out = str(d / "w")
    proc = subprocess.run(
        [sys.executable, "-m", "manta_tpu_torch.tools.wgs_workload", "--out",
         out, *GEN], capture_output=True, text=True, timeout=600, cwd=REPO)
    assert proc.returncode == 0, proc.stderr[-2000:]
    return out


# a workflow in a child: armed into argv[5] unless it is "-", at -j
# argv[4]; with "-", every span that would be recorded raises (in the
# forked workers too), and so would the run
_RUN = r"""
from manta_tpu_torch.parallel import worker_trace
from manta_tpu_torch.workflow.run import run_workflow
prefix, run_dir, jobs, trace_dir = sys.argv[2:6]
if trace_dir == "-":
    def _refuse(*a, **k):
        raise AssertionError("a span was recorded unarmed")
    worker_trace._Span.__init__ = _refuse
else:
    worker_trace.arm(trace_dir)
run_workflow([prefix + ".bam"], [], prefix + ".fa", run_dir,
             n_jobs=int(jobs), scan_size_mb=1, use_device_scoring="exact",
             device="cpu", verbose=False)
print(json.dumps({"pid": os.getpid(), "rec": worker_trace._REC is None,
                  "foreign": foreign()}))
"""


def _run(prefix, run_dir, jobs, trace_dir="-"):
    proc = subprocess.run(
        [sys.executable, "-c", _PRELUDE + "import os\n" + _RUN, REPO, prefix,
         run_dir, str(jobs), trace_dir], capture_output=True, text=True,
        timeout=600, cwd=REPO, env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


def _records(trace_dir):
    out = []
    for path in sorted(glob.glob(os.path.join(trace_dir, "*.json"))):
        with open(path) as f:
            out.append((os.path.basename(path), json.load(f)))
    return out


@pytest.fixture(scope="module")
def armed(prefix, tmp_path_factory):
    """An armed -j 2 run: (the child's line, its records by file name,
    its run directory)."""
    d = tmp_path_factory.mktemp("armed")
    trace_dir = d / "trace"
    trace_dir.mkdir()
    line = _run(prefix, str(d / "run"), 2, str(trace_dir))
    return line, _records(str(trace_dir)), str(d / "run")


def _fresh(monkeypatch, tmp_path):
    monkeypatch.setattr(worker_trace, "_REC", None)
    monkeypatch.setattr(worker_trace, "_WORKER", None)
    monkeypatch.setattr(worker_trace, "_ARMED",
                        {"dir": str(tmp_path), "device": True})


def test_spans_nest_with_their_parents_and_self_time(monkeypatch, tmp_path):
    """In one process: each span's parent is the span open around it, and
    its self time is its duration less what its children cover (two
    children that overlap count once)."""
    _fresh(monkeypatch, tmp_path)

    @worker_trace.traced_workflow
    def run():
        with worker_trace.span("phase2"):
            with worker_trace.span("chunk.score", n=3):
                time.sleep(0.02)
                with worker_trace.span("k3.route", pairs=4):
                    time.sleep(0.03)
            with worker_trace.span("chunk.find"):
                time.sleep(0.01)
        return 7

    assert run() == 7
    assert worker_trace._REC is None
    ((name, rec),) = _records(str(tmp_path))
    assert name == f"trace.{os.getpid()}.json"
    assert rec["role"] == "workflow" and rec["pid"] == os.getpid()
    assert rec["run"][0] == os.getpid() and rec["forked_from"] is None
    names = [s[0] for s in rec["spans"]]
    assert names == ["workflow", "phase2", "chunk.score", "k3.route",
                     "chunk.find"]
    assert [s[3] for s in rec["spans"]] == [None, 0, 1, 2, 1]
    assert rec["spans"][2][4] == {"n": 3}
    assert rec["spans"][3][4] == {"pairs": 4}
    for s in rec["spans"]:
        assert rec["run"][1] <= s[1] <= s[2]
    for s, own in zip(rec["spans"], span_math.self_ns(rec["spans"])):
        kids = [c for c in rec["spans"] if c[3] == names.index(s[0])]
        assert own == s[2] - s[1] - sum(c[2] - c[1] for c in kids)
    score = span_math.self_s(span_math.processes([rec]), "chunk.score")
    assert score[1] == 1 and 0.015 <= score[0] < 0.03
    # overlapping children count once
    made = [["a", 0, 100, None, {}], ["b", 10, 60, 0, {}],
            ["c", 40, 80, 0, {}], ["d", 50, 55, 1, {}]]
    assert span_math.self_ns(made) == [30, 45, 40, 5]


def test_unarmed_span_is_one_object_with_no_clock_and_no_allocation(
        monkeypatch):
    monkeypatch.setattr(worker_trace, "_REC", None)

    def _clock():
        raise AssertionError("a clock was read unarmed")

    monkeypatch.setattr(time, "time_ns", _clock)
    first = worker_trace.span("chunk.find")
    assert worker_trace.span("k3.route", pairs=9) is first

    def calls(n):
        for i in range(n):
            with worker_trace.span("chunk.find"):
                pass
            with worker_trace.span("k3.route", pairs=i):
                pass

    calls(100)
    tracemalloc.start()
    try:
        before = tracemalloc.get_traced_memory()[0]
        calls(20_000)
        after, peak = tracemalloc.get_traced_memory()
    finally:
        tracemalloc.stop()
    assert after - before < 512 and peak - before < 4096


def test_spans_only_arming_makes_no_context_of_its_own(monkeypatch,
                                                       tmp_path):
    """Armed with ``device=False``, a phase-2 worker's first call on a
    CUDA device makes no context and starts no profiler (the seam's
    own call makes the context, as unarmed): no ``cuda.context`` or
    ``trace.start`` span, no start-up time. On this CPU-only build a
    context made here would raise; the record's writer is not
    registered, as this process does not exit here."""
    _fresh(monkeypatch, tmp_path)
    worker_trace.arm(str(tmp_path), device=False)
    from manta_tpu_torch.parallel import forkpool
    monkeypatch.setattr(forkpool, "at_process_exit", lambda fn: None)
    worker_trace.enter_phase2_worker(3)
    with worker_trace.span("k3.route", pairs=1):
        worker_trace.device_call("cuda")
    worker_trace.device_call("cuda")
    w, rec = worker_trace._WORKER, worker_trace._REC
    assert w["touched"] and w["cuda_startup_s"] is None
    assert w["profiler"] is None
    assert [s[0] for s in rec["spans"]] == ["worker", "k3.route"]
    worker_trace.disarm()
    assert worker_trace._REC is None and worker_trace._WORKER is None


def test_unarmed_run_records_no_span_and_writes_no_file(prefix, tmp_path):
    run_dir = tmp_path / "run"
    line = _run(prefix, str(run_dir), 2)
    assert line["rec"] and line["foreign"] == []
    assert glob.glob(str(tmp_path / "**" / "*trace.*.json"),
                     recursive=True) == []


def test_armed_run_every_process_writes_a_record_of_the_run(armed):
    """The workflow process, the phase-1 segment workers and the
    phase-2 workers each write one record; each carries the run's
    identifier: the workflow process's pid and start."""
    line, recs, _run_dir = armed
    roles = {}
    for name, r in recs:
        roles.setdefault(r["role"], []).append(r)
        stem = "device_trace" if r["role"] == "phase2" else "trace"
        assert name == f"{stem}.{r['pid']}.json"
        assert set(s[0] for s in r["spans"]) <= set(
            worker_trace.SPANS[r["role"]] + worker_trace.SPANS["device"])
    (wf,) = roles["workflow"]
    assert wf["pid"] == line["pid"] and line["rec"]
    assert len(roles["phase1"]) == 2 and len(roles["phase2"]) == 2
    for _name, r in recs:
        assert r["run"] == [wf["pid"], wf["run"][1]]
        if r is not wf:
            assert r["forked_from"]["pid"] == wf["pid"]
    assert [s[0] for s in wf["spans"]] == [
        "workflow", "phase0.fragstats", "phase0.depth", "phase1.segments",
        "phase1.merge", "phase1.finalize", "phase1.save", "phase1.load",
        "phase2", "phase2.merge_shards", "final.sort_index"]
    regions = [s[4]["regions"] for r in roles["phase1"] for s in r["spans"]]
    assert sorted(regions) == [[[0, 0, 1_000_000]],
                               [[0, 1_000_000, 2_000_000]]]
    # the phase-2 workers' copies of the workflow's spans at their fork:
    # phases 0 and 1 closed, "workflow" and "phase2" open
    for r in roles["phase2"]:
        copy = r["forked_from"]["spans"]
        assert [s[0] for s in copy] == [s[0] for s in wf["spans"][:9]]
        assert [s[0] for s in copy if s[2] is None] == ["workflow", "phase2"]
    # a phase-0 to phase-1 view from the phase-2 workers' files alone
    alone = span_math.processes([r for r in roles["phase2"]])
    assert span_math.workflow_s(alone, ("phase1.merge",)) == pytest.approx(
        span_math.workflow_s(span_math.processes([wf]), ("phase1.merge",)))


def test_phase2_stage_spans_lie_in_their_worker_span(armed):
    _line, recs, _run_dir = armed
    workers = [r for _n, r in recs if r["role"] == "phase2"]
    for r in workers:
        spans = r["spans"]
        assert spans[0][0] == "worker" and spans[0][3] is None
        assert spans[0][4] == {"bin": r["bin"]}
        inside = set(span_math._inside(spans, 0))
        assert inside == set(range(1, len(spans)))
        names = {s[0] for s in spans}
        assert {"worker.setup", "worker.write", *STAGES} <= names
        for s in spans[1:]:
            assert spans[0][1] <= s[1] <= s[2] <= spans[0][2]
            if s[0] in STAGES:
                assert spans[s[3]][0] == "worker"
            if s[0] == "k3.route":
                assert spans[s[3]][0] == "chunk.score" and s[4]["pairs"] > 0
            if s[0] == "k1.dispatch":
                assert spans[s[3]][0] == "chunk.contig_align"
        assert span_math.worker_coverage(spans) >= 0.95


def _edge_walls(stats_path):
    """The [AllEdges] candidate, assembly and scoring walls (s) of
    svCandidateGenerationStats.tsv: per edge times the edge count."""
    with open(stats_path) as f:
        text = f.read().split("[RemoteEdges]")[0].split("[AllEdges]")[1]
    edges = int(re.search(r"InputEdgeCount\t(\d+)", text).group(1))
    return {label: float(re.search(label + r"SecsPerEdge\t([0-9.]+)s wall",
                                   text).group(1)) * edges
            for label in ("candi", "assem", "score")}


def test_stage_walls_match_the_edge_statistics(armed):
    """The summed walls of the stage spans are the walls the edge
    statistics report, within 5% or 5 ms: candidates (``chunk.find``),
    assembly (``chunk.assemble`` with ``chunk.contig_align``, whose
    contig alignment the statistics give to assembly by job share) and
    scoring (``chunk.score``)."""
    _line, recs, run_dir = armed
    walls = _edge_walls(os.path.join(run_dir, "results", "stats",
                                     "svCandidateGenerationStats.tsv"))
    summed = dict.fromkeys(STAGES, 0)
    for _n, r in recs:
        if r["role"] == "phase2":
            for s in r["spans"]:
                if s[0] in summed:
                    summed[s[0]] += (s[2] - s[1]) / 1e9
    pairs = {"candi": summed["chunk.find"],
             "assem": summed["chunk.assemble"]
             + summed["chunk.contig_align"],
             "score": summed["chunk.score"]}
    for label, got in pairs.items():
        assert abs(got - walls[label]) <= max(0.05 * walls[label],
                                              0.005), (label, got, walls)


def _stamp(log, text):
    m = re.search(r"\[([0-9T:.-]+)\] " + text, log)
    return datetime.datetime.fromisoformat(m.group(1)).timestamp()


def test_phase2_span_lies_on_the_log_stamps(armed):
    _line, recs, run_dir = armed
    (wf,) = [r for _n, r in recs if r["role"] == "workflow"]
    (p2,) = [s for s in wf["spans"] if s[0] == "phase2"]
    with open(os.path.join(run_dir, "workspace", "workflow_log.txt")) as f:
        log = f.read()
    start = _stamp(log, "generating and scoring SV candidates")
    end = _stamp(log, r"processed \d+ graph edges")
    assert abs(p2[1] / 1e9 - start) <= 0.010
    assert abs(p2[2] / 1e9 - end) <= 0.010


def test_at_jobs_1_the_stage_spans_nest_under_phase2(prefix, tmp_path):
    """At -j 1 the workflow process scores the edges: one record, its
    stage spans under ``phase2`` and the segments' scan under
    ``phase1.segments``; no phase-2 worker file."""
    trace_dir = tmp_path / "trace"
    trace_dir.mkdir()
    _run(prefix, str(tmp_path / "run"), 1, str(trace_dir))
    ((name, rec),) = _records(str(trace_dir))
    assert name.startswith("trace.") and rec["role"] == "workflow"
    spans = rec["spans"]
    names = [s[0] for s in spans]
    p2 = names.index("phase2")
    for s in spans:
        if s[0] in STAGES:
            assert s[3] == p2
        if s[0] == "k3.route":
            assert spans[s[3]][0] == "chunk.score"
    assert spans[names.index("phase1.segment")][3] == \
        names.index("phase1.segments")
    assert {"chunk.find", "chunk.assemble", "chunk.score"} <= set(names)
