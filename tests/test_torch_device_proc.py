"""The run's device process (``parallel/device_proc``), on the CPU.

The route runs here with ``device="cpu"``: the tests widen
``device_proc.DEVICE_TYPES`` to the CPU in a child process, so that the
device process runs the plain forms of K1 and K3 where on the card it
runs the kernels. Held here:

- the client against the in-process call, bit for bit: K1's scores over
  the scorer's bucket shapes (rows 8 to 64, query and reference tiers
  128 to 2048, empty references, a buffer that has to grow) and K3's
  best ln-likelihoods and positions over the split scan's read and scan
  tiers, one to three targets, the matmul form and its IUPAC fallback;
- a request that fails raises in its caller with the device process's
  traceback, and the device process serves on; one that is gone fails
  the next call;
- which runs engage it (``engages``), and that -j 1 and a caller's
  ``jump_scorer`` keep the in-process path in a whole run;
- a -j 2 run through it: the VCFs are the in-process run's, one exit
  line of each kind comes from the device process with the calls of the
  in-process run's workers, the records say who did what, the workflow
  process makes no CUDA call, and no child outlives ``run_workflow``,
  also where a worker raises.

The runs are on the seeded WGS-shaped workload of 1 chromosome x 2 Mb at
20x of ``test_torch_worker_trace.py``, scanned in 1 Mb segments, in
children that fork their workers."""

import ast
import glob
import gzip
import json
import os
import re
import subprocess
import sys

import pytest
import torch

from manta_tpu_torch.parallel import device_proc, worker_trace
from svbench import logs

from test_torch_kernel_work import GEN
from test_torch_standalone import _PRELUDE

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# (seed, rows, longest query, longest reference, gap open, jump score,
# empty references)
K1_CASES = {
    "one_row": (1, 1, 40, 80, -12, -100, False),
    "rows_8": (2, 7, 120, 200, -12, -100, False),
    "rows_16_open18": (3, 12, 200, 120, -18, -100, False),
    "rows_32_tier_512": (4, 20, 300, 500, -12, -100, False),
    "empty_references": (5, 9, 90, 60, -12, -100, True),
    "query_tier_2048": (6, 3, 1500, 300, -12, -100, False),
    "buffer_grows": (7, 40, 1100, 1000, -12, -60, False),
}
# (seed, reads, targets, shortest and longest read, longest target, mxu,
# an IUPAC code in a target)
K3_CASES = {
    "one_target": (11, 5, 1, (20, 80), 300, False, False),
    "read_tier_512": (12, 30, 2, (150, 300), 900, False, False),
    "scan_tier_4096": (13, 24, 2, (40, 100), 3000, False, False),
    "three_targets": (14, 120, 3, (30, 90), 700, False, False),
    "mxu": (15, 40, 2, (40, 100), 500, True, False),
    "mxu_iupac_fallback": (16, 8, 2, (40, 100), 300, True, True),
}

_CLIENT = r"""
import os, signal, numpy as np, torch
from types import SimpleNamespace
from manta_tpu_torch.parallel import device_proc
from manta_tpu_torch.align import device_jumpscore as dj
from manta_tpu_torch.scoring import device_scan
from manta_tpu_torch.scoring.evidence import QscoreSnp
K1, K3 = json.loads(sys.argv[2]), json.loads(sys.argv[3])
BASES = np.frombuffer(b"ACGT", np.uint8)


def k1_case(seed, rows, nq, nr, open_, jump, empty):
    rng = np.random.default_rng(seed)
    seq = lambda n: BASES[rng.integers(0, 4, n)].tobytes()
    jobs = [(seq(int(rng.integers(1, nq + 1))),
             b"" if empty and i % 2 else seq(int(rng.integers(1, nr + 1))),
             b"" if empty and i % 3 == 0 else seq(int(rng.integers(1, nr + 1))))
            for i in range(rows)]
    scores = SimpleNamespace(match=2, mismatch=-8, open=open_, extend=-1,
                             off_edge=-1)
    return lambda: dj.make_bucketed_scorer(scores, jump, "cpu")(jobs)


def k3_case(seed, n, t, read_len, target_len, mxu, iupac):
    rng = np.random.default_rng(seed)
    lens = rng.integers(read_len[0], read_len[1] + 1, n)
    off = np.zeros(n + 1, np.int64)
    off[1:] = np.cumsum(lens)
    batch = SimpleNamespace(
        seq=BASES[rng.integers(0, 4, off[-1])],
        qual=rng.integers(2, 41, off[-1]).astype(np.uint8),
        seq_off=off, qual_off=off.copy(), n=n)
    targets = [BASES[rng.integers(0, 4, int(rng.integers(
        target_len // 2, target_len + 1)))] for _ in range(t)]
    if iupac:
        targets[0] = targets[0].copy()
        targets[0][5] = ord("M")
    ranges = [(int(rng.integers(0, len(tg) // 2)), len(tg) // 2 + 20)
              for tg in targets]
    idx = np.arange(n, dtype=np.int64)
    return lambda: device_scan.DeviceScanContext(mxu=mxu, device="cpu") \
        .scan_multi(16, batch, idx, QscoreSnp(1e-3), targets, ranges)


def same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and \
        a.tobytes() == b.tobytes()


calls = {("k1", k): k1_case(*v) for k, v in K1.items()}
calls.update({("k3", k): k3_case(*v) for k, v in K3.items()})
want = {k: f() for k, f in calls.items()}
# a request that fails: the device process inherits this
score = dj._score
def failing(q, ql, *a):
    if int(ql[0]) == 30 and bool((q[0, :30] == ord("G")).all()):
        raise ValueError("a planted failure")
    return score(q, ql, *a)
dj._score = failing
device_proc.DEVICE_TYPES = ("cuda", "cpu")
device_proc.start(torch.device("cpu"), "exact")
got = {k: f() for k, f in calls.items()}
out = {"k1": {k: same(got["k1", k], want["k1", k]) for k in K1},
       "k3": {k: all(same(g, w) for g, w in zip(got["k3", k], want["k3", k]))
              and len(got["k3", k]) == 2 for k in K3},
       "dtypes": {f"{a}.{k}": [str(np.asarray(x).dtype) for x in
                              (v if a == "k3" else [v])]
                  for (a, k), v in got.items()},
       "counts": dict(device_proc.DEVICE_PROC)}
scores = SimpleNamespace(match=2, mismatch=-8, open=-12, extend=-1,
                         off_edge=-1)
try:
    dj.make_bucketed_scorer(scores, -100, "cpu")([(b"G" * 30, b"A", b"A")])
    out["failed"] = None
except RuntimeError as e:
    out["failed"] = str(e)
out["served_on"] = same(calls["k1", "rows_8"](), want["k1", "rows_8"])
os.kill(device_proc._RUN["proc"].pid, signal.SIGKILL)
device_proc._RUN["proc"].join(60)
try:
    calls["k3", "one_target"]()
    out["dead"] = None
except RuntimeError as e:
    out["dead"] = str(e)
out["stop"] = device_proc.stop()
out["after_stop"] = isinstance(device_proc.route(torch.device("cpu")),
                              device_proc.InProcess)
print(json.dumps(out))
"""


def _child(script, *args, timeout=600):
    proc = subprocess.run(
        [sys.executable, "-c", _PRELUDE + script, REPO, *args],
        capture_output=True, text=True, timeout=timeout, cwd=REPO,
        env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1]), proc.stderr


@pytest.fixture(scope="module")
def client():
    return _child(_CLIENT, json.dumps(K1_CASES), json.dumps(K3_CASES))[0]


@pytest.mark.parametrize("case", list(K1_CASES))
def test_k1_through_the_device_process_is_the_in_process_call(client, case):
    assert client["k1"][case]
    assert client["dtypes"][f"k1.{case}"] == ["int32"]


@pytest.mark.parametrize("case", list(K3_CASES))
def test_k3_through_the_device_process_is_the_in_process_call(client, case):
    assert client["k3"][case]
    assert client["dtypes"][f"k3.{case}"] == ["float32", "int32"]


def test_each_call_is_forwarded_once(client):
    c = client["counts"]                      # after the cases
    assert c["k1_calls"] == len(K1_CASES)
    assert c["k3_calls"] == len(K3_CASES)
    assert c["contexts"] == 0                 # made by no caller
    assert c["bytes_in"] > c["bytes_out"] > 0
    assert 0 <= c["ready_wait_s"] < 60
    assert 0 < c["service_s"] <= c["round_trip_s"]


def test_a_failed_request_raises_in_its_caller_and_the_process_serves_on(
        client):
    assert "a planted failure" in client["failed"]
    assert "Traceback" in client["failed"]
    assert client["served_on"]


def test_a_dead_device_process_fails_the_next_call(client):
    assert "device process exited" in client["dead"]
    assert client["stop"] == -9
    assert client["after_stop"]


# ------------------------------------------------------------ engages

CUDA = torch.device("cuda")
BASE = dict(device=CUDA, n_jobs=8, jump_scorer=None, is_rna=False,
            one_host=True, phase2_to_run=True)


@pytest.mark.parametrize("change, engaged", [
    ({}, True),
    ({"n_jobs": 2}, True),
    ({"n_jobs": 1}, False),
    ({"device": torch.device("cpu")}, False),
    ({"device": None}, False),
    ({"jump_scorer": len}, False),
    ({"is_rna": True}, False),
    ({"one_host": False}, False),
    ({"phase2_to_run": False}, False)],
    ids=["cuda_j8", "cuda_j2", "jobs_1", "cpu", "scoring_off",
         "jump_scorer", "rna", "multi_host_bins", "phase2_done"])
def test_which_runs_engage_a_device_process(change, engaged):
    assert device_proc.engages(**dict(BASE, **change)) is engaged


def test_no_run_no_client():
    assert device_proc._RUN is None
    for device in (CUDA, torch.device("cpu")):
        route = device_proc.route(device)
        assert isinstance(route, device_proc.InProcess)
        assert route.device == device and device_proc.route(device) is route
    assert device_proc.stop() is None


def _tree(path):
    with open(os.path.join(REPO, "manta_tpu_torch", path)) as f:
        return ast.parse(f.read())


def _function(tree, *names):
    """The function reached through ``names``, each one defined in the
    last (a class or a function)."""
    node = tree
    for name in names:
        node = next(n for n in ast.walk(node)
                    if isinstance(n, (ast.FunctionDef, ast.ClassDef))
                    and n.name == name)
    return node


def _called(node, name):
    """The calls in ``node`` of a function or method named ``name``."""
    return [n for n in ast.walk(node) if isinstance(n, ast.Call) and (
        getattr(n.func, "id", None) == name
        or getattr(n.func, "attr", None) == name)]


def test_one_owner_of_the_card_and_one_ledger_of_the_counts():
    """``device_proc`` alone decides where a kernel call runs: each seam
    makes one route call and asks the run trace nothing; the run trace
    reads its counts from the ledger, never from the counting modules;
    and only the ledger and the run trace hook a process's exit."""
    trace = _tree("parallel/worker_trace.py")
    for node in ast.walk(trace):
        if isinstance(node, ast.ImportFrom):
            module = "." * node.level + (node.module or "")
            names = {a.name for a in node.names}
            assert not module.lstrip(".").startswith(("align", "scoring")), \
                module
            assert "device_proc" not in module and \
                "device_proc" not in names, module
        assert not (isinstance(node, ast.Import) and any(
            ".align" in a.name or ".scoring" in a.name
            or "device_proc" in a.name for a in node.names))
        assert not (isinstance(node, ast.Attribute)
                    and node.attr == "modules"
                    and getattr(node.value, "id", None) == "sys")
    seams = {"k1": _function(_tree("align/device_jumpscore.py"),
                             "make_bucketed_scorer", "scorer"),
             "k3": _function(_tree("scoring/device_scan.py"),
                             "DeviceScanContext", "_scan_multi")}
    for kind, seam in seams.items():
        assert len(_called(seam, "route")) == 1, kind
        assert len(_called(seam, kind)) == 1, kind
        assert not any(getattr(n, "id", getattr(n, "attr", None))
                       == "device_call" for n in ast.walk(seam)), kind
    hooks = set()
    for root, _dirs, files in os.walk(os.path.join(REPO, "manta_tpu_torch")):
        for name in files:
            if name.endswith(".py"):
                path = os.path.relpath(os.path.join(root, name), os.path.join(
                    REPO, "manta_tpu_torch"))
                if _called(_tree(path), "at_process_exit"):
                    hooks.add(path)
    assert hooks == {"parallel/counters.py", "parallel/worker_trace.py"}


# ------------------------------------------------------------ whole runs

@pytest.fixture(scope="module")
def prefix(tmp_path_factory):
    d = tmp_path_factory.mktemp("dp")
    out = str(d / "w")
    proc = subprocess.run(
        [sys.executable, "-m", "manta_tpu_torch.tools.wgs_workload", "--out",
         out, *GEN], capture_output=True, text=True, timeout=600, cwd=REPO)
    assert proc.returncode == 0, proc.stderr[-2000:]
    return out


# a workflow at -j argv[4] in exact on the CPU, into argv[3]: argv[5]
# "proc" widens the device process to the CPU, "raise" too and makes
# every phase-2 worker raise, "scorer" too and passes a jump_scorer;
# argv[6] arms the spans into it unless it is "-"
_RUN = r"""
import multiprocessing, os, torch
from manta_tpu_torch.parallel import device_proc, worker_trace
from manta_tpu_torch.workflow.run import run_workflow
prefix, run_dir, jobs, route, trace_dir = sys.argv[2:7]
started = []
start = device_proc.start
def counting(*a):
    started.append(os.getpid())
    return start(*a)
device_proc.start = counting
kw = {}
if route != "in_process":
    device_proc.DEVICE_TYPES = ("cuda", "cpu")
if route == "raise":
    from manta_tpu_torch.candidates import svfinder
    def refuse(*a, **k):
        raise RuntimeError("a planted worker failure")
    svfinder.SVFinder.__init__ = refuse
if route == "scorer":
    from manta_tpu_torch.align.aligners import jump_score_batch
    kw["jump_scorer"] = lambda jobs: jump_score_batch(
        jobs, SCORES, JUMP)
    from manta_tpu_torch.candidates.refiner import RefinerOptions
    SCORES, JUMP = RefinerOptions().spanning_scores, RefinerOptions().jump_score
if trace_dir != "-":
    worker_trace.arm(trace_dir, device=False)
error = None
try:
    run_workflow([prefix + ".bam"], [], prefix + ".fa", run_dir,
                 n_jobs=int(jobs), scan_size_mb=1, use_device_scoring="exact",
                 device="cpu", verbose=False, **kw)
except RuntimeError as e:
    error = str(e)
children = []
for task in os.listdir("/proc/self/task"):
    with open(f"/proc/self/task/{task}/children") as f:
        children += f.read().split()
print(json.dumps({"pid": os.getpid(), "error": error, "started": started,
                  "children": children,
                  "active": [p.pid for p in multiprocessing.active_children()],
                  "cuda": torch.cuda.is_initialized(),
                  "contexts": device_proc.DEVICE_PROC["contexts"],
                  "run_left": device_proc._RUN is not None}))
"""


def _workflow(prefix, run_dir, jobs, route, trace_dir="-"):
    return _child(_RUN, prefix, str(run_dir), str(jobs), route,
                  str(trace_dir))


def _bodies(run_dir):
    out = {}
    for path in sorted(glob.glob(os.path.join(run_dir, "results",
                                              "variants", "*.vcf.gz"))):
        with gzip.open(path, "rt") as f:
            out[os.path.basename(path)] = [
                ln for ln in f if not ln.startswith(("##fileDate",
                                                     "##cmdline"))]
    return out


SCAN_LINE = re.compile(r"split-scan pid=(\d+): (\d+) calls")
DISPATCH_LINE = re.compile(r"device-dispatch pid=(\d+): (\d+) calls, "
                           r"(\d+) jobs")


@pytest.fixture(scope="module")
def runs(prefix, tmp_path_factory):
    """The same -j 2 run in process and through the device process, the
    second armed with the spans: (line, stderr, run directory) each, and
    the second's records."""
    d = tmp_path_factory.mktemp("runs")
    trace = d / "trace"
    trace.mkdir()
    inproc = (*_workflow(prefix, d / "inproc", 2, "in_process"),
              str(d / "inproc"))
    proc = (*_workflow(prefix, d / "proc", 2, "proc", trace),
            str(d / "proc"))
    recs = []
    for path in sorted(glob.glob(str(trace / "*.json"))):
        with open(path) as f:
            recs.append(json.load(f))
    return inproc, proc, recs


def test_jobs_2_vcfs_are_the_in_process_ones(runs):
    inproc, proc, _recs = runs
    want, got = _bodies(inproc[2]), _bodies(proc[2])
    assert set(want) >= {"diploidSV.vcf.gz", "candidateSV.vcf.gz"}
    assert got == want
    assert sum(1 for ln in want["diploidSV.vcf.gz"]
               if not ln.startswith("#")) > 0


def test_jobs_2_the_device_process_prints_the_workers_calls(runs):
    """The exit lines say the same in process and through the device
    process, read by the benchmark's own parser too."""
    inproc, proc, _recs = runs
    assert inproc[0]["started"] == [] and inproc[0]["error"] is None
    assert proc[0]["started"] == [proc[0]["pid"]] and proc[0]["error"] is None
    want_scan = SCAN_LINE.findall(inproc[1])
    want_k1 = DISPATCH_LINE.findall(inproc[1])
    assert len(want_scan) == 2                # one a worker
    got_scan = SCAN_LINE.findall(proc[1])
    got_k1 = DISPATCH_LINE.findall(proc[1])
    assert len(got_scan) == 1 and len(got_k1) <= 1
    assert int(got_scan[0][1]) == sum(int(c) for _p, c in want_scan) > 0
    assert sum(int(c) for _p, c, _j in got_k1) == \
        sum(int(c) for _p, c, _j in want_k1)
    assert sum(int(j) for _p, _c, j in got_k1) == \
        sum(int(j) for _p, _c, j in want_k1)
    pids = {int(p) for p, _c in got_scan} | {int(p) for p, _c, _j in got_k1}
    assert len(pids) == 1 and proc[0]["pid"] not in pids
    sums = logs.exit_lines(proc[1])
    assert sums == logs.exit_lines(inproc[1])
    assert sums["k3_calls"] > 0               # no launch: the CPU's forms


def test_jobs_2_records_say_who_did_what(runs):
    _inproc, proc, recs = runs
    wf = next(r for r in recs if r["role"] == "workflow")
    (dev,) = [r for r in recs if r["role"] == "device_proc"]
    workers = [r for r in recs if r["role"] == "phase2"]
    assert len(workers) == 2 and wf["pid"] == proc[0]["pid"]
    names = [s[0] for s in wf["spans"]]
    assert names[:3] == ["workflow", "device_proc.start", "phase0.fragstats"]
    assert names[-2:] == ["device_proc.stop", "final.sort_index"]
    assert names[names.index("phase2") + 1] == "device_proc.ready"
    ready = wf["spans"][names.index("device_proc.ready")]
    assert wf["spans"][ready[3]][0] == "phase2"
    # the workers are forked after the device process is ready
    assert all(w["forked_from"]["spans"][names.index("device_proc.ready")][2]
               is not None for w in workers)
    assert dev["forked_from"]["pid"] == wf["pid"] and dev["finished"]
    assert [s[0] for s in dev["forked_from"]["spans"]] == [
        "workflow", "device_proc.start"]
    assert set(s[0] for s in dev["spans"]) <= set(
        worker_trace.SPANS["device_proc"])
    served = [s for s in dev["spans"] if s[0].startswith("device_proc.")]
    c = dev["counts"]
    assert c["device_proc"]["contexts"] == 0        # none on the CPU
    assert len(served) == c["calls"]["split_score"] + c["calls"]["jump_score"]
    # every call counted once: by the device process that ran it, and as
    # forwarded by the worker that made it
    assert c["calls"]["split_score"] == sum(
        w["counts"]["device_proc"]["k3_calls"] for w in workers) > 0
    assert c["calls"]["jump_score"] == sum(
        w["counts"]["device_proc"]["k1_calls"] for w in workers)
    assert c["work"]["split_score"]["useful"] > 0
    for w in workers:
        assert w["counts"]["calls"] == {k: 0 for k in w["counts"]["calls"]}
        assert w["counts"]["work"]["split_score"]["useful"] == 0
        assert w["counts"]["device_proc"]["contexts"] == 0
        assert w["cuda_startup_s"] is None and not w["touched"]
    # on the CPU no context is made and none is timed
    assert dev["cuda_startup_s"] is None and dev["events"] is None


def test_jobs_2_the_workflow_process_makes_no_cuda_call(runs):
    _inproc, proc, _recs = runs
    assert proc[0]["cuda"] is False and proc[0]["contexts"] == 0


def test_jobs_2_leaves_no_live_child(runs):
    _inproc, proc, _recs = runs
    assert proc[0]["children"] == [] and proc[0]["active"] == []
    assert proc[0]["run_left"] is False


def test_a_worker_that_raises_leaves_no_live_child(prefix, tmp_path):
    line, err = _workflow(prefix, tmp_path / "run", 2, "raise")
    assert line["started"] == [line["pid"]]
    assert line["error"] and "a planted worker failure" in err
    assert line["children"] == [] and line["active"] == []
    assert line["run_left"] is False


@pytest.mark.parametrize("jobs, route", [(1, "proc"), (2, "scorer")],
                         ids=["jobs_1", "jump_scorer"])
def test_runs_that_keep_the_in_process_path(prefix, tmp_path, jobs, route):
    """With the CPU among the device types, -j 1 and a caller's contig
    scorer still start no device process, and score as before."""
    line, err = _workflow(prefix, tmp_path / "run", jobs, route)
    assert line["error"] is None and line["started"] == []
    scans = SCAN_LINE.findall(err)
    assert scans and all(int(c) > 0 for _p, c in scans)
    if jobs == 1:
        assert {int(p) for p, _c in scans} == {line["pid"]}
    assert _bodies(str(tmp_path / "run"))["diploidSV.vcf.gz"]
