"""The device trace of a -j N run's phase-2 workers, on the CPU.

``parallel/worker_trace`` makes each phase-2 worker of a -j N run keep
its own record when the timing tool arms it
(``tools.device_timing --kernel workflow --jobs N``), and the tool
merges the workers' files. Held here: unarmed, a worker writes no file
and starts no profiler; armed, each phase-2 worker writes one file, and
their counts sum to their exit lines' (``tools/device_counts``); the
merge of made-up traces from two processes (the busy union across them,
each copy given to a launch of its own process, events outside phase 2
and unfinished workers left out); the tool at --jobs 2 makes no CUDA
call in its own process and refuses --device cuda without a card; the
joint and tumor workloads' inputs; and the records at --jobs 2 are
those at --jobs 1 plus the -j N fields.

The runs are on a seeded WGS-shaped workload of 1 chromosome x 2 Mb at
20x (two samples for the joint workload), on the CPU (the plain forms
score; device fields null)."""

import glob
import json
import os
import subprocess
import sys

import pytest

from manta_tpu_torch.tools import device_timing as dt
from manta_tpu_torch.tools.device_counts import parse_lines

from test_torch_kernel_work import GEN, _tool
from test_torch_standalone import _PRELUDE

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def prefix(tmp_path_factory):
    d = tmp_path_factory.mktemp("wt")
    out = str(d / "w")
    proc = subprocess.run(
        [sys.executable, "-m", "manta_tpu_torch.tools.wgs_workload", "--out",
         out, *GEN], capture_output=True, text=True, timeout=600, cwd=REPO)
    assert proc.returncode == 0, proc.stderr[-2000:]
    return out


def _traces(run_dir):
    return sorted(glob.glob(os.path.join(run_dir, "workspace",
                                         "device_trace.*.json")))


# a -j 2 run in a child whose torch.profiler.profile raises: a worker
# that started one would fail, and the run with it
_UNARMED = r"""
import torch.profiler

class _NoProfiler:
    def __init__(self, *a, **k):
        raise AssertionError("a profiler was started")

torch.profiler.profile = _NoProfiler
from manta_tpu_torch.workflow.run import run_workflow
prefix, run_dir = sys.argv[2:4]
run_workflow([prefix + ".bam"], [], prefix + ".fa", run_dir, n_jobs=2,
             use_device_scoring="exact", device="cpu", verbose=False)
print(json.dumps({"foreign": foreign()}))
"""


def test_unarmed_workers_write_no_trace_and_start_no_profiler(prefix,
                                                               tmp_path):
    run_dir = str(tmp_path / "run")
    proc = subprocess.run(
        [sys.executable, "-c", _PRELUDE + _UNARMED, REPO, prefix, run_dir],
        capture_output=True, text=True, timeout=600, cwd=REPO,
        env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = parse_lines(proc.stderr)
    # the workers did score (the split router and the dispatcher ran)
    assert lines["device_processes"] >= 1 and lines["split_scans"] > 0
    assert _traces(run_dir) == []


@pytest.fixture(scope="module")
def armed(prefix, tmp_path_factory):
    """The tool at --jobs 2 on the CPU, exact: (rc, records, stderr,
    run dir)."""
    run_dir = str(tmp_path_factory.mktemp("armed") / "run")
    rc, lines, err = _tool("--kernel", "workflow", "--device", "cpu",
                           "--workload", "wgs", "--mode", "exact",
                           "--prefix", prefix, "--jobs", "2",
                           "--run-dir", run_dir)
    return rc, lines, err, run_dir


def test_armed_cpu_run_writes_a_trace_per_phase2_worker(armed):
    """One file a phase-2 worker, each finished and without device
    events (the cpu); the counts in the files sum to the exit lines'."""
    rc, lines, err, run_dir = armed
    assert rc == 0, err[-3000:]
    files = _traces(run_dir)
    traces = [json.load(open(f)) for f in files]
    *kernels, phase2, _launches = lines
    assert phase2["workers"] == phase2["worker_files"] == len(files) == 2
    assert {t["pid"] for t in traces} == {
        int(f.rsplit(".", 2)[-2]) for f in files}
    for t in traces:
        assert t["finished"] and t["touched"]
        assert t["events"] is None and t["cuda_startup_s"] is None
        # the worker's moments are spans now: its life, its stages, its
        # seams; on the CPU no context and no trace
        assert t["role"] == "phase2" and "marks" not in t
        names = {s[0] for s in t["spans"]}
        assert t["spans"][0][0] == "worker"
        assert {"worker.setup", "worker.write", "k3.route"} <= names
        assert not names & {"cuda.context", "trace.start", "trace.stop"}
    exit_lines = parse_lines(err)
    # each worker ran exact split scans and printed its line
    assert err.count("split-scan pid=") == 2
    summed = {k: sum(t["counts"]["calls"][k] for t in traces)
              for k in dt.KERNEL_OPS}
    assert summed["jump_score"] == exit_lines["dispatches"]
    assert summed["split_score"] == exit_lines["split_scans"] > 0
    assert sum(t["counts"]["work"]["split_score"]["useful"]
               for t in traces) == exit_lines["k3_useful_terms"] > 0
    assert sum(t["counts"]["work"]["jump_score"]["useful"]
               for t in traces) == exit_lines["k1_useful_cells"]
    k1, _k2, k3 = kernels
    assert k3["calls"] == summed["split_score"]
    assert k3["useful_work"] == exit_lines["k3_useful_terms"]
    assert k1["launches_wrapper"] == k1["launches_exit_lines"] == 0
    assert phase2["workers_launched"] == 0
    assert phase2["cuda_startup_s"] is None
    assert phase2["device_busy_ms"] is phase2["busy_share"] is None


def test_records_at_jobs_2_are_those_at_jobs_1_and_the_new_fields(
        armed, prefix, tmp_path):
    rc, lines, err = _tool("--kernel", "workflow", "--device", "cpu",
                           "--workload", "wgs", "--mode", "exact",
                           "--prefix", prefix, "--run-dir",
                           str(tmp_path / "run"))
    assert rc == 0, err[-3000:]
    one = lines[:-1]
    two = armed[1][:-1]
    assert [r.get("kernel") for r in one] == [r.get("kernel") for r in two]
    for a, b in zip(one[:-1], two[:-1]):
        assert set(b) - set(a) == {"launches_exit_lines"}
        assert set(a) <= set(b)
    assert set(two[-1]) - set(one[-1]) == {
        "jobs", "workers", "worker_files", "workers_launched",
        "cuda_startup_s", "clocks", "worker_marks_s",
        "events_outside_phase2", "overlapping_kernels"}
    assert set(one[-1]) <= set(two[-1])
    # the same run's calls: the bins of -j 2 split the same work
    assert [r["useful_work"] for r in one[:-1]] == \
        [r["useful_work"] for r in two[:-1]]


def _counts(k1=0, k3=0, k1_wall=0.0, k3_wall=0.0, useful=(0, 0)):
    from manta_tpu_torch.parallel.worker_trace import zero_counts
    c = zero_counts()
    c["launches"].update(jump_score=k1, split_score=k3)
    c["calls"].update(jump_score=k1, split_score=k3)
    c["wall"].update(jump_score=k1_wall, split_score=k3_wall)
    c["work"]["jump_score"]["useful"] = useful[0]
    c["work"]["split_score"]["useful"] = useful[1]
    return c


K1 = "void (anonymous namespace)::jump_systolic_kernel<3, false, 0>(int)"
K3 = "(anonymous namespace)::split_score_kernel(unsigned char const*)"
H2D = "Memcpy HtoD (Pinned -> Device)"
D2H = "Memcpy DtoH (Device -> Pageable)"
# phase 2 from 1000.000 s to 1000.010 s since the epoch
WINDOW = (1000.0, 1000.01)
US = 1000            # ns


def _ns(us):
    return 1_000_000_000_000 + int(us * US)


def test_merge_of_two_workers_traces():
    """Two processes: their events interleave and overlap in time (one
    card, two contexts); the union counts each instant once, the
    kernels' times add up, each copy goes to a launch of its own
    process (to the card: the next; back: the one before), and an event
    before phase 2 is counted and left out."""
    a = {"pid": 11, "bin": 0, "finished": True, "touched": True,
         "cuda_startup_s": 0.5, "clock": "wall",
         # the worker's life (what were its marks) as its spans
         "spans": [["worker", _ns(-3000), _ns(9000), None, {"bin": 0}],
                   ["k1.dispatch", _ns(50), _ns(350), 0, {}],
                   ["cuda.context", _ns(60), _ns(70), 1, {}],
                   ["trace.start", _ns(70), _ns(90), 1, {}],
                   ["k3.route", _ns(395), _ns(445), 0, {"pairs": 2}],
                   ["worker.write", _ns(500), _ns(600), 0, {}],
                   ["trace.stop", _ns(8000), _ns(8900), 0, {}]],
         "counts": _counts(k1=1, k3=1, k1_wall=0.002, k3_wall=0.001,
                           useful=(100, 10)),
         "events": [[H2D, _ns(-5000), 5 * US],     # phase 1: outside
                    [H2D, _ns(100), 10 * US],
                    [K1, _ns(120), 200 * US],
                    [D2H, _ns(330), 10 * US],
                    [H2D, _ns(400), 4 * US],
                    [K3, _ns(410), 20 * US],
                    [D2H, _ns(440), 2 * US]]}
    b = {"pid": 12, "bin": 1, "finished": True, "touched": True,
         "cuda_startup_s": 1.5, "clock": "wall",
         "counts": _counts(k3=1, k3_wall=0.001, useful=(0, 30)),
         "events": [[H2D, _ns(110), 20 * US],      # overlaps a's copy
                    [K3, _ns(200), 50 * US],       # overlaps a's K1
                    [D2H, _ns(250), 7 * US]]}
    reading = dt.merge_worker_traces([b, a], WINDOW)
    assert reading["workers"] == reading["worker_files"] == 2
    assert reading["workers_launched"] == 2
    assert reading["cuda_startup_s"] == [0.5, 1.5]
    assert reading["clocks"] == ["wall"]
    assert reading["events_outside_phase2"] == 1
    assert reading["overlapping_kernels"] == 0
    assert reading["counts"]["launches"] == {
        "jump_score": 1, "jump_score_bounded": 0, "split_score": 2}
    assert reading["counts"]["work"]["split_score"]["useful"] == 40
    assert reading["counts"]["wall"]["split_score"] == pytest.approx(0.002)
    # the moments of a's life after phase 2's start, read from its spans
    # (b has none); the trace's start and stop as spans of their own
    marks = {k: v["median"] for k, v in reading["marks_s"].items()}
    assert marks == pytest.approx({
        "entered": -0.003, "exit": 0.009, "first_device_call": 0.00005,
        "context_made": 0.00007, "trace_started": 0.00009,
        "bin_finished": 0.0006, "trace_stopped": 0.0089,
        "trace_start_s": 0.00002, "trace_stop_s": 0.0009})
    starts = [e[1] for e in reading["events"]]
    assert starts == sorted(starts) and starts[0] == pytest.approx(100.0)
    j, _bounded, s, phase2 = dt.workflow_records(reading, 0.01, "card",
                                                 "wgs", "exact")
    assert j["launches_profiler"] == 1 and s["launches_profiler"] == 2
    assert j["device_ms"] == pytest.approx(0.2)
    assert s["device_ms"] == pytest.approx(0.07)
    # a's first copy in phase 2 goes to its K1, b's to b's K3
    assert j["h2d"] == {"count": 1, "device_ms": pytest.approx(0.010)}
    assert j["d2h"] == {"count": 1, "device_ms": pytest.approx(0.010)}
    assert s["h2d"] == {"count": 2, "device_ms": pytest.approx(0.024)}
    assert s["d2h"] == {"count": 2, "device_ms": pytest.approx(0.009)}
    # union: 100-320 (a's copy, b's copy and K3 under a's K1), 330-340,
    # 400-404, 410-430, 440-442 us
    assert phase2["device_busy_ms"] == pytest.approx(0.256)
    assert phase2["busy_share"] == pytest.approx(0.256 / 10)


def test_merge_leaves_out_unfinished_workers_and_counts_overlaps():
    """A worker whose bin did not finish (it died, its bin retried)
    counts nowhere but in ``worker_files``; two kernels of one process
    that overlap in time (one stream cannot: a clock can) are counted."""
    done = {"pid": 21, "bin": 0, "finished": True, "touched": True,
            "cuda_startup_s": 0.25, "clock": "wall",
            "counts": _counts(k1=2, useful=(50, 0)),
            "events": [[K1, _ns(100), 100 * US], [K1, _ns(150), 100 * US]]}
    died = {"pid": 22, "bin": 1, "finished": False, "touched": True,
            "cuda_startup_s": 0.75, "clock": "wall",
            "counts": _counts(k1=5, useful=(999, 0)),
            "events": [[K1, _ns(500), 10 * US]]}
    reading = dt.merge_worker_traces([done, died], WINDOW)
    assert reading["workers"] == 1 and reading["worker_files"] == 2
    assert reading["counts"]["launches"]["jump_score"] == 2
    assert reading["counts"]["work"]["jump_score"]["useful"] == 50
    assert reading["cuda_startup_s"] == [0.25]
    assert reading["overlapping_kernels"] == 1
    assert [e[3] for e in reading["events"]] == [21, 21]


def test_merge_on_the_cpu_has_no_device_fields():
    cpu = {"pid": 31, "bin": 0, "finished": True, "touched": True,
           "cuda_startup_s": None, "clock": None, "events": None,
           "counts": _counts(useful=(7, 9))}
    reading = dt.merge_worker_traces([cpu], WINDOW)
    assert reading["events"] is None
    assert reading["events_outside_phase2"] is None
    assert reading["overlapping_kernels"] is None
    assert reading["cuda_startup_s"] == [] and reading["workers_launched"] == 0


# the tool in this child's own process, every call that would make a
# CUDA context (or call cuInit) replaced by one that raises
_NO_CUDA = r"""
import torch
import torch.cuda

def _refuse(*a, **k):
    raise AssertionError("CUDA touched in the tool's own process")

for name in ("init", "_lazy_init", "is_available", "get_device_name",
             "synchronize", "get_device_properties"):
    setattr(torch.cuda, name, _refuse)
from manta_tpu_torch.tools import device_timing
rc = device_timing.main(sys.argv[2:])
print(json.dumps({"rc": rc, "initialized": torch.cuda.is_initialized(),
                  "foreign": foreign()}))
"""


def _no_cuda(*args):
    proc = subprocess.run(
        [sys.executable, "-c", _PRELUDE + _NO_CUDA, REPO, *args],
        capture_output=True, text=True, timeout=600, cwd=REPO,
        env=dict(os.environ, OMP_NUM_THREADS="1"))
    lines = [json.loads(ln) for ln in proc.stdout.splitlines()
             if ln.startswith("{")]
    return proc, lines


def test_the_tool_at_jobs_2_touches_no_cuda_in_its_process(prefix,
                                                           tmp_path):
    proc, lines = _no_cuda("--kernel", "workflow", "--device", "cpu",
                           "--workload", "wgs", "--mode", "jump",
                           "--prefix", prefix, "--jobs", "2", "--run-dir",
                           str(tmp_path / "run"))
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert lines[-1] == {"rc": 0, "initialized": False, "foreign": []}
    phase2 = next(r for r in lines if r.get("metric") == "workflow_phase2")
    assert phase2["workers"] == 2


@pytest.mark.parametrize("workload", ["wgs", "joint", "tumor"])
def test_cuda_without_a_card_is_refused_at_jobs_2(workload, tmp_path):
    """Refused before anything runs, the card probed without a CUDA call
    (NVML's count); never a quiet run on the CPU."""
    import torch
    if torch.cuda.device_count() > 0:
        pytest.skip("a CUDA device is present")
    proc, lines = _no_cuda("--kernel", "workflow", "--workload", workload,
                           "--mode", "exact", "--prefix",
                           str(tmp_path / "none"), "--jobs", "2",
                           "--run-dir", str(tmp_path / "run"))
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "no CUDA device" in lines[0]["error"]
    assert lines[-1] == {"rc": 1, "initialized": False, "foreign": []}
    assert not (tmp_path / "run").exists()


def test_joint_and_tumor_workloads_resolve_their_inputs(tmp_path):
    p = str(tmp_path / "j")
    with pytest.raises(FileNotFoundError):
        dt.workflow_inputs("joint", p)
    for k in range(3):
        open(f"{p}.s{k}.bam", "w").close()
    assert dt.workflow_inputs("joint", p) == (
        [f"{p}.s0.bam", f"{p}.s1.bam", f"{p}.s2.bam"], [], p + ".fa", {})
    assert dt.workflow_inputs("tumor", p) == ([], [p + ".bam"], p + ".fa",
                                              {})
    with pytest.raises(ValueError):
        dt.workflow_inputs("tumor", None)


def test_joint_workload_at_jobs_2_on_the_cpu(tmp_path):
    """Two samples of ``tools.wgs_workload --samples 2`` through the tool
    at --jobs 2: one diploid record set, the counts of every worker."""
    p = str(tmp_path / "j")
    gen = subprocess.run(
        [sys.executable, "-m", "manta_tpu_torch.tools.wgs_workload", "--out",
         p, *GEN, "--samples", "2"], capture_output=True, text=True,
        timeout=600, cwd=REPO)
    assert gen.returncode == 0, gen.stderr[-2000:]
    run_dir = tmp_path / "run"
    rc, lines, err = _tool("--kernel", "workflow", "--device", "cpu",
                           "--workload", "joint", "--mode", "jump",
                           "--prefix", p, "--jobs", "2", "--run-dir",
                           str(run_dir))
    assert rc == 0, err[-3000:]
    *kernels, phase2, _launches = lines
    assert phase2["workers"] == len(_traces(str(run_dir))) >= 1
    assert kernels[0]["calls"] == parse_lines(err)["dispatches"]
    with open(run_dir / "results" / "variants" / "diploidSV.vcf.gz",
              "rb") as f:
        import gzip
        header = [ln for ln in gzip.decompress(f.read()).decode().split("\n")
                  if ln.startswith("#CHROM")]
    assert len(header[0].split("\t")[9:]) == 2
