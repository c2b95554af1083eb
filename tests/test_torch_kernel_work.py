"""Each kernel where the workflows launch it, on the CPU: the host-side
work counters (``KERNEL_WORK``), the exit lines that carry them, the
timing tool's workflow mode (``tools.device_timing --kernel workflow``)
and the matmul form on K3's own inputs (K3's library yardstick).

The counters are held against counts made here another way: K1's
against the cells of the jobs the dispatcher padded, K3's against a
brute-force walk over every (read, target, position) of a small random
batch. The workflow mode runs on a seeded WGS-shaped workload of 1
chromosome x 2 Mb at 20x with ``--device cpu``; its device fields are
null there, and the device readings (``workflow_records``) are held on
a trace made up here. The matmul form on K3's 512 pairs is held against
the plain exact scan within rtol/atol 1e-4, the matmul form's tolerance
(tests/test_torch_splitscore.py)."""

import json
import os
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from manta_tpu_torch.align import cuda_jumpscore, cuda_splitscore
from manta_tpu_torch.align import device_jumpscore as dj
from manta_tpu_torch.align.device_splitscore import (
    make_luts, split_score_factored,
)
from manta_tpu_torch.scoring import device_scan
from manta_tpu_torch.scoring.evidence import QscoreSnp
from manta_tpu_torch.tools import device_timing as dt
from manta_tpu_torch.tools.device_counts import parse_lines

from test_torch_splitscore import one_torch_thread  # noqa: F401  (autouse)
from test_torch_standalone import _PRELUDE

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GEN = ("--chroms", "1", "--mb", "2", "--depth", "20", "--seed", "7")
BASES = np.frombuffer(b"ACGT", np.uint8)

# exit lines as a run before the work counters printed them (the split
# line as a smoke run on the card printed it), and a worker's line of a
# -j N run after
OLD_LINES = (
    "[manta-tpu-torch] device-dispatch pid=4711: 3 calls, 10 jobs, 24 "
    "padded rows, 0.0071s total, first 0.0052s (incl. kernel build), 3 "
    "kernel launches; calls by bucket (B, nq, nr1, nr2): "
    "{(8, 256, 1024, 1024): 3}\n"
    "[manta-tpu-torch] split-scan pid=119: 18 calls (exact 18, mxu 0, "
    "fallback 0), 9044 rows, 0.02s total, 71 kernel launches\n")
NEW_LINES = (
    "[manta-tpu-torch] device-dispatch pid=4712: 2 calls, 9 jobs, 16 "
    "padded rows, 0.0050s total, first 0.0040s (incl. kernel build), 2 "
    "kernel launches; calls by bucket (B, nq, nr1, nr2): "
    "{(8, 256, 1024, 1024): 2}; work: 1500 useful cells, 2000 padded "
    "cells, 300 bytes\n"
    "[manta-tpu-torch] split-scan pid=4712: 5 calls (exact 5, mxu 0, "
    "fallback 0), 40 rows, 0.01s total, 5 kernel launches; work: 700 "
    "useful terms, 900 padded terms, 110 bytes\n")

_TOOL = r"""
import runpy
sys.argv = sys.argv[2:]
runpy.run_module(sys.argv[0], run_name="__main__", alter_sys=True)
"""


def _tool(*args):
    """The timing tool in a child that refuses jax, jaxlib and
    manta_tpu: (return code, its JSON lines, stderr)."""
    proc = subprocess.run(
        [sys.executable, "-c", _PRELUDE + _TOOL, REPO,
         "manta_tpu_torch.tools.device_timing", *args],
        capture_output=True, text=True, timeout=600, cwd=REPO,
        env=dict(os.environ, OMP_NUM_THREADS="1"))
    lines = [json.loads(ln) for ln in proc.stdout.splitlines()
             if ln.startswith("{")]
    return proc.returncode, lines, proc.stderr


# ---------------------------------------------------------------- K1

def test_k1_work_counter_equals_the_padded_jobs_cells():
    """A scorer call's jobs, counted here from the byte strings and the
    arrays pad_jobs made, against the counter's three fields."""
    rng = np.random.default_rng(5)
    seq = lambda n: bytes(BASES[rng.integers(0, 4, n)])
    scorer = dj.make_bucketed_scorer(SimpleNamespace(
        match=2, mismatch=-8, open=-12, extend=-1, off_edge=-1), -100, "cpu")
    padded, pad_jobs = [], dj.pad_jobs

    def keeping(jobs, rows):
        padded.append(pad_jobs(jobs, rows))
        return padded[-1]

    before = dict(cuda_jumpscore.KERNEL_WORK["jump_score"])
    batches = [[(seq(int(rng.integers(1, 300))), seq(int(rng.integers(0, 900))),
                 seq(int(rng.integers(0, 700)))) for _ in range(n)]
               for n in (3, 9, 1)]
    dj.pad_jobs = keeping
    try:
        for jobs in batches:
            scorer(jobs)
    finally:
        dj.pad_jobs = pad_jobs
    work = {k: v - before[k]
            for k, v in cuda_jumpscore.KERNEL_WORK["jump_score"].items()}
    assert work["useful"] == sum(len(q) * (len(a) + len(b))
                                 for jobs in batches for q, a, b in jobs)
    assert work["padded"] == sum(q.shape[0] * q.shape[1] * (r1.shape[1]
                                                            + r2.shape[1])
                                 for q, _ql, r1, _l1, r2, _l2 in padded)
    # int32 arrays in, a score a row out
    assert work["bytes"] == sum(sum(a.nbytes for a in arrays)
                                + 4 * len(arrays[0]) for arrays in padded)
    assert [len(p[0]) for p in padded] == [8, 16, 8]
    assert cuda_jumpscore.KERNEL_WORK["jump_score_bounded"]["useful"] == 0


# ---------------------------------------------------------------- K3

def _random_call(rng, n, t):
    """A batch of n reads (some shorter than others) and t junction
    targets of other lengths, with their breakend ranges."""
    lens = rng.integers(20, 80, n)
    off = np.zeros(n + 1, np.int64)
    off[1:] = np.cumsum(lens)
    batch = SimpleNamespace(
        seq=BASES[rng.integers(0, 4, off[-1])],
        qual=rng.integers(2, 41, off[-1]).astype(np.uint8),
        seq_off=off, qual_off=off.copy(), n=n)
    targets = [BASES[rng.integers(0, 4, int(rng.integers(60, 300)))]
               for _ in range(t)]
    ranges = []
    for tg in targets:
        b = int(rng.integers(0, len(tg)))
        ranges.append((b, min(len(tg) - 1, b + int(rng.integers(0, 6)))))
    return batch, np.arange(n, dtype=np.int64), targets, ranges


def test_k3_term_counter_equals_a_brute_force_count():
    """The counter's useful terms: every position of every pair's tier
    that the scan takes (scan_start <= position <= scan_end) times the
    pair's read bases, walked one by one; its padded terms and bytes
    from the call's tiers."""
    rng = np.random.default_rng(11)
    batch, idx, targets, ranges = _random_call(rng, 13, 3)
    ctx = device_scan.DeviceScanContext(device="cpu")
    before = dict(cuda_splitscore.KERNEL_WORK["split_score"])
    ctx.scan_multi(16, batch, idx, QscoreSnp(1e-3), targets, ranges)
    work = {k: v - before[k]
            for k, v in cuda_splitscore.KERNEL_WORK["split_score"].items()}
    Tp = device_scan._bucket(max(map(len, targets)) + 1)
    Lp = device_scan.read_tier(batch, idx)
    want = 0
    for r in idx:
        rl = int(batch.seq_off[r + 1] - batch.seq_off[r])
        for tg, (beg, end) in zip(targets, ranges):
            start = max(0, beg - rl + 2)
            stop = max(0, min(end, len(tg) - rl))
            for pos in range(Tp):
                for _base in range(rl):
                    want += start <= pos <= stop
    assert want > 0
    assert work["useful"] == want
    n, t = len(idx), len(targets)
    assert work["padded"] == n * t * Tp * Lp
    assert work["bytes"] == 2 * n * Lp + t * Tp + 4 * (n + 3 * t) \
        + 2 * 71 * 4 + 8 * n * t


# ------------------------------------------------------- the exit lines

@pytest.mark.parametrize("text, want", [
    (OLD_LINES, {"dispatches": 3, "k1_launches": 3, "split_scans": 18,
                 "k3_launches": 71, "k1_useful_cells": 0,
                 "k3_useful_terms": 0, "device_processes": 1}),
    (NEW_LINES, {"dispatches": 2, "k1_launches": 2, "k1_useful_cells": 1500,
                 "k1_padded_cells": 2000, "k1_bytes": 300, "split_scans": 5,
                 "k3_useful_terms": 700, "k3_padded_terms": 900,
                 "k3_bytes": 110}),
    # a -j N run: the workers' lines, an old one among them, add up
    (OLD_LINES + NEW_LINES + NEW_LINES,
     {"device_processes": 3, "dispatches": 7, "contig_jobs": 28,
      "k1_launches": 7, "k1_useful_cells": 3000, "k3_padded_terms": 1800,
      "split_scans": 28, "k3_launches": 81})])
def test_exit_lines_before_and_after_the_work_counters_parse(text, want):
    got = parse_lines(text)
    assert {k: got[k] for k in want} == want


def test_a_dispatch_exit_line_carries_the_counters():
    """A process's own device-dispatch exit line, as it prints it, reads
    back as its counters."""
    code = (
        "from types import SimpleNamespace\n"
        "from manta_tpu_torch.align import device_jumpscore as dj\n"
        "s = SimpleNamespace(match=2, mismatch=-8, open=-12, extend=-1, "
        "off_edge=-1)\n"
        "dj.make_bucketed_scorer(s, -100, 'cpu')([(b'ACGTAC', b'ACGTT' * 9, "
        "b'TTAC' * 30), (b'GGA', b'', b'AC')])\n"
        "print(dict(dj.KERNEL_WORK['jump_score']))\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300, cwd=REPO)
    assert proc.returncode == 0, proc.stderr[-2000:]
    work = eval(proc.stdout)
    got = parse_lines(proc.stderr)
    assert work["useful"] == 6 * (45 + 120) + 3 * 2
    assert (got["k1_useful_cells"], got["k1_padded_cells"],
            got["k1_bytes"]) == (work["useful"], work["padded"],
                                 work["bytes"])
    assert got["dispatches"] == 1 and got["contig_jobs"] == 2


# ------------------------------------------------ the workflow mode

@pytest.fixture(scope="module")
def wgs_prefix(tmp_path_factory):
    d = tmp_path_factory.mktemp("wf")
    prefix = str(d / "w")
    proc = subprocess.run(
        [sys.executable, "-m", "manta_tpu_torch.tools.wgs_workload", "--out",
         prefix, *GEN], capture_output=True, text=True, timeout=600,
        cwd=REPO)
    assert proc.returncode == 0, proc.stderr[-2000:]
    return prefix


KERNEL_KEYS = {
    "kernel", "metric", "workload", "mode", "device", "calls",
    "launches_wrapper", "launches_profiler", "path_wall_s", "device_ms",
    "device_ms_per_launch", "work_unit", "useful_work", "padded_work",
    "bytes", "ops", "bound_ms", "bound_by", "share_of_bound", "h2d", "d2h",
    "run_dir"}
DEVICE_FIELDS = ("launches_profiler", "device_ms", "device_ms_per_launch",
                 "share_of_bound")


@pytest.mark.parametrize("mode", ["jump", "exact"])
def test_workflow_mode_on_the_cpu(wgs_prefix, tmp_path, mode):
    """The documented keys, the device fields null, no kernel launched
    (the wrappers' counts, as the last line has them) and the calls of
    each seam equal to the workers' exit line, whose work the records
    carry."""
    rc, lines, err = _tool("--kernel", "workflow", "--device", "cpu",
                           "--workload", "wgs", "--mode", mode, "--prefix",
                           wgs_prefix, "--run-dir", str(tmp_path / "run"))
    assert rc == 0, err[-3000:]
    *kernels, phase2, launches = lines
    assert [r["kernel"] for r in kernels] == list(dt.KERNEL_OPS)
    assert launches == {"kernel_launches": {
        "jump_score": 0, "jump_score_bounded": 0, "split_score": 0}}
    for rec in kernels:
        assert KERNEL_KEYS <= set(rec)
        assert rec["device"] == "cpu" and rec["mode"] == mode
        assert all(rec[k] is None for k in DEVICE_FIELDS)
        assert rec["h2d"] == rec["d2h"] == {"count": None, "device_ms": None}
        assert rec["launches_wrapper"] == launches["kernel_launches"][
            rec["kernel"]] == 0
    assert phase2["metric"] == "workflow_phase2"
    assert phase2["phase2_wall_s"] > 0
    assert phase2["device_busy_ms"] is phase2["busy_share"] is None
    exit_lines = parse_lines(err)
    k1, k2, k3 = kernels
    assert k1["calls"] == exit_lines["dispatches"] > 0
    assert (k1["useful_work"], k1["padded_work"], k1["bytes"]) == (
        exit_lines["k1_useful_cells"], exit_lines["k1_padded_cells"],
        exit_lines["k1_bytes"])
    assert 0 < k1["useful_work"] <= k1["padded_work"]
    assert k1["ops"] == 20 * k1["useful_work"] and "bound_ms_int32" in k1
    assert k2["calls"] == k2["useful_work"] == 0
    if mode == "exact":
        assert k3["calls"] == exit_lines["split_scans"] > 0
        assert k3["useful_work"] == exit_lines["k3_useful_terms"] > 0
        assert k3["ops"] == 6 * k3["useful_work"]
    else:
        assert k3["calls"] == k3["useful_work"] == 0


def test_workflow_mode_needs_a_card_unless_asked_for_the_cpu(tmp_path):
    """No quiet fall back to the host: without --device cpu it refuses
    on a host without a card, before it runs anything."""
    if torch.cuda.device_count() > 0:
        pytest.skip("a CUDA device is present")
    rc, lines, _err = _tool("--kernel", "workflow", "--workload", "wgs",
                            "--prefix", str(tmp_path / "none"), "--run-dir",
                            str(tmp_path / "run"))
    assert rc == 1
    assert "no CUDA device" in lines[-1]["error"]
    assert not (tmp_path / "run").exists()


def test_workflow_records_on_a_made_up_trace():
    """The device readings: kernels told apart by name, each copy to
    the device given to the next launch and each copy back to the one
    before, busy time as the union of the events."""
    zero = {"useful": 0, "padded": 0, "bytes": 0}
    counts = {
        "launches": {"jump_score": 2, "jump_score_bounded": 0,
                     "split_score": 1},
        "calls": {"jump_score": 2, "jump_score_bounded": 0,
                  "split_score": 1},
        "wall": {"jump_score": 0.01, "jump_score_bounded": 0.0,
                 "split_score": 0.002},
        "work": {"jump_score": {"useful": 67_000_000, "padded": 10 ** 8,
                                "bytes": 1000},
                 "jump_score_bounded": dict(zero),
                 "split_score": {"useful": 0, "padded": 0,
                                 "bytes": 3_350_000}}}
    k1 = "void jump_systolic_kernel<4, false, 1>(int const*, int*)"
    events = [("Memcpy HtoD (Pageable -> Device)", 0.0, 2.0),
              ("Memcpy HtoD (Pageable -> Device)", 3.0, 2.0),
              (k1, 5.0, 100.0),
              ("Memcpy DtoH (Device -> Pageable)", 105.0, 1.0),
              ("Memcpy HtoD (Pinned -> Device)", 200.0, 4.0),
              ("split_score_kernel(unsigned char const*)", 204.0, 3.0),
              ("Memcpy DtoH (Device -> Pageable)", 207.0, 1.0),
              (k1, 300.0, 50.0), (k1 + " overlapped", 320.0, 40.0)]
    counts["launches"]["jump_score"] = counts["calls"]["jump_score"] = 3
    recs = dt.workflow_records({"counts": counts, "events": events}, 1.0,
                               "card", "wgs", "exact")
    j, b, s, phase2 = recs
    assert (j["launches_profiler"], b["launches_profiler"],
            s["launches_profiler"]) == (3, 0, 1)
    assert j["device_ms"] == pytest.approx(0.19)
    assert j["h2d"] == {"count": 2, "device_ms": pytest.approx(0.004)}
    assert j["d2h"] == {"count": 1, "device_ms": pytest.approx(0.001)}
    assert s["h2d"] == {"count": 1, "device_ms": pytest.approx(0.004)}
    assert s["d2h"] == {"count": 1, "device_ms": pytest.approx(0.001)}
    # K1: 20 x 67 M int32 operations, 0.02 ms at 67 Top/s; K3 by bytes,
    # 0.001 ms at 3.35 TB/s
    assert j["bound_by"] == "operations"
    assert j["bound_ms"] == pytest.approx(0.02)
    assert j["share_of_bound"] == pytest.approx(0.02 / 0.19)
    assert j["bound_ms_int32"] == pytest.approx(
        20 * 67e6 / dt.PEAK_INT32_OPS_PER_S * 1e3)
    assert s["bound_by"] == "bytes"
    assert s["bound_ms"] == pytest.approx(0.001)
    # busy: 0-2, 3-106, 200-208, 300-360 us
    assert phase2["device_busy_ms"] == pytest.approx(0.173)
    assert phase2["busy_share"] == pytest.approx(0.173 / 1000)
    assert phase2["device_events"][k1] == {"count": 2,
                                           "device_ms": pytest.approx(0.15)}


@pytest.mark.parametrize("name, kernel", [
    ("void jump_systolic_kernel<4, false, 1>(int const*, int const*)",
     "jump_score"),
    ("void jump_systolic_kernel<8, true, 2>(int const*, int const*)",
     "jump_score_bounded"),
    ("_Z20jump_systolic_kernelILi4ELb1ELi1EEvPKiS1_", "jump_score_bounded"),
    ("_Z20jump_systolic_kernelILi4ELb0ELi1EEvPKiS1_", "jump_score"),
    ("split_score_kernel(unsigned char const*, float)", "split_score"),
    ("Memcpy HtoD (Pageable -> Device)", None),
    ("void at::native::vectorized_elementwise_kernel<4>()", None)])
def test_profiler_names_map_to_the_port_kernels(name, kernel):
    assert dt.kernel_of(name) == kernel


# --------------------------------------------- K3's library yardstick

def test_mxu_yardstick_takes_k3s_own_inputs_at_512_pairs():
    """The timing tool's 512 pairs (256 reads x 2 targets): the matmul
    form reads K3's very tensors (views, no copy) and agrees with the
    plain exact scan within rtol/atol 1e-4; positions may differ only on
    near-ties under 1e-3."""
    rng = np.random.default_rng(0)
    n, t, T, L = 256, 2, 500, 150
    reads = torch.from_numpy(BASES[rng.integers(0, 4, (n, L))])
    quals = torch.from_numpy(rng.integers(20, 40, (n, L)).astype(np.uint8))
    targets = torch.from_numpy(BASES[rng.integers(0, 4, (t, T))])
    beg = torch.tensor([T // 2 - 5, T // 2 - 40], dtype=torch.int32)
    end = torch.tensor([T // 2 + 5, T // 2 - 38], dtype=torch.int32)
    rl = torch.from_numpy(rng.integers(100, L + 1, n).astype(np.int32))
    tl = torch.tensor([T, T - 7], dtype=torch.int32)
    lm, lx = (torch.from_numpy(a) for a in make_luts(0.0))
    args = (reads, quals, rl, targets, beg, end, tl, 16, lm, lx, T)
    call, diff = dt.mxu_on_k3_inputs(args)
    from manta_tpu_torch.align.device_splitscore_mxu import from_factored
    views = from_factored(reads, quals, rl, targets, beg, end, tl)
    assert views[0].data_ptr() == reads.data_ptr()
    assert views[1].data_ptr() == quals.data_ptr()
    assert views[2] is targets and views[6].data_ptr() == rl.data_ptr()
    best, pos = split_score_factored(*args)
    mb, mp = (a.t() for a in call())
    assert mb.shape == best.shape == (n, t)
    fin = torch.isfinite(best)
    assert fin.sum() > n
    np.testing.assert_allclose(mb[fin].numpy(), best[fin].numpy(),
                               rtol=1e-4, atol=1e-4)
    mism = (mp != pos) & fin
    assert ((mb - best).abs()[mism] < 1e-3).all()
    err, pos_differ, pairs = diff(best, pos)
    assert pairs == int(fin.sum()) and pos_differ == int(mism.sum())
    assert err == pytest.approx(float((mb - best).abs()[fin].max()))
