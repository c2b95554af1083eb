"""A whole run on the CPU at a tiny size, the card's look skipped: sound,
it comes out correct; with the timed path broken underneath (each fault
a cell can have on one card) or the K1 control in place of the program,
``correct`` comes out false. The K3 control and every cell at its own
size run on the card (``svbench/controls.py``, marker ``cuda``)."""

from __future__ import annotations

import pytest


def test_sound_run_is_correct(tiny_cell):
    r = tiny_cell()
    assert r["correct"] is True, r
    assert r["checks"]["k1_mismatched_jobs"]["value"] == 0
    assert list(r)[-1] == "checks"
    assert {"reads_per_s", "cpu_s_per_mread", "call_f1", "setup_s"} <= \
        set(r["metrics"])


@pytest.mark.parametrize("what", ["unchanged", "half_edges", "k1_answer",
                                  "k1_bounded"])
def test_fault_or_control_is_not_correct(tiny_cell, what):
    r = tiny_cell(what)
    assert r["correct"] is False


def test_k3_answer_fault_is_not_correct(tiny_cell):
    r = tiny_cell("k3_answer", mode="exact")
    assert r["correct"] is False
    assert r["checks"]["k3_mismatched_pairs"]["value"] > 0


@pytest.mark.cuda
def test_cell_on_the_card(tmp_path):
    """One short run of each cell on the card, correct; the K1 and K3
    controls on one seed, not correct."""
    import json
    import os
    import subprocess
    import sys

    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    bench = json.load(open(os.path.join(root, "BENCHMARK.json")))
    for cell in bench["workloads"]:
        out = subprocess.run(
            [sys.executable, "svbench/run.py", "--workload", cell["name"],
             "--seed", "987654321", "--seconds", "1", "--trace", "0"],
            cwd=root, capture_output=True, text=True, check=True)
        assert json.loads(out.stdout.splitlines()[-1])["correct"] is True
    for what in ("k1_bounded", "k3_mxu"):
        out = subprocess.run(
            [sys.executable, "svbench/controls.py", "--workload",
             "germline35x.exact", "--what", what, "--seed", "987654322"],
            cwd=root, capture_output=True, text=True, check=True)
        assert json.loads(out.stdout.splitlines()[-1])["correct"] is False
