"""Fixtures of the benchmark's own tests: a tiny cell on the CPU."""

from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

# one run of a 2 x 1 Mb germline sample at -j 2 on the CPU, the card's
# look skipped, with a control of svbench/controls.py by name; its own
# process, since a process that has run torch's CPU thread pool cannot
# fork workers that run it again
SCRIPT = """
import json, sys
sys.path.insert(0, sys.argv[1])
from svbench import controls, run
what, mode, cache, runs = sys.argv[2:6]
bench, cell, config, traffic = run.cell_spec("germline35x.exact")
config = dict(config, chroms=2, mb=1, depth=20)
config["workflow"] = dict(config["workflow"], jobs=2)
run.cell_spec = lambda name: (bench, cell, config, traffic)
run.CACHE, run.RUNS = cache, runs
control = {"no_card_check": True, "device": "cpu", "mode": mode,
           "k3_every": 1}
control.update(controls.CONTROLS[what] if what != "none" else {})
sys.exit(run.main(["--workload", cell["name"], "--seed", "3000000001",
                   "--seconds", "0"], control=control))
"""


@pytest.fixture(scope="session")
def tiny_cache(tmp_path_factory):
    return str(tmp_path_factory.mktemp("svbench_cache"))


@pytest.fixture
def tiny_cell(tiny_cache, tmp_path):
    """Runs the tiny cell with a control (a name of
    ``svbench.controls.CONTROLS``, or "none") and returns its result line
    as a dict."""
    def go(what="none", mode="jump"):
        res = subprocess.run(
            [sys.executable, "-c", SCRIPT, ROOT, what, mode, tiny_cache,
             str(tmp_path / "runs")], capture_output=True, text=True,
            timeout=600)
        assert res.returncode == 0, res.stderr[-3000:]
        return json.loads(res.stdout.strip().splitlines()[-1])
    return go
