"""What the benchmark runs imports: never ``jax``, ``jaxlib``, ``flax`` or
the JAX package ``manta_tpu`` (top-level names compared whole, since the
port's name ``manta_tpu_torch`` begins with it); and the plain
references and the yardstick import nothing of the port."""

from __future__ import annotations

import ast
import glob
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
SVBENCH = os.path.dirname(HERE)
ROOT = os.path.dirname(SVBENCH)

# refuses the named top-level packages on import, then imports the rest
PRELUDE = """
import importlib.abc, sys
REFUSED = set(sys.argv[1].split(","))
class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in REFUSED:
            raise ImportError("refused: " + name)
        return None
sys.meta_path.insert(0, Refuse())
sys.path.insert(0, sys.argv[2])
"""

# the yardstick: what decides correct and what the metrics are computed
# with; none of it may import the program
YARDSTICK = ("reference.py", "workload.py", "bamout.py", "truth.py",
             "logs.py", "roofline.py", "intervals.py")


def _run(code: str, refused: str) -> subprocess.CompletedProcess:
    return subprocess.run([sys.executable, "-c", PRELUDE + code, refused,
                           ROOT], capture_output=True, text=True,
                          timeout=300)


def test_benchmark_and_port_import_without_jax():
    code = """
import glob, importlib, importlib.util, os
for name in ("run", "capture", "controls", "device", "kernels",
             "reference", "workload", "bamout", "truth", "logs",
             "roofline", "intervals"):
    importlib.import_module("svbench." + name)
for path in sorted(glob.glob(os.path.join(sys.argv[2], "svbench",
                                          "metrics", "*.py"))):
    spec = importlib.util.spec_from_file_location("m", path)
    spec.loader.exec_module(importlib.util.module_from_spec(spec))
from svbench import run
run.import_port("jump", on_card=False)
bad = sorted({m.split(".")[0] for m in sys.modules} & REFUSED)
assert not bad, bad
print("ok")
"""
    res = _run(code, "jax,jaxlib,flax,manta_tpu")
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.strip().endswith("ok")


def test_forbidden_names_are_compared_whole():
    from svbench import run
    assert run.FORBIDDEN == ("jax", "jaxlib", "flax", "manta_tpu")
    sys.modules.setdefault("manta_tpu_torch_x", sys)
    try:
        assert "manta_tpu_torch_x" not in run.loaded_forbidden()
    finally:
        del sys.modules["manta_tpu_torch_x"]


def test_yardstick_imports_nothing_of_the_program():
    code = """
import importlib
for name in %r:
    importlib.import_module("svbench." + name[:-3])
print("ok")
""" % (YARDSTICK,)
    res = _run(code, "jax,jaxlib,flax,manta_tpu,manta_tpu_torch")
    assert res.returncode == 0, res.stderr[-3000:]
    for name in YARDSTICK:
        tree = ast.parse(open(os.path.join(SVBENCH, name)).read())
        for node in ast.walk(tree):
            mods = ([a.name for a in node.names]
                    if isinstance(node, ast.Import) else
                    [node.module or ""] if isinstance(node, ast.ImportFrom)
                    else [])
            for m in mods:
                assert m.split(".")[0] not in (
                    "jax", "jaxlib", "flax", "manta_tpu",
                    "manta_tpu_torch"), (name, m)


def test_metric_readers_import_nothing_of_the_program():
    for path in glob.glob(os.path.join(SVBENCH, "metrics", "*.py")):
        text = open(path).read()
        assert "manta_tpu" not in text and "jax" not in text, path
