"""manta_tpu_torch stands on its own: it runs with jax, jaxlib and the
JAX package manta_tpu all refused, and its copies of the host layers
carry the public names of their manta_tpu counterparts.

tests/conftest.py imports JAX into the pytest process, so the first
group runs in a subprocess whose sys.meta_path refuses the three
packages before anything else is imported."""

import ctypes
import gzip
import importlib
import inspect
import json
import os
import re
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the JAX-free modules of manta_tpu that the port keeps its own copy of,
# under the same names
COPIED = (
    "_native",
    "core.binomial", "core.cigar", "core.sizedist", "core.readfilter",
    "core.svmodel", "core.fragstats", "core.chromdepth", "core.depthsweep",
    "io", "io.bgzf", "io.bai", "io.bam", "io.bamwriter", "io.cram",
    "io.fasta",
    "align.aligners", "assembly.assembler", "scan.scanner",
    "graph.locusgraph", "graph.native_set", "graph.finder",
    "candidates.assembler_reads", "candidates.svfinder",
    "candidates.multijunction", "candidates.processor", "candidates.refiner",
    "scoring.evidence", "scoring.fragbank", "scoring.pairscore",
    "scoring.evidence_bam", "scoring.scorer",
    "format.tabix", "format.vcfwriter",
    "workflow.tasks", "workflow.stats", "workflow.postprocess",
    "workflow.config",
    "assembly.small_assembler", "options", "tools.test_assembler",
    "tools.workers", "tools.convert_inversion", "tools.denovo_scoring",
    "tools.svloci",
)

# the port's twins of the JAX-free scripts of benchmarks/ (same file name)
BENCH_TWINS = ("tools.soak_graph", "tools.bench_reduce",
               "tools.bench_graphbuild", "tools.bench_edges",
               "tools.bench_repeats")

# the JAX modules of manta_tpu/parallel/ that the port has as torch twins
PARALLEL_TWINS = ("parallel.mesh", "parallel.scan_parallel",
                  "parallel.mesh_scoring", "parallel.phase1_mesh",
                  "parallel.distributed")

_PRELUDE = r"""
import json, sys
sys.path.insert(0, sys.argv[1])
REFUSED = ("jax", "jaxlib", "manta_tpu")


class _Refuse:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in REFUSED:
            raise ImportError(f"refused: {name}")


sys.meta_path.insert(0, _Refuse())


def foreign():
    return sorted(m for m in sys.modules if m.split(".")[0] in REFUSED)
"""

_IMPORT_ALL = r"""
import importlib, pkgutil
import manta_tpu_torch
names = ["manta_tpu_torch"] + [
    m.name for m in pkgutil.walk_packages(manta_tpu_torch.__path__,
                                          "manta_tpu_torch.")]
for n in names:
    importlib.import_module(n)
try:
    import manta_tpu
    refused = False
except ImportError:
    refused = True
print(json.dumps({"modules": names, "foreign": foreign(),
                  "refused": refused}))
"""

_DEMO = r"""
import gzip
normal, tumor, fasta, run_dir, mode = sys.argv[2:7]
from manta_tpu_torch.workflow.run import run_workflow
run_workflow([normal], [tumor], fasta, run_dir, is_exome=True,
             use_device_scoring=mode, device="cpu", verbose=False)
with gzip.open(run_dir + "/results/variants/somaticSV.vcf.gz", "rt") as f:
    lines = list(f)
print(json.dumps({"body": [ln for ln in lines if not ln.startswith("#")],
                  "source": [ln for ln in lines
                             if ln.startswith("##source")],
                  "foreign": foreign()}))
"""

_TIMING = r"""
from manta_tpu_torch.tools import device_timing
rc = device_timing.main(["--device", "cpu", "--jump-shape", "3,24,40",
                         "--split-shape", "6,60,20", "--mxu-shape",
                         "2,3,60,20", "--matmul-n", "32", "--iters", "1",
                         "--jumpalign-shape", "4,24,40"])
print(json.dumps({"rc": rc, "foreign": foreign()}))
"""

_CONFIGURE = r"""
normal, tumor, fasta, run_dir = sys.argv[2:6]
from manta_tpu_torch.workflow import config
rc = config.main(["--bam", normal, "--tumorBam", tumor, "--referenceFasta",
                  fasta, "--runDir", run_dir, "--exome"])
with open(run_dir + "/runWorkflow.py") as f:
    script = f.read()
print(json.dumps({"rc": rc, "script": script, "foreign": foreign()}))
"""


def _run(script, *args):
    # one torch thread: see test_torch_splitscore.one_torch_thread
    proc = subprocess.run(
        [sys.executable, "-c", _PRELUDE + script, REPO, *args],
        capture_output=True, text=True, timeout=300, cwd=REPO,
        env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert proc.returncode == 0, proc.stderr[-3000:]
    return proc.stdout.strip().splitlines()


def test_every_module_imports_without_the_jax_package():
    out = json.loads(_run(_IMPORT_ALL)[-1])
    assert out["refused"]
    assert out["foreign"] == []
    for name in COPIED + PARALLEL_TWINS + BENCH_TWINS + (
            "tools.device_timing", "workflow.run", "align.device_jumpscore",
            "scoring.device_scan", "graft_entry"):
        assert f"manta_tpu_torch.{name}" in out["modules"]


_DRYRUN = r"""
from manta_tpu_torch.graft_entry import dryrun_multichip, entry
stages = dryrun_multichip(2, device="cpu")
fn, args = entry(device="cpu")
best, pos = fn(*args)
print(json.dumps({"stages": sorted(stages), "rows": int(best.shape[0]),
                  "foreign": foreign()}))
"""


def test_dry_run_on_cpu_shards_without_the_jax_package():
    """The further entry point, all seven stages on 2 CPU shards, and
    entry(), in a process that can import neither JAX nor manta_tpu."""
    lines = _run(_DRYRUN)
    out = json.loads(lines[-1])
    assert out["foreign"] == [] and out["rows"] == 64
    assert len(out["stages"]) == 7
    assert any(ln.startswith("dryrun_multichip ok: 2 devices")
               for ln in lines)


@pytest.mark.parametrize("name", ("mesh", "scan_parallel", "mesh_scoring",
                                  "phase1_mesh", "distributed"))
def test_parallel_twin_has_the_functions_of_its_counterpart(name):
    """Every public function of a JAX module of manta_tpu/parallel/ has
    its twin of the same name in the port, defined in the port."""
    ours = importlib.import_module(f"manta_tpu_torch.parallel.{name}")
    theirs = importlib.import_module(f"manta_tpu.parallel.{name}")
    want = {n for n, v in vars(theirs).items()
            if inspect.isfunction(v) and not n.startswith("_")
            and v.__module__ == theirs.__name__}
    assert want and want <= _public(ours), want - _public(ours)
    for attr in want:
        assert getattr(ours, attr).__module__ == ours.__name__


def _oracle():
    with gzip.open(os.path.join(REPO, "tests", "data", "demo",
                                "expectedResults", "somaticSV.vcf.gz"),
                   "rt") as f:
        return [ln for ln in f if not ln.startswith("#")]


@pytest.mark.parametrize("mode", ("off", "jump", "exact"))
def test_demo_workflow_without_the_jax_package(tmp_path, demo_fasta,
                                               normal_bam, tumor_bam, mode):
    out = json.loads(_run(_DEMO, normal_bam, tumor_bam, demo_fasta,
                          str(tmp_path / "run"), mode)[-1])
    assert out["foreign"] == []
    assert out["body"] == _oracle()
    assert len(out["body"]) == 6
    # the header names the program as the JAX package's does
    assert out["source"] == ["##source=GenerateSVCandidates manta-tpu-0.1.0\n"]


def test_device_timing_on_the_cpu_without_the_jax_package():
    lines = _run(_TIMING)
    out = json.loads(lines[-1])
    assert out == {"rc": 0, "foreign": []}
    records = [json.loads(ln) for ln in lines[:-1]]
    assert [r["kernel"] for r in records[:-1]] == [
        "matmul_bf16_ref", "jumpalign", "jumpalign", "split_scan_mxu",
        "split_scan_mxu_on_k3_inputs", "split_scan_exact", "jump_score_dp"]
    assert [r["metric"] for r in records[1:3]] == [
        "jump_align_throughput_host", "jump_align_throughput_device"]
    assert records[2]["host_parity"] == "4/4"
    assert all(r["device"] in ("cpu", "host") and r["timed_by"] == "host "
               "clock" and r["sec_per_iter"] > 0 for r in records[:-1])
    assert records[6]["shape"] == "B=3,q=24,refs=2x40"
    assert records[-1] == {"kernel_launches": {
        "jump_score": 0, "jump_score_bounded": 0, "split_score": 0}}


def test_device_timing_refuses_to_run_without_a_card():
    """No quiet fall back to the host: without --device cpu it needs the
    card, and the kernel benches have no cpu form."""
    import torch
    if torch.cuda.device_count() > 0:
        pytest.skip("a CUDA device is present")
    cmd = [sys.executable, "-m", "manta_tpu_torch.tools.device_timing"]
    for extra in ([], ["--device", "cpu", "--kernel", "jump_cuda_bounded"]):
        proc = subprocess.run(cmd + extra, capture_output=True, text=True,
                              timeout=300, cwd=REPO)
        assert proc.returncode == 1
        assert "error" in json.loads(proc.stdout.strip().splitlines()[-1])


def test_configured_run_script_drives_the_port(tmp_path, demo_fasta,
                                               normal_bam, tumor_bam):
    out = json.loads(_run(_CONFIGURE, normal_bam, tumor_bam, demo_fasta,
                          str(tmp_path / "cfg"))[-1])
    assert out["rc"] == 0 and out["foreign"] == []
    assert "from manta_tpu_torch.workflow.run import run_workflow" \
        in out["script"]
    assert not re.search(r"manta_tpu(?!_torch)", out["script"])


def test_port_sources_import_neither_jax_nor_the_jax_package():
    pattern = re.compile(
        r"^\s*(from|import)\s+(manta_tpu(\.|\s|$)|jax)", re.M)
    paths = [os.path.join(REPO, "chip_smoke.py")]
    for root, _dirs, files in os.walk(os.path.join(REPO, "manta_tpu_torch")):
        paths += [os.path.join(root, f) for f in files if f.endswith(".py")]
    assert len(paths) > 50
    for name in BENCH_TWINS:
        assert os.path.join(REPO, "manta_tpu_torch",
                            name.replace(".", os.sep) + ".py") in paths
    for path in paths:
        with open(path) as f:
            assert not pattern.search(f.read()), path


def _public(module):
    """The public names a module defines or imports; sub-modules are
    left out (a package gains them as other code imports them)."""
    names = getattr(module, "__all__", None)
    if names is None:
        names = [n for n, v in vars(module).items()
                 if not n.startswith("_") and not inspect.ismodule(v)]
    return set(names)


# public names a copy has beyond its counterpart's, each with its reason
EXTRA_PUBLIC = {
    # the port's run trace reads the scorer's counter
    # (parallel/worker_trace.counts, key "joint")
    "scoring.scorer": {"JOINT_STATS"},
}


@pytest.mark.parametrize("name", COPIED)
def test_copy_has_the_public_names_of_its_counterpart(name):
    """A missed, cut or stale copy shows here; and no function or class
    of a copy is the JAX package's own."""
    ours = importlib.import_module(f"manta_tpu_torch.{name}")
    theirs = importlib.import_module(f"manta_tpu.{name}")
    extra = EXTRA_PUBLIC.get(name, set())
    assert extra <= _public(ours)
    assert _public(ours) - extra == _public(theirs)
    assert ours.__file__ != theirs.__file__
    for attr in _public(ours):
        obj = getattr(ours, attr)
        # ctypes caches POINTER(...) types process-wide, under whichever
        # module made them first
        if inspect.isfunction(obj) or (
                inspect.isclass(obj)
                and not issubclass(obj, ctypes._Pointer)):
            assert obj.__module__.split(".")[0] != "manta_tpu", \
                f"{name}.{attr} comes from {obj.__module__}"
