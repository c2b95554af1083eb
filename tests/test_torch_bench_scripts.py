"""The port's twins of the five JAX-free benchmark scripts, held against
their originals in benchmarks/ on the same inputs, on the CPU:

- tools.soak_graph: the builder's fingerprints for all, even and odd
  loci, after the merge and after the flat round-trip, at the size of
  the JAX package's soak test and at a smaller one;
- tools.bench_reduce: node counts of its line, and the merged graph's
  flat arrays through each package's builder, save and native merge;
- tools.bench_graphbuild: reads, loci, nodes and edges on a 16-tile
  stress BAM at -j 1 and -j 2;
- tools.bench_edges: edges and the tumorSV body on that BAM, with scoring
  off and with jump (its plain form on the CPU);
- tools.bench_repeats: wilson, the aggregation of the same per-seed
  records, and one real seed at a small size.

The originals and the twins run as their users run them, each in a
process of its own (the originals' own workflow scores on the host
here: no TPU). The test imports both packages; the twins import
nothing of the JAX package (tests/test_torch_standalone.py)."""

import gzip
import importlib
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from manta_tpu_torch.tools import bench_repeats, soak_graph
from manta_tpu_torch.tools import stress_workload

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

TILES = 16
# the JAX package's soak test (tests/test_graph_soak.py) and a smaller
# size
SOAK_SIZES = ((60_000, 6), (6_000, 3))
CHROM_LEN = 130_000_000
REDUCE_ARGS = ("--loci", "24000", "--chroms", "6")
# the graph-build line's counts, equal between the packages
GRAPH_COUNTS = ("reads", "loci", "nodes", "edges")
# one repeats seed that runs in seconds here
REPEATS_SEED = ("--seeds", "3", "--chroms", "1", "--mb", "1", "--anchors",
                "6", "--jobs", "1")
DEVICE_TWINS = ("bench_edges", "bench_repeats")

_ENV = dict(os.environ, OMP_NUM_THREADS="1", JAX_PLATFORMS="cpu")


def _last_json(text: str) -> dict:
    return json.loads(next(ln for ln in reversed(text.splitlines())
                           if ln.startswith("{")))


def _run(argv, cwd=REPO, check=True) -> subprocess.CompletedProcess:
    proc = subprocess.run([sys.executable, *argv], capture_output=True,
                          text=True, timeout=600, cwd=cwd, env=_ENV)
    if check:
        assert proc.returncode == 0, proc.stderr[-3000:]
    return proc


# starts its first argument in a child of its own, from a small process:
# ru_maxrss carries the high-water mark of the process that started it
# (fork, then exec), and a test worker may hold more than the soak's 2 GB
_RELAUNCH = ("import subprocess, sys; sys.exit(subprocess.run("
             "[sys.executable, *sys.argv[1:]]).returncode)")


def _twin(name, *args) -> dict:
    return _last_json(_run(["-c", _RELAUNCH, "-m",
                            f"manta_tpu_torch.tools.{name}", *args]).stdout)


def _original(name, *args) -> dict:
    return _last_json(_run(["-c", _RELAUNCH,
                            os.path.join("benchmarks", f"{name}.py"),
                            *args]).stdout)


def _original_module(name):
    return importlib.import_module(f"benchmarks.{name}")


def _results_listing():
    path = os.path.join(REPO, "benchmarks", "results")
    return {n: os.path.getmtime(os.path.join(path, n))
            for n in os.listdir(path)}


def _body(run_dir):
    with gzip.open(os.path.join(run_dir, "results", "variants",
                                "tumorSV.vcf.gz"), "rt") as f:
        return [ln for ln in f if not ln.startswith("#")]


# ---- soak_graph

@pytest.mark.parametrize("which", ("all", "even", "odd"))
@pytest.mark.parametrize("loci,chroms", SOAK_SIZES)
def test_soak_builder_fingerprint_equals_the_original(loci, chroms, which):
    original = _original_module("soak_graph")
    fps = []
    for module in (soak_graph, original):
        g = module.build(loci, chroms, CHROM_LEN, seed=11, which=which)
        fps.append(module.fingerprint(g, chroms))
        g.free()
    assert fps[0] == fps[1]
    assert fps[0][1] > 0


@pytest.mark.parametrize("loci,chroms", SOAK_SIZES)
def test_soak_merge_and_flat_roundtrip_equal_the_original(loci, chroms):
    """The odd half merged with the even half, and the whole graph
    through export_flat and load_flat, fingerprint alike in both."""
    from manta_tpu.graph.locusgraph import \
        SVLocusSetOptions as ReferenceOptions
    from manta_tpu.graph.native_set import NativeLocusSet as ReferenceSet
    from manta_tpu_torch.graph.locusgraph import SVLocusSetOptions
    from manta_tpu_torch.graph.native_set import NativeLocusSet

    original = _original_module("soak_graph")
    out = []
    for module, cls, opts in ((soak_graph, NativeLocusSet,
                               SVLocusSetOptions),
                              (original, ReferenceSet, ReferenceOptions)):
        ga = module.build(loci, chroms, CHROM_LEN, seed=11, which="odd")
        gb = module.build(loci, chroms, CHROM_LEN, seed=11, which="even")
        ga.merge_native(gb)
        gb.free()
        merged = module.fingerprint(ga, chroms)
        ga.free()
        g = module.build(loci, chroms, CHROM_LEN, seed=11)
        g2 = cls(opts(observation_weight=3), chroms)
        g2.load_flat(*g.export_flat()[:3])
        out.append((merged, module.fingerprint(g, chroms),
                    module.fingerprint(g2, chroms)))
        g.free()
        g2.free()
    assert out[0] == out[1]
    assert out[0][1] == out[0][2]


def test_soak_line_has_the_originals_keys():
    twin = _twin("soak_graph", "--loci", "6000", "--chroms", "3")
    original = _original("soak_graph", "--loci", "6000", "--chroms", "3")
    assert list(twin) == list(original)
    walls = ("build_s", "split_merge_s", "peak_rss_gb")
    assert {k: v for k, v in twin.items() if k not in walls} == \
        {k: v for k, v in original.items() if k not in walls}
    assert twin["build_deterministic"] and twin["serialize_roundtrip"]


# ---- bench_reduce

def test_reduce_line_equals_the_originals(tmp_path):
    twin = _twin("bench_reduce", *REDUCE_ARGS, "--work-dir", str(tmp_path))
    original = _original("bench_reduce", *REDUCE_ARGS)
    assert list(twin) == list(original)
    assert twin["nodes"] == original["nodes"] > 0
    assert twin["nodes_presplit"] == original["nodes_presplit"] > 0
    assert os.listdir(tmp_path) == []          # its files are removed


def test_reduce_merged_graph_equals_the_originals(tmp_path):
    """Each package's parts (its soak builder), saved, merged by its
    native merge chain and finalized: the same flat arrays."""
    from manta_tpu.workflow.run import \
        merge_saved_graphs_native as reference_merge
    from manta_tpu_torch.workflow.run import merge_saved_graphs_native

    original = _original_module("soak_graph")
    chroms, per_part = 4, 3000
    names, lengths = [f"chr{i + 1}" for i in range(chroms)], [CHROM_LEN] \
        * chroms
    flats = []
    for tag, module, merge in (("twin", soak_graph, merge_saved_graphs_native),
                               ("original", original, reference_merge)):
        paths = []
        for tid in range(chroms):
            g = module.build(per_part, 1, CHROM_LEN, seed=100 + tid)
            paths.append(str(tmp_path / f"{tag}_{tid}.npz"))
            g.save_npz(paths[-1], names, lengths, 1, [{}],
                       is_finalized=False)
            g.free()
        nat, _meta = merge(paths)
        nat.finalize_native()
        flats.append(nat.export_flat())
        nat.free()
    assert len(flats[0]) == len(flats[1])
    for a, b in zip(*flats):
        np.testing.assert_array_equal(a, b)
    assert len(flats[0][1]) > 0


# ---- bench_graphbuild and bench_edges on one stress BAM

@pytest.fixture(scope="module")
def stress(tmp_path_factory, demo_fasta):
    d = tmp_path_factory.mktemp("bench_scripts")
    bam, fasta, reads = stress_workload.generate(
        TILES, str(d / "h"), depth_frac=0.2, strip_sa=True,
        demo_fasta=demo_fasta)
    assert reads == 2260 * TILES
    return d, bam, fasta


@pytest.mark.parametrize("jobs", (1, 2))
def test_graphbuild_counts_equal_the_originals(stress, jobs):
    d, bam, fasta = stress
    work = d / f"graphbuild_j{jobs}"
    work.mkdir()
    args = ("--bam", bam, "--fasta", fasta, "-j", str(jobs))
    twin = _twin("bench_graphbuild", *args, "--work-dir", str(work))
    original = _original("bench_graphbuild", *args)
    assert list(twin) == list(original)
    assert {k: twin[k] for k in GRAPH_COUNTS} == \
        {k: original[k] for k in GRAPH_COUNTS}
    assert twin["edges"] > 0 and twin["jobs"] == jobs
    assert os.listdir(work) == []


# the original's run directory, kept: tempfile.mkdtemp gives a fixed
# directory and shutil.rmtree spares it
_KEEP_ORIGINALS_RUN = r"""
import runpy, shutil, sys, tempfile
run_dir, script, *args = sys.argv[1:]
_mkdtemp = tempfile.mkdtemp
tempfile.mkdtemp = lambda *a, **k: run_dir if k.get("prefix") == \
    "bench_edges_" else _mkdtemp(*a, **k)
_rmtree = shutil.rmtree
shutil.rmtree = lambda p, *a, **k: None if p == run_dir else _rmtree(p, *a,
                                                                    **k)
sys.argv = [script, *args]
runpy.run_path(script, run_name="__main__")
"""


@pytest.fixture(scope="module")
def edges(stress):
    """The original's line and body, and the twin's with off and jump."""
    d, bam, fasta = stress
    args = ("--bam", bam, "--fasta", fasta)
    run_dir = str(d / "edges_original")
    os.makedirs(run_dir)
    out = {"original": (_last_json(_run(
        ["-c", _KEEP_ORIGINALS_RUN, run_dir,
         os.path.join("benchmarks", "bench_edges.py"), *args]).stdout),
        _body(run_dir))}
    for mode in ("off", "jump"):
        run_dir = str(d / f"edges_{mode}")
        line = _twin("bench_edges", *args, "--device", "cpu",
                     "--device-scoring", mode, "--run-dir", run_dir)
        out[mode] = line, _body(run_dir)
    return out


@pytest.mark.parametrize("mode", ("off", "jump"))
def test_edges_and_body_equal_the_originals(edges, mode):
    line, body = edges[mode]
    want_line, want_body = edges["original"]
    assert line["edges"] == want_line["edges"] > 0
    assert body == want_body and len(body) > 0
    # the original's keys in its order, then what ran where
    assert list(line)[:len(want_line)] == list(want_line)
    assert line["device"] == "cpu"
    assert line["device_scoring_resolved"] == mode


def test_edges_jump_scores_contig_jobs_on_the_plain_form(edges):
    off, jump = edges["off"][0], edges["jump"][0]
    assert off["dispatches"] == off["contig_jobs"] == 0
    assert jump["contig_jobs"] > 0 and jump["dispatches"] > 0
    # the plain form on the CPU: no kernel launch
    assert jump["k1_launches"] == jump["k3_launches"] == 0


# ---- bench_repeats

@settings(max_examples=300, deadline=None, database=None)
@given(st.integers(0, 2000).flatmap(
    lambda n: st.tuples(st.integers(0, n), st.just(n))))
def test_wilson_equals_the_originals(kn):
    original = _original_module("bench_repeats")
    assert bench_repeats.wilson(*kn) == original.wilson(*kn)


@pytest.mark.parametrize("k,n", ((0, 0), (0, 1), (1, 1), (5, 40), (40, 40),
                                 (141, 141), (1, 1000)))
def test_wilson_at_the_edges(k, n):
    original = _original_module("bench_repeats")
    assert bench_repeats.wilson(k, n) == original.wilson(k, n)


def _records():
    """Per-seed records in the checker's form, with and without the
    repeat keys that the aggregation reads with a default."""
    rng = np.random.default_rng(5)
    out = []
    for seed in (3, 5, 7):
        n, rep = int(rng.integers(60, 90)), int(rng.integers(30, 45))
        ins = int(rng.integers(0, rep))
        rec = {"metric": "wgs_sim_recall", "truth_n": n,
               "recall": round(float(rng.random()), 4),
               "fp_records": int(rng.integers(0, 4)),
               "truth_in_repeat": rep,
               "recall_in_repeat": round(int(rng.integers(0, rep)) / rep, 4),
               "recall_clean": round(int(rng.integers(0, n - rep))
                                     / (n - rep), 4),
               "graph_abort_count_hit": seed == 5,
               "graph_abort_density_hit": False, "seed": seed}
        if seed != 7:
            rec.update(truth_inside_tandem=ins,
                       recall_inside_tandem=round(
                           int(rng.integers(0, ins + 1)) / max(ins, 1), 4),
                       truth_repeat_edge=rep - ins,
                       recall_repeat_edge=0.5)
        out.append(rec)
    return out


def test_aggregation_equals_the_originals(tmp_path, monkeypatch, capsys):
    """The original's main over the same per-seed records (its run_seed
    replaced) against the twin's aggregate, key for key."""
    original = _original_module("bench_repeats")
    records = {r["seed"]: r for r in _records()}
    monkeypatch.setattr(original, "run_seed",
                        lambda seed, args: dict(records[seed]))
    monkeypatch.setattr(original, "REPO", str(tmp_path))
    os.makedirs(tmp_path / "benchmarks" / "results")
    monkeypatch.setattr(sys, "argv", ["bench_repeats.py", "--tag", "t"])
    original.main()
    with open(tmp_path / "benchmarks" / "results" /
              "repeats_check_t.json") as f:
        want = json.load(f)
    want_line = json.loads(capsys.readouterr().out.splitlines()[-1])

    class Args:
        seeds, anchors = [3, 5, 7], 40
    got = bench_repeats.aggregate([dict(r) for r in records.values()], Args)
    assert json.loads(json.dumps(got)) == want
    assert list(got) == list(want)
    assert {k: v for k, v in want.items() if k != "per_seed"} == want_line
    assert got["repeat_proximal"]["n"] > 0


@pytest.fixture(scope="module")
def repeats_seed(tmp_path_factory):
    """One real seed, jump (its plain form) then off on the same kept
    workload."""
    d = tmp_path_factory.mktemp("repeats")
    before = _results_listing()
    out = {}
    for mode in ("jump", "off"):
        proc = _run(["-m", "manta_tpu_torch.tools.bench_repeats",
                     *REPEATS_SEED, "--device", "cpu", "--device-scoring",
                     mode, "--work-dir", str(d / "work"), "--results-dir",
                     str(d / "results"), "--tag", mode, "--keep",
                     "--reuse"])
        lines = [json.loads(ln) for ln in proc.stdout.splitlines()
                 if ln.startswith("{")]
        with open(d / "results" / f"repeats_check_{mode}.json") as f:
            out[mode] = lines, json.load(f), proc.stderr
    return out, before == _results_listing()


def test_one_real_seed(repeats_seed):
    runs, untouched = repeats_seed
    (rec, line), saved, _err = runs["jump"]
    assert untouched            # nothing written under benchmarks/
    assert rec["seed"] == 3 and rec["metric"] == "wgs_sim_recall"
    assert rec["truth_in_repeat"] > 0 and 0 <= rec["recall"] <= 1
    assert rec["device"] == "cpu"
    assert rec["device_scoring_resolved"] == "jump"
    assert rec["contig_jobs"] > 0 and rec["k1_launches"] == 0
    assert saved["per_seed"] == [rec]
    assert line == {k: v for k, v in saved.items() if k != "per_seed"}
    assert line["repeat_proximal"]["n"] == rec["truth_in_repeat"]


def test_one_real_seed_equal_between_modes(repeats_seed):
    """Off and jump give the same record but for walls, paths and what
    ran where; off reused jump's workload."""
    runs, _ = repeats_seed
    (jump, _), _, _ = runs["jump"]
    (off, _), _, err = runs["off"]
    assert "reusing the workload" in err
    skip = bench_repeats.RUN_KEYS + bench_repeats.DEVICE_KEYS
    assert {k: v for k, v in jump.items() if k not in skip} == \
        {k: v for k, v in off.items() if k not in skip}
    assert off["contig_jobs"] == 0


# ---- no quiet fall-back to the host

@pytest.mark.parametrize("name", DEVICE_TWINS)
def test_device_twin_refuses_to_run_without_a_card(tmp_path, name):
    import torch
    if torch.cuda.device_count() > 0:
        pytest.skip("a CUDA device is present")
    args = {"bench_edges": ("--bam", "x.bam", "--fasta", "x.fa"),
            "bench_repeats": ("--work-dir", str(tmp_path / "w"),
                              "--results-dir", str(tmp_path / "r"))}[name]
    proc = _run(["-m", f"manta_tpu_torch.tools.{name}", *args], check=False)
    assert proc.returncode != 0
    assert "no CUDA device; pass --device cpu" in proc.stderr
    assert not os.path.exists(tmp_path / "r")


@pytest.mark.parametrize("name", ("soak_graph", "bench_reduce",
                                  "bench_graphbuild"))
def test_host_only_twin_says_so(name):
    text = " ".join(_run(["-m", f"manta_tpu_torch.tools.{name}",
                          "--help"]).stdout.split())
    assert "Host only" in text and "no device" in text
    assert "--device" not in text


def test_twins_write_nothing_under_benchmarks(tmp_path):
    """A twin's temporary files go under --work-dir and are removed."""
    before = _results_listing()
    listing = sorted(os.listdir(os.path.join(REPO, "benchmarks")))
    _twin("bench_reduce", "--loci", "3000", "--chroms", "3", "--work-dir",
          str(tmp_path))
    assert os.listdir(tmp_path) == []
    assert before == _results_listing()
    assert listing == sorted(os.listdir(os.path.join(REPO, "benchmarks")))
    shutil.rmtree(tmp_path)
