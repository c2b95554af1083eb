"""The port's joint diploid genotyper against the plain reference
``svbench/reference_joint.py`` (Manta's model in plain PyTorch, float64):

- on seeded random fragment banks at 1, 2, 3 and 10 samples, with the
  diploid and the tandem-duplication alt fractions, through
  ``SVScorer.score_diploid`` (``accumulate_lhood`` in the native core);
- the same comparison with the reference in float32, which must fail;
- one whole 3-sample sample (2 x 1 Mb at 35x, -j 2) through
  ``run_workflow``: every call of the genotyper, and the VCF's QUAL,
  filters and per-sample GT, FT, GQ and PL as written;
- on the card (marker ``cuda``), one whole sample of the benchmark's
  trio cell ``trio35x.exact`` the way ``svbench/run.py`` runs it.

Tolerances: the samples' ln-likelihoods within 1e-9 relative
(``jointcapture.LOGLHOOD_RTOL``): both sides sum float64 terms and only
the order of the sums differs, ~1e-15 relative at these sizes, while
float32 arithmetic leaves ~1e-7. GT, GQ, PL, QUAL and the filters are
integers and sets and must be equal, except where the reference's
unrounded phred value lies within 1e-6 of a rounding step, where the
last bits of the sums may round either way: such cases are counted and
printed, never more than a few.

This file imports no JAX: on the card run it with

    python -m pytest --noconftest -p no:cacheprovider -s -m cuda \\
        tests/test_torch_joint_genotype.py
"""

from __future__ import annotations

import ast
import json
import os
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jointcapture
from svbench import reference_joint as rj

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SAMPLES = (1, 2, 3, 10)
RECORDS = 24
SEED = 3000000021


# ------------------------------------------------------------ random banks

def _random_bank(rng, n: int, alt_fraction: float):
    """A fragment bank of ``n`` rows whose fragments carry the alt allele
    with probability ``alt_fraction``: spanning pairs and split reads
    that favour their allele, with semi-mapped fragments, reads that
    tell nothing, unevaluated breakends and empty rows among them."""
    from manta_tpu_torch.scoring.fragbank import FragmentBank
    b = SimpleNamespace()
    alt = rng.random(n) < alt_fraction                  # allele 0 = alt
    favoured = np.where(alt, 0, 1)
    b.r_scanned = rng.random((n, 2)) < 0.95
    b.r_anch = rng.random((n, 2)) < 0.85
    b.r_t2anch = b.r_anch | (rng.random((n, 2)) < 0.5)
    has_pair = rng.random(n) < 0.7
    # the other allele's breakends too, on some of those fragments
    b.pair_sup = (rng.random((n, 2, 2)) < 0.15) & has_pair[:, None, None]
    b.pair_sup[np.arange(n), favoured, rng.integers(0, 2, n)] |= has_pair
    b.pair_prob = np.where(b.pair_sup, rng.uniform(1e-5, 2e-3, (n, 2, 2)),
                           0.0)
    win = b.pair_sup[np.arange(n), favoured]
    b.pair_prob[np.arange(n), favoured] = np.where(
        win, rng.uniform(4e-3, 2e-2, (n, 2)), 0.0)
    b.sp_sup = rng.random((n, 2, 2, 2)) < 0.25
    b.sp_eval = rng.random((n, 2, 2, 2)) < 0.95
    b.sp_t2 = b.sp_sup | (rng.random((n, 2, 2, 2)) < 0.1)
    b.sp_lnl = rng.uniform(-40.0, -5.0, (n, 2, 2, 2))
    b.sp_lnl[np.arange(n), favoured] = rng.uniform(-3.0, -0.01, (n, 2, 2))
    blind = rng.random(n) < 0.1                 # neither allele fits
    b.sp_lnl[blind] = rng.uniform(-60.0, -45.0, (int(blind.sum()), 2, 2, 2))
    bank = FragmentBank()
    bank.rows_for([b"q%d.%d" % (i, rng.integers(1 << 30)) for i in range(n)])
    for k in rj.BANK_FIELDS:
        getattr(bank, k)[:n] = getattr(b, k)
    return bank


def _sv(kind: str, beg: int):
    from manta_tpu_torch.core.svmodel import (
        BND_LEFT_OPEN, BND_RIGHT_OPEN, GenomeInterval, SVBreakend,
        SVCandidate)
    left, right = ((BND_RIGHT_OPEN, BND_LEFT_OPEN) if kind == "diploid"
                   else (BND_LEFT_OPEN, BND_RIGHT_OPEN))
    return SVCandidate(
        SVBreakend(GenomeInterval(0, beg, beg + 1), left),
        SVBreakend(GenomeInterval(0, beg + 2000, beg + 2001), right),
        is_imprecise=False)


def _base(tracks):
    """The evidence summary the scorer keeps beside the banks: each
    sample's confident alt spanning pairs (``NoPairSupport`` reads it)."""
    from manta_tpu_torch.scoring.evidence import SampleInfo, ScoreInfo
    from manta_tpu_torch.scoring.fragbank import AL_ALT, support_counts
    base = ScoreInfo(samples=[SampleInfo() for _ in tracks])
    for sample, track in zip(base.samples, tracks):
        sample.alt.confident_spanning_pair_count = int(
            support_counts(track)[AL_ALT, 1])
    return base


def _score_random(samples: int, kind: str, directory, monkeypatch,
                  seed: int = SEED) -> dict:
    """Random records of one or two junctions (a deletion, or with
    ``kind`` "tandem" a tandem duplication with a random depth term)
    through the port's ``score_diploid`` under the capture; returns the
    captured calls."""
    from manta_tpu_torch.scoring import scorer
    rng = np.random.default_rng([seed, samples, kind == "tandem"])
    depth: dict = {}
    monkeypatch.setattr(scorer.SVScorer, "_dup_depth_loglhood",
                        lambda self, sv, ds: depth[id(sv)][ds])
    undo = jointcapture.install(str(directory))
    try:
        port = scorer.SVScorer(
            SimpleNamespace(extreme_fifth=(0, 500), chrom_names=["chr1"]),
            [None] * samples, [False] * samples, None)
        for r in range(RECORDS):
            junctions = []
            for j in range(1 + (r % 3 == 2)):
                sv = _sv(kind, 10_000 * r + 3000 * j)
                # a quarter of the records carry no alt allele anywhere
                fractions = (rng.choice([0.0, 0.0, 0.2, 0.5, 1.0], samples)
                             if r % 4 else np.zeros(samples))
                tracks = [_random_bank(rng, int(rng.integers(0, 60)), f)
                          for f in fractions]
                depth[id(sv)] = [list(rng.normal(0.0, 4.0, 3))
                                 for _ in range(samples)]
                junctions.append((sv, tracks, _base(tracks), float(
                    rng.choice([1.0, 0.4]))))
            port.score_diploid(junctions, scorer.DiploidResult())
    finally:
        undo()
    calls, _ = jointcapture.load(str(directory))
    assert len(calls) == RECORDS
    return calls


@pytest.mark.parametrize("kind", ["diploid", "tandem"])
@pytest.mark.parametrize("samples", SAMPLES)
def test_genotyper_matches_reference_on_random_banks(samples, kind, tmp_path,
                                                    monkeypatch):
    calls = _score_random(samples, kind, tmp_path, monkeypatch)
    got = jointcapture.compare_calls(calls)
    print(json.dumps(got))
    assert got["sample_junctions"] > 0 and got["fragments"] > 0
    assert got["loglhood_rel_err"] <= jointcapture.LOGLHOOD_RTOL
    assert got["mismatched_samples"] == 0
    assert got["mismatched_records"] == 0
    # the rounding-step allowance is for the odd case, not a habit
    assert got["near_step_samples"] + got["near_step_records"] <= 2
    # the records are not all alike: each genotype and filter shows
    gts = {g for c in calls.values() for g in c["port"]["gt"]}
    assert gts == {0, 1, 2}
    filters = set().union(*(c["port"]["filters"] for c in calls.values()))
    assert {"MinQUAL", "NoPairSupport"} <= filters


@pytest.mark.parametrize("samples", SAMPLES)
def test_float32_reference_fails_the_tolerance(samples, tmp_path,
                                              monkeypatch):
    """The control: the same comparison with the reference computed in
    float32 breaks the log-likelihood tolerance."""
    calls = _score_random(samples, "diploid", tmp_path, monkeypatch)
    got = jointcapture.compare_calls(calls, dtype=torch.float32)
    assert got["loglhood_rel_err"] > 10 * jointcapture.LOGLHOOD_RTOL
    assert got["loglhood_over_tolerance"] == 1


def test_reference_genotypes_known_cases():
    """Hand-checked records: one sample with no evidence calls ref at
    the prior (QUAL from theta alone), and a hundred alt-only pairs make
    a hom call whose PL puts ref at the cap."""
    empty = {k: np.zeros((0,) + rj.FIELD_SHAPE[k],
                         np.float64 if k in ("pair_prob", "sp_lnl")
                         else bool) for k in rj.BANK_FIELDS}
    one = {"samples": 1, "junctions": [{"weight": 1.0, "tandem": False,
                                        "pair_filter": True,
                                        "banks": [empty],
                                        "dup_depth": None}]}
    out = rj.joint_genotype(one)
    assert out["gt"] == [0] and out["loglhood"].abs().max() == 0
    # P(ref) = 1 - 1.5e-5 -> QUAL 0; no alt pair -> NoPairSupport
    assert out["qual"] == 0
    assert out["filters"] == {"MinQUAL", "SampleFT", "NoPairSupport"}
    bank = {k: np.zeros((100,) + rj.FIELD_SHAPE[k],
                        np.float64 if k in ("pair_prob", "sp_lnl")
                        else bool) for k in rj.BANK_FIELDS}
    bank["r_scanned"][:] = bank["r_anch"][:] = True
    bank["pair_sup"][:, 0, 0] = True
    bank["pair_prob"][:, 0, 0] = 0.01
    hom = dict(one, junctions=[dict(one["junctions"][0], banks=[bank])])
    out = rj.joint_genotype(hom)
    assert out["gt"] == [2] and out["pl"][0][0] == 999
    assert out["filters"] == set() and out["sample_filters"] == [set()]


def test_reference_imports_nothing_of_the_program():
    prelude = """
import importlib.abc, sys
class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "manta_tpu",
                                  "manta_tpu_torch"):
            raise ImportError("refused: " + name)
sys.meta_path.insert(0, Refuse())
sys.path.insert(0, sys.argv[1])
import svbench.reference_joint as rj
import torch
assert not torch.backends.cuda.matmul.allow_tf32
assert not torch.backends.cudnn.allow_tf32
print(sorted(m for m in sys.modules if m.split(".")[0] in
             ("jax", "jaxlib", "manta_tpu", "manta_tpu_torch")))
"""
    res = subprocess.run([sys.executable, "-c", prelude, REPO],
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    assert res.stdout.strip() == "[]"
    path = os.path.join(REPO, "svbench", "reference_joint.py")
    for node in ast.walk(ast.parse(open(path).read())):
        names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                 else [node.module or ""]
                 if isinstance(node, ast.ImportFrom) else [])
        for n in names:
            assert n.split(".")[0] not in ("jax", "jaxlib", "manta_tpu",
                                           "manta_tpu_torch"), n


# ------------------------------------------------------------ a whole sample

# one 3-sample sample through run_workflow at -j 2 on the CPU, armed with
# the spans only and captured, in a process of its own (the workers fork
# from it)
_WORKFLOW = """
import glob, json, sys
sys.path.insert(0, sys.argv[1]); sys.path.insert(0, sys.argv[1] + "/tests")
import jointcapture
from svbench.workload import generate
from manta_tpu_torch.parallel import worker_trace
from manta_tpu_torch.workflow import run as wf
out, cap, trace, run_dir = sys.argv[2:6]
r = generate(out, seed=int(sys.argv[6]), chroms=2, mb=1, depth=35,
             samples=3, log=lambda m: None)
undo = jointcapture.install(cap)
worker_trace.arm(trace, device=False)
wf.run_workflow(r["bams"], [], out + ".fa", run_dir, n_jobs=2,
                scan_size_mb=12, use_device_scoring="off", verbose=False,
                device="cpu")
worker_trace.disarm()
undo()
print(json.dumps(r))
"""


@pytest.fixture(scope="module")
def trio_run(tmp_path_factory):
    d = tmp_path_factory.mktemp("trio")
    paths = [str(d / n) for n in ("s", "cap", "trace", "run")]
    os.makedirs(paths[2])
    res = subprocess.run(
        [sys.executable, "-c", _WORKFLOW, REPO, *paths, "3000000031"],
        capture_output=True, text=True, timeout=600,
        env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert res.returncode == 0, res.stderr[-3000:]
    gen = json.loads(res.stdout.strip().splitlines()[-1])
    calls, emits = jointcapture.load(paths[1])
    return SimpleNamespace(
        gen=gen, calls=calls, emits=emits, trace=paths[2],
        truth=paths[0] + ".truth.tsv",
        vcf=os.path.join(paths[3], "results", "variants",
                         "diploidSV.vcf.gz"))


def test_workflow_genotyper_calls_match_reference(trio_run):
    got = jointcapture.compare_calls(trio_run.calls)
    print(json.dumps(got))
    assert got["junctions"] >= 20
    assert got["sample_junctions"] == 3 * got["junctions"]
    assert got["loglhood_rel_err"] <= jointcapture.LOGLHOOD_RTOL
    assert got["mismatched_samples"] == 0
    assert got["mismatched_records"] == 0
    assert got["near_step_samples"] + got["near_step_records"] <= 2


def test_workflow_vcf_matches_reference(trio_run):
    got = jointcapture.compare_vcf(trio_run.vcf, trio_run.calls,
                                   trio_run.emits)
    print(json.dumps(got))
    assert got["records"] >= 20 and got["unmatched_ids"] == 0
    assert got["sample_fields"] == 3 * got["records"]
    assert got["mismatched_records"] == 0
    assert got["mismatched_samples"] == 0
    # each sample's genotypes as planted, where a record matches
    conc = jointcapture.genotype_concordance(trio_run.vcf, trio_run.truth)
    print(json.dumps(conc))
    assert len(conc) == 3 and all(c["matched"] >= 15 for c in conc)


def test_workflow_workers_count_the_joint_work(trio_run):
    """Each phase-2 worker's record carries ``counts["joint"]``; summed
    over the workers, the junctions scored are the genotyper's
    single-junction calls, each of three samples, with the same fragments;
    and every ``chunk.score`` span says it scored three samples."""
    recs = [json.load(open(os.path.join(trio_run.trace, n)))
            for n in os.listdir(trio_run.trace)
            if n.startswith("device_trace.")]
    assert recs
    joint = [r["counts"]["joint"] for r in recs]
    singles = [c for c in trio_run.calls.values()
               if len(c["junctions"]) == 1]
    assert sum(j["junctions"] for j in joint) == len(singles)
    assert sum(j["sample_junctions"] for j in joint) == 3 * len(singles)
    frags = [sum(len(c["junctions"][0]["banks"][s]["r_scanned"])
                 for c in singles) for s in range(3)]
    summed = [sum(j["fragments"][s] for j in joint if j["fragments"])
              for s in range(3)]
    assert summed == frags
    assert all(j["evidence_ns"] > 0 and j["genotype_ns"] > 0
               for j in joint if j["junctions"])
    scores = [s for r in recs for s in r["spans"] if s[0] == "chunk.score"]
    assert scores and all(s[4] == {"samples": 3} for s in scores)


# ------------------------------------------------------------ on the card

_CARD = """
import json, os, sys
sys.path.insert(0, sys.argv[1]); sys.path.insert(0, sys.argv[1] + "/tests")
import jointcapture
from svbench import run
bench, cell, config, traffic = run.cell_spec("trio35x.exact")
inputs = run.sample_inputs(config, traffic, int(sys.argv[2]))
wf, resolved = run.import_port(traffic["device_scoring"])
undo = jointcapture.install(sys.argv[3])
s = run.run_sample(wf, inputs, config, traffic["device_scoring"],
                   sys.argv[4])
undo()
print(json.dumps(dict(s, mode=resolved, truth=inputs["truth"],
                      bams=inputs["bams"], reads_per_bam=inputs["reads"])))
"""


@pytest.mark.cuda
def test_trio_sample_on_the_card(tmp_path):
    """One whole sample of ``trio35x.exact`` (3 x 5.6 M reads, -j 8, K1
    and K3 on the card) through ``svbench/run.py``'s own functions, every
    call of the genotyper against the reference, the VCF as written, and
    the per-sample genotypes against the planted ones (a reading)."""
    os.environ["PYTORCH_NVML_BASED_CUDA_CHECK"] = "1"
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    seed = int(os.environ.get("JOINT_CARD_SEED", "2718281828"))
    cap, run_dir = str(tmp_path / "cap"), str(tmp_path / "sample")
    res = subprocess.run([sys.executable, "-c", _CARD, REPO, str(seed), cap,
                          run_dir], capture_output=True, text=True,
                         timeout=1500)
    assert res.returncode == 0, res.stderr[-3000:]
    sample = json.loads(res.stdout.strip().splitlines()[-1])
    assert sample["error"] is None and sample["mode"] == "exact", sample
    calls, emits = jointcapture.load(cap)
    vcf = os.path.join(run_dir, "results", "variants", "diploidSV.vcf.gz")
    line = {"device": torch.cuda.get_device_name(0), "seed": seed,
            "wall_s": sample["wall_s"], "reads": sample["reads"],
            "calls": jointcapture.compare_calls(calls),
            "vcf": jointcapture.compare_vcf(vcf, calls, emits),
            "concordance": jointcapture.genotype_concordance(
                vcf, sample["truth"])}
    print("[joint-card] " + json.dumps(line), flush=True)
    got = line["calls"]
    assert got["junctions"] > 0
    assert got["loglhood_rel_err"] <= jointcapture.LOGLHOOD_RTOL
    assert got["mismatched_samples"] == 0 and got["mismatched_records"] == 0
    assert line["vcf"]["unmatched_ids"] == 0
    assert line["vcf"]["mismatched_samples"] == 0
    assert line["vcf"]["mismatched_records"] == 0
