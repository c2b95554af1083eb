"""The port's joint diploid genotyper held against the plain reference
``svbench/reference_joint.py``: a capture of what the genotyper was given
and what it returned, and the comparisons.

``install(directory)`` wraps, in the process that runs the workflow and
before it forks its workers (which inherit the wrappers):

- ``SVScorer.score_diploid``: each call's inputs as the reference takes
  them (per junction the samples' fragment banks, the spanning weight,
  whether it is a tandem duplication, whether it counts towards
  ``NoPairSupport``, the depth term of a tandem duplication), the
  diploid options, and what the port returned, with its per-sample
  ln-likelihoods (the lists ``add_diploid_loglhood`` accumulated into);
- ``VcfWriterDiploidSV._emit``: which call's result each written VCF
  record carries, by the record's ID.

Each process appends its records to ``directory/joint.<pid>.pkl``.
"""

from __future__ import annotations

import gzip
import math
import os
import pickle

from svbench import reference_joint as rj

GENOTYPER_FILTERS = {"MinQUAL", "SampleFT", "NoPairSupport"}
# both sides compute in float64 and differ only in summation order
LOGLHOOD_RTOL = 1e-9

_STACK: list = []
_COUNT = [0]


def _append(directory: str, record: dict) -> None:
    with open(os.path.join(directory, f"joint.{os.getpid()}.pkl"),
              "ab") as f:
        pickle.dump(record, f)


def _bank(track) -> dict:
    return {k: getattr(track, k)[:track.n].copy() for k in rj.BANK_FIELDS}


def install(directory: str):
    """Wrap the genotyper and the diploid VCF writer; returns a function
    that restores them."""
    from manta_tpu_torch.core.svmodel import (
        EXT_INSERT, EXT_TANDUP, get_extended_sv_type, is_sv_below_min_size)
    from manta_tpu_torch.format import vcfwriter
    from manta_tpu_torch.scoring import scorer

    os.makedirs(directory, exist_ok=True)
    cls = scorer.SVScorer
    score_diploid, dup_depth = cls.score_diploid, cls._dup_depth_loglhood
    add_lhood = scorer.add_diploid_loglhood
    emit = vcfwriter.VcfWriterDiploidSV._emit

    def add_diploid_loglhood(weight, track, loglhood, fractions=None):
        add_lhood(weight, track, loglhood, fractions=fractions)
        if _STACK and all(x is not loglhood for x in _STACK[-1]["lh"]):
            _STACK[-1]["lh"].append(loglhood)

    def dup_depth_loglhood(self, sv, ds):
        out = dup_depth(self, sv, ds)
        if _STACK:
            _STACK[-1]["dup"][(id(sv), ds)] = list(out)
        return out

    def wrapped_score_diploid(self, junction_data, result):
        _STACK.append({"lh": [], "dup": {}})
        try:
            score_diploid(self, junction_data, result)
        finally:
            state = _STACK.pop()
        n = self.diploid_sample_count
        max_close = int(self.scanner.extreme_fifth[1])
        junctions = []
        for sv, tracks, _base, weight in junction_data:
            t = get_extended_sv_type(sv)
            dup = [state["dup"].get((id(sv), ds)) for ds in range(n)]
            junctions.append({
                "weight": float(weight), "tandem": t == EXT_TANDUP,
                "pair_filter": (t != EXT_INSERT and not
                                is_sv_below_min_size(sv, max_close)),
                "banks": [_bank(tracks[ds]) for ds in range(n)],
                "dup_depth": dup if all(d is not None for d in dup)
                else None})
        d = self.diploid_opt
        _COUNT[0] += 1
        key = (os.getpid(), _COUNT[0])
        result._joint_capture = key
        _append(directory, {"kind": "call", "key": key, "samples": n,
                            "junctions": junctions,
                            "opt": rj.DiploidOptions(
                                d.indel_prior, d.min_pass_alt_score,
                                d.min_pass_gt_score,
                                d.dup_gt_model == "tandem-aware"),
                            "port": {
                                "loglhood": [list(x) for x in state["lh"]],
                                "gt": [s.gt for s in result.samples],
                                "gq": [s.gt_score for s in result.samples],
                                "pl": [list(s.phred_loghood)
                                       for s in result.samples],
                                "sample_filters": [set(s.filters)
                                                   for s in result.samples],
                                "qual": result.alt_score,
                                "filters": set(result.filters)}})

    def wrapped_emit(self, chrom, pos, vid, ref, alt, score, info,
                     sample_tags):
        _append(directory, {"kind": "emit", "id": vid, "key": getattr(
            score[0], "_joint_capture", None), "junction": getattr(
                score[1], "_joint_capture", None)})
        return emit(self, chrom, pos, vid, ref, alt, score, info,
                    sample_tags)

    cls.score_diploid = wrapped_score_diploid
    cls._dup_depth_loglhood = dup_depth_loglhood
    scorer.add_diploid_loglhood = add_diploid_loglhood
    vcfwriter.VcfWriterDiploidSV._emit = wrapped_emit

    def remove():
        cls.score_diploid = score_diploid
        cls._dup_depth_loglhood = dup_depth
        scorer.add_diploid_loglhood = add_lhood
        vcfwriter.VcfWriterDiploidSV._emit = emit
    return remove


def load(directory: str) -> tuple[dict, dict]:
    """(calls by key, and by each written record's ID the keys of the
    call its QUAL came from and of its junction's own call: the two
    differ in a multi-junction event)."""
    calls, emits = {}, {}
    for name in sorted(os.listdir(directory)):
        if not (name.startswith("joint.") and name.endswith(".pkl")):
            continue
        with open(os.path.join(directory, name), "rb") as f:
            while True:
                try:
                    rec = pickle.load(f)
                except EOFError:
                    break
                if rec["kind"] == "call":
                    calls[rec["key"]] = rec
                else:
                    emits[rec["id"]] = (rec["key"], rec["junction"])
    return calls, emits


def rel_err(a: float, b: float) -> float:
    scale = max(abs(a), abs(b))
    return abs(a - b) / scale if scale else 0.0


def compare_call(rec: dict, dtype=None) -> dict:
    """One captured call against the reference: the largest relative
    error of the samples' ln-likelihoods, and the samples whose GT, GQ,
    PL or filters differ, apart from those the reference puts within
    ``NEAR_STEP`` of a rounding step (counted as ``near_step``)."""
    import torch
    ref = rj.joint_genotype(rec, rec["opt"],
                            dtype=dtype or torch.float64)
    port = rec["port"]
    worst = max(rel_err(a, b) for x, y in zip(port["loglhood"],
                                              ref["loglhood"].tolist())
                for a, b in zip(x, y))
    bad = near = 0
    for s in range(rec["samples"]):
        same = (port["gt"][s] == ref["gt"][s]
                and port["gq"][s] == ref["gq"][s]
                and port["pl"][s] == ref["pl"][s]
                and port["sample_filters"][s] == ref["sample_filters"][s])
        if not same:
            if ref["near_step"][s]:
                near += 1
            else:
                bad += 1
    record_same = (port["qual"] == ref["qual"] and
                   port["filters"] & GENOTYPER_FILTERS == ref["filters"])
    record_bad = int(not record_same and not ref["qual_near_step"])
    return {"loglhood_rel_err": worst, "mismatched_samples": bad,
            "near_step_samples": near, "mismatched_records": record_bad,
            "near_step_records": int(not record_same
                                     and ref["qual_near_step"])}


def compare_calls(calls: dict, dtype=None) -> dict:
    """Every captured call against the reference: counts of junctions,
    sample-junctions, fragments, mismatches and rounding-step cases, and
    the largest relative error of a ln-likelihood."""
    out = {"calls": len(calls), "junctions": 0, "sample_junctions": 0,
           "fragments": 0, "loglhood_rel_err": 0.0,
           "loglhood_over_tolerance": 0, "mismatched_samples": 0,
           "near_step_samples": 0, "mismatched_records": 0,
           "near_step_records": 0}
    for rec in calls.values():
        out["junctions"] += len(rec["junctions"])
        out["sample_junctions"] += len(rec["junctions"]) * rec["samples"]
        out["fragments"] += sum(len(b["r_scanned"]) for j in rec["junctions"]
                                for b in j["banks"])
        got = compare_call(rec, dtype)
        out["loglhood_rel_err"] = max(out["loglhood_rel_err"],
                                      got.pop("loglhood_rel_err"))
        for k, v in got.items():
            out[k] += v
    out["loglhood_over_tolerance"] = int(
        out["loglhood_rel_err"] > LOGLHOOD_RTOL)
    return out


def vcf_records(path: str) -> list[list[str]]:
    with gzip.open(path, "rt") as f:
        return [ln.rstrip("\n").split("\t") for ln in f
                if not ln.startswith("#")]


def _written(ref: dict, s: int, fields: dict) -> bool:
    ft = set() if fields["FT"] == "PASS" else set(fields["FT"].split(";"))
    return (fields["GT"] == rj.GT_LABELS[ref["gt"][s]]
            and fields["GQ"] == str(ref["gq"][s])
            and fields["PL"] == ",".join(str(p) for p in ref["pl"][s])
            and ft == ref["sample_filters"][s])


def compare_vcf(path: str, calls: dict, emits: dict) -> dict:
    """Each record of a diploidSV VCF against the reference recomputed
    from the calls its ID was written from: QUAL and the genotyper's
    record filters, and each sample's GT, FT, GQ and PL as written. In a
    multi-junction event the record carries the joint call, and the
    writer takes a sample whose joint genotype it rejects from the
    junction's own call (``SVWriter.cpp``): such a sample may equal
    either (counted as ``event_samples_from_junction``), and
    JUNCTION_QUAL is the junction's own QUAL."""
    out = {"records": 0, "mismatched_records": 0, "near_step_records": 0,
           "sample_fields": 0, "mismatched_samples": 0,
           "near_step_samples": 0, "event_samples_from_junction": 0,
           "unmatched_ids": 0}
    cache: dict = {}

    def reference(key):
        if key not in cache:
            cache[key] = rj.joint_genotype(calls[key], calls[key]["opt"])
        return cache[key]

    for w in vcf_records(path):
        key, junction = emits.get(w[2], (None, None))
        if key not in calls or junction not in calls:
            out["unmatched_ids"] += 1
            continue
        ref, own = reference(key), reference(junction)
        out["records"] += 1
        filters = set(w[6].split(";")) if w[6] != "PASS" else set()
        info = dict(kv.split("=", 1) for kv in w[7].split(";") if "=" in kv)
        same = (w[5] == str(ref["qual"])
                and filters & GENOTYPER_FILTERS == ref["filters"])
        if key != junction:
            same &= info.get("JUNCTION_QUAL") == str(own["qual"])
        if not same:
            near = ref["qual_near_step"] or own["qual_near_step"]
            out["near_step_records" if near else "mismatched_records"] += 1
        keys = w[8].split(":")
        for s, col in enumerate(w[9:]):
            f = dict(zip(keys, col.split(":")))
            out["sample_fields"] += 1
            if _written(ref, s, f):
                continue
            if key != junction and _written(own, s, f):
                out["event_samples_from_junction"] += 1
            elif ref["near_step"][s] or own["near_step"][s]:
                out["near_step_samples"] += 1
            else:
                out["mismatched_samples"] += 1
    return out


def genotype_concordance(vcf_path: str, truth_path: str,
                         tolerance: int = 50) -> list[dict]:
    """Per sample: the planted genotypes of the truth events that a VCF
    record of a compatible type matches (the truth checker's rule), and
    how many of them the record's GT equals."""
    want = {"DEL": ("DEL",), "INS": ("INS",), "DUP": ("DUP",),
            "INV": ("BND", "INV"), "BND": ("BND",)}
    label = {"ref": "0/0", "het": "0/1", "hom": "1/1"}
    recs = []
    for w in vcf_records(vcf_path):
        info = dict(kv.split("=", 1) for kv in w[7].split(";") if "=" in kv)
        keys = w[8].split(":")
        gts = [dict(zip(keys, c.split(":")))["GT"] for c in w[9:]]
        recs.append((w[0], int(w[1]), info.get("SVTYPE", ""),
                     w[6] in ("PASS", "Ploidy"), gts))
    out = None
    with open(truth_path) as f:
        next(f)
        for ln in f:
            chrom, pos, typ, _size, gt = ln.rstrip("\n").split("\t")
            planted = gt.split(":")[0].split(",")
            if out is None:
                out = [{"matched": 0, "equal": 0} for _ in planted]
            hits = [r for r in recs if r[0] == chrom and r[2] in want[typ]
                    and abs(r[1] - int(pos)) <= tolerance]
            if not hits:
                continue
            best = min(hits, key=lambda r: (not r[3], abs(r[1] - int(pos))))
            for s, g in enumerate(planted):
                out[s]["matched"] += 1
                out[s]["equal"] += int(best[4][s] == label[g])
    for o in out or []:
        o["concordance"] = (o["equal"] / o["matched"] if o["matched"]
                            else math.nan)
    return out or []
