"""Call accuracy against the planted truth: the frozen matching rule of
the port's truth checker (``manta_tpu_torch/tools/wgs_workload.py``
``check``), read as recall, precision and F1.

A truth event is found when a PASS record of a compatible type lies on
its chromosome within ``tolerance`` bases of its position (an inversion
may be called as INV or as BND). A PASS record is a false positive when
it matched no truth event and lies within ``tolerance`` of no truth
breakend (either end of a DEL, DUP or INV, or either side of a
translocation). Precision is the share of PASS records that are not
false positives.
"""

from __future__ import annotations

import gzip
import re

WANT = {"DEL": ("DEL",), "INS": ("INS",), "DUP": ("DUP",),
        "INV": ("BND", "INV"), "BND": ("BND",)}


def read_truth(path: str) -> list[dict]:
    truth = []
    with open(path) as f:
        next(f)
        for ln in f:
            c = ln.rstrip("\n").split("\t")
            truth.append(dict(chrom=c[0], pos=int(c[1]), type=c[2],
                              size=int(c[3]), gt=c[4]))
    return truth


def read_vcf(path: str) -> list[dict]:
    """The PASS records of a (gzipped) VCF: chrom, pos, id, svtype."""
    recs = []
    with gzip.open(path, "rt") as f:
        for ln in f:
            if ln.startswith("#"):
                continue
            c = ln.rstrip("\n").split("\t")
            if c[6] not in ("PASS", "."):
                continue
            info = dict(kv.split("=", 1) if "=" in kv else (kv, True)
                        for kv in c[7].split(";"))
            svtype = info.get("SVTYPE", "")
            if not svtype:
                m = re.match(r"^Manta(\w+?):", c[2])
                svtype = m.group(1) if m else ""
            recs.append(dict(chrom=c[0], pos=int(c[1]), id=c[2],
                             svtype=svtype))
    return recs


def score(truth: list[dict], recs: list[dict], tolerance: int = 50) -> dict:
    """Recall, precision and F1 of PASS records ``recs`` against
    ``truth``."""
    by_chrom: dict[str, list[dict]] = {}
    for r in recs:
        by_chrom.setdefault(r["chrom"], []).append(r)
    found = 0
    matched: set[str] = set()
    for tr in truth:
        hits = [r for r in by_chrom.get(tr["chrom"], ())
                if r["svtype"] in WANT[tr["type"]]
                and abs(r["pos"] - tr["pos"]) <= tolerance]
        if hits:
            found += 1
            matched.update(h["id"] for h in hits)
    points = {(t["chrom"], t["pos"]) for t in truth}
    for t in truth:
        if t["type"] in ("DEL", "DUP", "INV"):
            points.add((t["chrom"], t["pos"] + t["size"]))
        elif t["type"] == "BND" and ":" in t["gt"]:
            _, mate_chrom, mate_pos = t["gt"].split(":")
            points.add((mate_chrom, int(mate_pos)))
    fp = sum(1 for r in recs if r["id"] not in matched and not any(
        r["chrom"] == c and abs(r["pos"] - p) <= tolerance
        for c, p in points))
    recall = found / len(truth) if truth else 0.0
    precision = (len(recs) - fp) / len(recs) if recs else 0.0
    f1 = (2 * recall * precision / (recall + precision)
          if recall + precision else 0.0)
    return {"truth": len(truth), "found": found, "records": len(recs),
            "fp": fp, "recall": recall, "precision": precision, "f1": f1}
