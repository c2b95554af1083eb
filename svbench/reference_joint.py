"""Manta's joint diploid genotyper in plain PyTorch, float64 on the CPU.

The plain reference of the ``trio_wgs35x`` configuration: what Manta's
germline mode computes for one record from the fragment evidence of
each of its 1 to ~10 diploid samples (Chen et al. 2016, supplementary
methods ``methods.tex:579-627``; ``GenerateSVCandidates/SVScorer.cpp``
``getRefAltFromFrag``, ``incrementSpanningPairAlleleLnLhood:564``,
``incrementSplitReadLhood:616``, ``addDiploidLoglhood:767-801``,
``scoreDiploidSV:803-960``). It imports nothing of the program: its
inputs are arrays.

A record is one or two junctions (two for a multi-junction event, scored
jointly). For each junction it takes, per sample, the fragment bank's
arrays as the program holds them (``BANK_FIELDS``; axes: read 0 = read1,
allele 0 = alt and 1 = ref, breakend 0 = bp1), the spanning-pair weight,
whether the junction is a tandem duplication, whether it counts towards
``NoPairSupport``, and for a tandem duplication the per-sample depth
term. It computes, vectorised over fragments x samples x genotypes:

- per fragment, the ln-likelihood of the ref and the alt allele: the
  spanning pair's fragment-size likelihood mixed with the chimera rate
  (1e-3 each way) and raised to the spanning weight, plus the split
  reads' alignment likelihoods mixed with the split mapping-error rates
  (1e-6 ref, 1e-5 alt), the better of the two reads where both count;
- per sample and genotype {ref, het, hom}, the sum over fragments of
  ln((1 - f) P(ref) + f P(alt)) at the genotype's alt fraction f;
- per sample, the posterior under the prior theta = 1e-5 (het theta, hom
  theta / 2), GT, GQ, PL and the filters ``HomRef`` and ``MinGQ``;
- per record, QUAL = phred of the product of the samples' ref
  posteriors, ``MinQUAL``, ``SampleFT`` and ``NoPairSupport`` (no
  confident alt spanning pair in any sample at more than half the
  junctions that count).

Departures from the published description, each the program's own:

- the hom alt fraction is 0.99, not 1 (``SVScoreInfoDiploid.hpp:40``);
- tandem duplications, with ``tandem_aware``, take the fractions
  (0, 0.2, 1/3) and a read-depth term that is given as an input (the alt
  haplotype of a tandem duplication still carries both reference
  junctions); their ``MinGQ`` reads the non-ref posterior's quality
  where the call is not ref;
- the priors are rounded to float32 before their logarithm, as the C++
  holds them;
- GQ's error probability is the sum of the other genotypes' posteriors,
  not one less the called one (the same number, without cancellation);
- sums run over a padded fragment axis, not in read-name order, so they
  may differ from the program's in the last bits;
- of the record filters only those of the genotyper: ``MaxDepth``,
  ``MaxMQ0Frac`` and ``Ploidy`` read depths and other records.

Each result carries the unrounded phred values, so that a comparison can
tell a rounding step (within ``NEAR_STEP``) from a real difference.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

BANK_FIELDS = ("r_scanned", "r_anch", "r_t2anch", "pair_sup", "pair_prob",
               "sp_eval", "sp_sup", "sp_t2", "sp_lnl")
# trailing shape of each field after the fragment axis
FIELD_SHAPE = {"r_scanned": (2,), "r_anch": (2,), "r_t2anch": (2,),
               "pair_sup": (2, 2), "pair_prob": (2, 2),
               "sp_eval": (2, 2, 2), "sp_sup": (2, 2, 2), "sp_t2": (2, 2, 2),
               "sp_lnl": (2, 2, 2)}
DIPLOID_FRACTIONS = (0.0, 0.5, 0.99)
TANDEM_DUP_FRACTIONS = (0.0, 0.2, 1.0 / 3.0)
GT_LABELS = ("0/0", "0/1", "1/1")
MAX_Q = 999
# a phred value this close to a rounding step may round either way
NEAR_STEP = 1e-6

# the diploid model's fragment constants (addDiploidLoglhood)
CHIMERA_PROB = 1e-3
REF_SPLIT_MAP_PROB = 1e-6
ALT_SPLIT_MAP_PROB = 1e-5
SEMI_MAPPED_POWER = 0.0
SPLIT_PSEUDO_COUNT = 0.5
CONFIDENT_PAIR = 0.9


@dataclass(frozen=True)
class DiploidOptions:
    indel_prior: float = 1e-5
    min_pass_alt_score: int = 20
    min_pass_gt_score: int = 15
    tandem_aware: bool = True


def _stack(banks: list[dict], dtype) -> tuple[dict, torch.Tensor]:
    """The samples' banks padded to one fragment axis: (S, F, ...)
    tensors, and the (S, F) mask of real rows."""
    n = [int(len(b["r_scanned"])) for b in banks]
    f = max(n + [1])
    out = {}
    for name in BANK_FIELDS:
        is_float = name in ("pair_prob", "sp_lnl")
        t = torch.zeros((len(banks), f) + FIELD_SHAPE[name],
                        dtype=dtype if is_float else torch.bool)
        for s, b in enumerate(banks):
            if n[s]:
                t[s, :n[s]] = torch.as_tensor(b[name][:n[s]]).to(t.dtype)
        out[name] = t
    mask = torch.arange(f)[None, :] < torch.tensor(n)[:, None]
    return out, mask


def fragment_lnl(bank: dict, weight: float, dtype=torch.float64):
    """Per fragment of (S, F) padded banks: the ref and alt allele
    ln-likelihoods and whether the fragment counts (getRefAltFromFrag,
    not permissive)."""
    neg_inf = torch.tensor(-math.inf, dtype=dtype)
    # spanning pair: the best breakend's fragment-size likelihood
    p = torch.where(bank["pair_sup"], bank["pair_prob"],
                    torch.zeros((), dtype=dtype)).amax(-1)       # (S,F,al)
    p_alt, p_ref = p[..., 0], p[..., 1]
    scanned, anch = bank["r_scanned"], bank["r_anch"]
    paired = (scanned.all(-1) & anch.any(-1)
              & bank["pair_sup"].flatten(-2).any(-1))
    full_w = torch.tensor(weight, dtype=dtype)
    semi_w = torch.where(p_alt > p_ref, full_w * SEMI_MAPPED_POWER,
                         torch.zeros((), dtype=dtype))
    power = torch.where(anch.all(-1), full_w, semi_w)
    chim = torch.tensor(CHIMERA_PROB, dtype=dtype)
    pair_ref = torch.log((1 - chim) * p_ref + chim) * power
    pair_alt = torch.log((1 - chim) * p_alt + chim) * power
    zero = torch.zeros((), dtype=dtype)
    pair_ref = torch.where(paired, pair_ref, zero)
    pair_alt = torch.where(paired, pair_alt, zero)

    # split reads: each allele's best supported breakend, per read
    sup = bank["sp_sup"]                                  # (S,F,al,bp,rd)
    at_bp = sup.any(2)                                    # (S,F,bp,rd)
    has = at_bp.any(2)                                    # (S,F,rd)
    read_eval = has & bank["sp_eval"].flatten(2, 3).all(2)
    align = torch.where(at_bp[:, :, None], bank["sp_lnl"],
                        neg_inf).amax(3)                  # (S,F,al,rd)
    align = torch.where(has[:, :, None], align, zero)
    m_ref = torch.tensor(REF_SPLIT_MAP_PROB, dtype=dtype)
    m_alt = torch.tensor(ALT_SPLIT_MAP_PROB, dtype=dtype)
    ref_split = torch.logaddexp(torch.log1p(-m_ref) + align[:, :, 1],
                                torch.log(m_alt))
    alt_split = torch.logaddexp(torch.log1p(-m_alt) + align[:, :, 0],
                                torch.log(m_ref))
    # a read that tells neither allele from a mismapping adds nothing
    informative = ~((ref_split < torch.log(m_alt) + SPLIT_PSEUDO_COUNT)
                    & (alt_split < torch.log(m_ref) + SPLIT_PSEUDO_COUNT))
    ref_split = torch.where(informative, ref_split, zero)
    alt_split = torch.where(informative, alt_split, zero)
    any_read = read_eval.any(-1)
    split_ref = torch.where(any_read, torch.where(
        read_eval, ref_split, neg_inf).amax(-1), zero)
    split_alt = torch.where(any_read, torch.where(
        read_eval, alt_split, neg_inf).amax(-1), zero)
    return (pair_ref + split_ref, pair_alt + split_alt, paired | any_read)


def _phred(p: float) -> tuple[int, float]:
    """(phred value capped at MAX_Q, its unrounded value + 0.5)."""
    if p <= 0:
        return MAX_Q, math.inf
    u = -10.0 * math.log10(p) + 0.5
    return min(MAX_Q, math.floor(u)), u


def _near_step(u: float) -> bool:
    return u < MAX_Q + 0.5 and abs(u - round(u)) < NEAR_STEP


def sample_loglhood(junctions: list[dict], n_samples: int,
                    opt: DiploidOptions = DiploidOptions(),
                    dtype=torch.float64) -> torch.Tensor:
    """(S, 3) ln-likelihood of each sample's genotypes, summed over the
    record's junctions."""
    total = torch.zeros((n_samples, 3), dtype=dtype)
    for j in junctions:
        tandem = opt.tandem_aware and j["tandem"]
        bank, mask = _stack(j["banks"], dtype)
        ref, alt, counts = fragment_lnl(bank, j["weight"], dtype)
        f = torch.tensor(TANDEM_DUP_FRACTIONS if tandem
                         else DIPLOID_FRACTIONS, dtype=dtype)
        neg_inf = torch.tensor(-math.inf, dtype=dtype)
        ln_ref_w = torch.where(f < 1, torch.log1p(-f), neg_inf)
        ln_alt_w = torch.where(f > 0, torch.log(f), neg_inf)
        mix = torch.logaddexp(ref[..., None] + ln_ref_w,
                              alt[..., None] + ln_alt_w)      # (S,F,G)
        keep = (counts & mask)[..., None]
        total = total + torch.where(keep, mix, torch.zeros((), dtype=dtype)
                                    ).sum(1)
        if tandem and j.get("dup_depth") is not None:
            total = total + torch.as_tensor(j["dup_depth"], dtype=dtype)
    return total


def confident_alt_pairs(bank: dict) -> int:
    """Fragments of one sample's bank whose spanning pair favours the alt
    allele with probability over 0.9, both reads anchored
    (addConservativeSpanningPairSupport)."""
    t, mask = _stack([bank], torch.float64)
    p = torch.where(t["pair_sup"], t["pair_prob"],
                    torch.zeros((), dtype=torch.float64)).amax(-1)
    alt, ref = p[..., 0], p[..., 1]
    paired = t["pair_sup"].flatten(-2).any(-1)
    anchored = (t["r_scanned"] & t["r_anch"]).all(-1)
    sure = (alt > ref) & (alt / torch.where(paired, alt + ref, 1.0)
                          > CONFIDENT_PAIR)
    return int((sure & paired & anchored & mask).sum())


def joint_genotype(call: dict, opt: DiploidOptions = DiploidOptions(),
                   dtype=torch.float64) -> dict:
    """The record ``call`` = {"samples": S, "junctions": [{"weight",
    "tandem", "pair_filter", "banks": S dicts of ``BANK_FIELDS``,
    "dup_depth": (S, 3) or None}, ...]} through the joint genotyper."""
    n = call["samples"]
    junctions = call["junctions"]
    loglhood = sample_loglhood(junctions, n, opt, dtype)
    het = opt.indel_prior
    prior = torch.tensor([1 - het - het / 2, het, het / 2],
                         dtype=torch.float32).to(torch.float64)
    post = torch.softmax(loglhood.to(torch.float64) + torch.log(prior), -1)
    out = {"loglhood": loglhood, "posterior": post, "gt": [], "gq": [],
           "pl": [], "sample_filters": [], "near_step": []}
    dup_rule = opt.tandem_aware and all(j["tandem"] for j in junctions)
    for s in range(n):
        pp = post[s].tolist()
        gt = max(range(3), key=lambda g: (pp[g], -g))
        gq, u_gq = _phred(sum(pp[g] for g in range(3) if g != gt))
        lh = loglhood[s].tolist()
        best = max(range(3), key=lambda g: (lh[g], -g))
        pl, near = [], _near_step(u_gq)
        for g in range(3):
            u = -10.0 * (lh[g] - lh[best]) / math.log(10.0) + 0.5
            pl.append(min(MAX_Q, math.floor(u)))
            near |= _near_step(u)
        top = sorted(pp, reverse=True)
        near |= top[0] - top[1] <= 1e-9 * top[0]
        filters = set()
        if gt == 0:
            filters.add("HomRef")
        filter_gq = gq
        if dup_rule and gt != 0:
            nonref, u = _phred(pp[0])
            near |= _near_step(u)
            filter_gq = max(gq, nonref)
        if filter_gq < opt.min_pass_gt_score:
            filters.add("MinGQ")
        out["gt"].append(gt)
        out["gq"].append(gq)
        out["pl"].append(pl)
        out["sample_filters"].append(filters)
        out["near_step"].append(near)
    qual, u_qual = _phred(float(torch.prod(post[:, 0])))
    filters = set()
    if qual < opt.min_pass_alt_score:
        filters.add("MinQUAL")
    if all(out["sample_filters"]):
        filters.add("SampleFT")
    no_pairs = sum(1 for j in junctions if j["pair_filter"] and not any(
        confident_alt_pairs(b) for b in j["banks"]))
    if 2 * no_pairs > len(junctions):
        filters.add("NoPairSupport")
    out.update(qual=qual, qual_near_step=_near_step(u_qual),
               filters=filters)
    return out
