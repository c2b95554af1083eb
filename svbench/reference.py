"""Plain references of the two device kernels the cells drive, held
against what the program's seams returned in the window.

- K1, contig jump scoring: the best score of a global jump alignment of
  a contig (query) across two reference windows, with Manta's spanning
  scores (``configs/*.json`` ``aligner``). A frozen copy of the port's
  plain form (``align/device_jumpscore.batched_jump_score``, exact chain),
  in plain PyTorch on the CPU, padded to the jobs' own lengths rather
  than the program's buckets. ``rounds`` bounds the insertion chain as
  the port's K2 does: the control of K1's check.
- K3, the split-read scan: for each read against each junction target,
  the best basecall ln-likelihood over the scan positions and the first
  position that reaches it. A frozen copy of the plain form
  (``align/device_splitscore.batched_split_score``) in NumPy, float32
  terms added in base order, so equal to the kernel bit for bit; the
  ln-likelihood tables are worked out here from the SNP prior.

Nothing here imports the port.
"""

from __future__ import annotations

import math

import numpy as np
import torch

BAD = -10000
NEG = -(1 << 28)
MAX_QSCORE = 70
N_BASE = ord("N")
LN_RANDOM = np.float32(-math.log(4.0))


# ------------------------------------------------------------------ K1

def _pad(seqs, n, fill):
    out = np.full((len(seqs), max(n, 1)), fill, np.int32)
    lens = np.zeros(len(seqs), np.int32)
    for i, s in enumerate(seqs):
        a = np.frombuffer(bytes(s), np.uint8)
        out[i, :len(a)] = a
        lens[i] = len(a)
    return out, lens


def jump_scores(jobs, match: int, mismatch: int, open_: int, extend: int,
                off_edge: int, jump_score: int,
                rounds: int = 0) -> np.ndarray:
    """Best jump-alignment score of each (query, ref1, ref2) job;
    ``rounds`` > 0 bounds the insertion chain (``_maxplus_prefix``)."""
    if not jobs:
        return np.zeros(0, np.int64)
    nq = max(len(j[0]) for j in jobs)
    q, ql = _pad([j[0] for j in jobs], nq, 1)      # 1 never matches a base
    r1, r1l = _pad([j[1] for j in jobs], max(len(j[1]) for j in jobs), 2)
    r2, r2l = _pad([j[2] for j in jobs], max(len(j[2]) for j in jobs), 2)

    t = torch.from_numpy
    best = _jump_dp(t(q), t(ql), t(r1), t(r1l), t(r2), t(r2l),
                    (match, mismatch, open_, extend), off_edge, jump_score,
                    rounds)
    return best.to(torch.int64).numpy()


def _maxplus_prefix(f, extend, k, rounds=0):
    """ci[q] = max_{k<=q}(f[k] + (q-k+1)*extend); with ``rounds`` = K > 0
    the chain reaches back 2^K - 1 lanes only (K log-step shift+max
    rounds), the bounded chain of the port's K2."""
    g = torch.where(f <= BAD, NEG, f - extend * k)
    if rounds <= 0:
        run = torch.cummax(g, dim=1).values
    else:
        run = g
        for i in range(rounds):
            shift = 1 << i
            if shift < run.shape[1]:
                run = torch.cat([run[:, :shift], torch.maximum(
                    run[:, shift:], run[:, :-shift])], dim=1)
    return torch.clamp_min(run + extend * (k + 1), BAD)


def _walk(query, query_len, ref, ref_len, state, best, scores, jump_score,
          is_ref1, rounds):
    match, mismatch, open_, extend = scores
    pm, pd, pi, pj = state
    B, nq = query.shape
    i32 = torch.int32
    k = torch.arange(nq + 1, dtype=i32)[None, :]
    qn = query_len.long()[:, None]
    zero_col = torch.zeros((B, 1), dtype=i32)
    bad_col = torch.full((B, 1), BAD, dtype=i32)
    bad2 = torch.full((B, 2), BAD, dtype=i32)
    match_t = torch.tensor(match, dtype=i32)
    mismatch_t = torch.tensor(mismatch, dtype=i32)
    n_cols = int(ref_len.max()) if B else 0
    for c in range(n_cols):
        sub = torch.where(query == ref[:, c:c + 1], match_t, mismatch_t)
        diag = torch.maximum(torch.maximum(pm[:, :-1], pd[:, :-1]),
                             pi[:, :-1])
        if not is_ref1:
            diag = torch.maximum(diag, pj[:, :-1])
        vm = torch.cat([zero_col, diag + sub], dim=1)
        vd = torch.maximum(torch.maximum(pm[:, 1:] + open_, pd[:, 1:]),
                           pi[:, 1:]) + extend
        if is_ref1:
            vd = torch.cat([bad2, vd[:, 1:]], dim=1)
            f = torch.cat([bad2, vm[:, 1:-1] + open_], dim=1)
            vi = _maxplus_prefix(f, extend, k, rounds)
            vi[:, :2] = BAD
            vj = torch.maximum(torch.maximum(vm + jump_score,
                                             vi + jump_score), pj)
            vj = torch.cat([bad_col, vj[:, 1:]], dim=1)
        else:
            vd = torch.cat([bad_col, vd], dim=1)
            f = torch.cat([bad_col, torch.maximum(vm[:, :-1] + open_,
                                                  pj[:, :-1])], dim=1)
            vi = _maxplus_prefix(f, extend, k, rounds)
            vi[:, 0] = BAD
            vj = pj
        act = (c < ref_len)[:, None]
        pm = torch.where(act, vm, pm)
        pd = torch.where(act, vd, pd)
        pi = torch.where(act, vi, pi)
        pj = torch.where(act, vj, pj)
        end_val = torch.gather(pm, 1, qn)[:, 0]
        best = torch.where(act[:, 0], torch.maximum(best, end_val), best)
    return (pm, pd, pi, pj), best


def _jump_dp(query, query_len, ref1, ref1_len, ref2, ref2_len, scores,
             off_edge, jump_score, rounds):
    B, nq = query.shape
    q_idx = torch.arange(nq + 1, dtype=torch.int32)[None, :]
    qn = query_len[:, None]

    def fresh():
        cm = (q_idx * off_edge).expand(B, nq + 1).contiguous()
        bad = torch.full((B, nq + 1), BAD, dtype=torch.int32)
        return cm, bad, bad, bad

    def off_edge_best(cm, best):
        cand = cm + (qn - q_idx) * off_edge
        cand = torch.where(q_idx < qn, cand, NEG)
        return torch.maximum(best, cand.max(dim=1).values)

    state = fresh()
    best = torch.full((B,), NEG, dtype=torch.int32)
    state, best = _walk(query, query_len, ref1, ref1_len, state, best,
                        scores, jump_score, True, rounds)
    best = off_edge_best(state[0], best)
    cm, cd, ci, _ = fresh()
    state, best = _walk(query, query_len, ref2, ref2_len,
                        (cm, cd, ci, state[3]), best, scores, jump_score,
                        False, rounds)
    return off_edge_best(state[0], best)


# ------------------------------------------------------------------ K3

def split_luts(snp_prob: float):
    """ln-likelihood of a match and of a mismatch by clamped qscore,
    float32 (71,), from the basecall error mixed with a SNP prior
    (Manta's qscore_snp)."""
    q = np.arange(MAX_QSCORE + 1, dtype=np.float64)
    qerr = np.power(10.0, -q / 10.0)
    p = qerr * (1.0 - snp_prob / 3.0) + (1.0 - qerr) * snp_prob
    with np.errstate(divide="ignore"):
        ln_match = np.log1p(-p)
        ln_mism = np.log(p) + math.log(1 / 3.0)
    return ln_match.astype(np.float32), ln_mism.astype(np.float32)


def split_scan(reads, quals, read_len, targets, bp_ranges,
               flank_score_size: int, snp_prob: float):
    """Every read against every target: (best float32 (n, t), pos int32
    (n, t)). ``reads``/``quals``: (n, L) uint8 rows (reads padded with
    0xFF); ``targets``: list of uint8 arrays; ``bp_ranges``: (beg, end)
    a target."""
    lnm_lut, lnx_lut = split_luts(snp_prob)
    n, L = reads.shape
    rl = read_len.astype(np.int64)
    qi = np.clip(quals.astype(np.int64), 2, MAX_QSCORE)
    lnm, lnx = lnm_lut[qi], lnx_lut[qi]
    n_bases = min(L, int(rl.max())) if n else 0
    best = np.empty((n, len(targets)), np.float32)
    pos = np.empty((n, len(targets)), np.int32)
    for k, (tg, (beg, end)) in enumerate(zip(targets, bp_ranges)):
        tgt = np.asarray(tg, np.uint8)
        T = len(tgt)
        start = np.maximum(beg - rl + 2, 0)
        stop = np.maximum(np.minimum(end, T - rl), 0)
        # positions past every row's last are -inf in the plain form:
        # leave them out
        width = max(int((stop - start).max()) + 1, 1) if n else 1
        kk = np.arange(width)[None, :]
        pos0 = start[:, None] + kk
        lnl = np.zeros((n, width), np.float32)
        lo, hi = beg - flank_score_size, end + flank_score_size
        for j in range(n_bases):
            tpos = pos0 + j
            win = tgt[np.clip(tpos, 0, T - 1)] if T else \
                np.full(tpos.shape, N_BASE, np.uint8)
            qb = reads[:, j:j + 1]
            q_is_n = qb == N_BASE
            is_n = q_is_n | (win == N_BASE)
            mism = (qb != win) | q_is_n
            term = np.where(is_n, LN_RANDOM,
                            np.where(mism, lnx[:, j:j + 1], lnm[:, j:j + 1]))
            gate = (tpos > lo) & (tpos <= hi) & (j < rl)[:, None]
            lnl = lnl + np.where(gate, term, np.float32(0.0))
        lnl = np.where(kk <= (stop - start)[:, None], lnl,
                       np.float32(-np.inf))
        at = np.argmax(lnl, axis=1)
        best[:, k] = lnl[np.arange(n), at]
        pos[:, k] = start + at
    return best, pos
