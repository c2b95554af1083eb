"""Batched jump-SWG alignment scoring on the GPU (PyTorch).

Counterpart of manta_tpu/align/device_jumpscore.py. The two-reference
jump DP (native mt_align_jump) is evaluated score-only for a whole batch
of (contig, ref1, ref2) triples; the winning contig per edge is then
tracebacked once on the host native aligner, so device routing cannot
change results (identical int32 recurrences; the max is tie-blind).

Two forms with one contract, on int32 tensors in the JAX layout
((B, n), row-major):

- ``batched_jump_score``, the plain PyTorch form: a Python loop over
  reference columns, vectorised over (B, nq+1), with the in-column
  insert chain as an exact max-plus prefix

      ci[q] = extend*(q+1) + cummax_{k<=q}(f[k] - extend*k)

  (``torch.cummax``). It is the CPU path and the reference the CUDA
  kernel is held against.
- ``cuda_jumpscore.jump_score_cuda``, the hand-written Hopper kernel.

``make_bucketed_scorer`` is the production backend: it pads job batches
to the reference's shape buckets and dispatches on the device it is
given, the kernel on CUDA and the plain form on the CPU, never one for
the other.
"""

from __future__ import annotations

import numpy as np
import torch

from .cuda_jumpscore import KERNEL_LAUNCHES, jump_score_cuda

BAD = -10000
NEG = -(1 << 28)

# plain-form calls on CUDA tensors (the main path makes none: on CUDA
# the bucketed scorer launches the kernel)
PLAIN_CALLS = {"cuda": 0}


def from_reference_inputs(q, ql, r1, r1l, r2, r2l, device):
    """The padded int32 numpy arrays the JAX functions take (query,
    lengths, both references) as contiguous int32 tensors on ``device``,
    so both packages score the same numbers."""
    return tuple(torch.from_numpy(np.ascontiguousarray(a, np.int32))
                 .to(device) for a in (q, ql, r1, r1l, r2, r2l))


def _maxplus_prefix(f, extend, k):
    """ci[q] = max_{k<=q}(f[k] + (q-k+1)*extend), exact int32."""
    g = torch.where(f <= BAD, NEG, f - extend * k)
    run = torch.cummax(g, dim=1).values
    return torch.clamp_min(run + extend * (k + 1), BAD)


def _walk(query, query_len, ref, ref_len, n_cols, state, best, scores,
          jump_score, is_ref1):
    """Walk the reference columns of one phase (reference
    _make_col_ref1 / _make_col_ref2); columns at or past a row's ref
    length leave that row's state frozen."""
    match, mismatch, open_, extend = scores
    pm, pd, pi, pj = state
    B, nq = query.shape
    dev = query.device
    k = torch.arange(nq + 1, dtype=torch.int32, device=dev)[None, :]
    qn = query_len.long()[:, None]
    zero_col = torch.zeros((B, 1), dtype=torch.int32, device=dev)
    bad_col = torch.full((B, 1), BAD, dtype=torch.int32, device=dev)
    bad2 = torch.full((B, 2), BAD, dtype=torch.int32, device=dev)
    match_t = torch.tensor(match, dtype=torch.int32, device=dev)
    mismatch_t = torch.tensor(mismatch, dtype=torch.int32, device=dev)
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
            # D starts at row 2; the insert chain too (the reference's
            # q == 0 cutoff)
            vd = torch.cat([bad2, vd[:, 1:]], dim=1)
            f = torch.cat([bad2, vm[:, 1:-1] + open_], dim=1)
            vi = _maxplus_prefix(f, extend, k)
            vi[:, :2] = BAD
            vj = torch.maximum(torch.maximum(vm + jump_score,
                                             vi + jump_score), pj)
            vj = torch.cat([bad_col, vj[:, 1:]], dim=1)
        else:
            vd = torch.cat([bad_col, vd], dim=1)
            # jump -> insert pays no open
            f = torch.cat([bad_col, torch.maximum(vm[:, :-1] + open_,
                                                  pj[:, :-1])], dim=1)
            vi = _maxplus_prefix(f, extend, k)
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


def batched_jump_score(query, query_len, ref1, ref1_len, ref2, ref2_len,
                       match, mismatch, open_, extend, off_edge,
                       jump_score, nq_pad: int, nr1_pad: int, nr2_pad: int):
    """Max jump-alignment score per batch row (int32 (B,), exact); the
    plain PyTorch form of manta_tpu's batched_jump_score."""
    if query.is_cuda:
        PLAIN_CALLS["cuda"] += 1
    B = query.shape[0]
    dev = query.device
    nq1 = nq_pad + 1
    q_idx = torch.arange(nq1, dtype=torch.int32, device=dev)[None, :]
    qn = query_len[:, None]
    scores = (int(match), int(mismatch), int(open_), int(extend))
    jump_score, off_edge = int(jump_score), int(off_edge)

    def fresh():
        cm = (q_idx * off_edge).expand(B, nq1).contiguous()
        bad = torch.full((B, nq1), BAD, dtype=torch.int32, device=dev)
        return cm, bad, bad, bad

    def off_edge_best(cm, best):
        cand = cm + (qn - q_idx) * off_edge
        cand = torch.where(q_idx < qn, cand, NEG)
        return torch.maximum(best, cand.max(dim=1).values)

    def n_cols(lens, n_pad):
        # columns no row reaches change nothing; skip them
        return min(n_pad, max(0, int(lens.max())) if len(lens) else 0)

    cm, cd, ci, cj = fresh()
    best = torch.full((B,), NEG, dtype=torch.int32, device=dev)
    (cm, cd, ci, cj), best = _walk(
        query, query_len, ref1, ref1_len, n_cols(ref1_len, nr1_pad),
        (cm, cd, ci, cj), best, scores, jump_score, True)
    best = off_edge_best(cm, best)
    cm, cd, ci, _ = fresh()
    (cm, cd, ci, cj), best = _walk(
        query, query_len, ref2, ref2_len, n_cols(ref2_len, nr2_pad),
        (cm, cd, ci, cj), best, scores, jump_score, False)
    return off_edge_best(cm, best)


def _score(q, ql, r1, r1l, r2, r2l, scores, jump_score):
    """Dispatch on the tensors' device: the CUDA kernel, or on the CPU
    the plain form. Nothing else."""
    args = (scores.match, scores.mismatch, scores.open, scores.extend,
            scores.off_edge, jump_score)
    if q.device.type == "cuda":
        return jump_score_cuda(q, ql, r1, r1l, r2, r2l, *args)
    if q.device.type == "cpu":
        return batched_jump_score(q, ql, r1, r1l, r2, r2l, *args,
                                  q.shape[1], r1.shape[1], r2.shape[1])
    raise ValueError(f"no jump-score path for device {q.device}")


def _pad_to(seqs, rows, n, fill):
    out = np.full((rows, n), fill, np.int32)
    lens = np.zeros(rows, np.int32)
    for i, s in enumerate(seqs):
        arr = np.frombuffer(bytes(s), np.uint8).astype(np.int32)
        out[i, :len(arr)] = arr
        lens[i] = len(arr)
    return out, lens


def jump_scores(queries, ref1s, ref2s, scores, jump_score, device):
    """Convenience host wrapper: list-of-bytes in, numpy scores out."""
    B = len(queries)
    nq = max(len(q) for q in queries)
    nr1 = max(len(r) for r in ref1s)
    nr2 = max(len(r) for r in ref2s)
    q, ql = _pad_to(queries, B, nq, 1)     # sentinel 1 never matches bases
    r1, r1l = _pad_to(ref1s, B, nr1, 2)
    r2, r2l = _pad_to(ref2s, B, nr2, 2)
    t = from_reference_inputs(q, ql, r1, r1l, r2, r2l, device)
    return _score(*t, scores, jump_score).cpu().numpy()


def _bucket(n: int, tiers=(128, 256, 512, 1024, 2048, 4096)) -> int:
    for t in tiers:
        if n <= t:
            return t
    return ((n + 4095) // 4096) * 4096


def pad_jobs(jobs, rows: int):
    """(query, ref1, ref2) byte triples padded to the scorer's shape
    buckets: int32 numpy (query, query_len, ref1, ref1_len, ref2,
    ref2_len) with ``rows`` rows. Rows past the jobs are pad rows of
    length 1; pad codes 1 (query) and 2 (refs) never equal a base."""
    pad = rows - len(jobs)
    nq = _bucket(max(len(j[0]) for j in jobs))
    nr1 = _bucket(max(len(j[1]) for j in jobs))
    nr2 = _bucket(max(len(j[2]) for j in jobs))
    q, ql = _pad_to([j[0] for j in jobs] + [b"\x01"] * pad, rows, nq, 1)
    r1, r1l = _pad_to([j[1] for j in jobs] + [b"\x02"] * pad, rows, nr1, 2)
    r2, r2l = _pad_to([j[2] for j in jobs] + [b"\x02"] * pad, rows, nr2, 2)
    return q, ql, r1, r1l, r2, r2l


# dispatch accounting: every bucketed-scorer call records its wall time;
# reported once per process at exit as a "[manta-tpu-torch]
# device-dispatch ..." stderr line
DISPATCH_STATS = {"calls": 0, "jobs": 0, "rows": 0, "wall": 0.0,
                  "first_wall": 0.0}
_REPORT_REGISTERED = False


def _register_dispatch_report():
    global _REPORT_REGISTERED
    if _REPORT_REGISTERED:
        return
    _REPORT_REGISTERED = True
    import atexit
    import os as _os
    import sys as _sys

    def report():
        s = DISPATCH_STATS
        if s["calls"]:
            print(f"[manta-tpu-torch] device-dispatch pid={_os.getpid()}: "
                  f"{s['calls']} calls, {s['jobs']} jobs, "
                  f"{s['rows']} padded rows, {s['wall']:.2f}s total, "
                  f"first {s['first_wall']:.2f}s (incl. kernel build), "
                  f"{KERNEL_LAUNCHES['jump_score']} kernel launches",
                  file=_sys.stderr, flush=True)
            s["calls"] = 0        # once per process
    atexit.register(report)
    # fork-pool workers exit through multiprocessing's _exit_function,
    # which runs its own finalizers but NOT atexit handlers
    from multiprocessing.util import Finalize
    Finalize(None, report, exitpriority=0)


def make_bucketed_scorer(scores, jump_score: int, device):
    """Production scorer: pads job batches to shape buckets (the
    reference's tiers and pad sentinels) and returns the exact int32 max
    jump-alignment scores as numpy, bit-identical to the host traceback
    aligner. On a CUDA device every batch goes through the hand-written
    kernel; on the CPU through the plain form."""
    device = torch.device(device)
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"no jump-score path for device {device}")
    _register_dispatch_report()

    def scorer(jobs):
        import time as _time
        B = len(jobs)
        if B == 0:
            return np.zeros(0, np.int32)
        _t0 = _time.perf_counter()
        Bp = _bucket(B, tiers=(8, 16, 32, 64, 128, 256))
        t = from_reference_inputs(*pad_jobs(jobs, Bp), device)
        res = _score(*t, scores, jump_score).cpu().numpy()[:B]
        dt = _time.perf_counter() - _t0
        s = DISPATCH_STATS
        if s["calls"] == 0:
            s["first_wall"] = dt
        s["calls"] += 1
        s["jobs"] += B
        s["rows"] += Bp
        s["wall"] += dt
        return res

    return scorer
