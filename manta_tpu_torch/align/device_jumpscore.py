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
  It cuts the query lanes into strips that hand two boundary values a
  column upwards; ``batched_jump_score_strips`` is the plain model of
  that cut, for the tests (``batched_jump_score_flagged_strips`` that of
  the bounded kernel's cut into threads and strips).

The bounded-insert-chain variant (manta_tpu's
``pallas_jump_score_flagged`` / ``pallas_jump_score_bounded``) has the
same two forms: ``batched_jump_score_flagged`` /
``batched_jump_score_bounded`` here, and
``cuda_jumpscore.jump_score_flagged_cuda`` /
``jump_score_bounded_cuda``. It bounds the insert chain to the last
2^prefix_rounds lanes and flags the rows where that may have changed
the score; the bounded form reruns those rows through the exact form.
Only the timing entry point (``tools.device_timing``) and the tests run
it: production scoring stays on the exact kernel, as in the reference.

``make_bucketed_scorer`` is the production backend: it pads job batches
to the reference's shape buckets and dispatches on the device it is
given, the kernel on CUDA and the plain form on the CPU, never one for
the other.
"""

from __future__ import annotations

import numpy as np
import torch

from ..parallel import worker_trace
from .cuda_jumpscore import (
    KERNEL_LAUNCHES, KERNEL_WORK, jump_score_cuda, raise_on_kernel_error,
    rerun_flagged,
)

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


def _maxplus_prefix(f, extend, k, prefix_rounds=0):
    """ci[q] = max_{k<=q}(f[k] + (q-k+1)*extend), exact int32.

    With ``prefix_rounds`` = K > 0 the chain is bounded to the last 2^K
    lanes (K log-step shift+max rounds), and a second value comes back:
    the lanes where one more round, the chain bounded to 2^(K+1) lanes,
    is larger (a bool mask). Where 2^K covers every lane the rounds past
    the width change nothing: the exact chain, and an all-False mask."""
    g = torch.where(f <= BAD, NEG, f - extend * k)
    if prefix_rounds <= 0:
        run = torch.cummax(g, dim=1).values
        return torch.clamp_min(run + extend * (k + 1), BAD), None

    def round_(g, shift):
        if shift >= g.shape[1]:
            return g
        return torch.cat([g[:, :shift],
                          torch.maximum(g[:, shift:], g[:, :-shift])], dim=1)

    for i in range(prefix_rounds):
        g = round_(g, 1 << i)
    out = torch.clamp_min(g + extend * (k + 1), BAD)
    out2 = torch.clamp_min(round_(g, 1 << prefix_rounds)
                           + extend * (k + 1), BAD)
    return out, out2 > out


def _walk(query, query_len, ref, ref_len, n_cols, state, best, scores,
          jump_score, is_ref1, prefix_rounds=0, flag=None):
    """Walk the reference columns of one phase (reference
    _make_col_ref1 / _make_col_ref2); columns at or past a row's ref
    length leave that row's state frozen. With ``prefix_rounds`` > 0 the
    insert chain is the bounded one and ``flag`` (bool (B,)) gathers the
    rows whose detection round raised a lane at or below the query end
    in a walked column."""
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
            vi, raised = _maxplus_prefix(f, extend, k, prefix_rounds)
            vi[:, :2] = BAD
            vj = torch.maximum(torch.maximum(vm + jump_score,
                                             vi + jump_score), pj)
            vj = torch.cat([bad_col, vj[:, 1:]], dim=1)
        else:
            vd = torch.cat([bad_col, vd], dim=1)
            # jump -> insert pays no open
            f = torch.cat([bad_col, torch.maximum(vm[:, :-1] + open_,
                                                  pj[:, :-1])], dim=1)
            vi, raised = _maxplus_prefix(f, extend, k, prefix_rounds)
            vi[:, 0] = BAD
            vj = pj
        act = (c < ref_len)[:, None]
        pm = torch.where(act, vm, pm)
        pd = torch.where(act, vd, pd)
        pi = torch.where(act, vi, pi)
        pj = torch.where(act, vj, pj)
        end_val = torch.gather(pm, 1, qn)[:, 0]
        best = torch.where(act[:, 0], torch.maximum(best, end_val), best)
        if raised is not None:
            flag = flag | (act[:, 0] & (raised & (k <= qn)).any(dim=1))
    return (pm, pd, pi, pj), best, flag


def _jump_dp(query, query_len, ref1, ref1_len, ref2, ref2_len,
             match, mismatch, open_, extend, off_edge, jump_score,
             nq_pad, nr1_pad, nr2_pad, prefix_rounds, strip=0):
    """Both phases of the jump DP; returns (best int32 (B,), flag bool
    (B,) or None for the exact chain). ``strip`` > 0 walks the exact
    chain in strips of that many lanes (``_walk_strips``); with
    ``prefix_rounds`` > 0 it is (lanes per thread, threads per strip) of
    the bounded chain's cut (``_walk_bounded_strips``)."""
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
    flag = (torch.zeros(B, dtype=torch.bool, device=dev)
            if prefix_rounds > 0 else None)

    def walk(ref, ref_len, n, state, best, is_ref1, flag):
        if strip and prefix_rounds > 0:
            return _walk_bounded_strips(
                query, query_len, ref, ref_len, n, state, best, scores,
                jump_score, is_ref1, prefix_rounds, flag, *strip)
        if strip:
            return (*_walk_strips(query, query_len, ref, ref_len, n, state,
                                  best, scores, jump_score, is_ref1, strip),
                    flag)
        return _walk(query, query_len, ref, ref_len, n, state, best, scores,
                     jump_score, is_ref1, prefix_rounds, flag)

    (cm, cd, ci, cj), best, flag = walk(
        ref1, ref1_len, n_cols(ref1_len, nr1_pad), (cm, cd, ci, cj), best,
        True, flag)
    best = off_edge_best(cm, best)
    cm, cd, ci, _ = fresh()
    (cm, cd, ci, cj), best, flag = walk(
        ref2, ref2_len, n_cols(ref2_len, nr2_pad), (cm, cd, ci, cj), best,
        False, flag)
    return off_edge_best(cm, best), flag


def batched_jump_score(query, query_len, ref1, ref1_len, ref2, ref2_len,
                       match, mismatch, open_, extend, off_edge,
                       jump_score, nq_pad: int, nr1_pad: int, nr2_pad: int):
    """Max jump-alignment score per batch row (int32 (B,), exact); the
    plain PyTorch form of manta_tpu's batched_jump_score."""
    return _jump_dp(query, query_len, ref1, ref1_len, ref2, ref2_len,
                    match, mismatch, open_, extend, off_edge, jump_score,
                    nq_pad, nr1_pad, nr2_pad, 0)[0]


def _walk_strips(query, query_len, ref, ref_len, n_cols, state, best,
                 scores, jump_score, is_ref1, strip):
    """One phase of the jump DP in the strip form of the CUDA kernel
    (csrc/jump_systolic.cuh): the query lanes are cut into strips of
    ``strip`` lanes, and a strip takes from the strip below only two
    values per column: the diagonal maximum of that strip's last lane at
    the previous column, and the running maximum of the insert-chain
    sources up to and including that strip, taken before the
    ``extend*(q+1)`` offset and the BAD floor. A row's strips that lie
    wholly above its query length are not walked."""
    match, mismatch, open_, extend = scores
    pm, pd, pi, pj = (x.clone() for x in state)
    B, nq = query.shape
    dev = query.device
    i32 = dict(dtype=torch.int32, device=dev)
    qn = query_len[:, None]
    # lane q holds query[q-1]; 0 at lane 0 never equals a code
    qsh = torch.cat([torch.zeros((B, 1), **i32), query], dim=1)
    match_t = torch.tensor(match, **i32)
    mismatch_t = torch.tensor(mismatch, **i32)
    bounds = [(lo, min(lo + strip, nq + 1))
              for lo in range(0, nq + 1, strip)]
    for c in range(n_cols):
        rc = ref[:, c:c + 1]
        col_act = (c < ref_len)[:, None]
        dprev = torch.full((B,), BAD, **i32)
        excl = torch.full((B,), NEG, **i32)
        for lo, hi in bounds:
            q = torch.arange(lo, hi, **i32)[None, :]
            om, od, oi, oj = (x[:, lo:hi] for x in (pm, pd, pi, pj))
            dmax = torch.maximum(torch.maximum(om, od), oi)
            if not is_ref1:
                dmax = torch.maximum(dmax, oj)
            d = torch.cat([dprev[:, None], dmax[:, :-1]], dim=1)
            sub = torch.where(qsh[:, lo:hi] == rc, match_t, mismatch_t)
            vm = torch.where(q == 0, 0, d + sub)
            vd = torch.maximum(torch.maximum(om + open_, od), oi) + extend
            vd = torch.where(q <= (1 if is_ref1 else 0), BAD, vd)
            # the source lane q opens for lane q + 1
            if is_ref1:
                f = torch.where(q == 0, BAD, vm + open_)
            else:
                f = torch.maximum(vm + open_, oj)
            g = torch.where(f <= BAD, NEG, f - extend * (q + 1))
            run = torch.cummax(
                torch.cat([excl[:, None], g[:, :-1]], dim=1), dim=1).values
            vi = torch.clamp_min(run + extend * (q + 1), BAD)
            if is_ref1:
                vj = torch.where(
                    q == 0, BAD,
                    torch.maximum(torch.maximum(vm + jump_score,
                                                vi + jump_score), oj))
            else:
                vj = oj
            act = col_act & (lo <= qn)
            dprev = dmax[:, -1]
            excl = torch.maximum(run[:, -1], g[:, -1])
            pm[:, lo:hi] = torch.where(act, vm, om)
            pd[:, lo:hi] = torch.where(act, vd, od)
            pi[:, lo:hi] = torch.where(act, vi, oi)
            pj[:, lo:hi] = torch.where(act, vj, oj)
        end_val = torch.gather(pm, 1, qn.long())[:, 0]
        best = torch.where(col_act[:, 0], torch.maximum(best, end_val), best)
    return (pm, pd, pi, pj), best


def batched_jump_score_strips(query, query_len, ref1, ref1_len, ref2,
                              ref2_len, match, mismatch, open_, extend,
                              off_edge, jump_score, nq_pad: int,
                              nr1_pad: int, nr2_pad: int, strip: int):
    """``batched_jump_score`` in the strip decomposition of the CUDA
    kernel, ``strip`` query lanes to a strip: int32 (B,), equal to
    ``batched_jump_score`` for every strip width >= 1. The plain model
    of the kernel's boundary hand-over; the tests run it, nothing
    else."""
    if strip < 1:
        raise ValueError(f"strip must be >= 1, got {strip}")
    return _jump_dp(query, query_len, ref1, ref1_len, ref2, ref2_len,
                    match, mismatch, open_, extend, off_edge, jump_score,
                    nq_pad, nr1_pad, nr2_pad, 0, strip=int(strip))[0]


def _window_max(g, base, w: int, lanes: int):
    """The kernel's sliding maximum (csrc/jump_systolic.cuh window_max)
    for every thread of a strip at once: out[:, t, j] = max(g[:, k] for
    base[t] + j - w < k <= base[t] + j), by the same two passes with the
    chunks of w lanes anchored at each thread's own lanes. g (B, n),
    base (T,) long; returns (B, T, lanes)."""
    B = g.shape[0]
    neg = torch.full((B, base.numel()), NEG, dtype=torch.int32,
                     device=g.device)
    out = []
    u = neg
    for j in range(lanes):
        u = neg if j & (w - 1) == 0 else torch.maximum(u, g[:, base + j])
        out.append(u)
    sfx = neg
    for j in range(lanes - 1, -1, -1):
        q = base + j
        if j == lanes - 1 or (j + 1) & (w - 1) == 0:
            pivot = j & ~(w - 1)
            sfx = neg
            for k in range(j - w + 2, pivot + 1):
                sfx = torch.maximum(sfx, g[:, base + k])
        sfx = torch.maximum(sfx, g[:, q - w + 1])
        out[j] = torch.maximum(out[j], sfx)
    return torch.stack(out, dim=2)


def _tail_windows(g, own, w: int, lanes: int):
    """The kernel's form of both windows where they reach below a
    thread's first lane at every lane (lanes <= w): below the thread
    prefix maxima of the tail T[n] = g[:, own[t] - n], the first window
    of lane j ending at T[w - j] and the second at T[2w - j]; inside the
    thread one running maximum of the thread's own sources. g (B, n),
    own (T,) long; returns two (B, T, lanes)."""
    n = torch.arange(1, 2 * w + 1, device=g.device)
    tail = torch.cummax(g[:, own[:, None] - n[None, :]], dim=2).values
    mine = g[:, own[:, None] + torch.arange(lanes, device=g.device)]
    neg = torch.full_like(mine[:, :, :1], NEG)
    run = torch.cummax(torch.cat([neg, mine[:, :, :-1]], dim=2),
                       dim=2).values
    j = torch.arange(lanes, device=g.device)
    return (torch.maximum(tail[:, :, w - j - 1], run),
            torch.maximum(tail[:, :, 2 * w - j - 1], run))


def _walk_bounded_strips(query, query_len, ref, ref_len, n_cols, state, best,
                         scores, jump_score, is_ref1, prefix_rounds, flag,
                         lanes, threads):
    """One phase of the bounded-chain jump DP in the form of the CUDA
    kernel (csrc/jump_systolic.cuh, kBounded): strips of ``threads``
    threads of ``lanes`` query lanes. A column of a strip is a row of
    chain sources: the 2w sources below the strip, which are the top 2w
    entries of the row of the strip below (NEG below lane 0), then the
    strip's own. A source at or under BAD stays f - extend*k and is not
    set to NEG. Every thread takes its lanes' two windows from the row,
    by ``_tail_windows`` where the window is at least as long as the
    thread's lanes and by ``_window_max`` where it is shorter; between
    strips only the row's top 2w entries and
    the diagonal value of the last lane travel. A row's strips that lie
    wholly above its query length are not walked, and the flag looks at
    lanes at or below the query length only."""
    match, mismatch, open_, extend = scores
    pm, pd, pi, pj = (x.clone() for x in state)
    B, nq = query.shape
    dev = query.device
    i32 = dict(dtype=torch.int32, device=dev)
    w = 1 << prefix_rounds
    strip = lanes * threads
    qn = query_len[:, None]
    qsh = torch.cat([torch.zeros((B, 1), **i32), query], dim=1)
    match_t = torch.tensor(match, **i32)
    mismatch_t = torch.tensor(mismatch, **i32)
    bounds = [(lo, min(lo + strip, nq + 1))
              for lo in range(0, nq + 1, strip)]
    base = 2 * w + lanes * torch.arange(threads, device=dev) - 1
    for c in range(n_cols):
        rc = ref[:, c:c + 1]
        col_act = (c < ref_len)[:, None]
        dprev = torch.full((B,), BAD, **i32)
        tail = torch.full((B, 2 * w), NEG, **i32)
        for lo, hi in bounds:
            n = hi - lo
            q = torch.arange(lo, hi, **i32)[None, :]
            om, od, oi, oj = (x[:, lo:hi] for x in (pm, pd, pi, pj))
            dmax = torch.maximum(torch.maximum(om, od), oi)
            if not is_ref1:
                dmax = torch.maximum(dmax, oj)
            d = torch.cat([dprev[:, None], dmax[:, :-1]], dim=1)
            sub = torch.where(qsh[:, lo:hi] == rc, match_t, mismatch_t)
            vm = torch.where(q == 0, 0, d + sub)
            vd = torch.maximum(torch.maximum(om + open_, od), oi) + extend
            vd = torch.where(q <= (1 if is_ref1 else 0), BAD, vd)
            # the source lane q opens for lane q + 1; only lane 0 of the
            # ref1 phase is NEG
            if is_ref1:
                g = torch.where(q == 0, NEG, vm + open_ - extend * (q + 1))
            else:
                g = torch.maximum(vm + open_, oj) - extend * (q + 1)
            row = torch.cat([tail, g, torch.full((B, strip - n), NEG,
                                                 **i32)], dim=1)
            if lanes <= w:
                win, low = _tail_windows(row, base + 1, w, lanes)
            else:
                win = _window_max(row, base, w, lanes)
                low = _window_max(row, base - w, w, lanes)
            win = win.reshape(B, strip)[:, :n]
            low = low.reshape(B, strip)[:, :n]
            e1 = extend * (q + 1)
            vi = torch.clamp_min(win + e1, BAD)
            raised = (low > win) & (low + e1 > BAD) & (q <= qn)
            if is_ref1:
                vj = torch.where(
                    q == 0, BAD,
                    torch.maximum(torch.maximum(vm + jump_score,
                                                vi + jump_score), oj))
            else:
                vj = oj
            act = col_act & (lo <= qn)
            flag = flag | (act[:, 0] & raised.any(dim=1))
            dprev = dmax[:, -1]
            tail = row[:, strip:strip + 2 * w]
            pm[:, lo:hi] = torch.where(act, vm, om)
            pd[:, lo:hi] = torch.where(act, vd, od)
            pi[:, lo:hi] = torch.where(act, vi, oi)
            pj[:, lo:hi] = torch.where(act, vj, oj)
        end_val = torch.gather(pm, 1, qn.long())[:, 0]
        best = torch.where(col_act[:, 0], torch.maximum(best, end_val), best)
    return (pm, pd, pi, pj), best, flag


def batched_jump_score_flagged_strips(query, query_len, ref1, ref1_len, ref2,
                                      ref2_len, match, mismatch, open_,
                                      extend, off_edge, jump_score,
                                      nq_pad: int, nr1_pad: int, nr2_pad: int,
                                      prefix_rounds: int, lanes: int,
                                      threads: int):
    """``batched_jump_score_flagged`` in the decomposition of the CUDA
    kernel: strips of ``threads`` threads of ``lanes`` query lanes
    (``_walk_bounded_strips``). (best, flag) int32 (B,), equal to
    ``batched_jump_score_flagged`` for every such cut. The plain model of
    the bounded kernel's exchange; the tests run it, nothing else."""
    if prefix_rounds < 1:
        raise ValueError(f"prefix_rounds must be >= 1, got {prefix_rounds}")
    if lanes < 1 or threads < 1:
        raise ValueError(f"lanes and threads must be >= 1, got {lanes}, "
                         f"{threads}")
    best, flag = _jump_dp(query, query_len, ref1, ref1_len, ref2, ref2_len,
                          match, mismatch, open_, extend, off_edge,
                          jump_score, nq_pad, nr1_pad, nr2_pad,
                          int(prefix_rounds),
                          strip=(int(lanes), int(threads)))
    return best, flag.to(torch.int32)


def batched_jump_score_flagged(query, query_len, ref1, ref1_len, ref2,
                               ref2_len, match, mismatch, open_, extend,
                               off_edge, jump_score, nq_pad: int,
                               nr1_pad: int, nr2_pad: int,
                               prefix_rounds: int):
    """The jump DP with the insert chain bounded to 2^prefix_rounds
    lanes: (best int32 (B,), flag int32 (B,)), flag != 0 on the rows
    whose score may differ from the exact chain's. The plain PyTorch
    form of manta_tpu's pallas_jump_score_flagged, equal to it in both
    values on every row."""
    if prefix_rounds < 1:
        raise ValueError(f"prefix_rounds must be >= 1, got {prefix_rounds}")
    best, flag = _jump_dp(query, query_len, ref1, ref1_len, ref2, ref2_len,
                          match, mismatch, open_, extend, off_edge,
                          jump_score, nq_pad, nr1_pad, nr2_pad,
                          int(prefix_rounds))
    return best, flag.to(torch.int32)


def batched_jump_score_bounded(query, query_len, ref1, ref1_len, ref2,
                               ref2_len, match, mismatch, open_, extend,
                               off_edge, jump_score, nq_pad: int,
                               nr1_pad: int, nr2_pad: int,
                               prefix_rounds: int):
    """Exact scores through the bounded chain plus a rerun of the
    flagged rows through ``batched_jump_score``: (scores int32 (B,),
    n_flagged). The plain PyTorch form of manta_tpu's
    pallas_jump_score_bounded."""
    tail = (match, mismatch, open_, extend, off_edge, jump_score,
            nq_pad, nr1_pad, nr2_pad)
    tensors = (query, query_len, ref1, ref1_len, ref2, ref2_len)
    best, flag = batched_jump_score_flagged(*tensors, *tail, prefix_rounds)
    return rerun_flagged(
        best, flag, lambda *t: batched_jump_score(*t, *tail), tensors)


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
    res = _score(*t, scores, jump_score).cpu().numpy()
    raise_on_kernel_error()
    return res


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


def count_work(jobs, shape, kernel: str = "jump_score") -> None:
    """Add one launch's work to ``KERNEL_WORK[kernel]``: the jobs'
    useful cells, sum of len(query) x (len(ref1) + len(ref2)), and the
    padded launch ``shape`` (B, nq, nr1, nr2): its cells, and its bytes
    (int32 query and references, three lengths in, a score out)."""
    B, nq, nr1, nr2 = shape
    work = KERNEL_WORK[kernel]
    work["useful"] += sum(len(q) * (len(r1) + len(r2)) for q, r1, r2 in jobs)
    work["padded"] += B * nq * (nr1 + nr2)
    work["bytes"] += 4 * B * (nq + nr1 + nr2 + 4)


# dispatch accounting: every bucketed-scorer call records its wall time;
# reported once per process at exit as a "[manta-tpu-torch]
# device-dispatch ..." stderr line
DISPATCH_STATS = {"calls": 0, "jobs": 0, "rows": 0, "wall": 0.0,
                  "first_wall": 0.0}
# calls by padded bucket shape (B, nq, nr1, nr2)
DISPATCH_BUCKETS: dict[tuple[int, int, int, int], int] = {}
_REPORT_REGISTERED = False


def _register_dispatch_report():
    global _REPORT_REGISTERED
    if _REPORT_REGISTERED:
        return
    _REPORT_REGISTERED = True
    import os as _os
    import sys as _sys

    from ..parallel.forkpool import at_process_exit

    def report():
        s = DISPATCH_STATS
        work = KERNEL_WORK["jump_score"]
        if s["calls"]:
            print(f"[manta-tpu-torch] device-dispatch pid={_os.getpid()}: "
                  f"{s['calls']} calls, {s['jobs']} jobs, "
                  f"{s['rows']} padded rows, {s['wall']:.4f}s total, "
                  f"first {s['first_wall']:.4f}s (incl. kernel build), "
                  f"{KERNEL_LAUNCHES['jump_score']} kernel launches; "
                  f"calls by bucket (B, nq, nr1, nr2): "
                  f"{dict(sorted(DISPATCH_BUCKETS.items()))}; work: "
                  f"{work['useful']} useful cells, {work['padded']} "
                  f"padded cells, {work['bytes']} bytes",
                  file=_sys.stderr, flush=True)
            s["calls"] = 0        # once per process
    at_process_exit(report)


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
        with worker_trace.span("k1.dispatch"):
            worker_trace.device_call(device)
            _t0 = _time.perf_counter()
            Bp = _bucket(B, tiers=(8, 16, 32, 64, 128, 256))
            t = from_reference_inputs(*pad_jobs(jobs, Bp), device)
            res = _score(*t, scores, jump_score).cpu().numpy()[:B]
            raise_on_kernel_error()
            dt = _time.perf_counter() - _t0
        s = DISPATCH_STATS
        if s["calls"] == 0:
            s["first_wall"] = dt
        s["calls"] += 1
        s["jobs"] += B
        s["rows"] += Bp
        s["wall"] += dt
        shape = (Bp, *(int(t[i].shape[1]) for i in (0, 2, 4)))
        DISPATCH_BUCKETS[shape] = DISPATCH_BUCKETS.get(shape, 0) + 1
        count_work(jobs, shape)
        return res

    return scorer
