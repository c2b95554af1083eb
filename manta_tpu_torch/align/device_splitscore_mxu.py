"""Matmul formulation of batched split-read scoring (PyTorch).

Counterpart of manta_tpu/align/device_splitscore_mxu.py. Every candidate
read at a junction scores against the same target and the same
microhomology range, which factors the scan into per-symbol
correlations:

  term(r, j, s) = gate(s+j) * [ lnx(r,j)
                                + (read_r[j] == target[s+j]) * delta(r,j)
                                + (target[s+j] == N) * nadj(r,j) ]

  with  delta = lnm - lnx,  nadj = LN_RANDOM - lnx  (both zeroed where
  the read base is N or past read_len; lnx := LN_RANDOM on read-N).

  score(r, s) = prefix-sum base part + K(r, :) @ Tmat(:, s)

  K    (R, 5L): 4 match channels (delta * onehot_c(read)) + 1 N channel
  Tmat (5L, S): gated target indicator Toeplitz

As in the JAX package, K is split into bf16 hi/lo halves and Tmat holds
0/1, so every product is exact; the sums are float32 (~1e-6 relative to
the exact scan, not bit-identical). The JAX package asks XLA for float32
accumulation of bf16 operands; here the bf16-valued halves are widened
to float32 operands (exact) and multiplied with ``torch.bmm`` in full
float32: TF32 is switched off around the two products on CUDA, because
TF32 would round the operands to 10 mantissa bits and PyTorch's bf16
``bmm`` accumulates but returns bf16, and has no float32-output form on
the CPU. The same code runs on both devices.

The JAX package leaves these products to XLA outside any Pallas kernel;
the port leaves them to ``torch.bmm``. Requires bases in {A,C,G,T,N};
callers route other IUPAC codes to the exact scan.
"""

from __future__ import annotations

import math

import torch

from .device_splitscore import LN_RANDOM, MAX_QSCORE, N_BASE

_ACGT = (65, 67, 71, 84)  # 'A' 'C' 'G' 'T'


def _float32_bmm(a, b):
    """a @ b in float32 with full-precision float32 products on CUDA."""
    if not a.is_cuda:
        return torch.bmm(a, b)
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return torch.bmm(a, b)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def junction_split_score(reads, quals, targets, s0, bp_beg, bp_end,
                         read_len, target_len, flank_score_size,
                         ln_match_lut, ln_mism_lut, n_scan: int):
    """Score all scan positions for G junctions x R reads each.

    reads/quals: (G, R, L) uint8 (0xFF padded reads)
    targets:     (G, T) uint8, bp_beg/bp_end/target_len/s0: (G,) int32
    read_len:    (G, R) int32 (0 rows = padding reads)
    s0: absolute target offset of scan-grid position 0; the grid
        covers absolute positions [s0, s0 + n_scan).

    Returns (best_lnlhood, best_pos): (G, R) float32 / int32, with
    best_pos absolute (same convention as batched_split_score).
    """
    G, R, L = reads.shape
    T = targets.shape[1]
    S = n_scan
    dev = reads.device

    score_beg = bp_beg - flank_score_size                        # (G,)
    score_end = bp_end + flank_score_size

    j = torch.arange(L, dtype=torch.int32, device=dev)
    s = torch.arange(S, dtype=torch.int32, device=dev)
    ln_random = torch.tensor(LN_RANDOM, device=dev)
    zero = torch.zeros((), dtype=torch.float32, device=dev)

    # ---- per-read kernel vectors (G, R, L)
    qual_i = torch.clamp(quals.long(), 2, MAX_QSCORE)
    lnm = ln_match_lut[qual_i]
    lnx = ln_mism_lut[qual_i]
    read_n = reads == N_BASE
    pad = j[None, None, :] >= read_len[:, :, None]
    lnx_eff = torch.where(pad, zero, torch.where(read_n, ln_random, lnx))
    live = ~(read_n | pad)
    delta = torch.where(live, lnm - lnx, zero)
    nadj = torch.where(live, ln_random - lnx, zero)

    # K: (G, R, 5, L) -> (G, R, 5L); channel c holds delta on read==c
    ch = [delta * (reads == c) for c in _ACGT] + [nadj]
    K = torch.stack(ch, dim=2).reshape(G, R, 5 * L)
    K_hi = K.to(torch.bfloat16).float()
    K_lo = (K - K_hi).to(torch.bfloat16).float()

    # ---- gated target Toeplitz (G, 5, L, S) -> (G, 5L, S), 0/1 values
    p = s0[:, None, None] + j[:, None] + s[None, :]              # (G, L, S)
    p_c = torch.clamp(p, 0, T - 1).long()
    tg = torch.gather(targets, 1, p_c.reshape(G, L * S)).reshape(G, L, S)
    gate = (p > score_beg[:, None, None]) & (p <= score_end[:, None, None])
    tch = [(tg == c) & gate for c in _ACGT] + [(tg == N_BASE) & gate]
    Tmat = torch.stack(tch, dim=1).reshape(G, 5 * L, S).float()

    M = _float32_bmm(K_hi, Tmat) + _float32_bmm(K_lo, Tmat)

    # ---- base part: sum_j gate(s+j) * lnx_eff(r, j) via prefix sums
    P = torch.cat([torch.zeros((G, R, 1), dtype=torch.float32, device=dev),
                   torch.cumsum(lnx_eff, dim=-1)], dim=-1)       # (G, R, L+1)
    s_abs = s0[:, None] + s[None, :]                             # (G, S)
    jlo = torch.clamp_min(score_beg[:, None] - s_abs + 1, 0)     # (G, S)
    jhi = torch.clamp_max(score_end[:, None] - s_abs, L - 1)     # (G, S)
    jhi = torch.minimum(jhi[:, None, :], read_len[:, :, None] - 1)  # (G,R,S)
    jlo = torch.clamp_max(jlo, L)[:, None, :].expand(G, R, S)
    ok = jhi >= jlo
    base = torch.where(
        ok,
        torch.gather(P, 2, torch.where(ok, jhi + 1, 0).long())
        - torch.gather(P, 2, torch.where(ok, jlo, 0).long()),
        zero)

    lnl = base + M                                               # (G, R, S)

    scan_start = torch.clamp_min(bp_beg[:, None] - read_len + 2, 0)  # (G,R)
    scan_end = torch.clamp_min(
        torch.minimum(bp_end[:, None], target_len[:, None] - read_len), 0)
    s_valid = (s_abs[:, None, :] >= scan_start[:, :, None]) & \
        (s_abs[:, None, :] <= scan_end[:, :, None])
    lnl = torch.where(s_valid, lnl, -math.inf)
    best_i = torch.argmax(lnl, dim=-1)
    best = torch.gather(lnl, 2, best_i[:, :, None])[:, :, 0]
    any_valid = torch.any(s_valid, dim=-1)
    pos = torch.where(any_valid, s0[:, None] + best_i.to(torch.int32),
                      scan_start)
    return best, pos
