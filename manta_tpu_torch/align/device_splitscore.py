"""Batched split-read likelihood scan (PyTorch): the plain form.

Counterpart of manta_tpu/align/device_splitscore.py. The phase-2
scoring hot loop slides each read across a breakpoint junction target
and keeps the best basecall ln-likelihood (host reference:
scoring/evidence.py split_read_aligner; reference semantics:
GenerateSVCandidates/SplitReadAlignment.cpp).

Layout, as in the JAX package, padded to fixed shapes:
  reads:   (B, L)  uint8 base codes, 0xFF padding
  quals:   (B, L)  uint8
  targets: (B, T)  uint8 target (contig or reference) sequence
  bp_beg/bp_end: (B,) int32 microhomology-aware breakend offset range
  read_len/target_len: (B,) int32

Two forms with one contract:

- ``batched_split_score``, the plain PyTorch form: a Python loop over
  the read's bases, vectorised over (B, n_scan) planes, adding each
  base's term into one float32 accumulator in base order, the order of
  the JAX ``lax.scan`` and of the native host scan, so all three are
  bit-identical. Memory is O(B * n_scan), where the JAX form gathers a
  (B, n_scan, L) window. It is the CPU path and the reference the CUDA
  kernel is held against.
- ``cuda_splitscore.split_score_cuda``, the hand-written Hopper kernel
  (replaces the Pallas kernel manta_tpu/align/pallas_splitscore.py).

``split_score`` dispatches on the tensors' device: the kernel on CUDA,
the plain form on the CPU, never one for the other.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .cuda_splitscore import split_score_cuda

MAX_QSCORE = 70
PAD_BASE = 0xFF
N_BASE = ord("N")
LN_RANDOM = np.float32(-math.log(4.0))

# plain-form calls on CUDA tensors (the main path makes none: on CUDA
# split scans go through the kernel)
PLAIN_CALLS = {"cuda": 0}


def make_luts(snp_prob: float):
    """ln-likelihood LUTs indexed by clamped qscore, numpy float32 (71,)
    (reference: blt_util/qscore_snp.cpp)."""
    comp_snp3 = 1.0 - snp_prob / 3.0
    q = np.arange(MAX_QSCORE + 1, dtype=np.float64)
    qerr = np.power(10.0, -q / 10.0)
    p = qerr * comp_snp3 + (1.0 - qerr) * snp_prob
    with np.errstate(divide="ignore"):
        # q<2 entries are -inf but unused: quals are clamped to [2,70]
        ln_match = np.log1p(-p) if snp_prob > 0 else np.log1p(-qerr)
        ln_mism = np.log(p) + math.log(1 / 3.0)
    return ln_match.astype(np.float32), ln_mism.astype(np.float32)


def batched_split_score(reads, quals, targets, bp_beg, bp_end, read_len,
                        target_len, flank_score_size, ln_match_lut,
                        ln_mism_lut, n_scan: int):
    """Score all scan positions for a batch of read/target pairs; the
    plain PyTorch form of manta_tpu's batched_split_score.

    Returns (best_lnlhood, best_pos): (B,) float32 / int32."""
    if reads.is_cuda:
        PLAIN_CALLS["cuda"] += 1
    B, L = reads.shape
    T = targets.shape[1]
    dev = reads.device
    scan_start = torch.clamp_min(bp_beg - read_len + 2, 0)         # (B,)
    scan_end = torch.clamp_min(
        torch.minimum(bp_end, target_len - read_len), 0)
    score_beg = bp_beg - flank_score_size
    score_end = bp_end + flank_score_size
    k = torch.arange(n_scan, dtype=torch.int32, device=dev)[None, :]
    pos0 = scan_start[:, None] + k                              # (B, S)
    qual_i = torch.clamp(quals.long(), 2, MAX_QSCORE)
    lnm = ln_match_lut[qual_i]                                  # (B, L)
    lnx = ln_mism_lut[qual_i]
    ln_random = torch.tensor(LN_RANDOM, device=dev)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    lnl = torch.zeros((B, n_scan), dtype=torch.float32, device=dev)
    # strict left-to-right float32 accumulation over bases (a gated
    # term adds +0.0, which leaves the sum unchanged: it never holds
    # -0.0); bases no row has add nothing and are not walked
    n_bases = min(L, int(read_len.max())) if B else 0
    for j in range(n_bases):
        tpos = pos0 + j
        win = torch.gather(targets, 1, torch.clamp(tpos, 0, T - 1).long())
        q = reads[:, j:j + 1]
        q_is_n = q == N_BASE
        is_n = q_is_n | (win == N_BASE)
        mism = (q != win) | q_is_n
        term = torch.where(is_n, ln_random,
                           torch.where(mism, lnx[:, j:j + 1],
                                       lnm[:, j:j + 1]))
        gate = ((tpos > score_beg[:, None]) & (tpos <= score_end[:, None])
                & (j < read_len)[:, None])
        lnl = lnl + torch.where(gate, term, zero)
    scan_valid = k <= (scan_end - scan_start)[:, None]
    lnl = torch.where(scan_valid, lnl, -math.inf)
    # torch.argmax takes the first of equal maxima, as jnp.argmax does
    best_k = torch.argmax(lnl, dim=1)
    best = torch.gather(lnl, 1, best_k[:, None])[:, 0]
    return best, scan_start + best_k.to(torch.int32)


def split_score(reads, quals, targets, bp_beg, bp_end, read_len,
                target_len, flank_score_size, ln_match_lut, ln_mism_lut,
                n_scan: int):
    """Dispatch on the tensors' device: the CUDA kernel, or on the CPU
    the plain form. Nothing else."""
    args = (reads, quals, targets, bp_beg, bp_end, read_len, target_len,
            flank_score_size, ln_match_lut, ln_mism_lut, n_scan)
    if reads.device.type == "cuda":
        return split_score_cuda(*args)
    if reads.device.type == "cpu":
        return batched_split_score(*args)
    raise ValueError(f"no split-scan path for device {reads.device}")
