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

Beside the JAX layout there is the *factored* one, for the production
case of n reads scanned against the same t junction targets: reads,
quals (n, L) and read_len (n,) once per read, targets (t, T), bp_beg,
bp_end and target_len (t,) once per target, results (n, t), row r,
column k being read r against target k. ``batched_split_score_factored``
is its plain form, ``cuda_splitscore.split_score_factored_cuda`` the
same kernel; ``factored_from_replicated`` turns the read-major
replicated arrays of the JAX layout into it.

``split_score`` and ``split_score_factored`` dispatch on the tensors'
device: the kernel on CUDA, the plain form on the CPU, never one for the
other.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .cuda_splitscore import split_score_cuda, split_score_factored_cuda

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


def factored_from_replicated(reads, quals, targets, bp_beg, bp_end,
                             read_len, target_len, t: int, device):
    """The factored tensors (reads, quals, read_len, targets, bp_beg,
    bp_end, target_len) on ``device`` of a read-major replicated batch
    in the JAX layout: numpy arrays of B = n * t rows, row r * t + k
    being read r against target k. Raises if the rows are not such a
    replication."""
    arrays = [np.ascontiguousarray(a) for a in (
        reads, quals, targets, bp_beg, bp_end, read_len, target_len)]
    B = arrays[0].shape[0]
    if t < 1 or B % t:
        raise ValueError(f"{B} rows are not n reads x {t} targets")
    per_read = [arrays[i][::t] for i in (0, 1, 5)]
    per_target = [arrays[i][:t] for i in (2, 3, 4, 6)]
    for a, f in zip((arrays[i] for i in (0, 1, 5)), per_read):
        if not np.array_equal(a, np.repeat(f, t, axis=0)):
            raise ValueError("rows of one read differ")
    for a, f in zip((arrays[i] for i in (2, 3, 4, 6)), per_target):
        if not np.array_equal(a, np.concatenate([f] * (B // t))):
            raise ValueError("the targets do not repeat every t rows")
    r, q, rl = per_read
    tg, beg, end, tl = per_target
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                 for a in (r, q, rl, tg, beg, end, tl))


def batched_split_score_factored(reads, quals, read_len, targets, bp_beg,
                                 bp_end, target_len, flank_score_size,
                                 ln_match_lut, ln_mism_lut, n_scan: int):
    """Every read against every target, each stored once: the plain form
    of the factored layout, target by target through
    ``batched_split_score`` (the same sums in the same order, so equal to
    it on the replicated rows bit for bit).

    Returns (best_lnlhood, best_pos): (n, t) float32 / int32."""
    n = reads.shape[0]
    t = targets.shape[0]
    dev = reads.device
    best = torch.empty((n, t), dtype=torch.float32, device=dev)
    pos = torch.empty((n, t), dtype=torch.int32, device=dev)
    for k in range(t):
        best[:, k], pos[:, k] = batched_split_score(
            reads, quals, targets[k:k + 1].expand(n, -1),
            bp_beg[k:k + 1].expand(n), bp_end[k:k + 1].expand(n), read_len,
            target_len[k:k + 1].expand(n), flank_score_size, ln_match_lut,
            ln_mism_lut, n_scan)
    return best, pos


def split_score_factored(reads, quals, read_len, targets, bp_beg, bp_end,
                         target_len, flank_score_size, ln_match_lut,
                         ln_mism_lut, n_scan: int, out=None):
    """The factored scan, dispatched on the tensors' device: the CUDA
    kernel, or on the CPU the plain form. Nothing else. ``out``: see
    ``split_score_factored_cuda``; the plain form fills it too."""
    args = (reads, quals, read_len, targets, bp_beg, bp_end, target_len,
            flank_score_size, ln_match_lut, ln_mism_lut, n_scan)
    if reads.device.type == "cuda":
        return split_score_factored_cuda(*args, out=out)
    if reads.device.type == "cpu":
        best, pos = batched_split_score_factored(*args)
        if out is not None:
            out[0].view(torch.float32).copy_(best)
            out[1].copy_(pos)
            best, pos = out[0].view(torch.float32), out[1]
        return best, pos
    raise ValueError(f"no split-scan path for device {reads.device}")


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
