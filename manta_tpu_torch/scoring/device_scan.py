"""Device routing for production split-read scoring (PyTorch/CUDA).

Counterpart of manta_tpu/scoring/device_scan.py. Batches one breakend's
candidate reads x junction targets into the split scan on a torch
device, with the same contract as evidence.split_read_scan_multi.

Two formulations, as in the JAX package:
- exact (default): on a CUDA device the hand-written kernel
  (align/cuda_splitscore.split_score_factored_cuda), on the CPU the
  plain form (align/device_splitscore.batched_split_score_factored);
  both add the terms in the native host scan's order, so device and host
  give bit-identical winners and routing is a pure performance choice.
  Reads and targets are staged once each (no replication across the
  read x target pairs) in one host buffer, pinned for a CUDA device:
  a call makes one host-to-device copy and one device-to-host copy.
- mxu: the matmul/Toeplitz factorization
  (align/device_splitscore_mxu.junction_split_score) that shares each
  junction target across all its reads; ~1e-6 relative score error.
  Batches holding IUPAC codes outside {A,C,G,T,N} fall back to the
  exact scan: the kernel on CUDA, the plain form on the CPU.

Shapes are bucketed (read length and scan length padded to fixed
tiers), the JAX package's tiers. The qual LUTs are made on the device
once for each pair of contents, at the first scan, so a context built
before a fork creates no CUDA state in the parent.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from ..align.cuda_splitscore import KERNEL_LAUNCHES, KERNEL_WORK
from ..align.device_splitscore import split_score_factored
from ..align.device_splitscore_mxu import junction_split_score
from ..parallel import counters, device_proc, worker_trace

_TIERS = (256, 512, 1024, 2048, 4096, 8192)

_ACGTN_PAD = frozenset((65, 67, 71, 84, 78, 0xFF))  # A C G T N pad

# scan accounting: calls per route, (read, target) rows scanned and wall
# time; reported once per process at exit as a "[manta-tpu-torch]
# split-scan ..." stderr line
SCAN_STATS = {"exact": 0, "mxu": 0, "fallback": 0, "rows": 0, "wall": 0.0}
# exact scans by (read tier Lp, scan tier Tp): [calls, most reads, most
# targets in one call], the shapes the kernel was launched at
SCAN_TIERS: dict[tuple[int, int], list[int]] = {}
# copies the exact route asked for on a CUDA device: one each way a call
EXACT_COPIES = {"h2d": 0, "d2h": 0}


def _scan_line():
    s = SCAN_STATS
    work = KERNEL_WORK["split_score"]
    calls = s["exact"] + s["mxu"] + s["fallback"]
    if not calls:
        return None
    return (f"[manta-tpu-torch] split-scan pid={os.getpid()}: "
            f"{calls} calls (exact {s['exact']}, mxu {s['mxu']}, "
            f"fallback {s['fallback']}), {s['rows']} rows, "
            f"{s['wall']:.2f}s total, "
            f"{KERNEL_LAUNCHES['split_score']} kernel launches; "
            f"work: {work['useful']} useful terms, "
            f"{work['padded']} padded terms, {work['bytes']} bytes; "
            f"tiers (Lp, Tp): {dict(sorted(SCAN_TIERS.items()))}")


# the router's calls of the kernel: its exact scans and mxu fallbacks
counters.register(
    {"calls": lambda: {"split_score": SCAN_STATS["exact"]
                       + SCAN_STATS["fallback"]},
     "wall": lambda: {"split_score": SCAN_STATS["wall"]}},
    line=_scan_line)


def useful_terms(read_len, bp_beg, bp_end, target_len) -> int:
    """The split scan's useful terms over the (read, target) pairs the
    arguments broadcast to: a pair's valid scan positions, scan_start =
    max(0, bp_beg - read_len + 2) to scan_end = max(0, min(bp_end,
    target_len - read_len)), times its read length."""
    rl = np.asarray(read_len, np.int64)
    start = np.maximum(0, np.asarray(bp_beg, np.int64) - rl + 2)
    stop = np.maximum(0, np.minimum(np.asarray(bp_end, np.int64),
                                    np.asarray(target_len, np.int64) - rl))
    return int((np.clip(stop - start + 1, 0, None) * rl).sum())


def count_work(read_len, bp_beg, bp_end, target_len, Lp: int,
               Tp: int) -> None:
    """Add one exact scan's work to ``KERNEL_WORK["split_score"]``: its
    useful terms, the terms of its tiers (n x t x Tp x Lp), and its
    bytes (reads and quals (n, Lp), targets (t, Tp), four int32 vectors,
    both 71-entry float32 LUTs in; a float32 and an int32 a pair out)."""
    n, t = len(read_len), len(target_len)
    work = KERNEL_WORK["split_score"]
    work["useful"] += useful_terms(np.asarray(read_len)[:, None], bp_beg,
                                   bp_end, target_len)
    work["padded"] += n * t * Tp * Lp
    work["bytes"] += (2 * n * Lp + t * Tp + 4 * (n + 3 * t) + 2 * 71 * 4
                      + 8 * n * t)


def _bucket(n: int) -> int:
    for t in _TIERS:
        if n <= t:
            return t
    return ((n + 8191) // 8192) * 8192


def _gather_rows(flat, off, idx, out, fill):
    """out[r] = flat[off[idx[r]]:off[idx[r] + 1]], then ``fill``, for
    every r, without a Python loop: one take through an (n, longest)
    index plane. Returns the lengths (n,) int64."""
    start = off[idx].astype(np.int64)
    lens = off[idx + 1].astype(np.int64) - start
    longest = int(lens.max()) if len(lens) else 0
    col = np.arange(longest, dtype=np.int64)
    src = np.minimum(start[:, None] + col, len(flat) - 1)
    out[:, :longest] = np.where(col < lens[:, None], flat[src], fill)
    out[:, longest:] = fill
    return lens


def read_tier(batch, read_idx) -> int:
    """The read tier Lp of the selected batch reads."""
    return _bucket(int((batch.seq_off[read_idx + 1]
                        - batch.seq_off[read_idx]).max()))


def stage_reads(batch, read_idx, out=None):
    """The selected batch reads as (n, Lp) uint8 rows, 0xFF padded, with
    their quals (n, Lp) and lengths (n,) int32; Lp is the read tier.
    ``out``: None, or the (reads, quals) arrays of that shape to fill."""
    read_idx = np.asarray(read_idx, np.int64)
    n = len(read_idx)
    if out is None:
        Lp = read_tier(batch, read_idx)
        out = np.empty((n, Lp), np.uint8), np.empty((n, Lp), np.uint8)
    reads, quals = out
    read_lens = _gather_rows(batch.seq, batch.seq_off, read_idx, reads,
                             np.uint8(0xFF))
    _gather_rows(batch.qual, batch.qual_off, read_idx, quals, np.uint8(0))
    return reads, quals, read_lens.astype(np.int32)


def stage_exact(reads, quals, read_lens, targets, bp_ranges, Tp):
    """The scan's rows in the replicated (JAX) layout, read-major: each
    read row replicated across its t junction targets, targets N-padded
    to Tp. Returns the numpy arrays (reads, quals, targets, bp_beg,
    bp_end, read_len, target_len), B = n * t rows. The router itself
    stages the factored layout (``ExactStaging``); this is the layout
    the kernel is held against the JAX package in."""
    t = len(targets)
    B = len(reads) * t
    freads = np.repeat(reads, t, axis=0)
    fquals = np.repeat(quals, t, axis=0)
    tgts = np.full((B, Tp), ord("N"), np.uint8)
    bp_beg = np.zeros(B, np.int32)
    bp_end = np.zeros(B, np.int32)
    tl = np.zeros(B, np.int32)
    for k, tg in enumerate(targets):
        tgts[k::t, :len(tg)] = tg
        bp_beg[k::t] = bp_ranges[k][0]
        bp_end[k::t] = bp_ranges[k][1]
        tl[k::t] = len(tg)
    return freads, fquals, tgts, bp_beg, bp_end, np.repeat(read_lens, t), tl


def staged_bytes(n: int, t: int, Lp: int, Tp: int) -> int:
    """The bytes of one call's inputs in the factored layout: reads and
    quals (n, Lp), targets (t, Tp), then the int32 vectors read_len (n,),
    bp_beg, bp_end, target_len (t,). Lp and Tp are multiples of 256, so
    the vectors start 4-byte aligned."""
    return 2 * n * Lp + t * Tp + 4 * (n + 3 * t)


def staged_views(flat, n: int, t: int, Lp: int, Tp: int):
    """(reads, quals, read_len, targets, bp_beg, bp_end, target_len) as
    views of ``flat``, a numpy uint8 array or a torch uint8 tensor that
    holds a call's inputs in the factored layout."""
    o1, o2 = n * Lp, 2 * n * Lp
    o3 = o2 + t * Tp
    ints = flat[o3:o3 + 4 * (n + 3 * t)].view(
        np.int32 if isinstance(flat, np.ndarray) else torch.int32)
    return (flat[:o1].reshape(n, Lp), flat[o1:o2].reshape(n, Lp), ints[:n],
            flat[o2:o3].reshape(t, Tp), ints[n:n + t], ints[n + t:n + 2 * t],
            ints[n + 2 * t:])


def fill_staged(flat, batch, read_idx, targets, bp_ranges, Lp: int,
                Tp: int) -> None:
    """Write one call's inputs into ``flat`` (numpy uint8, at least
    ``staged_bytes`` long) in the factored layout: the selected batch
    reads and quals 0xFF and 0 padded to Lp, the targets N-padded to
    Tp."""
    n, t = len(read_idx), len(targets)
    reads, quals, read_len, tgts, bp_beg, bp_end, target_len = \
        staged_views(flat, n, t, Lp, Tp)
    read_len[:] = stage_reads(batch, read_idx, (reads, quals))[2]
    tgts[...] = ord("N")
    for k, tg in enumerate(targets):
        tgts[k, :len(tg)] = tg
        bp_beg[k] = bp_ranges[k][0]
        bp_end[k] = bp_ranges[k][1]
        target_len[k] = len(tg)


class ExactStaging:
    """One host buffer that holds every input of a scan call in the
    factored layout (``staged_views``), so that one copy takes them to
    the device. Pinned when the device is CUDA; grown when a call needs
    more and kept between calls (a call ends with the results on the
    host, so the buffer is free again)."""

    def __init__(self, device):
        self.device = device
        self._buf = None

    def host(self, n_bytes: int):
        """The buffer's first ``n_bytes``, as a CPU uint8 tensor."""
        if self._buf is None or self._buf.numel() < n_bytes:
            self._buf = torch.empty(
                max(n_bytes, 1 << 16), dtype=torch.uint8,
                pin_memory=self.device.type == "cuda")
        return self._buf[:n_bytes]

    def stage(self, batch, read_idx, targets, bp_ranges, Tp):
        """Fill the buffer and copy it; returns the device tensors
        (reads, quals, read_len, targets, bp_beg, bp_end,
        target_len)."""
        n, t = len(read_idx), len(targets)
        Lp = read_tier(batch, read_idx)
        host = self.host(staged_bytes(n, t, Lp, Tp))
        fill_staged(host.numpy(), batch, read_idx, targets, bp_ranges, Lp,
                    Tp)
        return self.upload(host, n, t, Lp, Tp)

    def upload(self, host, n: int, t: int, Lp: int, Tp: int):
        """The staged ``host`` buffer on the device, as ``stage``
        returns it: one copy on a CUDA device, none on the CPU."""
        if self.device.type == "cuda":
            dev = host.to(self.device, non_blocking=True)
            EXACT_COPIES["h2d"] += 1
        else:
            dev = host
        return staged_views(dev, n, t, Lp, Tp)


class DeviceScanContext:
    """The split router on ``device``: ``scan_multi`` buckets a call and
    hands it to this process's route (``parallel.device_proc``), whose
    own context of this class stages the inputs, keeps the LUT tensors
    and scans (``scan_staged``)."""

    def __init__(self, mxu: bool = False, device="cuda"):
        self._mxu = bool(mxu)
        self.device = torch.device(device)
        if self.device.type not in ("cuda", "cpu"):
            raise ValueError(f"no split-scan path for device {self.device}")
        self._luts = {}
        self.staging = ExactStaging(self.device)

    def luts_of(self, m, x):
        """The LUT tensors of the 71-entry LUTs ``m``, ``x`` (float32
        numpy), made once for each pair of contents."""
        key = (m.tobytes(), x.tobytes())
        hit = self._luts.get(key)
        if hit is None:
            # the scan clamps quals to [2, 70] and indexes a 71-entry LUT
            hit = self._luts[key] = tuple(
                torch.from_numpy(np.ascontiguousarray(a[:71])).to(
                    self.device) for a in (m, x))
        return hit

    def scan_multi(self, flank_score_size, batch, read_idx, qconv,
                   targets, bp_ranges):
        """Same contract as evidence.split_read_scan_multi."""
        with worker_trace.span("k3.route",
                               pairs=len(read_idx) * len(targets)):
            return self._scan_multi(flank_score_size, batch, read_idx,
                                    qconv, targets, bp_ranges)

    def _scan_multi(self, flank_score_size, batch, read_idx, qconv,
                    targets, bp_ranges):
        read_idx = np.asarray(read_idx, np.int64)
        Lp = read_tier(batch, read_idx)
        Tp = _bucket(max(len(tg) for tg in targets) + 1)
        # the first 71 entries of the 256-entry byte LUTs
        m, x = qconv.lut256()
        return device_proc.route(self.device).k3(
            lambda flat: fill_staged(flat, batch, read_idx, targets,
                                     bp_ranges, Lp, Tp),
            len(read_idx), len(targets), Lp, Tp, flank_score_size,
            self._mxu, m[:71], x[:71])

    def scan_staged(self, host, n: int, t: int, Lp: int, Tp: int,
                    flank_score_size: int, lut_m, lut_x, t0: float):
        """One call's scan from its inputs staged in ``host`` (this
        context's ``ExactStaging`` buffer, filled by ``fill_staged``),
        with the LUT tensors on the device: the (n, t) best float32
        ln-likelihoods and int32 positions, and the accounting
        (``SCAN_STATS`` from ``t0``, the call's start by
        ``perf_counter``; ``KERNEL_WORK``, ``SCAN_TIERS``). Run by the
        route of the process that owns the device: the caller's own, or
        the run's device process."""
        reads, quals, read_lens, tgts, bp_beg, bp_end, target_len = \
            staged_views(host.numpy(), n, t, Lp, Tp)
        exact = not (self._mxu and self._mxu_eligible(reads, tgts))
        if not exact:
            SCAN_STATS["mxu"] += 1
            out = self._scan_mxu(flank_score_size, reads, quals, read_lens,
                                 tgts, bp_beg, bp_end, target_len, lut_m,
                                 lut_x, Tp)
        else:
            # IUPAC codes the one-hot factorization can't encode fall
            # back to the exact scan, which takes any byte
            SCAN_STATS["fallback" if self._mxu else "exact"] += 1
            out = self._scan_exact(flank_score_size, host, n, t, Lp, Tp,
                                   lut_m, lut_x)
        SCAN_STATS["rows"] += n * t
        SCAN_STATS["wall"] += time.perf_counter() - t0
        if exact:
            count_work(read_lens, bp_beg, bp_end, target_len, Lp, Tp)
            tier = SCAN_TIERS.setdefault((Lp, Tp), [0, 0, 0])
            tier[0] += 1
            tier[1] = max(tier[1], n)
            tier[2] = max(tier[2], t)
        return out

    @staticmethod
    def _mxu_eligible(reads, targets) -> bool:
        codes = set(np.unique(reads).tolist())
        for tg in targets:
            codes.update(np.unique(tg).tolist())
        return codes <= _ACGTN_PAD

    def _scan_exact(self, flank_score_size, host, n, t, Lp, Tp, lut_m,
                    lut_x):
        staged = self.staging.upload(host, n, t, Lp, Tp)
        # scores' bits and positions in one tensor: one copy back
        out = torch.empty((2, n, t), dtype=torch.int32, device=self.device)
        split_score_factored(*staged, flank_score_size, lut_m, lut_x,
                             n_scan=Tp, out=out)
        if self.device.type == "cuda":
            EXACT_COPIES["d2h"] += 1
        res = out.cpu().numpy()
        return res[0].view(np.float32), res[1]

    def _scan_mxu(self, flank_score_size, reads, quals, read_lens, tgts,
                  bp_beg, bp_end, target_len, lut_m, lut_x, Tp):
        n, Lp = reads.shape
        t = len(tgts)
        # one matmul group per target; every group scores the same reads
        greads = np.broadcast_to(reads, (t, n, Lp))
        gquals = np.broadcast_to(quals, (t, n, Lp))
        grl = np.broadcast_to(read_lens, (t, n))
        s0 = np.zeros(t, np.int32)
        best, pos = junction_split_score(
            *(torch.from_numpy(np.ascontiguousarray(a)).to(self.device)
              for a in (greads, gquals, tgts, s0, bp_beg, bp_end, grl,
                        target_len)),
            flank_score_size, lut_m, lut_x, n_scan=Tp)
        # (t, n) -> (n, t)
        return (best.cpu().numpy().T.astype(np.float32).copy(),
                pos.cpu().numpy().T.astype(np.int32).copy())
