"""Wrappers of the hand-written CUDA split-scan kernel (csrc/split_score.cu).

Counterpart of manta_tpu/align/pallas_splitscore.py (``pallas_split_score``
and its body ``_kernel``). Two layouts, one kernel:

- ``split_score_cuda``, the JAX layout, a row per (read, target) pair:
  uint8 reads and quals (B, L), uint8 targets (B, T), int32 bp_beg,
  bp_end, read_len and target_len (B,), float32 LUTs (71,); returns the
  best float32 ln-likelihood and its int32 position per row. Same
  contract as ``device_splitscore.batched_split_score``.
- ``split_score_factored_cuda``, n reads against the same t targets,
  each stored once: reads and quals (n, L), read_len (n,), targets
  (t, T), bp_beg, bp_end and target_len (t,); returns (n, t) float32 and
  int32, row r, column k being read r against target k. Same contract as
  ``device_splitscore.batched_split_score_factored``.

Both are bit-identical to their plain forms.

The library is built with nvcc at first call (``manta_tpu_torch._build``)
and launched on the current CUDA stream. This wrapper only ever launches
the kernel: a CPU tensor or anything else the kernel does not take
raises.
"""

from __future__ import annotations

import ctypes
import math

import torch

# one per kernel launch made by split_score_cuda or
# split_score_factored_cuda, and nowhere else
KERNEL_LAUNCHES = {"split_score": 0}
# the work the split-scan router hands the kernel (on the CPU, its plain
# form), counted on the host from the call's own lengths: ``useful``
# terms (valid scan positions x read length over the (read, target)
# pairs), the ``padded`` terms of the call's tiers (n x t x Tp x Lp) and
# the ``bytes`` of its inputs and outputs, each once
# (``scoring.device_scan.count_work``)
KERNEL_WORK = {"split_score": {"useful": 0, "padded": 0, "bytes": 0}}

_LIB = None
_LN_RANDOM = -math.log(4.0)
# device index -> the most dynamic shared memory a block can have there
_SMEM_LIMIT: dict[int, int] = {}


def _lib():
    global _LIB
    if _LIB is None:
        from .._build import load
        lib = load("split_score")
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.mt_cuda_split_score.restype = ci
        lib.mt_cuda_split_score.argtypes = (
            [vp] * 11 + [ci] * 7 + [ctypes.c_float, vp])
        lib.mt_cuda_split_score_smem.restype = ctypes.c_longlong
        lib.mt_cuda_split_score_smem.argtypes = [ci, ci]
        lib.mt_cuda_split_score_max_smem.restype = ci
        lib.mt_cuda_split_score_max_smem.argtypes = []
        _LIB = lib
    return _LIB


def _check(name, t, dtype, shape, device):
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a torch.Tensor, got {type(t)}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if t.device.type != "cuda":
        raise ValueError(f"{name}: the CUDA split-scan kernel needs a CUDA "
                         f"tensor, got one on {t.device}")
    if device is not None and t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if shape is not None and tuple(t.shape) != shape:
        raise ValueError(f"{name}: expected shape {shape}, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


def _launch(reads, quals, read_len, targets, bp_beg, bp_end, target_len,
            flank_score_size, ln_match_lut, ln_mism_lut, n_scan, t,
            tgt_stride, out):
    """Check what both layouts share, launch, count. ``targets`` has
    ``rows`` rows and the three target vectors ``rows`` entries: t for
    the factored layout, n for the replicated one. ``out``: None, or
    the int32 (2, n, t) tensor that takes the scores' float32 bits
    (plane 0) and the positions (plane 1)."""
    _check("reads", reads, torch.uint8, None, None)
    if reads.dim() != 2:
        raise ValueError(f"reads: expected 2-D, got shape "
                         f"{tuple(reads.shape)}")
    dev = reads.device
    n, L = reads.shape
    rows = t if tgt_stride == 0 else n
    _check("quals", quals, torch.uint8, (n, L), dev)
    _check("read_len", read_len, torch.int32, (n,), dev)
    _check("targets", targets, torch.uint8, None, dev)
    if targets.dim() != 2 or targets.shape[0] != rows \
            or targets.shape[1] < 1:
        raise ValueError(f"targets: expected shape ({rows}, T >= 1), got "
                         f"{tuple(targets.shape)}")
    for name, x in (("bp_beg", bp_beg), ("bp_end", bp_end),
                    ("target_len", target_len)):
        _check(name, x, torch.int32, (rows,), dev)
    for name, x in (("ln_match_lut", ln_match_lut),
                    ("ln_mism_lut", ln_mism_lut)):
        _check(name, x, torch.float32, (71,), dev)
    n_scan = int(n_scan)
    if n_scan < 0:
        raise ValueError(f"n_scan must be >= 0, got {n_scan}")
    if out is None:
        out = torch.empty((2, n, t), dtype=torch.int32, device=dev)
    else:
        _check("out", out, torch.int32, (2, n, t), dev)
    best, pos = out[0].view(torch.float32), out[1]
    if n == 0 or t == 0:
        return best, pos
    lib = _lib()
    with torch.cuda.device(dev):
        need = lib.mt_cuda_split_score_smem(L, t)
        limit = _SMEM_LIMIT.get(dev.index)
        if limit is None:
            limit = _SMEM_LIMIT[dev.index] = \
                lib.mt_cuda_split_score_max_smem()
        if need > limit:
            raise ValueError(
                f"read width {L} and {t} targets per read need {need} "
                f"bytes of shared memory per read; the CUDA split-scan "
                f"kernel's limit on this device is {limit}")
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.mt_cuda_split_score(
            reads.data_ptr(), quals.data_ptr(), read_len.data_ptr(),
            targets.data_ptr(), bp_beg.data_ptr(), bp_end.data_ptr(),
            target_len.data_ptr(), ln_match_lut.data_ptr(),
            ln_mism_lut.data_ptr(), best.data_ptr(), pos.data_ptr(),
            n, t, tgt_stride, L, targets.shape[1], int(flank_score_size),
            n_scan, _LN_RANDOM, stream)
    if err != 0:
        raise RuntimeError(
            f"CUDA split-scan kernel launch failed: cudaError {err}")
    KERNEL_LAUNCHES["split_score"] += 1
    return best, pos


def split_score_cuda(reads, quals, targets, bp_beg, bp_end, read_len,
                     target_len, flank_score_size, ln_match_lut,
                     ln_mism_lut, n_scan: int):
    """Best split-scan ln-likelihood and position per row: float32 (B,)
    and int32 (B,), on the reads' device. Every row is a read with one
    target of its own."""
    best, pos = _launch(reads, quals, read_len, targets, bp_beg, bp_end,
                        target_len, flank_score_size, ln_match_lut,
                        ln_mism_lut, n_scan, 1, 1, None)
    return best[:, 0], pos[:, 0]


def split_score_factored_cuda(reads, quals, read_len, targets, bp_beg,
                              bp_end, target_len, flank_score_size,
                              ln_match_lut, ln_mism_lut, n_scan: int,
                              out=None):
    """Best split-scan ln-likelihood and position of every read against
    every target: float32 (n, t) and int32 (n, t), on the reads' device.
    With ``out``, an int32 (2, n, t) tensor, both are views of it (the
    scores' bits in plane 0), so one copy brings both to the host."""
    if not isinstance(targets, torch.Tensor) or targets.dim() != 2:
        raise ValueError("targets: expected a 2-D tensor")
    return _launch(reads, quals, read_len, targets, bp_beg, bp_end,
                   target_len, flank_score_size, ln_match_lut, ln_mism_lut,
                   n_scan, targets.shape[0], 0, out)
