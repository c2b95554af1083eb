"""Wrapper of the hand-written CUDA split-scan kernel (csrc/split_score.cu).

Counterpart of manta_tpu/align/pallas_splitscore.py (``pallas_split_score``
and its body ``_kernel``). Same contract as the plain form
``device_splitscore.batched_split_score`` on tensors in the JAX layout:
uint8 reads and quals (B, L), uint8 targets (B, T), int32 bp_beg,
bp_end, read_len and target_len (B,), float32 LUTs (71,); returns the
best float32 ln-likelihood and its int32 position per row, bit-identical
to the plain form.

The library is built with nvcc at first call (``manta_tpu_torch._build``)
and launched on the current CUDA stream. This wrapper only ever launches
the kernel: a CPU tensor or anything else the kernel does not take
raises.
"""

from __future__ import annotations

import ctypes
import math

import torch

# one per kernel launch made by split_score_cuda, and nowhere else
KERNEL_LAUNCHES = {"split_score": 0}

_LIB = None
_LN_RANDOM = -math.log(4.0)


def _lib():
    global _LIB
    if _LIB is None:
        from .._build import load
        lib = load("split_score")
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.mt_cuda_split_score.restype = ci
        lib.mt_cuda_split_score.argtypes = (
            [vp] * 11 + [ci] * 5 + [ctypes.c_float, vp])
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


def split_score_cuda(reads, quals, targets, bp_beg, bp_end, read_len,
                     target_len, flank_score_size, ln_match_lut,
                     ln_mism_lut, n_scan: int):
    """Best split-scan ln-likelihood and position per row: float32 (B,)
    and int32 (B,), on the reads' device."""
    _check("reads", reads, torch.uint8, None, None)
    if reads.dim() != 2:
        raise ValueError(f"reads: expected 2-D, got shape "
                         f"{tuple(reads.shape)}")
    dev = reads.device
    B, L = reads.shape
    _check("quals", quals, torch.uint8, (B, L), dev)
    _check("targets", targets, torch.uint8, None, dev)
    if targets.dim() != 2 or targets.shape[0] != B or targets.shape[1] < 1:
        raise ValueError(f"targets: expected shape ({B}, T >= 1), got "
                         f"{tuple(targets.shape)}")
    for name, t in (("bp_beg", bp_beg), ("bp_end", bp_end),
                    ("read_len", read_len), ("target_len", target_len)):
        _check(name, t, torch.int32, (B,), dev)
    for name, t in (("ln_match_lut", ln_match_lut),
                    ("ln_mism_lut", ln_mism_lut)):
        _check(name, t, torch.float32, (71,), dev)
    n_scan = int(n_scan)
    if n_scan < 0:
        raise ValueError(f"n_scan must be >= 0, got {n_scan}")
    best = torch.empty(B, dtype=torch.float32, device=dev)
    pos = torch.empty(B, dtype=torch.int32, device=dev)
    if B == 0:
        return best, pos
    lib = _lib()
    with torch.cuda.device(dev):
        need = lib.mt_cuda_split_score_smem(L, n_scan)
        limit = lib.mt_cuda_split_score_max_smem()
        if need > limit:
            raise ValueError(
                f"read width {L} and {n_scan} scan positions need {need} "
                f"bytes of shared memory per row; the CUDA split-scan "
                f"kernel's limit on this device is {limit}")
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.mt_cuda_split_score(
            reads.data_ptr(), quals.data_ptr(), targets.data_ptr(),
            bp_beg.data_ptr(), bp_end.data_ptr(), read_len.data_ptr(),
            target_len.data_ptr(), ln_match_lut.data_ptr(),
            ln_mism_lut.data_ptr(), best.data_ptr(), pos.data_ptr(),
            B, L, targets.shape[1], int(flank_score_size), n_scan,
            _LN_RANDOM, stream)
    if err != 0:
        raise RuntimeError(
            f"CUDA split-scan kernel launch failed: cudaError {err}")
    KERNEL_LAUNCHES["split_score"] += 1
    return best, pos
