"""Wrapper of the hand-written CUDA jump-DP kernel (csrc/jump_score.cu).

Counterpart of manta_tpu/align/pallas_jumpscore.py (``pallas_jump_score``
and its body ``_kernel``). Same contract as the plain form
``device_jumpscore.batched_jump_score`` on int32 tensors in the JAX
layout: query (B, nq), ref1 (B, nr1), ref2 (B, nr2), lengths (B,);
returns the exact int32 best score per row.

The library is built with nvcc at first call (``manta_tpu_torch._build``)
and launched on the current CUDA stream. This wrapper only ever launches
the kernel: a CPU tensor or anything else the kernel does not take
raises.
"""

from __future__ import annotations

import ctypes

import torch

# one per kernel launch made by jump_score_cuda, and nowhere else
KERNEL_LAUNCHES = {"jump_score": 0}

_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        from .._build import load
        lib = load("jump_score")
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.mt_cuda_jump_score.restype = ci
        lib.mt_cuda_jump_score.argtypes = [vp] * 7 + [ci] * 10 + [vp]
        lib.mt_cuda_jump_score_max_nq.restype = ci
        lib.mt_cuda_jump_score_max_nq.argtypes = []
        _LIB = lib
    return _LIB


def max_query_width() -> int:
    """Widest padded query (nq) the kernel takes."""
    return int(_lib().mt_cuda_jump_score_max_nq())


def _check(name, t, dim, device, rows=None):
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a torch.Tensor, got {type(t)}")
    if t.dtype != torch.int32:
        raise TypeError(f"{name}: expected int32, got {t.dtype}")
    if t.device.type != "cuda":
        raise ValueError(f"{name}: the CUDA jump kernel needs a CUDA "
                         f"tensor, got one on {t.device}")
    if device is not None and t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dim() != dim:
        raise ValueError(f"{name}: expected {dim}-D, got shape "
                         f"{tuple(t.shape)}")
    if rows is not None and t.shape[0] != rows:
        raise ValueError(f"{name}: expected {rows} rows, got "
                         f"{t.shape[0]}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


def jump_score_cuda(query, query_len, ref1, ref1_len, ref2, ref2_len,
                    match: int, mismatch: int, open_: int, extend: int,
                    off_edge: int, jump_score: int) -> torch.Tensor:
    """Best jump-alignment score per row, int32 (B,), on the query's
    device. Padded widths are the tensors' own widths."""
    _check("query", query, 2, None)
    dev = query.device
    B, nq = query.shape
    _check("query_len", query_len, 1, dev, B)
    _check("ref1", ref1, 2, dev, B)
    _check("ref1_len", ref1_len, 1, dev, B)
    _check("ref2", ref2, 2, dev, B)
    _check("ref2_len", ref2_len, 1, dev, B)
    lib = _lib()
    if nq > lib.mt_cuda_jump_score_max_nq():
        raise ValueError(f"query width {nq} exceeds the CUDA jump kernel's "
                         f"limit {lib.mt_cuda_jump_score_max_nq()}")
    out = torch.empty(B, dtype=torch.int32, device=dev)
    if B == 0:
        return out
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.mt_cuda_jump_score(
            query.data_ptr(), query_len.data_ptr(), ref1.data_ptr(),
            ref1_len.data_ptr(), ref2.data_ptr(), ref2_len.data_ptr(),
            out.data_ptr(), B, nq, ref1.shape[1], ref2.shape[1],
            int(match), int(mismatch), int(open_), int(extend),
            int(off_edge), int(jump_score), stream)
    if err != 0:
        raise RuntimeError(f"CUDA jump kernel launch failed: cudaError {err}")
    KERNEL_LAUNCHES["jump_score"] += 1
    return out
