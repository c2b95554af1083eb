"""Wrappers of the hand-written CUDA jump-DP kernels (csrc/jump_score.cu,
csrc/jump_score_bounded.cu).

Counterpart of manta_tpu/align/pallas_jumpscore.py: ``jump_score_cuda``
of ``pallas_jump_score``, ``jump_score_flagged_cuda`` of
``pallas_jump_score_flagged`` and ``jump_score_bounded_cuda`` of
``pallas_jump_score_bounded`` (body ``_kernel``). Same contracts as the
plain forms ``device_jumpscore.batched_jump_score``, ``..._flagged`` and
``..._bounded`` on int32 tensors in the JAX layout: query (B, nq), ref1
(B, nr1), ref2 (B, nr2), lengths (B,).

Both kernels are one systolic walk (csrc/jump_systolic.cuh): a warp
owns a strip of query lanes and its threads run one reference column
apart. ``kernel_layout`` says which form a batch takes: one warp per row,
or several that hand their boundary values on through device memory.

Each library is built with nvcc at first call (``manta_tpu_torch._build``)
and launched on the current CUDA stream. These wrappers only ever launch
the kernels: a CPU tensor or anything else a kernel does not take
raises.
"""

from __future__ import annotations

import ctypes

import torch

# one per kernel launch: "jump_score" by jump_score_cuda,
# "jump_score_bounded" by jump_score_flagged_cuda, and nowhere else
KERNEL_LAUNCHES = {"jump_score": 0, "jump_score_bounded": 0}
# the work the workflow's contig dispatcher hands each kernel (on the
# CPU, its plain form), counted on the host from the jobs' own lengths
# and the padded shapes, never read back from the device: ``useful``
# cells (query length x both references' lengths a job), the ``padded``
# cells the launch covers (B x nq x (nr1 + nr2)) and the ``bytes`` of
# its inputs and output, each once (``align.device_jumpscore``
# ``count_work``). No workflow launches the bounded kernel.
KERNEL_WORK = {name: {"useful": 0, "padded": 0, "bytes": 0}
               for name in KERNEL_LAUNCHES}

_LIB = None
_BOUNDED_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        from .._build import load
        lib = load("jump_score")
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.mt_cuda_jump_score.restype = ci
        lib.mt_cuda_jump_score.argtypes = (
            [vp] * 7 + [ci] * 10 + [vp, ctypes.c_longlong, ci, vp])
        lib.mt_cuda_jump_score_max_nq.restype = ci
        lib.mt_cuda_jump_score_max_nq.argtypes = []
        lib.mt_cuda_jump_score_max_strips.restype = ci
        lib.mt_cuda_jump_score_max_strips.argtypes = []
        lib.mt_cuda_jump_score_auto_lanes.restype = ci
        lib.mt_cuda_jump_score_auto_lanes.argtypes = [ci, ci]
        lib.mt_cuda_jump_score_strips.restype = ci
        lib.mt_cuda_jump_score_strips.argtypes = [ci, ci]
        lib.mt_cuda_jump_score_scratch_bytes.restype = ctypes.c_longlong
        lib.mt_cuda_jump_score_scratch_bytes.argtypes = [ci] * 5
        _LIB = lib
    return _LIB


def _bounded_lib():
    global _BOUNDED_LIB
    if _BOUNDED_LIB is None:
        from .._build import load
        lib = load("jump_score_bounded")
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.mt_cuda_jump_score_flagged.restype = ci
        lib.mt_cuda_jump_score_flagged.argtypes = (
            [vp] * 8 + [ci] * 11 + [vp, ctypes.c_longlong, ci, vp])
        lib.mt_cuda_jump_score_flagged_max_nq.restype = ci
        lib.mt_cuda_jump_score_flagged_max_nq.argtypes = []
        lib.mt_cuda_jump_score_flagged_max_shared_bytes.restype = \
            ctypes.c_longlong
        lib.mt_cuda_jump_score_flagged_max_shared_bytes.argtypes = []
        lib.mt_cuda_jump_score_flagged_auto_lanes.restype = ci
        lib.mt_cuda_jump_score_flagged_auto_lanes.argtypes = [ci] * 3
        lib.mt_cuda_jump_score_flagged_shared_bytes.restype = \
            ctypes.c_longlong
        lib.mt_cuda_jump_score_flagged_shared_bytes.argtypes = [ci] * 3
        lib.mt_cuda_jump_score_flagged_scratch_bytes.restype = \
            ctypes.c_longlong
        lib.mt_cuda_jump_score_flagged_scratch_bytes.argtypes = [ci] * 6
        _BOUNDED_LIB = lib
    return _BOUNDED_LIB


def max_query_width() -> int:
    """Widest padded query (nq) the kernel takes."""
    return int(_lib().mt_cuda_jump_score_max_nq())


def max_strips() -> int:
    """Most warps a row may take."""
    return int(_lib().mt_cuda_jump_score_max_strips())


def max_shared_bytes() -> int:
    """Most shared memory a warp of the bounded kernel may take."""
    return int(_bounded_lib().mt_cuda_jump_score_flagged_max_shared_bytes())


LANE_CHOICES = (3, 5, 9, 17)


def kernel_layout(B: int, nq: int, lanes: int = 0) -> tuple[int, int]:
    """(lanes per thread, warps per row) the exact kernel takes for a
    batch of B rows of padded query width nq: which form a batch runs
    in. A row is one warp where 32 x lanes covers its nq + 1 lanes
    (shuffles only); else several warps that hand their boundary values
    on through device memory. ``lanes`` = 0 is the kernel's own choice:
    the fewest lanes for which the batch's warps have a scheduler
    each."""
    lib = _lib()
    if lanes == 0:
        lanes = int(lib.mt_cuda_jump_score_auto_lanes(int(B), int(nq)))
    return lanes, int(lib.mt_cuda_jump_score_strips(int(nq), lanes))


def bounded_kernel_layout(B: int, nq: int, prefix_rounds: int,
                          lanes: int = 0) -> tuple[int, int, int]:
    """(lanes per thread, warps per row, bytes of shared memory a warp)
    the bounded kernel takes; ``lanes`` = 0 is its own choice: 5 lanes
    for a window under 32 lanes, from there on the fewest lanes from 9
    on for which a row is one warp and the most lanes where none is,
    among those whose ring fits a block's shared memory. (0, 0, 0)
    where none does."""
    lib = _bounded_lib()
    if lanes == 0:
        lanes = int(lib.mt_cuda_jump_score_flagged_auto_lanes(
            int(B), int(nq), int(prefix_rounds)))
        if lanes == 0:
            return 0, 0, 0
    return (lanes, int(_lib().mt_cuda_jump_score_strips(int(nq), lanes)),
            int(lib.mt_cuda_jump_score_flagged_shared_bytes(
                int(nq), int(prefix_rounds), lanes)))


# scratch of the multi-warp launches whose error word has not been read
_UNCHECKED: list[torch.Tensor] = []
# polls the warps of the multi-warp launches made while they waited for
# the warp below, beyond the first of each wait: for the boundary words,
# and for the bounded chain's tails; summed by raise_on_kernel_error
WAIT_POLLS = {"boundary": 0, "tail": 0}


def raise_on_kernel_error() -> None:
    """Read the error word of every multi-warp launch made since the
    last call (this waits for them) and raise if a warp gave up waiting
    for the warp below it: the scores of that launch are not valid. Adds
    the launches' wait polls to ``WAIT_POLLS``."""
    pending, _UNCHECKED[:] = list(_UNCHECKED), []
    failed = False
    for t in pending:
        error, boundary, tail = t[1:4].tolist()
        failed |= error != 0
        # the kernel's counters are int32 and may wrap
        WAIT_POLLS["boundary"] += boundary & 0xFFFFFFFF
        WAIT_POLLS["tail"] += tail & 0xFFFFFFFF
    if failed:
        raise RuntimeError("CUDA jump kernel: a warp gave up waiting for "
                           "its lower neighbour's boundary values")


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


def _check_batch(query, query_len, ref1, ref1_len, ref2, ref2_len):
    _check("query", query, 2, None)
    dev = query.device
    B = query.shape[0]
    _check("query_len", query_len, 1, dev, B)
    _check("ref1", ref1, 2, dev, B)
    _check("ref1_len", ref1_len, 1, dev, B)
    _check("ref2", ref2, 2, dev, B)
    _check("ref2_len", ref2_len, 1, dev, B)


def _check_lanes(lanes: int, strips: int, nq: int) -> None:
    if lanes not in (0, *LANE_CHOICES):
        raise ValueError(f"lanes must be 0 or one of {LANE_CHOICES}, got "
                         f"{lanes}")
    if lanes and strips > max_strips():
        raise ValueError(f"query width {nq} takes more than {max_strips()} "
                         f"warps at {lanes} lanes per thread")


def _scratch(n_bytes: int, device):
    """The launch's scratch, or None where it needs none; int64
    elements: the kernel wants it 8-aligned."""
    if not n_bytes:
        return None
    return torch.empty((n_bytes + 7) // 8, dtype=torch.int64, device=device)


def _keep_for_error_check(scratch) -> None:
    if scratch is not None:
        _UNCHECKED.append(scratch.view(torch.int32))
        if len(_UNCHECKED) > 16:      # bound what an unchecked run holds
            raise_on_kernel_error()


def jump_score_cuda(query, query_len, ref1, ref1_len, ref2, ref2_len,
                    match: int, mismatch: int, open_: int, extend: int,
                    off_edge: int, jump_score: int, *,
                    lanes: int = 0) -> torch.Tensor:
    """Best jump-alignment score per row, int32 (B,), on the query's
    device. Padded widths are the tensors' own widths. ``extend`` must
    not be positive. ``lanes`` (one of LANE_CHOICES) overrides the
    kernel's own choice of layout (``kernel_layout``), for the tests and
    the timing tool's sweep that the choice rests on; it changes the
    time, never the result. A launch of several warps per row leaves an
    error word that ``raise_on_kernel_error`` reads."""
    _check_batch(query, query_len, ref1, ref1_len, ref2, ref2_len)
    dev = query.device
    B, nq = query.shape
    lib = _lib()
    if nq > lib.mt_cuda_jump_score_max_nq():
        raise ValueError(f"query width {nq} exceeds the CUDA jump kernel's "
                         f"limit {lib.mt_cuda_jump_score_max_nq()}")
    lanes = int(lanes)
    if int(extend) > 0:
        raise ValueError(f"extend must not be positive, got {extend}")
    _check_lanes(lanes, lib.mt_cuda_jump_score_strips(nq, lanes or 1), nq)
    out = torch.empty(B, dtype=torch.int32, device=dev)
    if B == 0:
        return out
    nr1, nr2 = ref1.shape[1], ref2.shape[1]
    n_scratch = int(lib.mt_cuda_jump_score_scratch_bytes(B, nq, nr1, nr2,
                                                         lanes))
    scratch = _scratch(n_scratch, dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.mt_cuda_jump_score(
            query.data_ptr(), query_len.data_ptr(), ref1.data_ptr(),
            ref1_len.data_ptr(), ref2.data_ptr(), ref2_len.data_ptr(),
            out.data_ptr(), B, nq, nr1, nr2,
            int(match), int(mismatch), int(open_), int(extend),
            int(off_edge), int(jump_score),
            scratch.data_ptr() if n_scratch else None, n_scratch, lanes,
            stream)
    if err != 0:
        raise RuntimeError(f"CUDA jump kernel launch failed: cudaError {err}")
    KERNEL_LAUNCHES["jump_score"] += 1
    _keep_for_error_check(scratch)
    return out


def jump_score_flagged_cuda(query, query_len, ref1, ref1_len, ref2,
                            ref2_len, match: int, mismatch: int, open_: int,
                            extend: int, off_edge: int, jump_score: int,
                            prefix_rounds: int, *, lanes: int = 0):
    """The jump DP with the insert chain bounded to 2^prefix_rounds
    lanes: (best, flag), both int32 (B,) on the query's device; flag is
    1 on the rows whose score may differ from the exact chain's, else
    0. ``lanes`` as in ``jump_score_cuda``; the kernel's own choice is
    ``bounded_kernel_layout``'s. A window of thousands of lanes on a
    query too wide for one warp needs more shared memory than a block
    has and raises. A launch of several warps per row leaves an error
    word that ``raise_on_kernel_error`` reads."""
    if int(prefix_rounds) < 1:
        raise ValueError(f"prefix_rounds must be >= 1, got {prefix_rounds}")
    _check_batch(query, query_len, ref1, ref1_len, ref2, ref2_len)
    dev = query.device
    B, nq = query.shape
    rounds, lanes = int(prefix_rounds), int(lanes)
    lib = _bounded_lib()
    if nq > lib.mt_cuda_jump_score_flagged_max_nq():
        raise ValueError(
            f"query width {nq} exceeds the bounded CUDA jump kernel's "
            f"limit {lib.mt_cuda_jump_score_flagged_max_nq()}")
    if int(extend) > 0:
        raise ValueError(f"extend must not be positive, got {extend}")
    _check_lanes(lanes, (nq + 32 * lanes) // (32 * lanes) if lanes else 0,
                 nq)
    best = torch.empty(B, dtype=torch.int32, device=dev)
    flag = torch.empty(B, dtype=torch.int32, device=dev)
    if B == 0:
        return best, flag
    nr1, nr2 = ref1.shape[1], ref2.shape[1]
    n_scratch = int(lib.mt_cuda_jump_score_flagged_scratch_bytes(
        B, nq, nr1, nr2, rounds, lanes))
    if n_scratch < 0 or lib.mt_cuda_jump_score_flagged_shared_bytes(
            nq, rounds, lanes or lib.mt_cuda_jump_score_flagged_auto_lanes(
                B, nq, rounds)) > max_shared_bytes():
        raise ValueError(
            f"prefix_rounds {rounds} at query width {nq}"
            + (f" and {lanes} lanes per thread" if lanes else "")
            + f" needs more than the {max_shared_bytes()} bytes of shared "
            "memory a block has")
    scratch = _scratch(n_scratch, dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.mt_cuda_jump_score_flagged(
            query.data_ptr(), query_len.data_ptr(), ref1.data_ptr(),
            ref1_len.data_ptr(), ref2.data_ptr(), ref2_len.data_ptr(),
            best.data_ptr(), flag.data_ptr(), B, nq, nr1, nr2,
            int(match), int(mismatch), int(open_), int(extend),
            int(off_edge), int(jump_score), rounds,
            scratch.data_ptr() if n_scratch else None, n_scratch, lanes,
            stream)
    if err != 0:
        raise RuntimeError(
            f"bounded CUDA jump kernel launch failed: cudaError {err}")
    KERNEL_LAUNCHES["jump_score_bounded"] += 1
    _keep_for_error_check(scratch)
    return best, flag


def rerun_flagged(best, flag, exact_fn, tensors):
    """Replace ``best`` on the rows where ``flag`` != 0 by
    ``exact_fn(*rows of tensors)``; the rows are gathered on the
    tensors' device. Returns (scores, n_flagged)."""
    rows = torch.nonzero(flag, as_tuple=False)[:, 0]
    n = int(rows.numel())
    if n:
        best = best.clone()
        best[rows] = exact_fn(*(t.index_select(0, rows).contiguous()
                                for t in tensors))
    return best, n


def jump_score_bounded_cuda(query, query_len, ref1, ref1_len, ref2,
                            ref2_len, match: int, mismatch: int, open_: int,
                            extend: int, off_edge: int, jump_score: int,
                            prefix_rounds: int):
    """Exact scores through the bounded kernel plus a rerun of the
    flagged rows, gathered on the device, through ``jump_score_cuda``:
    (scores int32 (B,), n_flagged). Reading n_flagged waits for the
    bounded kernel."""
    scores = (match, mismatch, open_, extend, off_edge, jump_score)
    tensors = (query, query_len, ref1, ref1_len, ref2, ref2_len)
    best, flag = jump_score_flagged_cuda(*tensors, *scores, prefix_rounds)
    return rerun_flagged(
        best, flag, lambda *t: jump_score_cuda(*t, *scores), tensors)
