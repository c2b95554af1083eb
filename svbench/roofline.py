"""The yardstick of the kernels' roofline shares: the card's peaks, with
their sources, and the operations and bytes of the useful work.

Peaks of one NVIDIA H100 SXM5 at its full 700 W power limit:

- memory bandwidth 3.35 TB/s and float32 67 TFLOP/s outside the tensor
  cores (an FMA counted as two operations): NVIDIA H100 Tensor Core GPU
  data sheet, SXM column;
- int32: 132 SMs x 64 INT32 lanes x 1.98 GHz boost, 16.73 Tops/s: NVIDIA
  H100 Tensor Core GPU Architecture whitepaper (SM count, INT32 units a
  SM, boost clock of the SXM5 part).

Useful work, whatever implements it (padding, pad rows and bucket
columns count nothing):

- K1 (contig jump scoring): the DP cells of each contig job, contig
  length x (length of the first reference window + length of the
  second), as the port's ``KERNEL_WORK["jump_score"]["useful"]`` counts
  them. A cell of the second window's walk needs 14 int32 operations:
  the match or mismatch by comparison and select (2); the diagonal as the
  max of four states and the add (4); the deletion's open add, two maxes
  and extend add (4); the insertion's open add, max with the jump state,
  the chain's running max and extend add (4); the first window's walk
  has two more (the jump state) and the best end one. The smaller count
  is taken, so the bound is never overstated.
- K3 (split-read scan): the terms of each (read, target) pair, a read
  base at a valid scan position, as ``KERNEL_WORK["split_score"]
  ["useful"]`` counts them. A term needs one comparison of the read base
  with the target base and one float32 add of its ln-likelihood into the
  position's sum: 2 operations, against the float32 peak.
- Bytes: each useful input byte read once and each output byte written
  once. The counters hold the padded launches' bytes only, which bound
  the useful bytes from above; where even those take less time at the
  bandwidth peak than the operations at theirs, the operations bound the
  kernel, and that is the bound taken. Where they would not, the share is
  not read (``bound_s`` returns None).
"""

from __future__ import annotations

HBM_BYTES_S = 3.35e12
FP32_OPS_S = 67e12
INT32_OPS_S = 132 * 64 * 1.98e9
K1_OPS_PER_CELL = 14
K3_OPS_PER_TERM = 2

KERNELS = {
    # name: (profiler name fragment, ops a unit of useful work, peak)
    "jump_score": ("jump_systolic_kernel", K1_OPS_PER_CELL, INT32_OPS_S),
    "split_score": ("split_score_kernel", K3_OPS_PER_TERM, FP32_OPS_S),
}


def bound_s(kernel: str, useful: int, padded_bytes: int) -> float | None:
    """The least time the card could take for ``useful`` units of the
    kernel's work, or None where the byte term might set it."""
    _, ops, peak = KERNELS[kernel]
    t_ops = useful * ops / peak
    if padded_bytes / HBM_BYTES_S > t_ops:
        return None
    return t_ops


def share_pct(kernel: str, useful: int, padded_bytes: int, launches: int,
              device_s: float, traced_launches: int) -> float | None:
    """Percent of the roofline: the bound of the useful work of the
    launches that were traced, over their device time. The counters'
    work is taken a launch, since a profiler may drop a launch's record."""
    if not (useful and launches and traced_launches and device_s > 0):
        return None
    b = bound_s(kernel, useful, padded_bytes)
    if b is None:
        return None
    return 100.0 * b * traced_launches / launches / device_s
