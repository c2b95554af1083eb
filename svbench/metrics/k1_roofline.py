"""K1 (``csrc/jump_score.cu``, reached through ``candidates/processor`` ->
``align/device_jumpscore``): percent of its roofline in the traced
sample. The bound is the useful DP cells the workers' counters hold
(``KERNEL_WORK``) at ``svbench/roofline.py``'s operations a cell and the
int32 peak; the time is the kernel's records in the workers' device
traces."""

from svbench.kernels import kernel_reading


def read(run):
    return kernel_reading(run, "jump_score")
