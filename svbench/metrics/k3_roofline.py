"""K3 (``csrc/split_score.cu``, reached through ``scoring/device_scan``):
percent of its roofline in the traced sample: the useful terms the
workers' counters hold at ``svbench/roofline.py``'s operations a term
and the float32 peak, over the kernel's records in the workers' device
traces."""

from svbench.kernels import kernel_reading


def read(run):
    return kernel_reading(run, "split_score")
