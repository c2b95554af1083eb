"""The card, read through NVML without making a CUDA context: the
workflow forks its workers after set-up, and a process that has made a
context cannot hand CUDA to a forked child. Name, power limit, and the
device memory in use, sampled while samples run (the peak covers every
worker's context and allocations)."""

from __future__ import annotations

import ctypes
import os
import select
import subprocess
import sys


class _Memory(ctypes.Structure):
    _fields_ = [("total", ctypes.c_ulonglong), ("free", ctypes.c_ulonglong),
                ("used", ctypes.c_ulonglong)]


class Nvml:
    def __init__(self):
        self.lib = ctypes.CDLL("libnvidia-ml.so.1")
        if self.lib.nvmlInit_v2() != 0:
            raise RuntimeError("nvmlInit failed")
        self.handles = []
        count = ctypes.c_uint()
        self.lib.nvmlDeviceGetCount_v2(ctypes.byref(count))
        for i in range(count.value):
            h = ctypes.c_void_p()
            self.lib.nvmlDeviceGetHandleByIndex_v2(i, ctypes.byref(h))
            self.handles.append(h)

    def name(self, i: int = 0) -> str:
        buf = ctypes.create_string_buffer(96)
        self.lib.nvmlDeviceGetName(self.handles[i], buf, 96)
        return buf.value.decode()

    def power_limit_w(self, i: int = 0) -> float:
        mw = ctypes.c_uint()
        self.lib.nvmlDeviceGetPowerManagementLimit(self.handles[i],
                                                   ctypes.byref(mw))
        return mw.value / 1000.0

    def memory_used(self, i: int = 0) -> int:
        m = _Memory()
        self.lib.nvmlDeviceGetMemoryInfo(self.handles[i], ctypes.byref(m))
        return int(m.used)


class MemorySampler:
    """Peak device memory in use over the life of a ``with`` block, read
    every ``interval`` seconds by a child process (no thread of this
    process holds NVML when the workflow forks). Closing the child's
    stdin stops it; it prints the peak and exits."""

    def __init__(self, device: int = 0, interval: float = 0.1):
        self.device, self.interval = device, interval
        self.peak = 0
        self._proc = None

    def __enter__(self):
        self._proc = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), str(self.device),
             str(self.interval)],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True)
        return self

    def __exit__(self, *exc):
        out, _ = self._proc.communicate(timeout=60)
        self.peak = int(out.split()[-1])


def _sample(device: int, interval: float) -> None:
    nvml = Nvml()
    peak = 0
    while True:
        peak = max(peak, nvml.memory_used(device))
        ready, _, _ = select.select([sys.stdin], [], [], interval)
        if ready and not sys.stdin.read(1):
            break
    print(max(peak, nvml.memory_used(device)), flush=True)


if __name__ == "__main__":
    _sample(int(sys.argv[1]), float(sys.argv[2]))
