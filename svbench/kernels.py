"""A kernel's roofline share from the traced sample's workers: their
counters (launches and useful work when their bin was written) and
their device traces (the kernel's records, matched by name)."""

from __future__ import annotations

from svbench import roofline


def kernel_reading(run: dict, kernel: str) -> float | None:
    armed = run.get("armed")
    if not armed:
        return None
    fragment = roofline.KERNELS[kernel][0]
    launches = useful = nbytes = traced = 0
    device_s = 0.0
    for w in armed["workers"]:
        counts = w.get("counts") or {}
        launches += counts.get("launches", {}).get(kernel, 0)
        work = counts.get("work", {}).get(kernel, {})
        useful += work.get("useful", 0)
        nbytes += work.get("bytes", 0)
        for name, _t, d in w.get("events") or []:
            if fragment in name:
                traced += 1
                device_s += d / 1e9
    return roofline.share_pct(kernel, useful, nbytes, launches, device_s,
                              traced)
