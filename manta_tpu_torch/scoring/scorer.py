"""SV scorer whose device split scan is the port's.

Counterpart of ``manta_tpu/scoring/scorer.py:260-289``. The base class
binds ``use_device_scoring="exact"|"mxu"`` to
``manta_tpu.scoring.device_scan.DeviceScanContext``, which imports JAX.
This subclass builds the base with ``use_device_scoring=None`` and then,
in this one place, sets ``_device_scan`` (the seam
``SVScorer._score_split_reads`` routes breakends with at least 32
candidate reads to) to the port's context on ``device``. Everything
else, the routing test included, is the base class unchanged.
"""

from __future__ import annotations

from manta_tpu.scoring.scorer import SVScorer

from .device_scan import DeviceScanContext


class TorchSVScorer(SVScorer):
    def __init__(self, *args, use_device_scoring: bool | str | None = None,
                 device=None, **kwargs):
        """``use_device_scoring``: ``"exact"`` or ``True`` (the exact
        split scan on ``device``), ``"mxu"`` (the matmul form), or
        anything else for the native host scan, as in the base class."""
        super().__init__(*args, use_device_scoring=None, **kwargs)
        if use_device_scoring in ("exact", "mxu", True):
            if device is None:
                raise ValueError("the device split scan needs a device")
            self._device_scan = DeviceScanContext(
                mxu=(use_device_scoring == "mxu"), device=device)
