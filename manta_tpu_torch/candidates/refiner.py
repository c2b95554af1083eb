"""Assembly refiner whose device jump backend is the port's scorer.

Counterpart of ``manta_tpu/candidates/refiner.py:669-682``. The base
class binds ``jump_score_backend="device"`` to
``manta_tpu.align.device_jumpscore.make_bucketed_scorer``, which imports
JAX. This subclass builds the base with the JAX-free ``"native"``
backend and then, in this one place, rebinds ``_jump_score_backend``
(the seam ``candidates/processor.py:174`` calls) to the port's
``make_bucketed_scorer`` on ``device``. Everything else is the base
class unchanged.
"""

from __future__ import annotations

from manta_tpu.candidates.refiner import SVCandidateAssemblyRefiner

from ..align.device_jumpscore import make_bucketed_scorer


class TorchAssemblyRefiner(SVCandidateAssemblyRefiner):
    def __init__(self, *args, jump_score_backend: str | None = "native",
                 device=None, **kwargs):
        """``jump_score_backend``: ``"native"`` (host score batch),
        ``"device"`` (the port's bucketed scorer on ``device``) or None,
        as in the base class."""
        if jump_score_backend not in ("native", "device", None):
            raise ValueError(
                f"unknown jump_score_backend {jump_score_backend!r}")
        base_backend = None if jump_score_backend is None else "native"
        super().__init__(*args, jump_score_backend=base_backend, **kwargs)
        if jump_score_backend == "device":
            if device is None:
                raise ValueError("the device jump backend needs a device")
            self._jump_score_backend = make_bucketed_scorer(
                self.opt.spanning_scores, self.opt.jump_score, device)
