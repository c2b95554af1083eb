"""manta_tpu_torch: the manta_tpu SV caller on PyTorch and CUDA (Hopper).

A second package beside ``manta_tpu``. It imports ``torch`` and never
``jax``. The JAX-free host layers of ``manta_tpu`` are imported
unchanged: ``io``, ``core``, ``scan``, ``graph``, ``candidates``,
``assembly``, ``scoring`` (its host parts), ``format``,
``align.aligners`` and the native core loader ``_native``.

This package owns what in ``manta_tpu`` touches JAX on the main path:

- ``align.device_jumpscore``: batched contig jump scoring, the plain
  PyTorch form and the bucketed scorer (``manta_tpu.align.device_jumpscore``);
- ``align.cuda_jumpscore`` + ``csrc/jump_score.cu``: the hand-written
  Hopper kernel that replaces the Pallas kernel
  ``manta_tpu.align.pallas_jumpscore._kernel``;
- ``align.device_splitscore``, ``align.device_splitscore_mxu``: the
  split-read scan, its plain PyTorch form and its matmul form
  (``manta_tpu.align.device_splitscore``, ``..._mxu``);
- ``align.cuda_splitscore`` + ``csrc/split_score.cu``: the hand-written
  Hopper kernel that replaces the Pallas kernel
  ``manta_tpu.align.pallas_splitscore._kernel``;
- ``scoring.device_scan``, ``scoring.scorer``: the split-scan router
  and the scorer bound to it (``--device-scoring exact|mxu``);
- ``candidates.refiner``: the assembly refiner bound to the port's scorer;
- ``core.chromdepth``: the chromosome-depth estimate with its fork
  fan-out, without JAX;
- ``parallel.forkpool``: the JAX-free fork-result drain;
- ``workflow.run``: the workflow and its CLI
  (``python -m manta_tpu_torch.workflow.run``);
- ``native_core``: loads ``manta_tpu``'s native core on hosts that lack
  ``libdeflate``;
- ``_build``: builds the CUDA and C sources under ``csrc/`` at first
  use into ``build/``.
"""

__version__ = "0.1.0"
