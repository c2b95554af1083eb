"""manta_tpu_torch: the manta_tpu SV caller on PyTorch and CUDA (Hopper).

A second package beside ``manta_tpu``, and independent of it: it imports
``torch``, never ``jax``, and nothing of ``manta_tpu``. The host layers
(``_native``, ``core``, ``io``, ``align.aligners``, ``assembly``,
``scan``, ``graph``, ``candidates``, ``scoring``, ``format``,
``workflow.tasks|stats|postprocess|config``, ``options``, and the
command-line tools ``tools.test_assembler|workers|convert_inversion|
denovo_scoring|svloci``) are the port's own copies of the JAX package's
JAX-free modules, under the same names; they load the same native core
source (``native/manta_core.cpp``), which the port builds into its own
``build/`` (``_native``) and never writes under ``native/``.

What replaces the JAX package's device code:

- ``align.device_jumpscore``: batched contig jump scoring, the plain
  PyTorch forms (exact and bounded-chain) and the bucketed scorer
  (``manta_tpu.align.device_jumpscore``);
- ``align.cuda_jumpscore`` + ``csrc/jump_score.cu``,
  ``csrc/jump_score_bounded.cu`` (both on ``csrc/jump_systolic.cuh``): the
  hand-written Hopper kernels that replace the Pallas kernel
  ``manta_tpu.align.pallas_jumpscore._kernel`` in its exact and its
  bounded-chain form;
- ``align.device_splitscore``, ``align.device_splitscore_mxu``: the
  split-read scan, its plain PyTorch form and its matmul form
  (``manta_tpu.align.device_splitscore``, ``..._mxu``);
- ``align.cuda_splitscore`` + ``csrc/split_score.cu``: the hand-written
  Hopper kernel that replaces the Pallas kernel
  ``manta_tpu.align.pallas_splitscore._kernel``;
- ``scoring.device_scan``: the split-scan router
  (``--device-scoring exact|mxu``), built by ``scoring.scorer``;
- ``parallel.forkpool``: the fork-result drain;
- ``parallel.mesh``, ``parallel.scan_parallel``,
  ``parallel.mesh_scoring``, ``parallel.phase1_mesh``,
  ``parallel.distributed``: a mesh of torch devices, the scan and the
  contig scorer cut over it, the phase-1 gates as tensors, and the
  multi-host phases over ``torch.distributed``
  (``manta_tpu.parallel.*``);
- ``graft_entry``: ``entry()`` and the multi-device dry run
  ``dryrun_multichip`` (the repository's ``__graft_entry__.py``);
- ``workflow.run``: the workflow and its CLI
  (``python -m manta_tpu_torch.workflow.run``);
- ``tools.device_timing``: kernel timing on the card
  (``python -m manta_tpu_torch.tools.device_timing``), the counterpart
  of ``benchmarks/device_timing.py``;
- ``tools.wgs_workload``, ``tools.stress_workload``: the generators of
  the WGS-shaped and the high-spanning-contig workloads, byte for byte
  those of ``benchmarks/wgs_workload.py`` and
  ``benchmarks/stress_workload.py``;
- ``native_core``: loads the native core on hosts that lack
  ``libdeflate``;
- ``_build``: builds the CUDA and C sources under ``csrc/`` at first
  use into ``build/``.
"""

__version__ = "0.1.0"
