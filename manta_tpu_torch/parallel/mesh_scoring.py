"""Mesh-sharded phase-2 contig scoring backend.

Counterpart of ``manta_tpu/parallel/mesh_scoring.py``. A drop-in for
``align.device_jumpscore.make_bucketed_scorer`` that cuts the padded job
batch over a mesh's first axis instead of dispatching to one device:
each device scores its slice of the junction-contig jobs (the
hand-written jump kernel on a CUDA device, the plain form on the CPU,
never one for the other) and the results gather back to the host.
Scores are the same exact int32 jump DP (bit-identical to the host
traceback aligner), so routing through a mesh cannot change winner
selection: ``graft_entry.dryrun_multichip`` stage 5 runs the demo
workflow through this backend and diffs the somatic VCF against the
host-scored run.
"""

from __future__ import annotations

import numpy as np
import torch

from ..align.device_jumpscore import (
    _bucket, _score, pad_jobs, raise_on_kernel_error,
)
from .mesh import Mesh, shard_batch_spec

# every mesh-scorer call: jobs, padded rows and device slices scored
MESH_STATS = {"calls": 0, "jobs": 0, "rows": 0, "slices": 0}


def make_mesh_bucketed_scorer(mesh: Mesh, scores, jump_score: int):
    """Production-shaped bucketed scorer over an n-device mesh.

    Pads job batches to the bucketed scorer's shape buckets and pad
    sentinels and to a device-divisible batch, cuts the batch over the
    mesh's first axis and scores each slice on its device. On CUDA
    devices every slice's kernel is launched before any result is waited
    for. Returns numpy int32 scores of the jobs, in order."""
    n_dev = mesh.devices.shape[0]
    batch_sharded, _ = shard_batch_spec(mesh, mesh.axis_names[0])

    def scorer(jobs):
        B = len(jobs)
        if B == 0:
            return np.zeros(0, np.int32)
        Bp = _bucket(B, tiers=(8, 16, 32, 64, 128, 256))
        Bp = -(-Bp // n_dev) * n_dev           # device-divisible
        pieces = [batch_sharded(torch.from_numpy(a))
                  for a in pad_jobs(jobs, Bp)]
        outs = [_score(*t, scores, jump_score) for t in zip(*pieces)]
        res = np.concatenate([o.cpu().numpy() for o in outs])[:B]
        raise_on_kernel_error()
        MESH_STATS["calls"] += 1
        MESH_STATS["jobs"] += B
        MESH_STATS["rows"] += Bp
        MESH_STATS["slices"] += n_dev
        return res

    return scorer
