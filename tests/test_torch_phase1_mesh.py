"""The port's phase-1 read gates as tensors (manta_tpu_torch.parallel.
phase1_mesh) on the demo tumor BAM vs manta_tpu's jnp twin and the numpy
building blocks of core/readfilter.py. Tolerance: exact (bool masks and
an integer count)."""

import jax
import numpy as np
import torch

from manta_tpu.parallel.phase1_mesh import read_gate_masks as jax_gate_masks
from manta_tpu_torch.core.readfilter import has_sa_tag
from manta_tpu_torch.io.bam import BamReader
from manta_tpu_torch.parallel.mesh import make_mesh, shard_batch_spec
from manta_tpu_torch.parallel.phase1_mesh import (
    read_gate_masks, shard_evidence_counts,
)

from test_phase1_mesh import MAX_TLEN, MIN_MAPQ, MIN_TLEN, _cols, _host_masks

NAMES = ("core_bad", "innie", "anomalous", "candidate")


def test_tensor_gates_match_host_and_jax(tumor_bam):
    batch = BamReader(tumor_bam).read_all()
    sa = has_sa_tag(batch)
    cols = _cols(batch, sa)
    host = _host_masks(batch, sa)
    ours = read_gate_masks(*(torch.from_numpy(np.ascontiguousarray(c))
                             for c in cols), MIN_MAPQ, MIN_TLEN, MAX_TLEN)
    theirs = jax.jit(lambda *a: jax_gate_masks(*a, MIN_MAPQ, MIN_TLEN,
                                               MAX_TLEN))(*cols)
    for h, o, j, name in zip(host, ours, theirs, NAMES):
        assert o.dtype == torch.bool
        np.testing.assert_array_equal(o.numpy(), h, err_msg=name)
        np.testing.assert_array_equal(o.numpy(), np.asarray(j), err_msg=name)
    assert host[3].any() and not host[3].all()


def test_tensor_gates_under_mesh(tumor_bam):
    """Reads position-sorted and cut along the mesh data axis (the
    genome-bin decomposition) over 8 CPU shards: all four masks and the
    summed evidence count equal the host's."""
    n_dev = 8
    mesh = make_mesh(n_dev, device="cpu")
    batch = BamReader(tumor_bam).read_all()
    sa = has_sa_tag(batch)
    host = _host_masks(batch, sa)
    cols = _cols(batch, sa)
    n = len(cols[0])
    pad = (-n) % n_dev
    # padding rows: unmapped flag, so core_bad and never candidates
    fills = (0x4, 0, 0, 0, -1, -1, 0, False)
    sharded, _replicated = shard_batch_spec(mesh)
    ops = [sharded(torch.from_numpy(np.concatenate(
        [c, np.full(pad, fill, c.dtype)]))) for c, fill in zip(cols, fills)]
    masks, counts = [], []
    for i in range(n_dev):
        m = read_gate_masks(*(op[i] for op in ops), MIN_MAPQ, MIN_TLEN,
                            MAX_TLEN)
        masks.append(m)
        counts.append(shard_evidence_counts(m[3]))
    assert counts[0].dtype == torch.int32 and counts[0].dim() == 0
    assert int(torch.stack(counts).sum()) == int(host[3].sum())
    for k, name in enumerate(NAMES):
        got = torch.cat([m[k] for m in masks]).numpy()[:n]
        np.testing.assert_array_equal(got, host[k], err_msg=name)
