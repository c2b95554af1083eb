"""The port's scan-parallel split scoring (manta_tpu_torch.parallel.
scan_parallel) on 8 CPU shards and on a 2 x 4 mesh, vs the port's
single-device matmul scan and manta_tpu's scan-parallel form.

Inputs are made from a seed with numpy (the workloads of
tests/test_scan_parallel.py) and handed to both packages. Tolerance:
positions equal exactly to the port's single-device scan and to JAX's
sharded result; scores equal exactly between the port's sharded and
single-device results, and within rtol 1e-6 / atol 1e-4 of JAX's: the
matmul form's float32 sums run over a few hundred terms in another
order in the two packages (the same atol tests/test_torch_splitscore.py
gives the matmul form across packages)."""

import numpy as np
import pytest
import torch

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from manta_tpu.align.device_splitscore import make_luts as jax_make_luts
from manta_tpu.parallel.scan_parallel import (
    junction_split_score_scan_parallel as jax_scan_parallel,
)
from manta_tpu_torch.align.device_splitscore import make_luts
from manta_tpu_torch.align.device_splitscore_mxu import junction_split_score
from manta_tpu_torch.parallel.mesh import Mesh as TorchMesh
from manta_tpu_torch.parallel.mesh import make_mesh, make_mesh_2d
from manta_tpu_torch.parallel.scan_parallel import (
    combine_shards, junction_split_score_scan_parallel,
)

from test_scan_parallel import BASES, _workload
from test_torch_splitscore import one_torch_thread  # noqa: F401  (autouse)


def _torch(args):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in args)


def _luts():
    return tuple(torch.from_numpy(a) for a in make_luts(0.0))


def _invalid_workload():
    """tests/test_scan_parallel.py:62: a junction whose scan window lies
    outside every shard's grid."""
    T = 64
    rng = np.random.default_rng(3)
    G, R, L = 1, 2, 40
    reads = BASES[rng.integers(0, 4, (G, R, L))].copy()
    quals = np.full((G, R, L), 30, np.uint8)
    read_len = np.full((G, R), L, np.int32)
    targets = BASES[rng.integers(0, 4, (G, T))].copy()
    return (reads, quals, targets, np.array([40], np.int32),
            np.array([60], np.int32), np.array([61], np.int32), read_len,
            np.full(G, T, np.int32))


def _jax_sharded(args, n_scan, shape, names, batch_axis=None):
    lut_m, lut_x = jax_make_luts(0.0)
    mesh = Mesh(np.asarray(jax.devices()[:8]).reshape(shape), names)
    if batch_axis:
        sh = NamedSharding(mesh, P(batch_axis))
        args = tuple(jax.device_put(a, sh) for a in args)
    best, pos = jax_scan_parallel(mesh, *args, 50, lut_m, lut_x,
                                  n_scan=n_scan, batch_axis=batch_axis)
    return np.asarray(best), np.asarray(pos)


def _check(args, n_scan, mesh, jax_result, batch_axis=None):
    t = _torch(args)
    want_best, want_pos = junction_split_score(*t, 50, *_luts(),
                                               n_scan=n_scan)
    best, pos = junction_split_score_scan_parallel(
        mesh, *t, 50, *_luts(), n_scan=n_scan, batch_axis=batch_axis)
    assert best.dtype == torch.float32 and pos.dtype == torch.int32
    assert best.shape == want_best.shape == pos.shape
    np.testing.assert_array_equal(pos.numpy(), want_pos.numpy())
    np.testing.assert_array_equal(best.numpy(), want_best.numpy())
    jax_best, jax_pos = jax_result
    np.testing.assert_array_equal(pos.numpy(), jax_pos)
    fin = np.isfinite(jax_best)
    np.testing.assert_array_equal(np.isfinite(best.numpy()), fin)
    np.testing.assert_allclose(best.numpy()[fin], jax_best[fin], rtol=1e-6,
                               atol=1e-4)
    return best


def test_scan_parallel_matches_single_device_and_jax():
    T = 256
    args = _workload(T=T)
    _check(args, T, make_mesh(8, axis="scan", device="cpu"),
           _jax_sharded(args, T, (-1,), ("scan",)))


def test_scan_parallel_all_invalid_fallback():
    """All shards -inf: the position falls back to scan_start, as in
    the single-device scan."""
    args = _invalid_workload()
    best = _check(args, 24, make_mesh(8, axis="scan", device="cpu"),
                  _jax_sharded(args, 24, (-1,), ("scan",)))
    assert torch.isneginf(best).all()


def test_scan_parallel_2d_mesh():
    """2-D (edge x scan) mesh: junctions data-parallel over 'edge', scan
    positions sequence-parallel over 'scan'."""
    T = 128
    args = _workload(G=4, R=4, L=48, T=T, seed=9)
    mesh = make_mesh_2d((2, 4), ("edge", "scan"), device="cpu")
    assert mesh.shape == {"edge": 2, "scan": 4} and mesh.size == 8
    _check(args, T, mesh,
           _jax_sharded(args, T, (2, 4), ("edge", "scan"), "edge"),
           batch_axis="edge")


def test_combine_takes_the_lowest_position_among_ties():
    best = torch.tensor([[1.0, -np.inf], [1.0, -np.inf], [0.5, -np.inf]])
    pos = torch.tensor([[7, 30], [3, 20], [1, 25]], dtype=torch.int32)
    gbest, gpos = combine_shards(best, pos)
    assert gbest.tolist() == [1.0, -np.inf] and gpos.tolist() == [3, 20]


def test_mesh_rejects_what_it_cannot_cut():
    args = _torch(_workload(G=3, R=2, L=16, T=128))
    with pytest.raises(ValueError, match="scan shards"):
        junction_split_score_scan_parallel(
            make_mesh(3, axis="scan", device="cpu"), *args, 50, *_luts(),
            n_scan=128)
    with pytest.raises(ValueError, match="batch shards"):
        junction_split_score_scan_parallel(
            make_mesh_2d((2, 2), ("edge", "scan"), device="cpu"), *args, 50,
            *_luts(), n_scan=128, batch_axis="edge")
    with pytest.raises(ValueError, match="axis names"):
        TorchMesh(np.empty((2, 2), dtype=object), ("data",))
    with pytest.raises(RuntimeError, match="CUDA devices"):
        make_mesh(10 ** 6)
