"""Device-mesh helpers for multi-GPU scale-out.

Counterpart of ``manta_tpu/parallel/mesh.py``. The phase-2 hot path
(candidate scoring: split-read scans, contig jump scores) is
embarrassingly parallel over candidates and edges, so the primary mesh
axis is data-parallel ``data`` over the batch dimension. JAX's mesh is
single-controller: one process, a list of devices, shardings named by
axis. This one is the same thing written out: a small ``Mesh`` that
holds an n-dimensional array of ``torch.device`` with named axes, and
the callers cut their batches over an axis themselves and run each
slice on its device (``mesh_scoring``, ``scan_parallel``). There is no
global default device and no ``torch.distributed`` here.

``device=None`` means the card: the first ``n_devices`` CUDA devices.
``device="cpu"`` gives ``n_devices`` shards that all live on the CPU,
the counterpart of JAX's virtual CPU devices, which is how the tests
run 8 shards on a host without a card.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


@dataclass(frozen=True)
class Mesh:
    """An n-dimensional array of devices with one name per axis."""
    devices: np.ndarray                  # object array of torch.device
    axis_names: tuple[str, ...]

    def __post_init__(self):
        if self.devices.ndim != len(self.axis_names):
            raise ValueError(f"{self.devices.ndim}-D device array, "
                             f"{len(self.axis_names)} axis names")

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def axis(self, name: str) -> int:
        return self.axis_names.index(name)


def mesh_devices(n_devices: int | None = None, device=None) -> list:
    """The first ``n_devices`` devices of the kind ``device`` names: CUDA
    devices for None or "cuda" (all of them when ``n_devices`` is None),
    ``n_devices`` times the CPU for "cpu". Raises where the host has
    fewer CUDA devices than asked for. ``torch.cuda.device_count()`` asks
    NVML and does not initialise CUDA, so a later fork still can."""
    kind = torch.device("cuda" if device is None else device).type
    if kind == "cpu":
        return [torch.device("cpu")] * (1 if n_devices is None
                                        else int(n_devices))
    if kind != "cuda":
        raise ValueError(f"no mesh of {kind} devices")
    have = torch.cuda.device_count()
    n = have if n_devices is None else int(n_devices)
    if n < 1 or n > have:
        raise RuntimeError(f"need {n} CUDA devices, have {have}; pass "
                           "device='cpu' for a mesh of CPU shards")
    return [torch.device("cuda", i) for i in range(n)]


def make_mesh(n_devices: int | None = None, axis: str = "data",
              device=None) -> Mesh:
    """A 1-D data-parallel mesh over the first n_devices devices."""
    devs = mesh_devices(n_devices, device)
    arr = np.empty(len(devs), dtype=object)
    arr[:] = devs
    return Mesh(arr, (axis,))


def make_mesh_2d(shape: tuple[int, int], axis_names: tuple[str, str],
                 device=None) -> Mesh:
    """A 2-D mesh (e.g. edge x scan) over the first shape[0] * shape[1]
    devices, row-major."""
    devs = mesh_devices(shape[0] * shape[1], device)
    arr = np.empty(len(devs), dtype=object)
    arr[:] = devs
    return Mesh(arr.reshape(shape), tuple(axis_names))


def shard_batch_spec(mesh: Mesh, axis: str = "data"):
    """(batch-sharded, replicated) placements for kernel operands: two
    functions from a host or device tensor to its per-device pieces. The
    first cuts dim 0 into ``mesh.shape[axis]`` equal contiguous slices,
    one on each device along ``axis``; the second puts a copy on each.
    On a mesh of several axes the devices along ``axis`` at index 0 of
    the others are taken."""
    ax = mesh.axis(axis)
    index = [0] * mesh.devices.ndim
    index[ax] = slice(None)
    devs = list(mesh.devices[tuple(index)])

    def batch_sharded(t):
        if t.shape[0] % len(devs):
            raise ValueError(f"batch of {t.shape[0]} does not divide over "
                             f"{len(devs)} devices")
        return [piece.to(d) for piece, d in
                zip(torch.chunk(t, len(devs), dim=0), devs)]

    def replicated(t):
        return [t.to(d) for d in devs]

    return batch_sharded, replicated
