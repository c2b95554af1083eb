"""Scan-position (sequence-parallel) sharding of split-read scoring.

Counterpart of ``manta_tpu/parallel/scan_parallel.py``. The matmul
junction scan (``align/device_splitscore_mxu``) evaluates an (R reads x
S scan positions) score matrix per junction. For very long targets S is
the long axis, the domain's analogue of sequence length. This module
cuts S over a mesh axis: every shard scores ALL reads against its
contiguous slice of scan positions (the shard's grid offset rides in
through the scan's ``s0`` operand), then one combine runs over the
shards' results, gathered on the mesh's first device: the maximum
score, and the lowest position among ties. JAX does the combine with
``pmax`` and a masked ``pmin`` inside ``shard_map``; here it is a plain
function on the stacked results.

Tie-breaking matches the single-device scan: the winning position is
the LOWEST scan position among score ties, which argmax gives for free
within a shard and the masked minimum restores across shards.
"""

from __future__ import annotations

import torch

from ..align.device_splitscore_mxu import junction_split_score
from .mesh import Mesh

_BIG_POS = 2**31 - 1


def combine_shards(best, pos):
    """(n_shards, ...) per-shard (best, pos) -> the global pair: the
    maximum score over shards and the lowest position among the shards
    that reach it. ``>=`` keeps the ties of -inf with -inf: a shard
    without a valid scan position never wins unless ALL are -inf, and
    then the position is the lowest per-shard fallback (scan_start), as
    in the single-device scan."""
    gbest = best.max(dim=0).values
    tie = best >= gbest[None]
    big = torch.full_like(pos, _BIG_POS)
    return gbest, torch.where(tie, pos, big).min(dim=0).values


def junction_split_score_scan_parallel(
        mesh: Mesh, reads, quals, targets, s0, bp_beg, bp_end,
        read_len, target_len, flank_score_size, ln_match_lut, ln_mism_lut,
        n_scan: int, scan_axis: str = "scan",
        batch_axis: str | None = None):
    """Scan-parallel junction_split_score over ``mesh[scan_axis]``.

    Operands follow align/device_splitscore_mxu.junction_split_score, as
    tensors on any device. The junction batch dim G may additionally be
    cut over ``mesh[batch_axis]`` (2-D edge x scan decomposition).
    ``n_scan`` must divide evenly by the scan-axis size, and G by the
    batch-axis size.

    Returns (best_lnlhood, best_pos): (G, R) float32 / int32 on the
    mesh's first device, equal to the single-device scan's output
    (bit-equal scores; positions equal under the lowest-position tie
    rule)."""
    n_shards = mesh.shape[scan_axis]
    if n_scan % n_shards:
        raise ValueError(f"n_scan {n_scan} does not divide over "
                         f"{n_shards} scan shards")
    local_scan = n_scan // n_shards
    n_batch = mesh.shape[batch_axis] if batch_axis else 1
    G = reads.shape[0]
    if G % n_batch:
        raise ValueError(f"{G} junctions do not divide over {n_batch} "
                         f"batch shards")
    per = G // n_batch
    home = mesh.devices.flat[0]
    batched = (reads, quals, targets, s0, bp_beg, bp_end, read_len,
               target_len)

    def device_at(bi, si):
        index = [0] * mesh.devices.ndim
        index[mesh.axis(scan_axis)] = si
        if batch_axis:
            index[mesh.axis(batch_axis)] = bi
        return mesh.devices[tuple(index)]

    # every shard's scan is enqueued before any result is gathered
    results = []
    for bi in range(n_batch):
        rows = slice(bi * per, (bi + 1) * per)
        for si in range(n_shards):
            dev = device_at(bi, si)
            ops = [t[rows].to(dev) for t in batched]
            # contiguous slice of the scan grid for this shard
            ops[3] = ops[3] + si * local_scan
            results.append(junction_split_score(
                *ops, flank_score_size, ln_match_lut.to(dev),
                ln_mism_lut.to(dev), n_scan=local_scan))
    out_best, out_pos = [], []
    for bi in range(n_batch):
        mine = results[bi * n_shards:(bi + 1) * n_shards]
        best, pos = combine_shards(
            torch.stack([b.to(home) for b, _p in mine]),
            torch.stack([p.to(home) for _b, p in mine]))
        out_best.append(best)
        out_pos.append(pos)
    return torch.cat(out_best), torch.cat(out_pos)
