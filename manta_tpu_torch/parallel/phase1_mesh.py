"""Phase-1 read-gate math on the device mesh (the genome-bin axis).

Counterpart of ``manta_tpu/parallel/phase1_mesh.py``. Phase 1's per-read
work (core filters, pair-orientation and template-length gates feeding
the SV-evidence decision) is pure elementwise mask arithmetic over
fixed-width read columns. The production pipeline runs it on the host;
this module is the tensor twin of the numpy building blocks in
``core/readfilter.py``, held bit-identical by the tests and executed
under the multi-device dry run's genome-bin mesh axis.

Mapping: reads arrive position-sorted; cutting the read axis over the
mesh's "data" axis IS the genome-bin decomposition (contiguous position
ranges per device). The per-shard evidence counts reduce with one sum,
the only cross-bin coupling phase 1 has before graph merge.
"""

from __future__ import annotations

import torch

from ..io.bam import (
    FLAG_DUP, FLAG_MATE_REVERSE, FLAG_MATE_UNMAPPED, FLAG_PAIRED,
    FLAG_QCFAIL, FLAG_REVERSE, FLAG_SECONDARY, FLAG_SUPPLEMENTARY,
    FLAG_UNMAPPED,
)


def read_gate_masks(flag, mapq, pos, next_pos, refid, next_refid, tlen,
                    sa, min_mapq: int, min_tlen: int, max_tlen: int):
    """Tensor twin of the phase-1 per-read gates.

    Inputs are int32/bool tensors of one shard's reads (any shape, all
    equal, one device); ``sa`` marks reads carrying an SA tag. Returns
    (core_bad, innie, anomalous, candidate) bool tensors:

    - core_bad: io gate: qcfail/dup, secondary/supplementary without
      SA, unmapped (core/readfilter.is_read_unmapped_or_filtered_core)
    - innie: FR pair on one chromosome with consistent strand/position
      order (core/readfilter.is_innie_pair)
    - anomalous: mapped pair that is NOT a proper innie within the
      fragment-size window [min_tlen, max_tlen], the pair-evidence
      trigger
    - candidate: survives core gate + mapq and is anomalous, the shard's
      contribution to evidence counts
    """
    f = flag
    core_bad = (f & (FLAG_QCFAIL | FLAG_DUP)) != 0
    core_bad = core_bad | (((f & FLAG_SUPPLEMENTARY) != 0) & ~sa)
    core_bad = core_bad | (((f & FLAG_SECONDARY) != 0) & ~sa)
    core_bad = core_bad | ((f & FLAG_UNMAPPED) != 0)

    mapped_pair = ((f & FLAG_PAIRED) != 0) & \
        ((f & (FLAG_UNMAPPED | FLAG_MATE_UNMAPPED)) == 0)
    chrom_pair = mapped_pair & (refid == next_refid) & (refid >= 0)
    fwd = (f & FLAG_REVERSE) == 0
    mate_fwd = (f & FLAG_MATE_REVERSE) == 0
    innie = chrom_pair & (fwd != mate_fwd)
    left = pos < next_pos
    right = pos > next_pos
    innie = innie & ~(left & ~fwd)
    innie = innie & ~(right & fwd)

    atl = torch.abs(tlen)
    proper = innie & (atl >= min_tlen) & (atl <= max_tlen)
    anomalous = mapped_pair & ~proper

    candidate = ~core_bad & (mapq >= min_mapq) & anomalous
    return core_bad, innie, anomalous, candidate


def shard_evidence_counts(candidate):
    """One shard's evidence count (an int32 scalar tensor on the shard's
    device); the shards' counts add up to the run's, the phase-1
    analogue of the reference's per-segment counter merge."""
    return candidate.sum(dtype=torch.int32)
