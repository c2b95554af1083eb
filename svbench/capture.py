"""What the window's kernels returned, kept for the comparison that
decides ``correct``.

``install(directory, seed)`` wraps the two seams of the port that reach
the device kernels, in the process that runs the workflow, before it
forks its phase-2 workers (which inherit the wrappers):

- the contig dispatcher's scorer (``align.device_jumpscore``
  ``make_bucketed_scorer``), which sends contig jobs to K1: every call's
  jobs and the scores it returned;
- the split router (``scoring.device_scan.DeviceScanContext.scan_multi``),
  which sends reads x junction targets to K3: the reads, quals, targets,
  breakend ranges, flank and SNP prior of one call in ``K3_EVERY``, chosen
  by a checksum of the call's inputs and the seed (the same calls on
  every run of a seed, whatever worker makes them), with the best
  ln-likelihoods and positions it returned.

Each kept call is one ``.npz`` file in ``directory``, written by the
process that made it. The wrappers add a checksum a call and a small
write on the kept ones to the window's host work; they change no
argument and no result. ``remove()`` restores the seams.
"""

from __future__ import annotations

import os
import zlib

import numpy as np

K3_EVERY = 16
_SAVED: dict = {}


def _write(directory: str, kind: str, arrays: dict) -> None:
    n = _SAVED.setdefault((os.getpid(), kind), [0])
    n[0] += 1
    path = os.path.join(directory, f"{kind}.{os.getpid()}.{n[0]}.npz")
    np.savez(path + ".tmp.npz", **arrays)
    os.replace(path + ".tmp.npz", path)


def _flat(seqs):
    lens = np.array([len(s) for s in seqs], np.int64)
    blob = (np.concatenate([np.frombuffer(bytes(s), np.uint8) for s in seqs])
            if seqs else np.zeros(0, np.uint8))
    return blob, lens


def snp_prior(qconv) -> float:
    """The SNP prior a qscore converter mixes into the basecall error,
    recovered from its error probabilities: p = s + qerr (1 - 4 s / 3)
    at q = 20."""
    qerr = 10.0 ** -2.0
    return float(round((qconv.p[20] - qerr) / (1.0 - 4.0 * qerr / 3.0), 12))


def install(directory: str, seed: int, k3_every: int = K3_EVERY):
    """Wrap the seams; returns a function that restores them."""
    from manta_tpu_torch.align import device_jumpscore
    from manta_tpu_torch.scoring import device_scan

    os.makedirs(directory, exist_ok=True)
    make_scorer = device_jumpscore.make_bucketed_scorer
    scan_multi = device_scan.DeviceScanContext.scan_multi

    def make_bucketed_scorer(scores, jump_score, device):
        inner = make_scorer(scores, jump_score, device)

        def scorer(jobs):
            res = inner(jobs)
            if len(jobs):
                q, ql = _flat([j[0] for j in jobs])
                r1, r1l = _flat([j[1] for j in jobs])
                r2, r2l = _flat([j[2] for j in jobs])
                _write(directory, "k1", dict(
                    q=q, ql=ql, r1=r1, r1l=r1l, r2=r2, r2l=r2l,
                    out=np.asarray(res, np.int64)))
            return res
        return scorer

    def wrapped_scan(self, flank_score_size, batch, read_idx, qconv,
                     targets, bp_ranges):
        best, pos = scan_multi(self, flank_score_size, batch, read_idx,
                               qconv, targets, bp_ranges)
        idx = np.asarray(read_idx, np.int64)
        beg, end = batch.seq_off[idx], batch.seq_off[idx + 1]
        reads = [batch.seq[b:e] for b, e in zip(beg, end)]
        quals = [batch.qual[b:e] for b, e in zip(batch.qual_off[idx],
                                                 batch.qual_off[idx + 1])]
        r, rl = _flat(reads)
        t, tl = _flat(targets)
        key = zlib.crc32(t.tobytes(), zlib.crc32(r.tobytes(), seed & 0xFFFF))
        if key % k3_every == 0:
            qb, _ = _flat(quals)
            _write(directory, "k3", dict(
                reads=r, read_len=rl, quals=qb, targets=t, target_len=tl,
                bp=np.asarray(bp_ranges, np.int64).reshape(-1, 2),
                flank=np.int64(flank_score_size),
                snp=np.float64(snp_prior(qconv)),
                best=np.asarray(best, np.float32),
                pos=np.asarray(pos, np.int32)))
        return best, pos

    device_jumpscore.make_bucketed_scorer = make_bucketed_scorer
    device_scan.DeviceScanContext.scan_multi = wrapped_scan

    def remove():
        device_jumpscore.make_bucketed_scorer = make_scorer
        device_scan.DeviceScanContext.scan_multi = scan_multi
    return remove


def load(directory: str, kind: str) -> list[dict]:
    """Every kept call of ``kind`` ("k1" or "k3"), in a fixed order."""
    names = sorted(n for n in os.listdir(directory)
                   if n.startswith(kind + ".") and n.endswith(".npz")
                   and ".tmp" not in n) if os.path.isdir(directory) else []
    out = []
    for n in names:
        with np.load(os.path.join(directory, n)) as z:
            out.append({k: z[k] for k in z.files})
    return out


def split(blob: np.ndarray, lens: np.ndarray) -> list[bytes]:
    off = np.concatenate([[0], np.cumsum(lens)])
    return [blob[off[i]:off[i + 1]].tobytes() for i in range(len(lens))]
