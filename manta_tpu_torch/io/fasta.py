"""FASTA reference reader with .fai index support.

Reference analogue: samtools_fasta_util.cpp region fetch in the
reference's htsapi layer.
"""

from __future__ import annotations

import numpy as np


class FastaReader:
    def __init__(self, path: str):
        self.path = path
        self._index: dict[str, tuple[int, int, int, int]] = {}
        self.names: list[str] = []
        with open(path + ".fai") as f:
            for line in f:
                parts = line.rstrip("\n").split("\t")
                if len(parts) < 5:
                    continue
                name, length, offset, linebases, linewidth = parts[:5]
                self._index[name] = (
                    int(length), int(offset), int(linebases), int(linewidth)
                )
                self.names.append(name)
        self._f = open(path, "rb")

    def chrom_length(self, name: str) -> int:
        return self._index[name][0]

    def fetch(self, name: str, beg: int, end: int) -> bytes:
        """Uppercased sequence for 0-based half-open [beg, end).

        Out-of-range positions are clamped to the chromosome; callers that
        need padding should check lengths.
        """
        length, offset, linebases, linewidth = self._index[name]
        beg = max(0, beg)
        end = min(length, end)
        if beg >= end:
            return b""
        start_off = offset + (beg // linebases) * linewidth + (beg % linebases)
        end_off = offset + ((end - 1) // linebases) * linewidth + ((end - 1) % linebases) + 1
        self._f.seek(start_off)
        raw = self._f.read(end_off - start_off)
        return raw.replace(b"\n", b"").replace(b"\r", b"").upper()

    def fetch_arr(self, name: str, beg: int, end: int) -> np.ndarray:
        return np.frombuffer(self.fetch(name, beg, end), dtype=np.uint8)
