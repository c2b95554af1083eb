"""BGZF (blocked gzip) codec.

Implements the BGZF container from the SAM/BAM specification (SAMv1.pdf
section 4.1): a series of standard gzip members, each carrying a 'BC'
extra subfield holding BSIZE (total block length - 1), payload <= 64KiB.
Virtual file offsets are (compressed_block_start << 16) | within_block.

Capability-parity target: htslib's bgzf.c as used by the reference's
htsapi layer (reference: src/c++/lib/htsapi/bam_streamer.hpp).
"""

from __future__ import annotations

import io
import os
import struct
import zlib

# Fixed 28-byte EOF marker block from the SAM spec.
BGZF_EOF = bytes.fromhex(
    "1f8b08040000000000ff0600424302001b0003000000000000000000"
)

_HDR = struct.Struct("<4BI2B2H")  # magic(4) mtime xfl os xlen


def _parse_block_header(buf: bytes, off: int) -> tuple[int, int]:
    """Return (payload_offset, total_block_size) for the gzip member at off."""
    if buf[off : off + 4] != b"\x1f\x8b\x08\x04":
        raise ValueError(f"not a BGZF block at offset {off}")
    xlen = struct.unpack_from("<H", buf, off + 10)[0]
    xoff = off + 12
    xend = xoff + xlen
    bsize = -1
    while xoff < xend:
        si1, si2, slen = buf[xoff], buf[xoff + 1], struct.unpack_from("<H", buf, xoff + 2)[0]
        if si1 == 0x42 and si2 == 0x43 and slen == 2:
            bsize = struct.unpack_from("<H", buf, xoff + 4)[0] + 1
        xoff += 4 + slen
    if bsize < 0:
        raise ValueError(f"BGZF block at {off} missing BC subfield")
    return xend, bsize


def bgzf_decompress_all(data: bytes) -> bytes:
    """Decompress an entire BGZF byte string into one contiguous buffer."""
    out = []
    off = 0
    n = len(data)
    while off < n:
        payload_off, bsize = _parse_block_header(data, off)
        # payload runs to block end minus CRC32(4) + ISIZE(4)
        comp = data[payload_off : off + bsize - 8]
        if comp:
            out.append(zlib.decompress(comp, wbits=-15))
        off += bsize
    return b"".join(out)


def bgzf_compress_block(payload: bytes, level: int = 6) -> bytes:
    """Compress <=64KiB payload into a single BGZF block."""
    assert len(payload) <= 0xFF00, "BGZF payload must be <= 65280 bytes"
    co = zlib.compressobj(level, zlib.DEFLATED, -15)
    comp = co.compress(payload) + co.flush()
    bsize = len(comp) + 26  # header(12) + extra(6) + crc(4) + isize(4)
    hdr = (
        b"\x1f\x8b\x08\x04" + b"\x00" * 5 + b"\xff"
        + struct.pack("<H", 6)
        + b"BC" + struct.pack("<HH", 2, bsize - 1)
    )
    crc = zlib.crc32(payload) & 0xFFFFFFFF
    return hdr + comp + struct.pack("<II", crc, len(payload))


class BgzfWriter:
    """Streaming BGZF writer (used for .vcf.gz / evidence-BAM output)."""

    def __init__(self, fileobj, level: int = 6):
        self._f = fileobj
        self._level = level
        self._buf = bytearray()
        self._coffset = 0  # compressed bytes emitted so far

    def write(self, data: bytes) -> None:
        self._buf += data
        while len(self._buf) >= 0xFF00:
            blk = bgzf_compress_block(bytes(self._buf[:0xFF00]), self._level)
            self._f.write(blk)
            self._coffset += len(blk)
            del self._buf[:0xFF00]

    def tell_virtual(self) -> int:
        """BGZF virtual offset of the next byte to be written
        (compressed block offset << 16 | within-block offset)."""
        return (self._coffset << 16) | len(self._buf)

    def close(self) -> None:
        if self._buf:
            blk = bgzf_compress_block(bytes(self._buf), self._level)
            self._f.write(blk)
            self._coffset += len(blk)
            self._buf.clear()
        self._f.write(BGZF_EOF)
        self._f.flush()


# process-wide shared state: multiple readers over the same alignment
# file (phase-0 stats, phase-1 scan, phase-2 edge/score/evidence
# fetches) share one mapping of the compressed bytes and one
# decompressed-block LRU, keyed by file identity so a rewritten path
# never serves stale blocks
_FILE_DATA: dict[tuple, "mmap.mmap"] = {}
_BLOCK_CACHE: dict[tuple, tuple[bytes, int]] = {}


def node_mem_gb() -> float:
    """Node memory as seen by IO-cache sizing. MANTA_TPU_NODE_GB
    overrides the probed value — for bounding memory on shared hosts,
    and for testing configurations on a different-size box (the
    FFPE-depth memory experiment in docs/PERF_r03.md)."""
    env = os.environ.get("MANTA_TPU_NODE_GB")
    if env:
        return float(env)
    return (os.sysconf("SC_PAGE_SIZE")
            * os.sysconf("SC_PHYS_PAGES")) / 1e9


def configured_node_gb() -> float | None:
    """MANTA_TPU_NODE_GB when set, else None. Cache tiers default to
    the small configuration and only scale up when the user asks via
    this knob — never from the probed node size (see
    _default_cache_blocks for the measurements behind that)."""
    env = os.environ.get("MANTA_TPU_NODE_GB")
    if env is None or env == "":
        return None
    try:
        return float(env)
    except ValueError:
        import warnings
        warnings.warn(
            f"MANTA_TPU_NODE_GB={env!r} is not a number; "
            "ignoring it (small cache tier)", stacklevel=2)
        return None


def _default_cache_blocks() -> int:
    """Decompressed-block LRU capacity (~64 KB per block). The default
    is the reference-like ~192 MB per process: a round-4 A/B on the
    44.7 M-read WGS workload measured the node-scaled 1.5 GB tier
    STRICTLY worse (phase-2 wall 35.7 → 22.5 s, whole-run peak
    anonymous RSS 4.9 → 1.5 GB at -j2, docs/PERF_r04.md), and round 3
    measured the small tier at CPU parity on the 290x deep-exome shape
    (docs/PERF_r03.md). Edge-ordered phase-2 fetches reuse little
    beyond the hot window, so a big LRU only buys eviction and
    allocator churn. MANTA_TPU_NODE_GB ≥ 64 opts back into the large
    tiers for access patterns that measure otherwise."""
    mem_gb = configured_node_gb()
    if mem_gb is None:
        return 3072    # default: ~192 MB
    if mem_gb >= 64:
        return 24576   # ~1.5 GB
    if mem_gb >= 16:
        return 8192    # ~512 MB
    return 3072        # ~192 MB


_CACHE_BLOCKS = _default_cache_blocks()


def _shared_file_data(path: str):
    import mmap
    st = os.stat(path)
    key = (os.path.abspath(path), st.st_mtime_ns, st.st_size)
    data = _FILE_DATA.get(key)
    if data is None:
        # drop mappings (and cached blocks) of older versions of the path
        stale = [k for k in _FILE_DATA if k[0] == key[0]]
        for k in stale:
            del _FILE_DATA[k]
        if stale:
            for bk in [bk for bk in _BLOCK_CACHE if bk[0] in stale]:
                del _BLOCK_CACHE[bk]
        with open(path, "rb") as f:
            if st.st_size == 0:
                data = b""
            else:
                data = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
        _FILE_DATA[key] = data
    return key, data


_INFLATE_POOL = None


def _inflate_threads() -> int:
    """Block-inflation concurrency: MANTA_TPU_IO_THREADS when set (the
    workflow exports cpu/n_jobs so forked edge/segment workers
    don't oversubscribe), else up to 16 — BGZF blocks are independent
    deflate streams, and segment-scale reads on many-core hosts are
    decompression-bound (the reference leans on htslib's bgzf thread
    pool the same way)."""
    env = os.environ.get("MANTA_TPU_IO_THREADS")
    if env:
        try:
            return max(1, int(env))
        except ValueError:
            pass
    return min(16, os.cpu_count() or 1)


def set_worker_io_threads(n_workers: int):
    """Called as the first action inside a forked phase worker: cap
    this worker's inflation threads at its share of the host so
    n_workers concurrent workers don't oversubscribe (the parent's
    sequential phases keep the full min(16, cpus) budget). A user-set
    MANTA_TPU_IO_THREADS, inherited through the fork, wins."""
    os.environ.setdefault(
        "MANTA_TPU_IO_THREADS",
        str(max(1, min(16, (os.cpu_count() or 1) // max(1, n_workers)))))


def _drop_inflate_pool():
    # fork() in a process with live executor threads leaves the child a
    # dead pool whose queue locks may be held — the child must build a
    # fresh one (the parent's stays valid in the parent)
    global _INFLATE_POOL
    _INFLATE_POOL = None


os.register_at_fork(after_in_child=_drop_inflate_pool)


def _inflate_pool():
    """Shared block-inflation thread pool (zlib drops the GIL)."""
    global _INFLATE_POOL
    if _INFLATE_POOL is None:
        import concurrent.futures
        _INFLATE_POOL = concurrent.futures.ThreadPoolExecutor(
            _inflate_threads(),
            thread_name_prefix="bgzf-inflate")
    return _INFLATE_POOL


def _native_inflate_batch(data, jobs) -> bool:
    """Inflate a job list through the native threaded libdeflate batch
    (mt_bgzf_inflate_batch); returns False to fall back to zlib. Each
    block's exact output size comes from its trailing ISIZE word."""
    try:
        import numpy as np

        from .._native import get_lib, i32p, i64p, u8p
        lib = get_lib()
    except Exception:
        return False
    n = len(jobs)
    comp_off = np.empty(n, np.int64)
    comp_len = np.empty(n, np.int32)
    out_off = np.zeros(n + 1, np.int64)
    for k, (_ck, coff, payload_off, bsize) in enumerate(jobs):
        comp_off[k] = payload_off
        comp_len[k] = (coff + bsize - 8) - payload_off
        isize = struct.unpack_from("<I", data, coff + bsize - 4)[0]
        out_off[k + 1] = out_off[k] + isize
    out_blob = np.empty(int(out_off[-1]), np.uint8)
    arr = np.frombuffer(data, np.uint8)
    rc = lib.mt_bgzf_inflate_batch(
        n, arr.ctypes.data_as(u8p), comp_off.ctypes.data_as(i64p),
        comp_len.ctypes.data_as(i32p), out_blob.ctypes.data_as(u8p),
        out_off.ctypes.data_as(i64p),
        _inflate_threads())
    if rc != 0:
        return False
    for k, (ck, coff, _payload_off, bsize) in enumerate(jobs):
        if len(_BLOCK_CACHE) >= _CACHE_BLOCKS:
            for kk in list(_BLOCK_CACHE)[:_CACHE_BLOCKS // 2]:
                del _BLOCK_CACHE[kk]
        payload = out_blob[int(out_off[k]):int(out_off[k + 1])].tobytes()
        _BLOCK_CACHE[ck] = (payload, coff + bsize)
    return True


class BgzfReader:
    """Random-access BGZF reader with virtual-offset support.

    Reads whole blocks on demand; the compressed file mapping and the
    decompressed-block LRU are shared process-wide across readers of
    the same file (phase-2 region queries revisit the same breakend
    neighborhoods many times across edges and scoring passes).
    """

    def __init__(self, path: str):
        self.path = path
        self._key, self._data = _shared_file_data(path)

    def block_at(self, coffset: int) -> tuple[bytes, int]:
        """Decompress block starting at compressed offset; return (payload, next_coffset)."""
        ck = (self._key, coffset)
        hit = _BLOCK_CACHE.pop(ck, None)
        if hit is not None:
            _BLOCK_CACHE[ck] = hit  # move-to-end: eviction drops true LRU
            return hit
        try:
            payload_off, bsize = _parse_block_header(self._data, coffset)
            comp = self._data[payload_off : coffset + bsize - 8]
            payload = zlib.decompress(comp, wbits=-15) if comp else b""
        except (zlib.error, struct.error, IndexError) as e:
            raise ValueError(
                f"{self.path}: corrupt or truncated BGZF block at "
                f"offset {coffset}: {e}") from e
        if len(_BLOCK_CACHE) >= _CACHE_BLOCKS:
            # drop the oldest inserted half (dicts preserve order)
            for k in list(_BLOCK_CACHE)[:_CACHE_BLOCKS // 2]:
                del _BLOCK_CACHE[k]
        out = (payload, coffset + bsize)
        _BLOCK_CACHE[ck] = out
        return out

    def _prefetch_range(self, cstart: int, cend: int):
        """Decompress the range's uncached blocks concurrently: BGZF
        blocks are independent deflate streams and zlib releases the
        GIL, so a small thread pool overlaps block inflation (the
        dominant cost of large region reads) across cores."""
        jobs = []
        n = len(self._data)
        coff = cstart
        while coff < n:
            ck = (self._key, coff)
            hit = _BLOCK_CACHE.get(ck)
            if hit is not None:
                nxt = hit[1]
            else:
                try:
                    payload_off, bsize = _parse_block_header(self._data,
                                                             coff)
                except (struct.error, IndexError, ValueError):
                    return  # block_at re-raises with context
                jobs.append((ck, coff, payload_off, bsize))
                nxt = coff + bsize
            if coff == cend or nxt > cend:
                break
            coff = nxt
        if len(jobs) < 4:
            return
        if _native_inflate_batch(self._data, jobs):
            return

        data = self._data

        def inflate(job):
            ck, coff, payload_off, bsize = job
            comp = data[payload_off : coff + bsize - 8]
            payload = zlib.decompress(comp, wbits=-15) if comp else b""
            return ck, (payload, coff + bsize)

        for ck, out in _inflate_pool().map(inflate, jobs):
            if len(_BLOCK_CACHE) >= _CACHE_BLOCKS:
                for k in list(_BLOCK_CACHE)[:_CACHE_BLOCKS // 2]:
                    del _BLOCK_CACHE[k]
            _BLOCK_CACHE[ck] = out

    def read_range(self, vstart: int, vend: int) -> bytes:
        """Read the uncompressed bytes between two virtual offsets."""
        cstart, ustart = vstart >> 16, vstart & 0xFFFF
        cend, uend = vend >> 16, vend & 0xFFFF
        self._prefetch_range(cstart, cend)
        out = []
        coff = cstart
        first = True
        while True:
            payload, nxt = self.block_at(coff)
            lo = ustart if first else 0
            if coff == cend:
                out.append(payload[lo:uend])
                break
            out.append(payload[lo:])
            first = False
            coff = nxt
            if coff >= len(self._data) or coff > cend:
                break
        return b"".join(out)

    def read_range_arr(self, vstart: int, vend: int):
        """Uncompressed bytes between two virtual offsets, as a numpy
        uint8 view over one output buffer. Unlike read_range, blocks
        inflate natively straight into the output (no per-block
        split/re-join and no LRU churn) — the fast path for BAI chunk
        reads, whose consumers parse once and never revisit blocks."""
        import numpy as np

        try:
            from .._native import get_lib, i32p, i64p, u8p
            lib = get_lib()
        except Exception:
            return np.frombuffer(self.read_range(vstart, vend), np.uint8)
        cstart, ustart = vstart >> 16, vstart & 0xFFFF
        cend, uend = vend >> 16, vend & 0xFFFF
        data = self._data
        nfile = len(data)
        if cstart >= nfile:
            return np.empty(0, np.uint8)
        # native chain walk: one call parses every block header in the
        # range (the per-block Python walk this replaces was the
        # hottest line of the single-core pipeline profile)
        dview = np.frombuffer(data, np.uint8)
        maxb = (min(cend, nfile - 1) - cstart) // 28 + 2
        coffs_a = np.empty(maxb, np.int64)
        pay_offs_a = np.empty(maxb, np.int64)
        pay_lens_a = np.empty(maxb, np.int32)
        isizes_a = np.empty(maxb, np.int32)
        cnt = int(lib.mt_bgzf_index_range(
            dview.ctypes.data_as(u8p), nfile, cstart, cend, maxb,
            coffs_a.ctypes.data_as(i64p),
            pay_offs_a.ctypes.data_as(i64p),
            pay_lens_a.ctypes.data_as(i32p),
            isizes_a.ctypes.data_as(i32p)))
        if cnt <= 0:
            # corrupt/truncated chain: let read_range raise with
            # file/offset context
            return np.frombuffer(self.read_range(vstart, vend),
                                 np.uint8)
        coffs = coffs_a[:cnt]
        isizes = isizes_a[:cnt]
        # LRU probes: blocks block_at already inflated are copied from
        # cache instead of re-inflated
        cached = []
        for c in coffs.tolist():
            hit = _BLOCK_CACHE.get((self._key, c))
            cached.append(hit[0] if hit is not None else None)
        # same bounds as read_range: trim the last block at uend only
        # when the chain actually reached the cend block
        tail = (int(isizes[-1]) - uend) if int(coffs[-1]) == cend else 0
        total = int(isizes.sum())
        out = np.empty(total, np.uint8)
        out_off = np.zeros(cnt + 1, np.int64)
        np.cumsum(isizes, out=out_off[1:])
        jobs = [k for k, p in enumerate(cached) if p is None]
        if jobs:
            comp_off = np.ascontiguousarray(pay_offs_a[jobs])
            comp_len = np.ascontiguousarray(pay_lens_a[jobs])
            # the native kernel derives each job's output span from
            # consecutive offset-table entries, so non-contiguous job
            # destinations (cache hits interleaved) go through a dense
            # scratch buffer instead
            want = isizes_a[jobs].astype(np.int64)
            span_off = np.zeros(len(jobs) + 1, np.int64)
            np.cumsum(want, out=span_off[1:])
            if len(jobs) == cnt:
                # common case: nothing cached — inflate straight in
                rc = lib.mt_bgzf_inflate_batch(
                    len(jobs), np.frombuffer(data, np.uint8)
                    .ctypes.data_as(u8p),
                    comp_off.ctypes.data_as(i64p),
                    comp_len.ctypes.data_as(i32p),
                    out.ctypes.data_as(u8p),
                    out_off.ctypes.data_as(i64p),
                    _inflate_threads())
                if rc != 0:
                    return np.frombuffer(self.read_range(vstart, vend),
                                         np.uint8)
            else:
                scratch = np.empty(int(span_off[-1]), np.uint8)
                rc = lib.mt_bgzf_inflate_batch(
                    len(jobs), np.frombuffer(data, np.uint8)
                    .ctypes.data_as(u8p),
                    comp_off.ctypes.data_as(i64p),
                    comp_len.ctypes.data_as(i32p),
                    scratch.ctypes.data_as(u8p),
                    span_off.ctypes.data_as(i64p),
                    _inflate_threads())
                if rc != 0:
                    return np.frombuffer(self.read_range(vstart, vend),
                                         np.uint8)
                for m, k in enumerate(jobs):
                    out[int(out_off[k]):int(out_off[k + 1])] = \
                        scratch[int(span_off[m]):int(span_off[m + 1])]
        for k, payload in enumerate(cached):
            if payload is not None and isizes[k]:
                out[int(out_off[k]):int(out_off[k + 1])] = \
                    np.frombuffer(payload, np.uint8)
        return out[ustart:total - tail]

    def decompress_all(self) -> bytes:
        try:
            return bgzf_decompress_all(self._data)
        except (zlib.error, struct.error, IndexError, ValueError) as e:
            raise ValueError(
                f"{self.path}: corrupt or truncated BGZF stream: "
                f"{e}") from e

    @property
    def size(self) -> int:
        return len(self._data)
