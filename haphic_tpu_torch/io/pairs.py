"""Columnar ingest of Hi-C alignments in 4DN `.pairs` format.

The reference iterates read pairs one by one in Python and mutates
defaultdicts (scripts/HapHiC_cluster.py:1539-1583) — its top wall-clock
hot loop. Here every chunk of the file becomes four numpy columns
(ref_id, pos, mref_id, mpos); all downstream statistics are vectorized
segment reductions (see haphic_tpu_torch.core.contacts).

A `alignments.bed` side file can be emitted for `juicer pre`, matching
the reference's BED lines (scripts/HapHiC_cluster.py:1549-1557).
"""

from __future__ import annotations

import gzip
import io as _io
import os
from dataclasses import dataclass
from typing import Iterator, List, Optional

import numpy as np

_PAIRS_LIB = None
_PAIRS_LOADED = False


def _native_pairs():
    """The native tokenizer library, or None (falls back to the Python
    block tokenizer)."""
    global _PAIRS_LIB, _PAIRS_LOADED
    if _PAIRS_LOADED:
        return _PAIRS_LIB
    _PAIRS_LOADED = True
    import ctypes
    from haphic_tpu_torch.utils.nativelib import load_shared
    lib = load_shared('libpairsreader.so', ['pairs_reader.cpp'])
    if lib is not None:
        lib.pairs_open.restype = ctypes.c_void_p
        lib.pairs_open.argtypes = [ctypes.c_char_p,
                                   ctypes.POINTER(ctypes.c_char_p),
                                   ctypes.c_int64]
        lib.pairs_next.restype = ctypes.c_int64
        lib.pairs_next.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int64), ctypes.c_int64]
        lib.pairs_close.restype = None
        lib.pairs_close.argtypes = [ctypes.c_void_p]
    _PAIRS_LIB = lib
    return lib


@dataclass
class AlignChunk:
    """One chunk of alignment records (0-based positions, like pysam)."""
    ref: np.ndarray    # int32 contig ids (-1 = not in FASTA)
    pos: np.ndarray    # int64 0-based
    mref: np.ndarray
    mpos: np.ndarray


def detect_format(path: str) -> str:
    """Parity: scripts/HapHiC_cluster.py:2510-2527."""
    if path.endswith('.bam'):
        return 'bam'
    if path.endswith('.pairs'):
        return 'pairs'
    if path.endswith('.pairs.gz'):
        return 'bgzipped_pairs'
    raise RuntimeError('Unknown file format for Hi-C read alignments')


def prefetch(chunks, depth: int = 4):
    """Producer thread wrapping a chunk iterable: text parsing (which
    holds the GIL in C string ops) overlaps the numpy accumulation of
    the previous chunk. ~1.3-1.6x on 2-host-core ingest; exceptions
    propagate to the consumer. If the consumer abandons iteration
    early (exception mid-aggregation, generator close), the producer
    is signalled to stop and the wrapped iterable is closed so its
    file handle is released rather than leaked for the process
    lifetime."""
    import queue
    import threading
    q: 'queue.Queue' = queue.Queue(maxsize=depth)
    DONE = object()
    stop = threading.Event()

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.2)
                return True
            except queue.Full:
                continue
        return False

    def run():
        try:
            for c in chunks:
                if not put(c):
                    return
            put(DONE)
        except BaseException as e:
            put(e)
        finally:
            if stop.is_set():
                close = getattr(chunks, 'close', None)
                if close is not None:
                    close()

    t = threading.Thread(target=run, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is DONE:
                break
            if isinstance(item, BaseException):
                raise item
            yield item
        t.join()
    finally:
        stop.set()


class PairsReader:
    """Chunked reader for .pairs / .pairs.gz.

    Yields :class:`AlignChunk` with contig names resolved to ids via the
    sorted ``names`` array (unknown contigs → -1). Optionally tees BED
    records (read1/read2 lines) to ``bed_path``.
    """

    def __init__(self, path: str, names: List[str],
                 bed_path: Optional[str] = None,
                 chunk_lines: int = 2_000_000):
        self.path = path
        self.names_arr = np.asarray(names)
        self.bed_path = bed_path
        self.chunk_lines = chunk_lines

    def _open(self):
        if self.path.endswith('.gz'):
            return gzip.open(self.path, 'rt')
        return open(self.path, 'rt', buffering=1 << 20)

    def _resolve(self, name_col: List[str]) -> np.ndarray:
        arr = np.asarray(name_col)
        idx = np.searchsorted(self.names_arr, arr)
        idx_c = np.clip(idx, 0, len(self.names_arr) - 1)
        ok = self.names_arr[idx_c] == arr
        return np.where(ok, idx_c, -1).astype(np.int32)

    def __iter__(self) -> Iterator[AlignChunk]:
        if self.bed_path is None:
            native = None
            if not os.environ.get('HAPHIC_NO_NATIVE_PAIRS'):
                native = _native_pairs()
            if native is not None:
                yield from self._iter_native(native)
            else:
                yield from self._iter_fast()
            return
        yield from self._iter_lines()

    def _iter_native(self, lib) -> Iterator[AlignChunk]:
        """native/pairs_reader.cpp: one C pass over the byte stream.
        ctypes releases the GIL during pairs_next, so under prefetch()
        the parse overlaps the numpy link aggregation on another core
        (~10x the Python block tokenizer's throughput)."""
        import ctypes
        names_b = [n.encode() for n in self.names_arr.tolist()]
        arr_t = ctypes.c_char_p * len(names_b)
        handle = lib.pairs_open(self.path.encode(), arr_t(*names_b),
                                len(names_b))
        if not handle:
            raise RuntimeError('cannot open {}'.format(self.path))
        cap = self.chunk_lines
        i32p = ctypes.POINTER(ctypes.c_int32)
        i64p = ctypes.POINTER(ctypes.c_int64)
        try:
            while True:
                ref = np.empty(cap, dtype=np.int32)
                pos = np.empty(cap, dtype=np.int64)
                mref = np.empty(cap, dtype=np.int32)
                mpos = np.empty(cap, dtype=np.int64)
                n = lib.pairs_next(
                    handle, ref.ctypes.data_as(i32p),
                    pos.ctypes.data_as(i64p),
                    mref.ctypes.data_as(i32p),
                    mpos.ctypes.data_as(i64p), cap)
                if n < 0:
                    raise RuntimeError(
                        'read error in {}'.format(self.path))
                if n == 0:
                    break
                yield AlignChunk(ref=ref[:n], pos=pos[:n],
                                 mref=mref[:n], mpos=mpos[:n])
        finally:
            lib.pairs_close(handle)

    def _iter_fast(self) -> Iterator[AlignChunk]:
        """Block tokenizer: read ~16 MB of text, split it into tokens
        with ONE C-level str.split, and stride-slice the columns.
        ~6x the line-loop's throughput; falls back per block when the
        column count is ragged."""
        with self._open() as f:
            rem = ''
            while True:
                block = f.read(1 << 24)
                if not block:
                    break
                block = rem + block
                nl = block.rfind('\n')
                if nl < 0:
                    rem = block
                    continue
                rem = block[nl + 1:]
                text = block[:nl]
                if text.startswith('#') or '\n#' in text:
                    lines = [l for l in text.split('\n')
                             if l and not l.startswith('#')]
                else:
                    lines = [l for l in text.split('\n') if l]
                if not lines:
                    continue
                ncols = len(lines[0].split())
                parts = '\n'.join(lines).split()
                # total token count alone can coincidentally match a
                # block that mixes column widths; the stride-sliced
                # position columns would then hold non-numeric tokens,
                # so the astype below raises and the block falls back
                # to the validating per-line parser
                if (ncols < 5 or len(parts) != ncols * len(lines)
                        or len(lines[-1].split()) != ncols):
                    chunk = self._parse_lines(lines)
                else:
                    try:
                        pos = (np.asarray(parts[2::ncols])
                               .astype(np.int64) - 1)
                        mpos = (np.asarray(parts[4::ncols])
                                .astype(np.int64) - 1)
                    except ValueError:
                        chunk = self._parse_lines(lines)
                    else:
                        refs = np.asarray(parts[1::ncols])
                        mrefs = np.asarray(parts[3::ncols])
                        chunk = AlignChunk(ref=self._resolve(refs), pos=pos,
                                           mref=self._resolve(mrefs),
                                           mpos=mpos)
                if len(chunk.ref):
                    yield chunk
            tail = [l for l in rem.split('\n')
                    if l.strip() and not l.startswith('#')]
            if tail:
                chunk = self._parse_lines(tail)
                if len(chunk.ref):
                    yield chunk

    def _parse_lines(self, lines: List[str]) -> AlignChunk:
        refs, mrefs, poss, mposs = [], [], [], []
        for line in lines:
            cols = line.split()
            if len(cols) < 5:     # blank/whitespace-only/short lines
                continue
            refs.append(cols[1])
            poss.append(int(cols[2]) - 1)
            mrefs.append(cols[3])
            mposs.append(int(cols[4]) - 1)
        return AlignChunk(ref=self._resolve(refs),
                          pos=np.asarray(poss, dtype=np.int64),
                          mref=self._resolve(mrefs),
                          mpos=np.asarray(mposs, dtype=np.int64))

    def _iter_lines(self) -> Iterator[AlignChunk]:
        bed = open(self.bed_path, 'w') if self.bed_path else None
        refs: List[str] = []
        mrefs: List[str] = []
        poss: List[int] = []
        mposs: List[int] = []
        ids: List[str] = []

        def flush() -> AlignChunk:
            nonlocal refs, mrefs, poss, mposs, ids
            if bed is not None:
                out = _io.StringIO()
                for k in range(len(ids)):
                    out.write('{0}\t{1}\t{1}\t{2}/1\t255\t.\n{3}\t{4}\t{4}\t{2}/2\t255\t.\n'
                              .format(refs[k], poss[k], ids[k], mrefs[k], mposs[k]))
                bed.write(out.getvalue())
            chunk = AlignChunk(
                ref=self._resolve(refs),
                pos=np.asarray(poss, dtype=np.int64),
                mref=self._resolve(mrefs),
                mpos=np.asarray(mposs, dtype=np.int64))
            refs, mrefs, poss, mposs, ids = [], [], [], [], []
            return chunk

        with self._open() as f:
            for line in f:
                if not line.strip() or line.startswith('#'):
                    continue
                cols = line.split()
                ids.append(cols[0])
                refs.append(cols[1])
                poss.append(int(cols[2]) - 1)   # pairs are 1-based
                mrefs.append(cols[3])
                mposs.append(int(cols[4]) - 1)
                if len(ids) >= self.chunk_lines:
                    yield flush()
            if ids:
                yield flush()
        if bed is not None:
            bed.close()
