"""BAM ingest without pysam.

The native path loads ``native/libbamreader.so`` (C++ BGZF decoder with
a worker-thread pool — the htslib `threads=` equivalent the reference
uses, scripts/HapHiC_cluster.py:1586-1593) through ctypes and receives
columnar record arrays. A pure-Python BGZF/struct fallback covers
environments without a compiler.

`BamReader` yields the same AlignChunk as the pairs reader: 0-based
positions, contig ids resolved against the Assembly's sorted name
table, read1-only records (the reference's htslib filter string
'filter=flag.read1', :2846-2874 — the inter-contig cut happens
in core.contacts which drops intra-contig pairs unless binned).
"""

from __future__ import annotations

import ctypes
import gzip
import os
import struct
from typing import Iterator, List, Optional

import numpy as np

from haphic_tpu_torch.io.pairs import AlignChunk

FLAG_PAIRED = 0x1
FLAG_UNMAPPED = 0x4
FLAG_READ1 = 0x40


def _load_native():
    from haphic_tpu_torch.utils.nativelib import load_shared
    lib = load_shared('libbamreader.so', ['bam_reader.cpp'])
    if lib is None:
        return None
    lib.bam_open.restype = ctypes.c_void_p
    lib.bam_open.argtypes = [ctypes.c_char_p, ctypes.c_int]
    lib.bam_nrefs.restype = ctypes.c_int
    lib.bam_nrefs.argtypes = [ctypes.c_void_p]
    lib.bam_ref_name.restype = ctypes.c_char_p
    lib.bam_ref_name.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.bam_header_text.restype = ctypes.c_char_p
    lib.bam_header_text.argtypes = [ctypes.c_void_p]
    lib.bam_read_chunk.restype = ctypes.c_int64
    lib.bam_read_chunk.argtypes = [
        ctypes.c_void_p, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_uint16), ctypes.POINTER(ctypes.c_uint8),
        ctypes.POINTER(ctypes.c_int32)]
    lib.bam_close.argtypes = [ctypes.c_void_p]
    return lib


_native = None
_native_checked = False


def native_lib():
    global _native, _native_checked
    if not _native_checked:
        _native = _load_native()
        _native_checked = True
    return _native


def check_sorting_order(header_text: str) -> None:
    """Reject coordinate-sorted BAM
    (parity: scripts/HapHiC_cluster.py:1347-1359)."""
    for line in header_text.splitlines():
        if line.startswith('@HD') and 'SO:coordinate' in line:
            raise RuntimeError(
                'The input BAM file is coordinate-sorted. Please use a BAM '
                'sorted by read name or in the original order')


# ---------------- pure-Python fallback ------------------------------

def _py_bgzf_stream(path: str) -> Iterator[bytes]:
    with open(path, 'rb') as f:
        data = f.read()
    import zlib
    off = 0
    n = len(data)
    while off + 18 <= n:
        if data[off] != 0x1f or data[off + 1] != 0x8b:
            break
        xlen = struct.unpack_from('<H', data, off + 10)[0]
        extra = data[off + 12: off + 12 + xlen]
        bsize = None
        p = 0
        while p + 4 <= len(extra):
            si1, si2, slen = extra[p], extra[p + 1], \
                struct.unpack_from('<H', extra, p + 2)[0]
            if si1 == 66 and si2 == 67 and slen == 2:
                bsize = struct.unpack_from('<H', extra, p + 4)[0] + 1
            p += 4 + slen
        if bsize is None:
            raise RuntimeError('not a BGZF file: {}'.format(path))
        cstart = off + 12 + xlen
        cend = off + bsize - 8
        isize = struct.unpack_from('<I', data, off + bsize - 4)[0]
        if isize:
            yield zlib.decompress(data[cstart:cend], -15)
        off += bsize


class _PyBam:
    def __init__(self, path: str):
        self._chunks = _py_bgzf_stream(path)
        self._buf = b''
        self._off = 0
        magic = self._read(4)
        if magic != b'BAM\x01':
            raise RuntimeError('not a BAM file: {}'.format(path))
        l_text = struct.unpack('<I', self._read(4))[0]
        self.header_text = self._read(l_text).decode('latin1')
        n_ref = struct.unpack('<I', self._read(4))[0]
        self.ref_names: List[str] = []
        for _ in range(n_ref):
            l_name = struct.unpack('<I', self._read(4))[0]
            self.ref_names.append(self._read(l_name)[:-1].decode())
            self._read(4)

    def _read(self, n: int) -> bytes:
        while len(self._buf) - self._off < n:
            try:
                nxt = next(self._chunks)
            except StopIteration:
                if len(self._buf) - self._off == 0 and n > 0:
                    raise EOFError
                raise EOFError
            self._buf = self._buf[self._off:] + nxt
            self._off = 0
        out = self._buf[self._off:self._off + n]
        self._off += n
        return out

    def detail_records(self):
        """Yield full records for CIGAR-aware consumers (UL reads):
        (qname, flag, refid, pos0, mapq, cigartuples, aux_bytes)."""
        while True:
            try:
                block_size = struct.unpack('<I', self._read(4))[0]
            except EOFError:
                return
            rec = self._read(block_size)
            refid, p = struct.unpack_from('<ii', rec, 0)
            l_read_name = rec[8]
            q = rec[9]
            n_cigar = struct.unpack_from('<H', rec, 12)[0]
            fl = struct.unpack_from('<H', rec, 14)[0]
            l_seq = struct.unpack_from('<I', rec, 16)[0]
            off = 32
            qname = rec[off:off + l_read_name - 1].decode()
            off += l_read_name
            cig = []
            for _ in range(n_cigar):
                v = struct.unpack_from('<I', rec, off)[0]
                cig.append((v & 0xf, v >> 4))
                off += 4
            off += (l_seq + 1) // 2 + l_seq
            yield qname, fl, refid, p, q, cig, rec[off:]

    def records(self, chunk_records: int):
        ref, pos, mref, mpos, flag, mapq = [], [], [], [], [], []
        while True:
            try:
                block_size = struct.unpack('<I', self._read(4))[0]
            except EOFError:
                break
            rec = self._read(block_size)
            refid, p = struct.unpack_from('<ii', rec, 0)
            q = rec[9]
            fl = struct.unpack_from('<H', rec, 14)[0]
            next_refid, next_pos = struct.unpack_from('<ii', rec, 20)
            ref.append(refid)
            pos.append(p)
            mref.append(next_refid)
            mpos.append(next_pos)
            flag.append(fl)
            mapq.append(q)
            if len(ref) >= chunk_records:
                yield (np.asarray(ref, np.int32), np.asarray(pos, np.int64),
                       np.asarray(mref, np.int32), np.asarray(mpos, np.int64),
                       np.asarray(flag, np.uint16), np.asarray(mapq, np.uint8))
                ref, pos, mref, mpos, flag, mapq = [], [], [], [], [], []
        if ref:
            yield (np.asarray(ref, np.int32), np.asarray(pos, np.int64),
                   np.asarray(mref, np.int32), np.asarray(mpos, np.int64),
                   np.asarray(flag, np.uint16), np.asarray(mapq, np.uint8))


def find_int_tag(aux: bytes, tag: bytes) -> Optional[int]:
    """Scan an aux blob for an integer-typed tag (e.g. b'AS', b'NM')."""
    p = 0
    n = len(aux)
    sizes = {ord('A'): 1, ord('c'): 1, ord('C'): 1, ord('s'): 2,
             ord('S'): 2, ord('i'): 4, ord('I'): 4, ord('f'): 4}
    fmts = {ord('c'): '<b', ord('C'): '<B', ord('s'): '<h',
            ord('S'): '<H', ord('i'): '<i', ord('I'): '<I'}
    while p + 3 <= n:
        t = aux[p:p + 2]
        typ = aux[p + 2]
        p += 3
        if typ in sizes:
            if t == tag and typ in fmts:
                return struct.unpack_from(fmts[typ], aux, p)[0]
            p += sizes[typ]
        elif typ in (ord('Z'), ord('H')):
            q = aux.index(b'\x00', p)
            p = q + 1
        elif typ == ord('B'):
            sub = aux[p]
            cnt = struct.unpack_from('<I', aux, p + 1)[0]
            esz = {ord('c'): 1, ord('C'): 1, ord('s'): 2, ord('S'): 2,
                   ord('i'): 4, ord('I'): 4, ord('f'): 4}[sub]
            p += 5 + esz * cnt
        else:
            return None
    return None


def open_detail_bam(path: str) -> '_PyBam':
    """Open a BAM for record-level (CIGAR-aware) iteration."""
    return _PyBam(path)


class BamReader:
    """Chunked columnar BAM reader yielding AlignChunk (read1 records).

    ``names``: the Assembly's (sorted) contig names; BAM reference ids
    are remapped onto those ids, absent contigs become -1.
    """

    def __init__(self, path: str, names: List[str], threads: int = 4,
                 chunk_records: int = 1 << 20, min_mapq: int = 0,
                 use_native: Optional[bool] = None):
        if path.endswith('.cram'):
            # the reference reads CRAM for free through pysam
            # (HapHiC_cluster.py:2862); CRAM needs the reference
            # FASTA-backed codec htslib implements, which this
            # self-contained reader does not — fail with the fix
            raise RuntimeError(
                'CRAM input is not supported: convert with '
                "'samtools view -b -o aln.bam aln.cram' (or emit "
                '.pairs) and rerun')
        self.path = path
        self.names = names
        self.threads = threads
        self.chunk_records = chunk_records
        self.min_mapq = min_mapq
        if use_native is None:
            use_native = native_lib() is not None
        self.use_native = use_native and native_lib() is not None

    def _remap(self, bam_names: List[str]) -> np.ndarray:
        name2id = {c: i for i, c in enumerate(self.names)}
        remap = np.full(len(bam_names) + 1, -1, dtype=np.int32)
        for i, c in enumerate(bam_names):
            remap[i] = name2id.get(c, -1)
        return remap      # index -1 (unmapped) stays -1 via remap[-1]

    def __iter__(self) -> Iterator[AlignChunk]:
        if self.use_native:
            yield from self._iter_native()
        else:
            yield from self._iter_python()

    def _emit(self, remap, ref, pos, mref, mpos, flag, mapq):
        keep = (flag & FLAG_READ1) != 0
        if self.min_mapq:
            keep &= mapq >= self.min_mapq
        # remap BAM reference ids onto assembly ids FIRST: a contig that
        # is in the BAM header but not the FASTA must drop out here
        ref = np.where(ref >= 0, remap[np.clip(ref, 0, None)], -1)
        mref = np.where(mref >= 0, remap[np.clip(mref, 0, None)], -1)
        keep &= (ref >= 0) & (mref >= 0)
        ref, pos = ref[keep], pos[keep]
        mref, mpos = mref[keep], mpos[keep]
        if not len(ref):
            return None
        return AlignChunk(ref=ref, pos=pos, mref=mref, mpos=mpos)

    def _iter_native(self):
        lib = native_lib()
        h = lib.bam_open(self.path.encode(), self.threads)
        if not h:
            raise RuntimeError('cannot open BAM file {}'.format(self.path))
        try:
            check_sorting_order(
                lib.bam_header_text(h).decode('latin1'))
            nref = lib.bam_nrefs(h)
            bam_names = [lib.bam_ref_name(h, i).decode()
                         for i in range(nref)]
            remap = self._remap(bam_names)
            n = self.chunk_records
            ref = np.empty(n, np.int32)
            pos = np.empty(n, np.int64)
            mref = np.empty(n, np.int32)
            mpos = np.empty(n, np.int64)
            flag = np.empty(n, np.uint16)
            mapq = np.empty(n, np.uint8)
            nm = np.empty(n, np.int32)
            ptr = lambda a, t: a.ctypes.data_as(ctypes.POINTER(t))
            while True:
                got = lib.bam_read_chunk(
                    h, n, ptr(ref, ctypes.c_int32), ptr(pos, ctypes.c_int64),
                    ptr(mref, ctypes.c_int32), ptr(mpos, ctypes.c_int64),
                    ptr(flag, ctypes.c_uint16), ptr(mapq, ctypes.c_uint8),
                    ptr(nm, ctypes.c_int32))
                if got < 0:
                    raise RuntimeError('BAM parse error in {}'.format(
                        self.path))
                if got == 0:
                    break
                chunk = self._emit(remap, ref[:got].copy(), pos[:got].copy(),
                                   mref[:got].copy(), mpos[:got].copy(),
                                   flag[:got], mapq[:got])
                if chunk is not None:
                    yield chunk
        finally:
            lib.bam_close(h)

    def _iter_python(self):
        bam = _PyBam(self.path)
        check_sorting_order(bam.header_text)
        remap = self._remap(bam.ref_names)
        for ref, pos, mref, mpos, flag, mapq in \
                bam.records(self.chunk_records):
            chunk = self._emit(remap, ref, pos, mref, mpos, flag, mapq)
            if chunk is not None:
                yield chunk
