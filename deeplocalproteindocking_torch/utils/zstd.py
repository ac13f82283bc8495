"""A Zstandard decoder (RFC 8878) in Python and numpy.

Reads what the JAX package's Orbax checkpoints hold (tensorstore writes
zstd frames for the OCDBT manifests, the B-tree nodes and the zarr
chunks) on a machine that has no zstd library:

    from deeplocalproteindocking_torch.utils.zstd import decompress
    raw = decompress(frames)

It covers frames (with or without a content size, single segment or
not, a dictionary ID of 0), skippable frames, several frames in a row,
raw, RLE and compressed blocks, every literals mode (raw, RLE, Huffman
with one or four streams, treeless), Huffman weights written directly
or FSE-coded, sequences in predefined, RLE, FSE and repeat modes with
the three repeat offsets, and the content checksum (the low 32 bits of
xxHash64), which it checks.  Dictionaries are not supported.

A frame that breaks a rule of the format raises :class:`ZstdError`: a
bitstream that does not end where its section ends, an offset before the
start of the frame, a size that disagrees with the header, a checksum
that differs.  A byte changed inside a frame without a checksum can
still decode to other bytes where the format leaves it no way to tell.

Huffman streams decode through numpy: the table entry at every bit
position of a stream is looked up at once, and a Python loop follows
the chain of positions.
"""
from __future__ import annotations

import numpy as np

__all__ = ["ZstdError", "decompress", "xxh64"]

_MAGIC = 0xFD2FB528
_MAX_BLOCK = 1 << 17


class ZstdError(ValueError):
    """A zstd stream that this decoder cannot read or that is damaged."""


# ---------------------------------------------------------------- xxHash64

_P1 = 11400714785074694791
_P2 = 14029467366897019727
_P3 = 1609587929392839161
_P4 = 9650029242287828579
_P5 = 2870177450012600261
_M64 = (1 << 64) - 1


def _round(acc: int, lane: int) -> int:
    acc = (acc + lane * _P2) & _M64
    return (((acc << 31) | (acc >> 33)) & _M64) * _P1 & _M64


def xxh64(data: bytes, seed: int = 0) -> int:
    """The 64-bit xxHash of ``data``."""
    n = len(data)
    i = 0
    if n >= 32:
        v1 = (seed + _P1 + _P2) & _M64
        v2 = (seed + _P2) & _M64
        v3 = seed
        v4 = (seed - _P1) & _M64
        stop = n - n % 32
        lanes = np.frombuffer(data, "<u8", stop // 8).tolist()
        for k in range(0, len(lanes), 4):
            a = (v1 + lanes[k] * _P2) & _M64
            v1 = (((a << 31) | (a >> 33)) & _M64) * _P1 & _M64
            a = (v2 + lanes[k + 1] * _P2) & _M64
            v2 = (((a << 31) | (a >> 33)) & _M64) * _P1 & _M64
            a = (v3 + lanes[k + 2] * _P2) & _M64
            v3 = (((a << 31) | (a >> 33)) & _M64) * _P1 & _M64
            a = (v4 + lanes[k + 3] * _P2) & _M64
            v4 = (((a << 31) | (a >> 33)) & _M64) * _P1 & _M64
        h = (((v1 << 1) | (v1 >> 63)) + ((v2 << 7) | (v2 >> 57))
             + ((v3 << 12) | (v3 >> 52)) + ((v4 << 18) | (v4 >> 46))) & _M64
        for v in (v1, v2, v3, v4):
            h = ((h ^ _round(0, v)) * _P1 + _P4) & _M64
        i = stop
    else:
        h = (seed + _P5) & _M64
    h = (h + n) & _M64
    while i + 8 <= n:
        h ^= _round(0, int.from_bytes(data[i:i + 8], "little"))
        h = ((((h << 27) | (h >> 37)) & _M64) * _P1 + _P4) & _M64
        i += 8
    if i + 4 <= n:
        h ^= int.from_bytes(data[i:i + 4], "little") * _P1 & _M64
        h = ((((h << 23) | (h >> 41)) & _M64) * _P2 + _P3) & _M64
        i += 4
    while i < n:
        h ^= data[i] * _P5 & _M64
        h = (((h << 11) | (h >> 53)) & _M64) * _P1 & _M64
        i += 1
    h ^= h >> 33
    h = h * _P2 & _M64
    h ^= h >> 29
    h = h * _P3 & _M64
    return h ^ (h >> 32)


# ------------------------------------------------------------- bitstreams

class _BackwardBits:
    """A bitstream read from its end, as zstd's FSE and Huffman streams
    are: the highest set bit of the last byte marks the start, and
    reads past the first bit give zeros (``pos`` then goes negative)."""

    def __init__(self, buf: bytes):
        if not buf or buf[-1] == 0:
            raise ZstdError("bitstream without its end marker")
        self.buf = buf
        self.pos = (len(buf) - 1) * 8 + buf[-1].bit_length() - 1
        self.lo = self.pos
        self.win = 0

    def read(self, n: int) -> int:
        p = self.pos - n
        if p < self.lo:
            self._refill(p)
        self.pos = p
        if p >= 0:
            return (self.win >> (p - self.lo)) & ((1 << n) - 1)
        return ((self.win & ((1 << (p + n)) - 1)) << -p) if p + n > 0 else 0

    def _refill(self, p: int) -> None:
        lo = max(0, p - 256) & ~7
        hi = (self.pos + 7) >> 3
        self.win = int.from_bytes(self.buf[lo >> 3:hi], "little")
        self.lo = lo


class _ForwardBits:
    """Little-endian bits from the front of a buffer (FSE table
    descriptions)."""

    def __init__(self, buf: bytes, start: int):
        self.x = int.from_bytes(buf[start:start + 1024], "little")
        self.n = 8 * min(1024, len(buf) - start)
        self.pos = 0

    def peek(self, n: int) -> int:
        return (self.x >> self.pos) & ((1 << n) - 1)

    def skip(self, n: int) -> None:
        self.pos += n
        if self.pos > self.n:
            raise ZstdError("FSE table description runs past its block")


# -------------------------------------------------------------------- FSE

class _FSETable:
    """An FSE decoding table: per state, its symbol, the bits to read
    and the base of the next state."""
    __slots__ = ("al", "sym", "nb", "base")

    def __init__(self, al, sym, nb, base):
        self.al, self.sym, self.nb, self.base = al, sym, nb, base


def _read_ncount(buf: bytes, start: int, max_al: int, max_sym: int):
    """An FSE table description: ``(normalized counts, accuracy log,
    bytes read)``."""
    if start >= len(buf):
        raise ZstdError("missing FSE table description")
    bits = _ForwardBits(buf, start)
    al = bits.peek(4) + 5
    bits.skip(4)
    if al > max_al:
        raise ZstdError(f"FSE accuracy log {al} above {max_al}")
    remaining = (1 << al) + 1
    threshold = 1 << al
    nbits = al + 1
    counts = []
    prev0 = False
    while remaining > 1 and len(counts) <= max_sym:
        if prev0:
            n0 = len(counts)
            while True:
                r = bits.peek(2)
                bits.skip(2)
                n0 += r
                if r != 3:
                    break
            if n0 > max_sym:
                raise ZstdError("FSE zero run past the last symbol")
            counts.extend([0] * (n0 - len(counts)))
        mx = 2 * threshold - 1 - remaining
        low = bits.peek(nbits - 1)
        if low < mx:
            count = low
            bits.skip(nbits - 1)
        else:
            count = bits.peek(nbits)
            if count >= threshold:
                count -= mx
            bits.skip(nbits)
        count -= 1
        remaining -= -count if count < 0 else count
        counts.append(count)
        prev0 = count == 0
        while remaining < threshold:
            nbits -= 1
            threshold >>= 1
    if remaining != 1 or len(counts) > max_sym + 1:
        raise ZstdError("FSE normalized counts do not sum to the table")
    return counts, al, (bits.pos + 7) >> 3


def _fse_table(counts, al: int) -> _FSETable:
    size = 1 << al
    sym = [0] * size
    high = size - 1
    nxt = []
    for s, c in enumerate(counts):
        if c == -1:
            sym[high] = s
            high -= 1
            nxt.append(1)
        else:
            nxt.append(c)
    step = (size >> 1) + (size >> 3) + 3
    mask = size - 1
    pos = 0
    for s, c in enumerate(counts):
        for _ in range(max(c, 0)):
            sym[pos] = s
            pos = (pos + step) & mask
            while pos > high:
                pos = (pos + step) & mask
    if pos != 0:
        raise ZstdError("FSE spread did not return to state 0")
    nb = [0] * size
    base = [0] * size
    for u in range(size):
        x = nxt[sym[u]]
        nxt[sym[u]] = x + 1
        k = al - (x.bit_length() - 1)
        nb[u] = k
        base[u] = (x << k) - size
    return _FSETable(al, sym, nb, base)


def _rle_table(symbol: int) -> _FSETable:
    return _FSETable(0, [symbol], [0], [0])


# ------------------------------------------------------------- sequences

_LL_BASE = list(range(16)) + [16, 18, 20, 22, 24, 28, 32, 40, 48, 64, 128,
                              256, 512, 1024, 2048, 4096, 8192, 16384,
                              32768, 65536]
_LL_BITS = [0] * 16 + [1, 1, 1, 1, 2, 2, 3, 3, 4, 6, 7, 8, 9, 10, 11, 12,
                       13, 14, 15, 16]
_ML_BASE = list(range(3, 35)) + [35, 37, 39, 41, 43, 47, 51, 59, 67, 83,
                                 99, 131, 259, 515, 1027, 2051, 4099, 8195,
                                 16387, 32771, 65539]
_ML_BITS = [0] * 32 + [1, 1, 1, 1, 2, 2, 3, 3, 4, 4, 5, 7, 8, 9, 10, 11,
                       12, 13, 14, 15, 16]
_LL_DEFAULT = ([4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 1, 1, 1, 2, 2, 2, 2,
                2, 2, 2, 2, 2, 3, 2, 1, 1, 1, 1, 1] + [-1] * 4, 6)
_ML_DEFAULT = ([1, 4, 3, 2, 2, 2, 2, 2, 2] + [1] * 37 + [-1] * 7, 6)
_OF_DEFAULT = ([1, 1, 1, 1, 1, 1, 2, 2, 2] + [1] * 15 + [-1] * 5, 5)
# (max symbol, max accuracy log, predefined counts) of LL, OF, ML.
_SEQ_KINDS = (("ll", 35, 9, _LL_DEFAULT), ("of", 31, 8, _OF_DEFAULT),
              ("ml", 52, 9, _ML_DEFAULT))
_PREDEFINED = {}


def _predefined(kind: str, counts_al) -> _FSETable:
    if kind not in _PREDEFINED:
        _PREDEFINED[kind] = _fse_table(*counts_al)
    return _PREDEFINED[kind]


# ---------------------------------------------------------------- Huffman

def _huffman_weights(buf: bytes, start: int):
    """``(weights of every symbol but the last, bytes read)``."""
    if start >= len(buf):
        raise ZstdError("missing Huffman tree description")
    hb = buf[start]
    if hb >= 128:
        n = hb - 127
        raw = buf[start + 1:start + 1 + (n + 1) // 2]
        if len(raw) != (n + 1) // 2:
            raise ZstdError("Huffman weights run past their block")
        w = []
        for b in raw:
            w += [b >> 4, b & 15]
        return w[:n], 1 + (n + 1) // 2
    end = start + 1 + hb
    if end > len(buf):
        raise ZstdError("Huffman weights run past their block")
    counts, al, used = _read_ncount(buf[:end], start + 1, 6, 255)
    table = _fse_table(counts, al)
    bits = _BackwardBits(buf[start + 1 + used:end])
    sym, nb, base = table.sym, table.nb, table.base
    s1 = bits.read(al)
    s2 = bits.read(al)
    w = []
    while True:
        w.append(sym[s1])
        s1 = base[s1] + bits.read(nb[s1])
        if bits.pos < 0:
            w.append(sym[s2])
            break
        w.append(sym[s2])
        s2 = base[s2] + bits.read(nb[s2])
        if bits.pos < 0:
            w.append(sym[s1])
            break
        if len(w) > 255:
            raise ZstdError("too many Huffman weights")
    if len(w) > 255:
        raise ZstdError("too many Huffman weights")
    return w, 1 + hb


def _huffman_table(weights):
    """``(symbol per code, bits per code, max bits)`` of a tree given by
    the weights of every symbol but the last."""
    if any(x > 11 for x in weights):
        raise ZstdError("Huffman weight above 11")
    total = sum(1 << (x - 1) for x in weights if x)
    if total == 0:
        raise ZstdError("Huffman tree without a weight")
    max_bits = total.bit_length()
    rest = (1 << max_bits) - total
    if rest & (rest - 1) or max_bits > 11:
        raise ZstdError("Huffman weights do not complete a tree")
    weights = list(weights) + [rest.bit_length()]
    rank = [0] * (max_bits + 2)
    for x in weights:
        if x:
            rank[x] += 1
    start = [0] * (max_bits + 2)
    acc = 0
    for x in range(1, max_bits + 1):
        start[x] = acc
        acc += rank[x] << (x - 1)
    sym = np.zeros(1 << max_bits, np.uint8)
    nb = np.zeros(1 << max_bits, np.int64)
    for s, x in enumerate(weights):
        if x:
            n = 1 << (x - 1)
            sym[start[x]:start[x] + n] = s
            nb[start[x]:start[x] + n] = max_bits + 1 - x
            start[x] += n
    return sym, nb, max_bits


def _huffman_stream(buf: bytes, table, count: int) -> bytes:
    """Decode ``count`` symbols of one backward Huffman stream."""
    sym, nb, max_bits = table
    if not buf or buf[-1] == 0:
        raise ZstdError("Huffman stream without its end marker")
    start = (len(buf) - 1) * 8 + buf[-1].bit_length() - 1
    if count == 0:
        if start != 0:
            raise ZstdError("Huffman stream holds bits past its symbols")
        return b""
    bits = np.unpackbits(np.frombuffer(buf, np.uint8), bitorder="little")
    padded = np.zeros(start + max_bits, np.int64)
    padded[max_bits:] = bits[:start]
    # win[p]: the max_bits bits just below bit position p (zeros under 0).
    win = np.zeros(start + 1, np.int64)
    for j in range(max_bits):
        win |= padded[j:j + start + 1] << j
    step = nb[win].tolist()
    out_sym = sym[win].tolist()
    out = bytearray(count)
    p = start
    for k in range(count):
        out[k] = out_sym[p]
        p -= step[p]
        if p < 0:
            raise ZstdError("Huffman stream ends before its symbols")
    if p != 0:
        raise ZstdError("Huffman stream does not end at its last symbol")
    return bytes(out)


# ------------------------------------------------------------------ frame

class _Frame:
    """The state a frame carries from block to block."""

    def __init__(self):
        self.out = bytearray()
        self.huffman = None
        self.seq_tables = {}
        self.reps = [1, 4, 8]

    # -- literals --
    def literals(self, blk: bytes):
        b0 = blk[0]
        kind, fmt = b0 & 3, (b0 >> 2) & 3
        if kind < 2:
            if fmt in (0, 2):
                size, hdr = b0 >> 3, 1
            elif fmt == 1:
                size, hdr = (b0 >> 4) + (blk[1] << 4), 2
            else:
                size, hdr = (b0 >> 4) + (blk[1] << 4) + (blk[2] << 12), 3
            if hdr > len(blk):
                raise ZstdError("literals header runs past its block")
            if kind == 0:
                if hdr + size > len(blk):
                    raise ZstdError("raw literals run past their block")
                return blk[hdr:hdr + size], hdr + size
            if hdr >= len(blk):
                raise ZstdError("RLE literals without their byte")
            return blk[hdr:hdr + 1] * size, hdr + 1
        nbits, hdr = ((10, 3), (10, 3), (14, 4), (18, 5))[fmt]
        if hdr > len(blk):
            raise ZstdError("literals header runs past its block")
        h = int.from_bytes(blk[:hdr], "little")
        regen = (h >> 4) & ((1 << nbits) - 1)
        comp = (h >> (4 + nbits)) & ((1 << nbits) - 1)
        end = hdr + comp
        if end > len(blk) or regen > _MAX_BLOCK:
            raise ZstdError("compressed literals run past their block")
        p = hdr
        if kind == 2:
            weights, used = _huffman_weights(blk[:end], p)
            self.huffman = _huffman_table(weights)
            p += used
        elif self.huffman is None:
            raise ZstdError("treeless literals without an earlier tree")
        data = blk[p:end]
        if fmt == 0:
            return _huffman_stream(data, self.huffman, regen), end
        if len(data) < 6:
            raise ZstdError("four-stream literals without a jump table")
        s1, s2, s3 = (int.from_bytes(data[i:i + 2], "little")
                      for i in (0, 2, 4))
        cuts = [6, 6 + s1, 6 + s1 + s2, 6 + s1 + s2 + s3, len(data)]
        if cuts[3] > len(data):
            raise ZstdError("literal stream sizes run past their section")
        per = (regen + 3) // 4
        if 3 * per > regen:
            raise ZstdError("too few literals for four streams")
        counts = [per, per, per, regen - 3 * per]
        return b"".join(_huffman_stream(data[cuts[i]:cuts[i + 1]],
                                        self.huffman, counts[i])
                        for i in range(4)), end

    # -- sequences --
    def sequences(self, blk: bytes, p: int):
        """``(list of (ll, ml, offset) triples)`` of the section at
        ``blk[p:]``."""
        if p >= len(blk):
            raise ZstdError("missing sequences section")
        b0 = blk[p]
        if b0 == 0:
            if p + 1 != len(blk):
                raise ZstdError("bytes after an empty sequences section")
            return []
        if b0 < 128:
            nseq, p = b0, p + 1
        elif b0 < 255:
            nseq, p = ((b0 - 128) << 8) + blk[p + 1], p + 2
        else:
            nseq, p = blk[p + 1] + (blk[p + 2] << 8) + 0x7F00, p + 3
        if p >= len(blk):
            raise ZstdError("sequences header runs past its block")
        modes = blk[p]
        p += 1
        if modes & 3:
            raise ZstdError("reserved bits set in the sequence modes")
        tables = {}
        for (kind, max_sym, max_al, default), shift in zip(_SEQ_KINDS,
                                                           (6, 4, 2)):
            mode = (modes >> shift) & 3
            if mode == 0:
                tables[kind] = _predefined(kind, default)
            elif mode == 1:
                if p >= len(blk) or blk[p] > max_sym:
                    raise ZstdError(f"bad RLE {kind} symbol")
                tables[kind] = _rle_table(blk[p])
                p += 1
            elif mode == 2:
                counts, al, used = _read_ncount(blk, p, max_al, max_sym)
                tables[kind] = _fse_table(counts, al)
                p += used
            else:
                if kind not in self.seq_tables:
                    raise ZstdError(f"repeat {kind} table without an "
                                    f"earlier one")
                tables[kind] = self.seq_tables[kind]
        self.seq_tables = tables
        return self._decode_sequences(blk[p:], nseq, tables)

    def _decode_sequences(self, buf: bytes, nseq: int, tables):
        ll_t, of_t, ml_t = tables["ll"], tables["of"], tables["ml"]
        ll_sym, ll_nb, ll_base = ll_t.sym, ll_t.nb, ll_t.base
        of_sym, of_nb, of_base = of_t.sym, of_t.nb, of_t.base
        ml_sym, ml_nb, ml_base = ml_t.sym, ml_t.nb, ml_t.base
        bits = _BackwardBits(buf)
        read = bits.read
        ll_s = read(ll_t.al)
        of_s = read(of_t.al)
        ml_s = read(ml_t.al)
        r1, r2, r3 = self.reps
        seqs = []
        last = nseq - 1
        for i in range(nseq):
            of_code = of_sym[of_s]
            ll_code = ll_sym[ll_s]
            ml_code = ml_sym[ml_s]
            if of_code > 31:
                raise ZstdError("offset code above 31")
            ov = (1 << of_code) + read(of_code)
            ml = _ML_BASE[ml_code] + read(_ML_BITS[ml_code])
            ll = _LL_BASE[ll_code] + read(_LL_BITS[ll_code])
            if ov > 3:
                r1, r2, r3 = ov - 3, r1, r2
            else:
                if ll == 0:
                    ov += 1
                if ov == 2:
                    r1, r2 = r2, r1
                elif ov == 3:
                    r1, r2, r3 = r3, r1, r2
                elif ov == 4:
                    r1, r2, r3 = r1 - 1, r1, r2
                    if r1 == 0:
                        raise ZstdError("repeat offset of 0")
            seqs.append((ll, ml, r1))
            if i != last:
                ll_s = ll_base[ll_s] + read(ll_nb[ll_s])
                ml_s = ml_base[ml_s] + read(ml_nb[ml_s])
                of_s = of_base[of_s] + read(of_nb[of_s])
            if bits.pos < 0:
                raise ZstdError("sequence bitstream read past its start")
        if bits.pos != 0:
            raise ZstdError("sequence bitstream does not end at its "
                            "last sequence")
        self.reps = [r1, r2, r3]
        return seqs

    def compressed_block(self, blk: bytes) -> None:
        lits, p = self.literals(blk)
        seqs = self.sequences(blk, p)
        out = self.out
        start = len(out)
        lp = 0
        for ll, ml, off in seqs:
            if ll:
                if lp + ll > len(lits):
                    raise ZstdError("sequence takes more literals than the "
                                    "block holds")
                out += lits[lp:lp + ll]
                lp += ll
            n = len(out)
            if off > n:
                raise ZstdError("match offset before the start of the frame")
            if ml <= off:
                out += out[n - off:n - off + ml]
            else:
                pat = bytes(out[n - off:])
                out += (pat * (ml // off + 1))[:ml]
        out += lits[lp:]
        if len(out) - start > _MAX_BLOCK:
            raise ZstdError("block decodes past the largest block size")


def _frame(data, p: int):
    """Decode the frame whose header starts at ``data[p]`` (past its
    magic number): ``(content, position after the frame)``."""
    if p >= len(data):
        raise ZstdError("truncated frame header")
    fhd = data[p]
    fcs_flag, single = fhd >> 6, (fhd >> 5) & 1
    if fhd & 0x08:
        raise ZstdError("reserved bit set in the frame header")
    checksum, did_flag = (fhd >> 2) & 1, fhd & 3
    p += 1
    if not single:
        p += 1
    did_size = (0, 1, 2, 4)[did_flag]
    if int.from_bytes(data[p:p + did_size], "little"):
        raise ZstdError("frames with a dictionary are not supported")
    p += did_size
    fcs_size = (1 if single else 0, 2, 4, 8)[fcs_flag]
    if p + fcs_size > len(data):
        raise ZstdError("truncated frame header")
    fcs = None
    if fcs_size:
        fcs = int.from_bytes(data[p:p + fcs_size], "little")
        if fcs_size == 2:
            fcs += 256
    p += fcs_size
    frame = _Frame()
    while True:
        if p + 3 > len(data):
            raise ZstdError("truncated block header")
        bh = int.from_bytes(data[p:p + 3], "little")
        p += 3
        last, btype, size = bh & 1, (bh >> 1) & 3, bh >> 3
        if btype == 1:
            if p >= len(data):
                raise ZstdError("truncated RLE block")
            frame.out += data[p:p + 1] * size
            p += 1
        else:
            if p + size > len(data):
                raise ZstdError("truncated block")
            if size > _MAX_BLOCK:
                raise ZstdError("block above the largest block size")
            if btype == 0:
                frame.out += data[p:p + size]
            elif btype == 2:
                frame.compressed_block(bytes(data[p:p + size]))
            else:
                raise ZstdError("reserved block type")
            p += size
        if last:
            break
    out = bytes(frame.out)
    if fcs is not None and len(out) != fcs:
        raise ZstdError(f"frame decodes to {len(out)} bytes, its header "
                        f"says {fcs}")
    if checksum:
        if p + 4 > len(data):
            raise ZstdError("truncated content checksum")
        want = int.from_bytes(data[p:p + 4], "little")
        if xxh64(out) & 0xFFFFFFFF != want:
            raise ZstdError("content checksum differs")
        p += 4
    return out, p


def decompress(data: bytes) -> bytes:
    """The content of every zstd frame in ``data``, in order (skippable
    frames skipped).  Raises :class:`ZstdError` on anything else."""
    data = memoryview(data).tobytes()
    if not data:
        raise ZstdError("no zstd frame")
    parts = []
    p = 0
    while p < len(data):
        if p + 4 > len(data):
            raise ZstdError("truncated frame magic number")
        magic = int.from_bytes(data[p:p + 4], "little")
        if magic == _MAGIC:
            out, p = _frame(data, p + 4)
            parts.append(out)
        elif magic & 0xFFFFFFF0 == 0x184D2A50:
            if p + 8 > len(data):
                raise ZstdError("truncated skippable frame")
            p += 8 + int.from_bytes(data[p + 4:p + 8], "little")
            if p > len(data):
                raise ZstdError("truncated skippable frame")
        else:
            raise ZstdError(f"not a zstd frame (magic {magic:#010x})")
    return b"".join(parts)
