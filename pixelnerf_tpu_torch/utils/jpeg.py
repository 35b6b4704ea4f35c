"""JPEG reading on ``struct`` and numpy.

:func:`imread` returns what ``imageio.v2.imread`` (Pillow on libjpeg-turbo)
returns for the same file, bit for bit: uint8 (H, W, 3) for a
three-component image, uint8 (H, W) for a gray one. It decodes as
libjpeg-turbo's default decompression does:

- baseline and extended sequential (SOF0, SOF1) and progressive (SOF2)
  Huffman coding at 8-bit precision, with restart intervals and tables
  defined between scans; quantisation tables latched at a component's first
  scan (``jdinput.c``);
- the Huffman decode (``jdhuff.c``, ``jdphuff.c``) is the one loop over
  symbols in Python. It reads a 16-bit window of the scan's bits at every
  bit position (one vector operation per restart interval) through a
  65,536-entry table per Huffman table, and writes each coefficient in
  zig-zag order into one int32 array per component. Everything after it
  works on every block at once;
- dequantisation and ``jidctint.c``'s ``jpeg_idct_islow`` (CONST_BITS 13,
  PASS1_BITS 2) in int64, and the post-IDCT range limit of ``jdmaster.c``
  (``range_limit[x & 1023]``);
- ``jdsample.c``'s upsampling as ``jinit_upsampler`` chooses it with fancy
  upsampling on: full size, h2v1 and h2v2 fancy, and box replication where
  a component is at most 2 samples wide;
- ``jdcolor.c``'s YCbCr to RGB tables. The colour space is decided as
  ``jdapimin.c`` ``default_decompress_parms`` decides it: a JFIF marker
  means YCbCr, an Adobe marker with transform 0 means RGB, and without
  either, component ids 'R', 'G', 'B' mean RGB.

EXIF orientation is not applied (imageio does not apply it).

What it refuses, naming the file: arithmetic coding, lossless and
hierarchical frames, precision other than 8 bits, 2 or 4 components,
sampling layouts other than full size, h2v1 and h2v2 per component, DNL,
Huffman tables a scan uses and the file does not define, and progressive
files whose scans leave one of the first ten coefficients of a component
incomplete (libjpeg would smooth their blocks) raise
``NotImplementedError``; truncated or corrupt data raises ``ValueError``
(libjpeg fills what is missing with zeros and warns, Pillow raises on a
truncated file, and this reader raises on both).
"""
from __future__ import annotations

import functools
import struct
from array import array

import numpy as np

SOI = b"\xff\xd8"

# zig-zag position -> natural (row-major) position within a block
_NATURAL = np.array(sorted(range(64), key=lambda n: (n // 8 + n % 8, n // 8 if (n // 8 + n % 8) % 2 else -(n // 8))))

_SOF_NAMES = {0xC3: "lossless", 0xC5: "hierarchical (differential sequential)",
              0xC6: "hierarchical (differential progressive)", 0xC7: "hierarchical (differential lossless)",
              0xC9: "arithmetic-coded (extended sequential)", 0xCA: "arithmetic-coded (progressive)",
              0xCB: "arithmetic-coded (lossless)", 0xCD: "arithmetic-coded hierarchical",
              0xCE: "arithmetic-coded hierarchical", 0xCF: "arithmetic-coded hierarchical",
              0xCC: "arithmetic-coded (DAC marker)", 0xDE: "hierarchical (DHP marker)",
              0xDF: "hierarchical (EXP marker)"}

# the post-IDCT range limit of jdmaster.c prepare_range_limit_table, indexed
# by (x & 1023): x + 128 clamped to 0-255 for x in [-512, 512), wrapping beyond
_IDCT_LIMIT = np.concatenate([np.arange(128, 256), np.full(384, 255), np.zeros(384), np.arange(0, 128)]).astype(np.uint8)


def _ycc_tables():
    """jdcolor.c build_ycc_rgb_table: SCALEBITS 16, ONE_HALF rounding."""
    x = np.arange(256, dtype=np.int64) - 128
    half = 1 << 15

    def fix(c):
        return int(c * (1 << 16) + 0.5)

    cr_r = (fix(1.40200) * x + half) >> 16
    cb_b = (fix(1.77200) * x + half) >> 16
    cr_g = -fix(0.71414) * x
    cb_g = -fix(0.34414) * x + half
    return cr_r, cb_b, cr_g, cb_g


_CR_R, _CB_B, _CR_G, _CB_G = _ycc_tables()


class _Component:
    __slots__ = ("cid", "h", "v", "tq", "qt", "rows", "cols", "width", "height", "coef", "bits")

    def __init__(self, cid, h, v, tq):
        self.cid, self.h, self.v, self.tq = cid, h, v, tq
        self.qt = None            # latched at the component's first scan


# an entry of a table with values (sequential scans): the code and the
# coefficient's bits fit the window, and the entry holds the decoded value
_HAS_VALUE = 0x8000


def _huffman_lut(counts, symbols, is_dc: bool, where: str, with_values: bool = False):
    """A canonical Huffman table as a 65,536-entry tuple: for every 16-bit
    window, (code length << 8) | symbol, 0 where no code starts it. With
    ``with_values``, where the code's length l and the coefficient's size s
    fit the window (l + s <= 16; s > 0 for an AC table), the entry is instead
    ``(value << 16) | _HAS_VALUE | (run << 5) | (l + s)``, the value
    extended to its sign as ``jdhuff.c`` ``HUFF_EXTEND`` does."""
    if sum(counts) != len(symbols):
        raise ValueError(f"{where}: Huffman table of {sum(counts)} codes has {len(symbols)} symbols")
    if is_dc and any(s > 15 for s in symbols):
        raise ValueError(f"{where}: DC Huffman table has a symbol above 15")
    code = 0
    for length in range(1, 17):
        code += counts[length - 1]
        if code > 1 << length:
            raise ValueError(f"{where}: bad Huffman table")
        code <<= 1
    return _build_lut(bytes(counts), bytes(symbols), is_dc, with_values)


@functools.lru_cache(maxsize=16)
def _build_lut(counts: bytes, symbols: bytes, is_dc: bool, with_values: bool) -> tuple:
    """:func:`_huffman_lut`'s table of a checked table; files written by one
    encoder share their tables, so that a table is built once."""
    lut = np.zeros(65536, np.int64)
    code = k = 0
    for length in range(1, 17):
        for _ in range(counts[length - 1]):
            lo = code << (16 - length)
            lut[lo : lo + (1 << (16 - length))] = (length << 8) | symbols[k]
            code += 1
            k += 1
        code <<= 1
    if with_values:
        length, s, run = lut >> 8, lut & 15, (lut >> 4) & 15
        fits = (lut != 0) & (length + s <= 16) & ((s > 0) | is_dc)
        raw = (np.arange(65536) >> np.maximum(16 - length - s, 0)) & ((1 << s) - 1)
        value = np.where(raw < np.where(s > 0, 1 << np.maximum(s - 1, 0), 0), raw - (1 << s) + 1, raw)
        lut = np.where(fits, (value << 16) | _HAS_VALUE | (run << 5) | (length + s), lut)
    return tuple(lut.tolist())


def _windows(data: np.ndarray) -> array:
    """Unstuffed scan bytes -> the 16 bits that start at every bit position,
    zeros past the end (as libjpeg inserts them), and 64 more such windows
    so that an overrun is caught after the loop rather than by an index."""
    n = data.size
    b = np.zeros(n + 4, np.uint32)
    b[:n] = data
    v = (b[:n] << 24) | (b[1 : n + 1] << 16) | (b[2 : n + 2] << 8) | b[3 : n + 3]
    w = np.zeros(8 * n + 64, np.uint16)
    for j in range(8):
        w[j : 8 * n : 8] = v >> (16 - j)
    return array("H", w.tobytes())


def _segments(buf: bytes, pos: int, path: str):
    """The entropy-coded data of a scan starting at ``pos``: a list of its
    restart intervals, each (unstuffed uint8 array, number of the restart
    marker after it or None), and the position of the marker that ends the
    scan."""
    segs, start = [], pos
    n = len(buf)
    raw = np.frombuffer(buf, np.uint8)
    while True:
        i = buf.find(b"\xff", pos)
        if i < 0 or i + 1 >= n:
            raise ValueError(f"{path}: truncated JPEG (the scan data has no end)")
        nxt = buf[i + 1]
        if nxt == 0:
            pos = i + 2
            continue
        j = i
        while nxt == 0xFF:                       # fill bytes before a marker
            j += 1
            if j + 1 >= n:
                raise ValueError(f"{path}: truncated JPEG (the scan data has no end)")
            nxt = buf[j + 1]
        seg = raw[start:i]
        stuffed = np.flatnonzero((seg[:-1] == 0xFF) & (seg[1:] == 0)) + 1
        seg = np.delete(seg, stuffed) if stuffed.size else seg
        if not 0xD0 <= nxt <= 0xD7:
            segs.append((seg, None))
            return segs, j
        segs.append((seg, nxt - 0xD0))
        start = pos = j + 2


def _intervals(segs, n_units: int, restart: int, path: str):
    """Check the restart markers' count and numbers; yields (data, first
    unit, unit count) per interval."""
    if not restart:
        expect = 1
    else:
        expect = -(-n_units // restart)
    # an encoder may end a scan with a restart marker: empty intervals after
    # the last one are skipped, as libjpeg skips a marker it does not expect
    while len(segs) > expect and segs[-1][0].size == 0:
        segs = segs[:-1]
    if len(segs) != expect:
        raise ValueError(f"{path}: corrupt JPEG ({len(segs)} restart intervals in a scan of {n_units} units, "
                         f"{expect} expected)")
    for k, (data, rst) in enumerate(segs):
        if k < expect - 1 and rst != k % 8:
            raise ValueError(f"{path}: corrupt JPEG (restart marker {rst} where {k % 8} was expected)")
        first = k * restart if restart else 0
        yield data, first, (min(restart, n_units - first) if restart else n_units)


def _overrun(path):
    return ValueError(f"{path}: truncated or corrupt JPEG data (a scan ends before its last block)")


def _bad_code(path):
    return ValueError(f"{path}: corrupt JPEG data (a bit pattern that is no Huffman code)")


def _decode_sequential(w, units, pred, path):
    """Baseline and extended sequential blocks: for each unit (an MCU) the
    (coefficient array, base, DC table, AC table, predictor slot) of its
    blocks, the tables with values. Returns the bit position after the
    interval."""
    p = 0
    for blocks in units:
        for coef, base, dc, ac, ci in blocks:
            e = dc[w[p]]
            if e & _HAS_VALUE:
                p += e & 31
                pred[ci] += e >> 16
            else:
                if not e:
                    raise _bad_code(path)
                p += e >> 8
                s = e & 15
                v = w[p] >> (16 - s)
                p += s
                if v < (1 << (s - 1)):
                    v -= (1 << s) - 1
                pred[ci] += v
            coef[base] = pred[ci]
            k = 1
            while k < 64:
                e = ac[w[p]]
                if e & _HAS_VALUE:
                    p += e & 31
                    k += (e >> 5) & 15
                    if k > 63:
                        raise ValueError(f"{path}: corrupt JPEG data (a coefficient past the end of its block)")
                    coef[base + k] = e >> 16
                    k += 1
                    continue
                if not e:
                    raise _bad_code(path)
                p += e >> 8
                s = e & 15
                if s:
                    k += (e >> 4) & 15
                    if k > 63:
                        raise ValueError(f"{path}: corrupt JPEG data (a coefficient past the end of its block)")
                    v = w[p] >> (16 - s)
                    p += s
                    if v < (1 << (s - 1)):
                        v -= (1 << s) - 1
                    coef[base + k] = v
                    k += 1
                elif e & 0xF0 == 0xF0:
                    k += 16
                else:
                    break
    return p


def _decode_dc_first(w, units, al, pred, path):
    p = 0
    for blocks in units:
        for coef, base, dc, _, ci in blocks:
            e = dc[w[p]]
            if not e:
                raise _bad_code(path)
            p += e >> 8
            s = e & 15
            if s:
                v = w[p] >> (16 - s)
                p += s
                if v < (1 << (s - 1)):
                    v -= (1 << s) - 1
                pred[ci] += v
            coef[base] = pred[ci] << al
    return p


def _decode_dc_refine(w, units, al):
    p = 0
    bit = 1 << al
    for blocks in units:
        for coef, base, _, _, _ in blocks:
            if w[p] >> 15:
                coef[base] |= bit
            p += 1
    return p


def _decode_ac_first(w, units, ss, se, al, path):
    p = 0
    eobrun = 0
    for blocks in units:
        coef, base, _, ac, _ = blocks[0]
        if eobrun:
            eobrun -= 1
            continue
        k = ss
        while k <= se:
            e = ac[w[p]]
            if not e:
                raise _bad_code(path)
            p += e >> 8
            r = (e >> 4) & 15
            s = e & 15
            if s:
                k += r
                if k > se:
                    raise ValueError(f"{path}: corrupt JPEG data (a coefficient past the end of its band)")
                v = w[p] >> (16 - s)
                p += s
                if v < (1 << (s - 1)):
                    v -= (1 << s) - 1
                coef[base + k] = v << al
            elif r == 15:
                k += 15
            else:
                eobrun = 1 << r
                if r:
                    eobrun += w[p] >> (16 - r)
                    p += r
                eobrun -= 1
                break
            k += 1
    return p


def _decode_ac_refine(w, units, ss, se, al, path):
    """jdphuff.c decode_mcu_AC_refine: new coefficients of magnitude 1 << al
    and a correction bit for every coefficient already nonzero that a run
    passes over."""
    p = 0
    eobrun = 0
    p1 = 1 << al
    m1 = -1 << al
    for blocks in units:
        coef, base, _, ac, _ = blocks[0]
        k = ss
        if not eobrun:
            while k <= se:
                e = ac[w[p]]
                if not e:
                    raise _bad_code(path)
                p += e >> 8
                r = (e >> 4) & 15
                s = e & 15
                if s:
                    if s != 1:
                        raise ValueError(f"{path}: corrupt JPEG data (a refinement coefficient of size {s})")
                    s = p1 if w[p] >> 15 else m1
                    p += 1
                elif r != 15:
                    eobrun = 1 << r
                    if r:
                        eobrun += w[p] >> (16 - r)
                        p += r
                    break
                while k <= se:
                    c = coef[base + k]
                    if c:
                        if w[p] >> 15 and not c & p1:
                            coef[base + k] = c + p1 if c >= 0 else c + m1
                        p += 1
                    else:
                        r -= 1
                        if r < 0:
                            break
                    k += 1
                if s:
                    if k > se:
                        raise ValueError(f"{path}: corrupt JPEG data (a coefficient past the end of its band)")
                    coef[base + k] = s
                k += 1
        if eobrun:
            while k <= se:
                c = coef[base + k]
                if c:
                    if w[p] >> 15 and not c & p1:
                        coef[base + k] = c + p1 if c >= 0 else c + m1
                    p += 1
                k += 1
            eobrun -= 1
    return p


def _idct_islow(blocks: np.ndarray) -> np.ndarray:
    """jidctint.c jpeg_idct_islow on dequantised (N, 8, 8) int64
    coefficients in natural order -> (N, 8, 8) uint8 samples."""
    def one_dim(x, axis, out_shift, pass2):
        def at(k):
            return np.take(x, k, axis=axis)

        z2, z3 = at(2), at(6)
        z1 = (z2 + z3) * 4433
        tmp2 = z1 - z3 * 15137
        tmp3 = z1 + z2 * 6270
        z2, z3 = at(0), at(4)
        if pass2:
            z2 = z2 + (1 << (2 + 2))                 # the final descale's rounding, folded into DC
        tmp0 = (z2 + z3) << 13
        tmp1 = (z2 - z3) << 13
        tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
        tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
        t0, t1, t2, t3 = at(7), at(5), at(3), at(1)
        z1, z2, z3, z4 = t0 + t3, t1 + t2, t0 + t2, t1 + t3
        z5 = (z3 + z4) * 9633
        t0 = t0 * 2446
        t1 = t1 * 16819
        t2 = t2 * 25172
        t3 = t3 * 12299
        z1 = z1 * -7373
        z2 = z2 * -20995
        z3 = z3 * -16069 + z5
        z4 = z4 * -3196 + z5
        t0 += z1 + z3
        t1 += z2 + z4
        t2 += z2 + z3
        t3 += z1 + z4
        outs = [tmp10 + t3, tmp11 + t2, tmp12 + t1, tmp13 + t0, tmp13 - t0, tmp12 - t1, tmp11 - t2, tmp10 - t3]
        if not pass2:
            # DESCALE(x, CONST_BITS - PASS1_BITS)
            outs = [(o + (1 << (out_shift - 1))) >> out_shift for o in outs]
        else:
            outs = [o >> out_shift for o in outs]
        return np.stack(outs, axis=axis)

    ws = one_dim(blocks, 1, 13 - 2, False)             # columns: rows index 1
    out = one_dim(ws, 2, 13 + 2 + 3, True)             # rows
    return _IDCT_LIMIT[out & 1023]


# blocks per chunk of the IDCT (int64 temporaries of ~32 MB each)
_IDCT_CHUNK = 1 << 16


def _component_samples(comp: _Component) -> np.ndarray:
    """A component's coefficients -> its (rows*8, cols*8) uint8 plane."""
    zz = np.frombuffer(comp.coef, np.int32).astype(np.int16).astype(np.int64).reshape(-1, 64)
    q = np.asarray(comp.qt, np.int64)
    out = np.empty((zz.shape[0], 8, 8), np.uint8)
    for a in range(0, zz.shape[0], _IDCT_CHUNK):
        part = zz[a : a + _IDCT_CHUNK] * q
        nat = np.empty_like(part)
        nat[:, _NATURAL] = part
        out[a : a + _IDCT_CHUNK] = _idct_islow(nat.reshape(-1, 8, 8))
    return out.reshape(comp.rows, comp.cols, 8, 8).transpose(0, 2, 1, 3).reshape(comp.rows * 8, comp.cols * 8)


def _upsample(x: np.ndarray, hr: int, vr: int) -> np.ndarray:
    """jdsample.c at its default (fancy) setting: ``x`` the component's
    (downsampled_height, downsampled_width) samples, ``hr``, ``vr`` the
    ratios of the largest sampling factors to its own: 1x1, 2x1 or 2x2."""
    if (hr, vr) == (1, 1):
        return x
    dh, dw = x.shape
    if dw <= 2:                                    # libjpeg's box replication
        return np.repeat(np.repeat(x, vr, axis=0), 2, axis=1)
    x = x.astype(np.int32)
    if vr == 1:
        out = np.empty((dh, 2 * dw), np.int32)
        out[:, 0] = x[:, 0]
        out[:, 2::2] = (3 * x[:, 1:] + x[:, :-1] + 1) >> 2
        out[:, 1:-1:2] = (3 * x[:, :-1] + x[:, 1:] + 2) >> 2
        out[:, -1] = x[:, -1]
        return out.astype(np.uint8)
    above = np.concatenate([x[:1], x[:-1]])      # the top row is its own neighbour
    below = np.concatenate([x[1:], x[-1:]])      # and so is the bottom row
    out = np.empty((2 * dh, 2 * dw), np.int32)
    for v, nb in ((0, above), (1, below)):
        cs = 3 * x + nb
        o = out[v::2]
        o[:, 0] = (4 * cs[:, 0] + 8) >> 4
        o[:, 2::2] = (3 * cs[:, 1:] + cs[:, :-1] + 8) >> 4
        o[:, 1:-1:2] = (3 * cs[:, :-1] + cs[:, 1:] + 7) >> 4
        o[:, -1] = (4 * cs[:, -1] + 7) >> 4
    return out.astype(np.uint8)


def _ycc_to_rgb(y, cb, cr) -> np.ndarray:
    y = y.astype(np.int64)
    r = y + _CR_R[cr]
    g = y + ((_CB_G[cb] + _CR_G[cr]) >> 16)
    b = y + _CB_B[cb]
    return np.clip(np.stack([r, g, b], axis=-1), 0, 255).astype(np.uint8)


class _Decoder:
    def __init__(self, buf: bytes, path: str):
        self.buf, self.path = buf, path
        self.qt = {}
        self.dc, self.ac = {}, {}
        self.restart = 0
        self.frame = None
        self.jfif = False
        self.adobe = None         # the Adobe marker's transform byte
        self.scans = 0

    def fail(self, msg, kind=ValueError):
        return kind(f"{self.path}: {msg}")

    def segment(self, pos):
        if pos + 2 > len(self.buf):
            raise self.fail("truncated JPEG (a marker segment is cut)")
        (length,) = struct.unpack_from(">H", self.buf, pos)
        if length < 2 or pos + length > len(self.buf):
            raise self.fail("truncated JPEG (a marker segment is cut)")
        return self.buf[pos + 2 : pos + length], pos + length

    def next_marker(self, pos):
        """libjpeg's next_marker: bytes before an 0xFF are skipped (it warns),
        fill bytes 0xFF are skipped."""
        buf = self.buf
        while True:
            i = buf.find(b"\xff", pos)
            if i < 0:
                raise self.fail("truncated JPEG (no EOI marker)")
            j = i + 1
            while j < len(buf) and buf[j] == 0xFF:
                j += 1
            if j >= len(buf):
                raise self.fail("truncated JPEG (no EOI marker)")
            if buf[j] != 0:
                return buf[j], j + 1
            pos = j + 1

    def decode(self):
        buf = self.buf
        if buf[:2] != SOI:
            raise self.fail("not a JPEG file")
        pos = 2
        while True:
            marker, pos = self.next_marker(pos)
            if marker == 0xD9:                       # EOI
                break
            if 0xD0 <= marker <= 0xD7 or marker == 0x01:
                continue                             # parameterless markers out of place: ignored
            if marker in _SOF_NAMES:
                raise self.fail(f"{_SOF_NAMES[marker]} JPEG is not supported", NotImplementedError)
            if marker == 0xDC:
                raise self.fail("a DNL marker (the height defined after the scan) is not supported",
                                NotImplementedError)
            seg, pos = self.segment(pos)
            if marker in (0xC0, 0xC1, 0xC2):
                self.read_sof(marker, seg)
            elif marker == 0xC4:
                self.read_dht(seg)
            elif marker == 0xDB:
                self.read_dqt(seg)
            elif marker == 0xDD:
                if len(seg) < 2:
                    raise self.fail("bad DRI marker")
                (self.restart,) = struct.unpack_from(">H", seg)
            elif marker == 0xDA:
                pos = self.read_scan(seg, pos)
            elif marker == 0xE0:
                self.jfif = self.jfif or (len(seg) >= 14 and seg[:5] == b"JFIF\0")
            elif marker == 0xEE:
                if len(seg) >= 12 and seg[:5] == b"Adobe":
                    self.adobe = seg[11]
            elif marker == 0xD8:
                raise self.fail("corrupt JPEG (a second SOI marker)")
            # other APPn, COM and unknown markers with a length are skipped
        if self.frame is None or not self.scans:
            raise self.fail("JPEG without a frame or a scan")
        return self.finish()

    def read_sof(self, marker, seg):
        if self.frame is not None:
            raise self.fail("corrupt JPEG (a second frame header)")
        if len(seg) < 6:
            raise self.fail("bad SOF marker")
        precision, height, width, n = struct.unpack_from(">BHHB", seg)
        if precision != 8:
            raise self.fail(f"{precision}-bit precision is not supported (8-bit only)", NotImplementedError)
        if height == 0:
            raise self.fail("a height defined by a DNL marker is not supported", NotImplementedError)
        if width == 0:
            raise self.fail("a frame of width 0")
        if n not in (1, 3):
            raise self.fail(f"{n} components are not supported (1 gray or 3 colour)", NotImplementedError)
        if len(seg) < 6 + 3 * n:
            raise self.fail("bad SOF marker")
        comps = []
        for k in range(n):
            cid, hv, tq = struct.unpack_from(">BBB", seg, 6 + 3 * k)
            h, v = hv >> 4, hv & 15
            if not (1 <= h <= 4 and 1 <= v <= 4) or tq > 3:
                raise self.fail(f"bad SOF marker (sampling {h}x{v}, table {tq})")
            comps.append(_Component(cid, h, v, tq))
        hmax, vmax = max(c.h for c in comps), max(c.v for c in comps)
        layout = [(c.cid, hmax / c.h, vmax / c.v) for c in comps]
        if any((hr, vr) not in ((1, 1), (2, 1), (2, 2)) for _, hr, vr in layout):
            raise self.fail(f"a sampling layout whose components are upsampled "
                            f"{', '.join(f'{hr:g}x{vr:g}' for _, hr, vr in layout)} (horizontal x vertical); "
                            "only 1x1, 2x1 and 2x2 are read", NotImplementedError)
        mcux, mcuy = -(-width // (8 * hmax)), -(-height // (8 * vmax))
        for c in comps:
            c.width = -(-width * c.h // hmax)          # downsampled_width
            c.height = -(-height * c.v // vmax)
            c.rows, c.cols = mcuy * c.v, mcux * c.h
            c.coef = array("i", bytes(4 * 64 * c.rows * c.cols))
            c.bits = [-1] * 64                         # coef_bits of the progressive scans
        self.frame = dict(progressive=marker == 0xC2, width=width, height=height, comps=comps, hmax=hmax,
                          vmax=vmax, mcux=mcux, mcuy=mcuy)

    def read_dht(self, seg):
        pos = 0
        while pos < len(seg):
            if pos + 17 > len(seg):
                raise self.fail("bad DHT marker")
            tc_th = seg[pos]
            counts = list(seg[pos + 1 : pos + 17])
            n = sum(counts)
            if tc_th & 15 > 3 or tc_th >> 4 > 1 or n > 256 or pos + 17 + n > len(seg):
                raise self.fail("bad DHT marker")
            table = (counts, list(seg[pos + 17 : pos + 17 + n]))
            (self.ac if tc_th >> 4 else self.dc)[tc_th & 15] = table
            pos += 17 + n

    def read_dqt(self, seg):
        pos = 0
        while pos < len(seg):
            pq, tq = seg[pos] >> 4, seg[pos] & 15
            size = 128 if pq else 64
            if tq > 3 or pq > 1 or pos + 1 + size > len(seg):
                raise self.fail("bad DQT marker")
            self.qt[tq] = np.frombuffer(seg, ">u2" if pq else np.uint8, 64, pos + 1).astype(np.int64)
            pos += 1 + size

    def lut(self, kind, tid, cache, with_values):
        key = (kind, tid)
        if key not in cache:
            tables = self.dc if kind == "dc" else self.ac
            if tid not in tables:
                raise self.fail(f"a scan uses {kind.upper()} Huffman table {tid}, which the file does not define "
                                "(Motion-JPEG's default tables are not supplied)", NotImplementedError)
            cache[key] = _huffman_lut(*tables[tid], kind == "dc", self.path, with_values)
        return cache[key]

    def read_scan(self, seg, pos):
        f = self.frame
        if f is None:
            raise self.fail("corrupt JPEG (a scan before the frame header)")
        if len(seg) < 1 or len(seg) < 4 + 2 * seg[0]:
            raise self.fail("bad SOS marker")
        ns = seg[0]
        by_id = {c.cid: c for c in f["comps"]}
        comps, tables = [], []
        for k in range(ns):
            cid, t = seg[1 + 2 * k], seg[2 + 2 * k]
            if cid not in by_id or by_id[cid] in comps:
                raise self.fail(f"bad SOS marker (component id {cid})")
            comps.append(by_id[cid])
            tables.append((t >> 4, t & 15))
        ss, se, ahal = seg[1 + 2 * ns], seg[2 + 2 * ns], seg[3 + 2 * ns]
        ah, al = ahal >> 4, ahal & 15
        progressive = f["progressive"]
        if not progressive:
            if ss != 0 or se != 63 or ah or al:
                # libjpeg warns and decodes a sequential scan whatever these say
                ss, se, ah, al = 0, 63, 0, 0
        elif (ss > se or se > 63 or al > 13 or (ss == 0 and se != 0) or (ss > 0 and ns != 1)
              or (ah and ah - 1 != al)):
            raise self.fail(f"bad progressive scan (Ss {ss}, Se {se}, Ah {ah}, Al {al}, {ns} components)")
        if ns < 1 or ns > 4:
            raise self.fail(f"bad SOS marker ({ns} components)")
        for c in comps:
            if c.qt is None:
                if c.tq not in self.qt:
                    raise self.fail(f"quantisation table {c.tq} is not defined")
                c.qt = self.qt[c.tq]
        cache = {}
        need_dc = not progressive or (ss == 0 and ah == 0)
        need_ac = not progressive or ss > 0
        dcs = [self.lut("dc", td, cache, not progressive) if need_dc else None for td, _ in tables]
        acs = [self.lut("ac", ta, cache, not progressive) if need_ac else None for _, ta in tables]

        # the blocks of each unit (an MCU of an interleaved scan, a block of
        # a component's own block grid in a scan of one component)
        if ns == 1:
            c = comps[0]
            bw, bh = -(-c.width // 8), -(-c.height // 8)
            bases = ((np.arange(bh)[:, None] * c.cols + np.arange(bw)[None]) * 64).ravel().tolist()
            dc, ac = dcs[0], acs[0]
            units = [((c.coef, b, dc, ac, 0),) for b in bases]
        else:
            blocks = sum(c.h * c.v for c in comps)
            if blocks > 10:
                raise self.fail(f"bad MCU ({blocks} blocks, at most 10)")
            per = []                                    # (comp slot, row offset, col offset) of each block
            for k, c in enumerate(comps):
                per += [(k, v, h) for v in range(c.v) for h in range(c.h)]
            units = []
            for my in range(f["mcuy"]):
                for mx in range(f["mcux"]):
                    units.append(tuple((comps[k].coef, ((my * comps[k].v + v) * comps[k].cols + mx * comps[k].h + h)
                                        * 64, dcs[k], acs[k], k) for k, v, h in per))
        segs, end = _segments(self.buf, pos, self.path)
        for data, first, count in _intervals(segs, len(units), self.restart, self.path):
            w = _windows(data)
            part = units[first : first + count]
            pred = [0] * ns
            try:
                if not progressive:
                    p = _decode_sequential(w, part, pred, self.path)
                elif ss == 0 and ah == 0:
                    p = _decode_dc_first(w, part, al, pred, self.path)
                elif ss == 0:
                    p = _decode_dc_refine(w, part, al)
                elif ah == 0:
                    p = _decode_ac_first(w, part, ss, se, al, self.path)
                else:
                    p = _decode_ac_refine(w, part, ss, se, al, self.path)
            except (IndexError, OverflowError):
                raise _overrun(self.path) from None
            if p > 8 * data.size:
                raise _overrun(self.path)
        if progressive:
            for c in comps:
                for k in range(ss, se + 1):
                    c.bits[k] = al
        self.scans += 1
        return end

    def finish(self):
        f = self.frame
        comps = f["comps"]
        planes = []
        for c in comps:
            if c.qt is None:
                raise self.fail(f"component {c.cid} has no scan")
            if f["progressive"] and any(b != 0 for b in c.bits[:10]):
                raise self.fail("progressive scans leave a low-frequency coefficient incomplete (libjpeg would "
                                "smooth the blocks)", NotImplementedError)
            x = _component_samples(c)[: c.height, : c.width]
            x = _upsample(x, f["hmax"] // c.h, f["vmax"] // c.v)
            planes.append(x[: f["height"], : f["width"]])
        if len(planes) == 1:
            return np.ascontiguousarray(planes[0])
        if self.jfif:
            rgb = False
        elif self.adobe is not None:
            rgb = self.adobe == 0
        else:
            rgb = [c.cid for c in comps] == [82, 71, 66]
        if rgb:
            return np.stack(planes, axis=-1)
        return _ycc_to_rgb(*planes)


def imread(path: str) -> np.ndarray:
    """Read a JPEG file as ``imageio.v2.imread`` does (see the module doc)."""
    with open(path, "rb") as f:
        buf = f.read()
    return _Decoder(buf, str(path)).decode()
