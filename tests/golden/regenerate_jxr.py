"""A JPEG XR encoder (ITU-T T.832 | ISO/IEC 29199-2) in Python and numpy,
written from recall of the standard's forward process, and the goldens
it writes for ``tests/test_torch_jpegxr.py``,
``tests/golden/regenerate_czi.py`` and ``chip_smoke.py``. It imports
nothing of either package.

No JPEG XR reference (jxrlib, imagecodecs, pylibCZIrw, FreeImage) is on
any machine here, so the port's decoder (``native/jpegxr.cpp``) is held
to this encoder: at lossless settings a round trip must give the source
back exactly, which ties every inverse transform of the decoder to the
forward one here; at lossy settings the decoder must give what this
encoder reconstructs, bit for bit. Neither side was written with the
standard's text or jxrlib's source at hand: the VLC code tables, the
DC/CBP/run-level syntax, the transforms' slot order and the overlap
filter's lifting steps follow the standard's structure as recalled, so
the two sides agree with each other and may share a misreading; any
invertible filter passes a lossless round trip. Agreement with
ZEN-written streams is unchecked. :func:`encode` returns both the
codestream and that reconstruction (dequantization, prediction with the
decoder's truncated flexbits, the inverse transforms and the output
formatting, in numpy).

The forward process: the output format's offset and shift (and
``SHIFT_BITS`` at 16 bits, three fractional bits without
``NO_SCALED_FLAG``), the forward colour transform (RGB to YUV, then
4:2:2 or 4:2:0 chroma by averaging), the first-stage overlap pre-filter
(POT) across 4 × 4 block edges, the 4 × 4 PCT, the second-stage POT on
each channel's image of block DCs across macroblock edges, the
second-stage PCT (a 2 × 2 Hadamard for 4:2:0 chroma, two and a 2-point
lift for 4:2:2), quantization (per tile, per macroblock index), DC, LP
and HP prediction, the adaptive scans, the adaptive VLC tables, model
bits and FLEXBITS, tiles in spatial or frequency order, the index table,
the alpha plane, and the tag-based file container.

Run: python tests/golden/regenerate_jxr.py
"""

from __future__ import annotations

import hashlib
import json
import struct
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

HERE = Path(__file__).parent
JSON_NAME = "jxr_golden.json"

# ------------------------------------------------------------------ bits


class BitWriter:
    """Bits most significant first; :meth:`align` pads a byte with 0s."""

    def __init__(self):
        self.out = bytearray()
        self.acc = 0
        self.n = 0

    def put(self, v: int, n: int) -> None:
        if n == 0:
            return
        if not 0 <= v < (1 << n):
            raise ValueError(f"{v} does not fit {n} bits")
        self.acc = (self.acc << n) | v
        self.n += n
        while self.n >= 8:
            self.n -= 8
            self.out.append((self.acc >> self.n) & 0xFF)
        self.acc &= (1 << self.n) - 1

    def align(self) -> None:
        if self.n:
            self.put(0, 8 - self.n)

    def data(self) -> bytes:
        self.align()
        return bytes(self.out)


def vlw_esc(bw: BitWriter, v: int) -> None:
    """VLW_ESC: two bytes below 0xFB00, else 0xFB and four bytes."""
    if v < 0xFB00:
        bw.put(v, 16)
    else:
        bw.put(0xFB, 8)
        bw.put(v, 32)


# ---------------------------------------------------- adaptive VLC tables

# code lengths of each table of each alphabet; codes are assigned from the
# longest length up, the first code of a length one past the last code of
# the longer length shifted down (so '1', '01', '001', '0000', '0001')
LENGTHS = {
    4: [[1, 2, 3, 3]],
    5: [[1, 2, 3, 4, 4], [1, 3, 3, 3, 3]],
    6: [[1, 2, 3, 4, 5, 5], [1, 2, 4, 4, 4, 4], [1, 3, 3, 3, 4, 4],
        [2, 2, 3, 3, 3, 3]],
    7: [[1, 2, 3, 4, 5, 6, 6], [1, 3, 3, 4, 4, 4, 4]],
    12: [[1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 11],
         [2, 2, 3, 3, 4, 4, 5, 5, 6, 6, 6, 6],
         [2, 3, 3, 3, 3, 4, 4, 5, 5, 5, 6, 6],
         [3, 3, 3, 3, 3, 4, 4, 4, 4, 4, 5, 5],
         [3, 3, 3, 3, 4, 4, 4, 4, 4, 4, 4, 4]],
}
THRESHOLD, MEMORY = 8, 8


def table_codes(lengths: list[int]) -> list[tuple[int, int]]:
    order = sorted(range(len(lengths)), key=lambda s: (-lengths[s], s))
    out: list = [None] * len(lengths)
    code, prev = -1, lengths[order[0]]
    for s in order:
        code = (code + 1) >> (prev - lengths[s])
        out[s] = (code, lengths[s])
        prev = lengths[s]
    return out


CODES = {n: [table_codes(t) for t in ts] for n, ts in LENGTHS.items()}


class AdaptiveVLC:
    """One adaptive table: the table index moves down when the
    discriminant falls below -THRESHOLD and up when the (second, for 6
    and 12 symbols) discriminant passes THRESHOLD; each symbol adds the
    difference of its code lengths between neighbouring tables."""

    def __init__(self, nsym: int):
        self.nsym = nsym
        self.L = LENGTHS[nsym]
        self.T = len(self.L)
        self.two = nsym in (6, 12)
        self.t = 1 if self.two else 0
        self.d = self.d1 = 0
        self._set()

    def _set(self) -> None:
        L, t, T, n = self.L, self.t, self.T, self.nsym
        if T == 1:
            self.delta = self.delta1 = [0] * n
        elif not self.two:
            self.delta = self.delta1 = [L[0][s] - L[1][s] for s in range(n)]
        else:
            lo = max(t, 1)
            hi = min(t, T - 2)
            self.delta = [L[lo - 1][s] - L[lo][s] for s in range(n)]
            self.delta1 = [L[hi][s] - L[hi + 1][s] for s in range(n)]
        self.lower = None if t == 0 else -THRESHOLD
        self.upper = None if t == T - 1 else THRESHOLD

    def put(self, bw: BitWriter, s: int) -> None:
        code, n = CODES[self.nsym][self.t][s]
        bw.put(code, n)
        self.d += self.delta[s]
        if self.two:
            self.d1 += self.delta1[s]

    def adapt(self) -> None:
        if self.T == 1:
            return
        dl = self.d
        dh = self.d1 if self.two else self.d
        if self.lower is not None and dl < self.lower:
            self.t -= 1
            self.d = self.d1 = 0
        elif self.upper is not None and dh > self.upper:
            self.t += 1
            self.d = self.d1 = 0
        lim = THRESHOLD * MEMORY
        self.d = min(max(self.d, -lim), lim)
        self.d1 = min(max(self.d1, -lim), lim)
        self._set()


LEVEL_REMAP, LEVEL_FLC = [2, 3, 4, 6, 10, 14], [0, 0, 1, 2, 2, 2]
RUN_REMAP = [1, 2, 3, 5, 7, 1, 2, 3, 5, 7, 1, 2, 3, 4, 5]
RUN_FLC = [0, 0, 1, 1, 3, 0, 0, 1, 1, 2, 0, 0, 0, 0, 1]


def put_level(bw: BitWriter, tab: AdaptiveVLC, v: int) -> None:
    """An absolute level of 2 or more."""
    if v < 18:
        i = max(k for k in range(6) if LEVEL_REMAP[k] <= v)
        tab.put(bw, i)
        bw.put(v - LEVEL_REMAP[i], LEVEL_FLC[i])
        return
    tab.put(bw, 6)
    k = (v - 2).bit_length() - 1
    if k > 29:
        raise ValueError(f"a level of {v} is too large to code")
    bw.put(min(k - 4, 15), 4)
    if k >= 19:
        bw.put(min(k - 19, 3), 2)
    if k >= 22:
        bw.put(k - 22, 3)
    bw.put(v - 2 - (1 << k), k)


def put_run(bw: BitWriter, tab: AdaptiveVLC, r: int, maxrun: int) -> None:
    """A run of 1..maxrun zeros before a nonzero coefficient."""
    assert 1 <= r <= maxrun
    if maxrun == 1:
        return
    if maxrun < 5:
        for k in range(1, 4):
            if r == k:
                bw.put(1, 1)
                return
            bw.put(0, 1)
            if maxrun == k + 1:
                return
        return
    b = 2 if maxrun <= 6 else (1 if maxrun <= 10 else 0)
    i = max(k for k in range(5) if RUN_REMAP[b * 5 + k] <= r)
    tab.put(bw, i)
    bw.put(r - RUN_REMAP[b * 5 + i], RUN_FLC[b * 5 + i])


class BandTables:
    """The run-level tables of one band (LP or HP) of one plane."""

    def __init__(self):
        self.first = [AdaptiveVLC(12), AdaptiveVLC(12)]
        self.cont = [AdaptiveVLC(6), AdaptiveVLC(6)]
        self.last2 = AdaptiveVLC(4)
        self.run = AdaptiveVLC(5)
        self.level = [AdaptiveVLC(7), AdaptiveVLC(7)]

    def adapt(self) -> None:
        for t in (*self.first, *self.cont, self.run, *self.level):
            t.adapt()


def put_block(bw: BitWriter, tabs: BandTables, cls: int, v: list[int]
              ) -> None:
    """Run-level coding of a block of coefficients in scan order, at
    least one of them nonzero."""
    n = len(v)
    nz = [i for i in range(n) if v[i]]
    prev = -1
    for j, p in enumerate(nz):
        run = p - prev - 1
        nxt = 0 if j == len(nz) - 1 else (1 if nz[j + 1] == p + 1 else 2)
        sl = 1 if abs(v[p]) > 1 else 0
        if j == 0:
            tabs.first[cls].put(bw, nxt * 4 + sl * 2 + (run > 0))
            if run:
                put_run(bw, tabs.run, run, n - 1)
        else:
            if run:
                put_run(bw, tabs.run, run, n - prev - 2)
            if n - 1 - p <= 1:
                tabs.last2.put(bw, nxt * 2 + sl)
            else:
                tabs.cont[cls].put(bw, nxt * 2 + sl)
        bw.put(1 if v[p] < 0 else 0, 1)
        if sl:
            put_level(bw, tabs.level[cls], abs(v[p]))
        prev = p


class Model:
    """Model bits of one band: the low bits of each value that are sent
    as they are (or as FLEXBITS, for HP), luma and chroma apart."""
    W0 = (240, 12, 1)
    W1 = ((0, 240, 120, 80), (0, 12, 6, 4), (0, 16, 8, 5))
    W420, W422 = (120, 37, 2), (120, 18, 1)

    def __init__(self, band: int):
        self.band = band
        self.bits = [0, 0]
        self.state = [0, 0]

    def update(self, fmt: str, nch: int, lap: list[int]) -> None:
        b = self.band
        lap = [lap[0] * self.W0[b], lap[1]]
        if fmt == "420":
            lap[1] *= self.W420[b]
        elif fmt == "422":
            lap[1] *= self.W422[b]
        else:
            lap[1] *= self.W1[b][nch - 1]
            if b == 2:
                lap[1] >>= 4
        for j in range(1 if nch == 1 else 2):
            ms = self.state[j]
            delta = (lap[j] - 70) >> 2
            if delta <= -8:
                ms += max(delta + 4, -16)
                if ms < -8:
                    if self.bits[j] == 0:
                        ms = -8
                    else:
                        ms = 0
                        self.bits[j] -= 1
            elif delta >= 8:
                ms += min(delta - 4, 15)
                if ms > 8:
                    if self.bits[j] >= 15:
                        self.bits[j], ms = 15, 8
                    else:
                        ms = 0
                        self.bits[j] += 1
            self.state[j] = ms


class Scan:
    """An adaptive scan: a nonzero at a scan position raises its count,
    which moves it one place forward when it passes the one before."""

    def __init__(self, slots: list[int]):
        self.slots = list(slots)
        self.totals = [32 - 2 * i for i in range(len(slots))]

    def update(self, vals_in_scan: list[int]) -> None:
        for i in [k for k, x in enumerate(vals_in_scan) if x]:
            self.totals[i] += 1
            if i and self.totals[i] > self.totals[i - 1]:
                for a in (self.slots, self.totals):
                    a[i], a[i - 1] = a[i - 1], a[i]


# ------------------------------------------------------------ transforms
# natural frequency index (row * 4 + column) -> coefficient slot of the PCT
NAT2SLOT = [0, 4, 2, 5, 8, 12, 10, 13, 1, 6, 3, 7, 9, 14, 11, 15]
# the slots predicted from the block or macroblock above (the first row)
# and from the left (the first column), for 4x4, 4:2:0 and 4:2:2 layouts
ROW = {16: [4, 2, 5], 4: [2], 8: [3]}
COL = {16: [8, 1, 9], 4: [1], 8: [1, 2]}
LP_SCAN = {16: [NAT2SLOT[k] for k in (4, 1, 5, 8, 2, 12, 9, 6, 3, 13, 10, 7,
                                      14, 11, 15)],
           4: [1, 2, 3], 8: [1, 2, 3, 5, 6, 4, 7]}
HORIZ = [NAT2SLOT[k] for k in (1, 4, 5, 2, 8, 6, 9, 3, 12, 10, 7, 13, 11,
                               14, 15)]
VERT = [NAT2SLOT[k] for k in (4, 8, 5, 1, 12, 9, 6, 2, 13, 3, 15, 7, 10,
                              14, 11)]
GROUPS = [(0, 3, 12, 15), (1, 2, 13, 14), (4, 7, 8, 11), (5, 6, 9, 10)]


def t2x2h(a, b, c, d, r):
    """The 2 × 2 Hadamard (its own inverse)."""
    a = a + d
    b = b - c
    t = (a - b + r) >> 1
    c2, d2 = t - d, t - c
    return a - d2, b + c2, c2, d2


def fwd_odd(a, b, c, d):
    a = a + d
    b = b - c
    d = ((a + 1) >> 1) - d
    c = c + ((b + 1) >> 1)
    d = d - ((3 * c + 4) >> 3)
    c = c + ((3 * d + 4) >> 3)
    b = b - ((3 * a + 4) >> 3)
    a = a + ((3 * b + 4) >> 3)
    c = c - ((a + 1) >> 1)
    d = d + (b >> 1)
    return a + c, b - d, c, d


def inv_odd(a, b, c, d):
    b = b + d
    a = a - c
    d = d - (b >> 1)
    c = c + ((a + 1) >> 1)
    a = a - ((3 * b + 4) >> 3)
    b = b + ((3 * a + 4) >> 3)
    c = c - ((3 * d + 4) >> 3)
    d = d + ((3 * c + 4) >> 3)
    c = c - ((b + 1) >> 1)
    d = ((a + 1) >> 1) - d
    return a - d, b + c, c, d


def fwd_oddodd(a, b, c, d):
    b, c = -b, -c
    d = d + a
    c = c - b
    t1, t2 = d >> 1, c >> 1
    a = a - t1
    b = b + t2
    a = a + ((b * 3 + 4) >> 3)
    b = b - ((a * 3 + 3) >> 2)
    a = a + ((b * 3 + 3) >> 3)
    b = b - t2
    a = a + t1
    return a, b, c + b, d - a


def inv_oddodd(a, b, c, d):
    d = d + a
    c = c - b
    t1, t2 = d >> 1, c >> 1
    a = a - t1
    b = b + t2
    a = a - ((b * 3 + 3) >> 3)
    b = b + ((a * 3 + 3) >> 2)
    a = a - ((b * 3 + 4) >> 3)
    b = b - t2
    a = a + t1
    c = c + b
    d = d - a
    return a, -b, -c, d


def fct4(x: np.ndarray) -> np.ndarray:
    """The 4 × 4 PCT: (..., 16) pixels in raster order -> slots."""
    p = np.empty_like(x)
    for k, (q0, q1, q2, q3) in enumerate(GROUPS):
        p[..., k], p[..., 8 + k], p[..., 4 + k], p[..., 12 + k] = t2x2h(
            x[..., q0], x[..., q1], x[..., q2], x[..., q3], 0)
    p[..., 0], p[..., 1], p[..., 2], p[..., 3] = t2x2h(
        p[..., 0], p[..., 1], p[..., 2], p[..., 3], 1)
    p[..., 4], p[..., 5], p[..., 7], p[..., 6] = fwd_odd(
        p[..., 4], p[..., 5], p[..., 7], p[..., 6])
    p[..., 8], p[..., 10], p[..., 11], p[..., 9] = fwd_odd(
        p[..., 8], p[..., 10], p[..., 11], p[..., 9])
    p[..., 15], p[..., 14], p[..., 13], p[..., 12] = fwd_oddodd(
        p[..., 15], p[..., 14], p[..., 13], p[..., 12])
    return p


def ict4(p: np.ndarray) -> np.ndarray:
    p = p.copy()
    p[..., 15], p[..., 14], p[..., 13], p[..., 12] = inv_oddodd(
        p[..., 15], p[..., 14], p[..., 13], p[..., 12])
    p[..., 8], p[..., 10], p[..., 11], p[..., 9] = inv_odd(
        p[..., 8], p[..., 10], p[..., 11], p[..., 9])
    p[..., 4], p[..., 5], p[..., 7], p[..., 6] = inv_odd(
        p[..., 4], p[..., 5], p[..., 7], p[..., 6])
    p[..., 0], p[..., 1], p[..., 2], p[..., 3] = t2x2h(
        p[..., 0], p[..., 1], p[..., 2], p[..., 3], 1)
    x = np.empty_like(p)
    for k, (q0, q1, q2, q3) in enumerate(GROUPS):
        x[..., q0], x[..., q1], x[..., q2], x[..., q3] = t2x2h(
            p[..., k], p[..., 8 + k], p[..., 4 + k], p[..., 12 + k], 0)
    return x


def fct420(d: np.ndarray) -> np.ndarray:
    """(..., 4) block DCs (2 × 2 raster) -> 4 slots."""
    return np.stack(t2x2h(d[..., 0], d[..., 1], d[..., 2], d[..., 3], 1), -1)


def ict420(p: np.ndarray) -> np.ndarray:
    return fct420(p)


def fct422(d: np.ndarray) -> np.ndarray:
    """(..., 8) block DCs (4 rows × 2 columns, raster) -> 8 slots: the DC,
    the difference of the halves' DCs, then each half's other three."""
    at, bt, ct, dt = t2x2h(d[..., 0], d[..., 1], d[..., 2], d[..., 3], 1)
    ab, bb, cb, db = t2x2h(d[..., 4], d[..., 5], d[..., 6], d[..., 7], 1)
    diff = ab - at
    dc = at + (diff >> 1)
    return np.stack([dc, diff, bt, ct, dt, bb, cb, db], -1)


def ict422(p: np.ndarray) -> np.ndarray:
    at = p[..., 0] - (p[..., 1] >> 1)
    ab = p[..., 1] + at
    top = t2x2h(at, p[..., 2], p[..., 3], p[..., 4], 1)
    bot = t2x2h(ab, p[..., 5], p[..., 6], p[..., 7], 1)
    return np.stack([*top, *bot], -1)


def p4(a, b, c, d, inverse: bool):
    """The 4-point overlap filter across the edge between b and c."""
    d = d - a
    c = c - b
    a = a + ((d + 1) >> 1)
    b = b + ((c + 1) >> 1)
    if not inverse:
        c = c - ((3 * d + 4) >> 3)
        d = d + ((3 * c + 4) >> 3)
    else:
        d = d - ((3 * c + 4) >> 3)
        c = c + ((3 * d + 4) >> 3)
    b = b - ((c + 1) >> 1)
    a = a - ((d + 1) >> 1)
    return a, b, c + b, d + a


def p2(a, b, inverse: bool):
    """The 2-point overlap filter."""
    d = b - a
    a = a + ((3 * d + 8) >> 4) if inverse else a - ((3 * d + 8) >> 4)
    return a, a + d


def _pass(plane: np.ndarray, bounds, s: int, inverse: bool, axis: int):
    if not len(bounds):
        return
    x = np.asarray(bounds)
    v = plane if axis == 1 else plane.T
    if s == 2:
        r = p4(v[:, x - 2], v[:, x - 1], v[:, x], v[:, x + 1], inverse)
        v[:, x - 2], v[:, x - 1], v[:, x], v[:, x + 1] = r
    else:
        v[:, x - 1], v[:, x] = p2(v[:, x - 1], v[:, x], inverse)


def overlap(plane: np.ndarray, regions, g, s, inverse: bool) -> None:
    """The overlap filter of one stage on ``plane`` in place: in each
    region (a hard tile, or the whole image), across every inner edge of
    the grid ``g`` = (rows, columns), with half-widths ``s``; horizontal
    edges' filters run after the vertical ones' (before, inverse)."""
    for y0, y1, x0, x1 in regions:
        sub = plane[y0:y1, x0:x1]
        xs = list(range(g[1], x1 - x0, g[1]))
        ys = list(range(g[0], y1 - y0, g[0]))
        if not inverse:
            _pass(sub, xs, s[1], False, 1)
            _pass(sub, ys, s[0], False, 0)
        else:
            _pass(sub, ys, s[0], True, 0)
            _pass(sub, xs, s[1], True, 1)


def to_blocks(a: np.ndarray, bh: int, bw: int) -> np.ndarray:
    h, w = a.shape
    return a.reshape(h // bh, bh, w // bw, bw).transpose(0, 2, 1, 3) \
        .reshape(h // bh, w // bw, bh * bw)


def from_blocks(b: np.ndarray, bh: int, bw: int) -> np.ndarray:
    nh, nw, _ = b.shape
    return b.reshape(nh, nw, bh, bw).transpose(0, 2, 1, 3) \
        .reshape(nh * bh, nw * bw)


# ------------------------------------------------------------ parameters

PIXEL_FORMATS = {  # name -> (GUID last byte, channels, bytes, order)
    "8bppGray": (0x08, 1, 1, "Y"), "16bppGray": (0x0B, 1, 2, "Y"),
    "24bppBGR": (0x0C, 3, 1, "BGR"), "24bppRGB": (0x0D, 3, 1, "RGB"),
    "32bppBGRA": (0x0F, 4, 1, "BGRA"), "48bppRGB": (0x15, 3, 2, "RGB"),
}
GUID_PREFIX = bytes.fromhex("24C3DD6F034EFE4BB1853D77768DC9")
YONLY, YUV420, YUV422, YUV444 = 0, 1, 2, 3
CLR_RGB = 7
BD8, BD16 = 1, 2
FMT_CODE = {"Y": YONLY, "420": YUV420, "422": YUV422, "444": YUV444}


@dataclass
class Plane:
    """An image plane's coding settings. Quantizers: ``dc`` is ("image",
    q) or ("tile", [q per tile]); ``lp`` is ("use_dc",), ("image", q) or
    ("tile", [entry per tile]) with an entry "use_dc" or a list of q (the
    macroblocks pick one each); ``hp`` likewise with "use_lp". A q is
    (channel mode 0/1/2, QP indices): one index, Y and UV, or one per
    channel."""
    fmt: str = "444"                 # "Y", "444", "422", "420"
    scaled: bool = False             # NO_SCALED_FLAG = not scaled
    bands: int = 0                   # ALL, NOFLEXBITS, NOHIGHPASS, DCONLY
    dc: tuple = ("image", (0, (0,)))
    lp: tuple = ("use_dc",)
    hp: tuple = ("use_lp",)


@dataclass
class Params:
    pixel_format: str = "24bppBGR"
    plane: Plane = field(default_factory=Plane)
    alpha: Plane | None = None        # interleaved alpha image plane
    planar_alpha: Plane | None = None  # alpha as a second codestream
    overlap: int = 1
    frequency: bool = False
    tile_w: tuple = ()                # widths in MB of all but the last
    tile_h: tuple = ()
    hard: bool = False
    index_table: bool = False         # forced on by tiles or frequency
    short_header: bool = True
    window: tuple | None = None       # (top, left, bottom, right)
    trim: int = 0                     # TRIMMED_FLEXBITS (0: flag off)
    shift_bits: int = 0               # SHIFT_BITS at 16 bits


def _remap(idx: int, scaled: bool, shift: int) -> int:
    if idx == 0:
        return 1
    if not scaled:
        if idx < 32:
            man, e = (idx + 3) >> 2, 0
        elif idx < 48:
            man, e = (16 + (idx & 15) + 1) >> 1, (idx >> 4) - 2
        else:
            man, e = 16 + (idx & 15), (idx >> 4) - 3
    elif idx < 16:
        man, e = idx, shift
    else:
        man, e = 16 + (idx & 15), (idx >> 4) - 1 + shift
    return man << e


def _qps(q, nch: int, scaled: bool, shifted_uv: bool) -> list[int]:
    """QP step of each channel for the quantizer q."""
    mode, idx = q
    ind = [idx[0]] * nch if mode == 0 else (
        [idx[0]] + [idx[1]] * (nch - 1) if mode == 1 else list(idx))
    return [_remap(ind[c], scaled, 0 if (c and shifted_uv) else 1)
            for c in range(nch)]


def _put_q(bw: BitWriter, q, nch: int) -> None:
    mode, idx = q
    if nch > 1:
        bw.put(mode, 2)
    for v in idx[:1 if mode == 0 or nch == 1 else (2 if mode == 1 else nch)]:
        bw.put(v, 8)


# ----------------------------------------------------------- the encoder

class PlaneCoder:
    """One image plane: its transform coefficients, quantized levels,
    coding state and reconstruction."""

    def __init__(self, chans: list[np.ndarray], p: Plane, params: Params,
                 tiles_x: list[int], tiles_y: list[int], mbh: int, mbw: int):
        self.p, self.params = p, params
        self.fmt, self.nch = p.fmt, len(chans)
        self.mbh, self.mbw = mbh, mbw
        self.tiles_x, self.tiles_y = tiles_x, tiles_y   # MB boundaries
        self.ntx, self.nty = len(tiles_x) - 1, len(tiles_y) - 1
        ol = params.overlap
        # per channel: block layout in the MB, its (bh, bw) in blocks
        self.lay = [(4, 4)] + [{"444": (4, 4), "422": (4, 2), "420": (2, 2)
                                }[self.fmt] for _ in range(self.nch - 1)]
        self.hp_lev, self.lp_lev, self.dc_lev = [], [], []
        self.coef = []
        for c, ch in enumerate(chans):
            bh, bw = self.lay[c]
            ch = ch.copy()
            if ol >= 1:
                overlap(ch, self._regions(4 * bh, 4 * bw), (4, 4), (2, 2),
                        False)
            blk = fct4(to_blocks(ch, 4, 4))
            dcimg = blk[..., 0].copy()
            if ol == 2:
                sv, sh = (2 if bh == 4 else 1), (2 if bw == 4 else 1)
                overlap(dcimg, self._regions(bh, bw), (bh, bw), (sv, sh),
                        False)
            mbd = to_blocks(dcimg, bh, bw)
            lp = fct4(mbd) if bh * bw == 16 else (
                fct422(mbd) if bh == 4 else fct420(mbd))
            hp = to_blocks_mb(blk, bh, bw)      # (mbh, mbw, nb, 16)
            self.coef.append((lp, hp))
        self._quant()

    def _regions(self, uh: int, uw: int):
        """Overlap regions in units of uh × uw per MB."""
        if not self.params.hard:
            return [(0, self.mbh * uh, 0, self.mbw * uw)]
        return [(self.tiles_y[j] * uh, self.tiles_y[j + 1] * uh,
                 self.tiles_x[i] * uw, self.tiles_x[i + 1] * uw)
                for j in range(self.nty) for i in range(self.ntx)]

    def tile_of(self, my: int, mx: int) -> int:
        i = max(k for k in range(self.ntx) if self.tiles_x[k] <= mx)
        j = max(k for k in range(self.nty) if self.tiles_y[k] <= my)
        return j * self.ntx + i

    def _quant(self) -> None:
        """The tiles' quantizers, each MB's LP and HP index, the levels."""
        p, nch, nt = self.p, self.nch, self.ntx * self.nty
        sc = p.scaled
        dcq = [p.dc[1]] * nt if p.dc[0] == "image" else list(p.dc[1])
        self.dc_qp = [_qps(q, nch, sc, True) for q in dcq]
        self.lp_q, self.hp_q = [], []
        for t in range(nt):
            if p.lp[0] == "use_dc":
                lp = ["use_dc"]
            elif p.lp[0] == "image":
                lp = [p.lp[1]]
            else:
                lp = p.lp[1][t]
            self.lp_q.append([self.dc_qp[t]] if lp == ["use_dc"] or
                             lp == "use_dc" else
                             [_qps(q, nch, sc, True) for q in lp])
            if p.hp[0] == "use_lp":
                hp = "use_lp"
            elif p.hp[0] == "image":
                hp = [p.hp[1]]
            else:
                hp = p.hp[1][t]
            self.hp_q.append(list(self.lp_q[t]) if hp == "use_lp" else
                             [_qps(q, nch, sc, False) for q in hp])
        # HP with the LP quantizers takes each MB's LP index
        self.hp_uses_lp = [p.hp[0] == "use_lp" or (
            p.hp[0] == "tile" and p.hp[1][t] == "use_lp") for t in range(nt)]
        self.lp_idx = np.zeros((self.mbh, self.mbw), int)
        self.hp_idx = np.zeros((self.mbh, self.mbw), int)
        for my in range(self.mbh):
            for mx in range(self.mbw):
                t = self.tile_of(my, mx)
                self.lp_idx[my, mx] = (mx + 2 * my) % len(self.lp_q[t])
                self.hp_idx[my, mx] = self.lp_idx[my, mx] \
                    if self.hp_uses_lp[t] else \
                    (2 * mx + my + 1) % len(self.hp_q[t])
        for c in range(nch):
            lp, hp = self.coef[c]
            qdc = np.zeros(lp.shape[:2], np.int64)
            qlp = np.zeros(lp.shape[:2], np.int64)
            qhp = np.zeros(lp.shape[:2], np.int64)
            for my in range(self.mbh):
                for mx in range(self.mbw):
                    t = self.tile_of(my, mx)
                    qdc[my, mx] = self.dc_qp[t][c]
                    qlp[my, mx] = self.lp_q[t][self.lp_idx[my, mx]][c]
                    qhp[my, mx] = self.hp_q[t][self.hp_idx[my, mx]][c]
            lpl = _q(lp, qlp[..., None])
            lpl[..., 0] = _q(lp[..., 0], qdc)
            hpl = _q(hp, qhp[..., None, None])
            hpl[..., 0] = 0
            if p.bands >= 2:
                hpl[:] = 0
            if p.bands == 3:
                lpl[..., 1:] = 0
            self.lp_lev.append(lpl)
            self.hp_lev.append(hpl)
        self.hp_rec = [np.zeros_like(h) for h in self.hp_lev]

    # --------------------------------------------------------- coding
    def start_tile(self) -> None:
        """Every adaptive state is reset at the start of a tile."""
        self.dc_tabs = [AdaptiveVLC(7), AdaptiveVLC(7)]
        self.lp_tabs, self.hp_tabs = BandTables(), BandTables()
        self.cbp_tabs = [AdaptiveVLC(5), AdaptiveVLC(5)]
        self.models = [Model(0), Model(1), Model(2)]
        self.lp_scan = [Scan(LP_SCAN[16])] + [
            Scan(LP_SCAN[self.lp_lev[c].shape[-1]])
            for c in range(1, self.nch)]
        self.hp_scan = [Scan(HORIZ), Scan(VERT)]

    def _cls(self, c: int) -> int:
        return 0 if c == 0 else 1

    def dc_mode(self, my, mx, t0x, t0y) -> int:
        """0 none, 1 left, 2 top, 3 the mean of both."""
        left, top = mx > t0x, my > t0y
        if not (left or top):
            return 0
        if not top:
            return 1
        if not left:
            return 2
        d = [self.lp_lev[c] for c in range(self.nch)]
        cs = range(self.nch) if self.fmt == "444" else range(1)
        sh = sum(abs(int(d[c][my - 1, mx - 1, 0]) - int(d[c][my, mx - 1, 0]))
                 for c in cs)
        sv = sum(abs(int(d[c][my - 1, mx - 1, 0]) - int(d[c][my - 1, mx, 0]))
                 for c in cs)
        if sh * 4 < sv:
            return 2
        if sv * 4 < sh:
            return 1
        return 3

    def put_qp_index(self, bw: BitWriter, n: int, i: int) -> None:
        b = _qbits(n)
        if b == 0:
            return
        bw.put(1 if i else 0, 1)
        if i:
            bw.put(i - 1, b)

    def code_mb_indices(self, bw, my, mx, t, which) -> None:
        if "lp" in which and self.p.bands != 3:
            self.put_qp_index(bw, len(self.lp_q[t]), self.lp_idx[my, mx])
        if "hp" in which and self.p.bands < 2 and not self.hp_uses_lp[t]:
            self.put_qp_index(bw, len(self.hp_q[t]), self.hp_idx[my, mx])

    def code_dc(self, bw, my, mx, t0x, t0y) -> None:
        mode = self.dc_mode(my, mx, t0x, t0y)
        m = self.models[0]
        res = []
        for c in range(self.nch):
            d = self.lp_lev[c]
            cur = int(d[my, mx, 0])
            pred = 0
            if mode == 1:
                pred = int(d[my, mx - 1, 0])
            elif mode == 2:
                pred = int(d[my - 1, mx, 0])
            elif mode == 3:
                pred = (int(d[my, mx - 1, 0]) + int(d[my - 1, mx, 0])) >> 1
            res.append(cur - pred)
        ks = [m.bits[self._cls(c)] for c in range(self.nch)]
        his = [abs(r) >> k for r, k in zip(res, ks)]
        for h in his:
            bw.put(1 if h else 0, 1)
        for c, (r, k, h) in enumerate(zip(res, ks, his)):
            if h:
                put_level(bw, self.dc_tabs[self._cls(c)], h + 1)
            bw.put(abs(r) & ((1 << k) - 1), k)
            if r:
                bw.put(1 if r < 0 else 0, 1)
        m.update(self.fmt, self.nch, [int(his[0] != 0),
                                      sum(h != 0 for h in his[1:])])
        for tb in self.dc_tabs:
            tb.adapt()

    def code_lp(self, bw, my, mx, t0x, t0y) -> None:
        mode = self.dc_mode(my, mx, t0x, t0y)
        m = self.models[1]
        vs, los, nz = [], [], []
        for c in range(self.nch):
            lev = self.lp_lev[c]
            n = lev.shape[-1]
            res = lev[my, mx].astype(np.int64).copy()
            if mode == 1 and self.lp_idx[my, mx - 1] == self.lp_idx[my, mx]:
                for s in COL[n]:
                    res[s] -= lev[my, mx - 1, s]
            elif mode == 2 and self.lp_idx[my - 1, mx] == self.lp_idx[my, mx]:
                for s in ROW[n]:
                    res[s] -= lev[my - 1, mx, s]
            k = m.bits[self._cls(c)]
            v = [int(np.sign(r)) * (abs(int(r)) >> k) for r in res]
            vs.append((v, [int(r) for r in res], k))
            nz.append(any(v[1:]))
        for f in nz:
            bw.put(int(f), 1)
        lap = [0, 0]
        for c, (v, res, k) in enumerate(vs):
            sc = self.lp_scan[c]
            vscan = [v[s] for s in sc.slots]
            if nz[c]:
                put_block(bw, self.lp_tabs, self._cls(c), vscan)
            lap[self._cls(c)] += sum(1 for x in vscan if x)
            sc.update(vscan)
        for c, (v, res, k) in enumerate(vs):
            for s in range(1, len(v)):
                lo = abs(res[s]) & ((1 << k) - 1)
                bw.put(lo, k)
                if v[s] == 0 and lo:
                    bw.put(1 if res[s] < 0 else 0, 1)
        m.update(self.fmt, self.nch, lap)
        self.lp_tabs.adapt()

    def hp_mode(self, my, mx) -> int:
        """0 none, 1 from the left, 2 from above."""
        lp = self.lp_lev[0][my, mx]
        er = sum(abs(int(lp[s])) for s in ROW[16])
        ec = sum(abs(int(lp[s])) for s in COL[16])
        if er * 4 < ec:
            return 1
        if ec * 4 < er:
            return 2
        return 0

    def _cbp_pred(self, c, my, mx, b, t0x, t0y, bits_now) -> int:
        bh, bw = self.lay[c]
        r, q = divmod(b, bw)
        if q:
            return bits_now[b - 1]
        if mx > t0x:
            return self.cbp[c][my, mx - 1][r * bw + bw - 1]
        if r:
            return bits_now[b - bw]
        if my > t0y:
            return self.cbp[c][my - 1, mx][(bh - 1) * bw]
        return 0

    def code_hp(self, bw, my, mx, t0x, t0y) -> None:
        mode = self.hp_mode(my, mx)
        scan = self.hp_scan[1 if mode == 1 else 0]
        m = self.models[2]
        trim = self.params.trim
        flex = self.p.bands == 0
        blocks = []           # per channel: list of (v, res) per block
        for c in range(self.nch):
            k = m.bits[self._cls(c)]
            lev = self.hp_lev[c][my, mx]
            rec = self.hp_rec[c][my, mx]
            bh, bwd = self.lay[c]
            out = []
            for b in range(bh * bwd):
                r, q = divmod(b, bwd)
                pred = np.zeros(16, np.int64)
                if mode == 1 and q:
                    for s in COL[16]:
                        pred[s] = rec[b - 1, s]
                elif mode == 2 and r:
                    for s in ROW[16]:
                        pred[s] = rec[b - bwd, s]
                res = lev[b] - pred
                v = [0] + [int(np.sign(x)) * (abs(int(x)) >> k)
                           for x in res[1:]]
                for s in range(1, 16):
                    a = abs(int(res[s]))
                    lo = ((a & ((1 << k) - 1)) >> trim << trim) if flex \
                        else 0
                    mag = (abs(v[s]) << k) + lo
                    sgn = -1 if res[s] < 0 else 1
                    rec[b, s] = pred[s] + sgn * mag
                out.append((v, [int(x) for x in res], k))
            blocks.append(out)
        # the coded block pattern, each bit XOR its prediction
        for c in range(self.nch):
            bh, bwd = self.lay[c]
            bits = [int(any(v[1:])) for v, _, _ in blocks[c]]
            diff = [bits[b] ^ self._cbp_pred(c, my, mx, b, t0x, t0y, bits)
                    for b in range(len(bits))]
            self.cbp[c][my, mx] = bits
            self._put_cbp(bw, c, diff, bh, bwd)
        lap = [0, 0]
        for c in range(self.nch):
            for v, _, _ in blocks[c]:
                vscan = [v[s] for s in scan.slots]
                if any(vscan):
                    put_block(bw, self.hp_tabs, self._cls(c), vscan)
                    lap[self._cls(c)] += sum(1 for x in vscan if x)
                scan.update(vscan)
        self.flex_data[(my, mx)] = blocks
        m.update(self.fmt, self.nch, lap)
        self.hp_tabs.adapt()
        for tb in self.cbp_tabs:
            tb.adapt()

    def _put_cbp(self, bw, c, diff, bh, bwd) -> None:
        quads = [[(2 * qy + y) * bwd + 2 * qx + x for y in (0, 1)
                  for x in (0, 1)] for qy in range(bh // 2)
                 for qx in range(bwd // 2)]
        pats = [sum(diff[b] << i for i, b in enumerate(q)) for q in quads]
        mask = [int(p != 0) for p in pats]
        if len(quads) == 1:
            bw.put(mask[0], 1)
        elif len(quads) == 2:
            bw.put(int(any(mask)), 1)
            if any(mask):
                bw.put(int(all(mask)), 1)
                if not all(mask):
                    bw.put(mask.index(1), 1)
        else:
            _put_set(bw, self.cbp_tabs[self._cls(c)], mask, True)
        for p, f in zip(pats, mask):
            if f:
                _put_set(bw, None, [(p >> i) & 1 for i in range(4)], False)

    def code_flex(self, bw, my, mx) -> None:
        trim = self.params.trim
        for c, out in enumerate(self.flex_data[(my, mx)]):
            for v, res, k in out:
                n = k - trim
                if n <= 0:
                    continue
                for s in range(1, 16):
                    lo = (abs(res[s]) & ((1 << k) - 1)) >> trim
                    bw.put(lo, n)
                    if v[s] == 0 and lo:
                        bw.put(1 if res[s] < 0 else 0, 1)


def _put_set(bw, tab, mask, with_zero: bool) -> None:
    """A set of four flags: its size (an adaptive 5-symbol table, or the
    fixed 4-symbol one when it cannot be empty), then which."""
    k = sum(mask)
    if with_zero:
        tab.put(bw, k)
    else:
        code, n = CODES[4][0][k - 1]
        bw.put(code, n)
    on = [i for i in range(4) if mask[i]]
    if k == 1:
        bw.put(on[0], 2)
    elif k == 2:
        bw.put(PAIRS.index(tuple(on)), 3)
    elif k == 3:
        bw.put([i for i in range(4) if not mask[i]][0], 2)


PAIRS = [(0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3)]


def _qbits(n: int) -> int:
    return 0 if n < 2 else (1 if n < 4 else (2 if n < 6 else
                                             (3 if n < 10 else 4)))


def _q(c: np.ndarray, step) -> np.ndarray:
    return np.sign(c) * ((np.abs(c) + step // 2) // step)


def to_blocks_mb(blk: np.ndarray, bh: int, bw: int) -> np.ndarray:
    """(nby, nbx, 16) block coefficients -> (mbh, mbw, bh * bw, 16)."""
    nby, nbx, _ = blk.shape
    return blk.reshape(nby // bh, bh, nbx // bw, bw, 16).transpose(
        0, 2, 1, 3, 4).reshape(nby // bh, nbx // bw, bh * bw, 16)


def from_blocks_mb(b: np.ndarray, bh: int, bw: int) -> np.ndarray:
    mbh, mbw = b.shape[:2]
    return b.reshape(mbh, mbw, bh, bw, 16).transpose(0, 2, 1, 3, 4) \
        .reshape(mbh * bh, mbw * bw, 16)


# ------------------------------------------------------ colour and output

def _cc(r, g, b):
    b = b - r
    r = r + ((b + 1) >> 1) - g
    g = g + (r >> 1)
    return g, -r, b            # Y, U, V


def _icc(y, u, v):
    r, g, b = -u, y, v
    g = g - (r >> 1)
    r = r - ((b + 1) >> 1) + g
    b = b + r
    return r, g, b


def _offset(depth: int, shift_bits: int) -> int:
    return (128 if depth == 1 else 32768) >> shift_bits


def _to_internal(x: np.ndarray, depth: int, sb: int, scaled: bool):
    s = 3 if scaled else 0
    return ((x.astype(np.int64) >> sb) - _offset(depth, sb)) << s


def _to_output(x: np.ndarray, depth: int, sb: int, scaled: bool):
    s = 3 if scaled else 0
    if s:
        x = (x + (1 << (s - 1))) >> s
    x = x + _offset(depth, sb)
    hi = (255 if depth == 1 else 65535) >> sb
    return np.clip(x, 0, hi) << sb


def _upsample(c: np.ndarray, axis: int) -> np.ndarray:
    """Chroma at even positions, odd ones the rounded mean of their
    neighbours (the last repeated)."""
    c = np.moveaxis(c, axis, 0)
    nxt = np.concatenate([c[1:], c[-1:]], 0)
    out = np.empty((2 * c.shape[0],) + c.shape[1:], c.dtype)
    out[0::2] = c
    out[1::2] = (c + nxt + 1) >> 1
    return np.moveaxis(out, 0, axis)


# ---------------------------------------------------------- the codestream

def _tile_bounds(sizes, total: int) -> list[int]:
    b = [0]
    for s in sizes:
        b.append(b[-1] + s)
    if b[-1] >= total:
        raise ValueError("tiles past the image")
    return b + [total]


def _plane_header(bw: BitWriter, p: Plane, nch: int, depth: int,
                  params: Params) -> None:
    bw.put(FMT_CODE[p.fmt], 3)
    bw.put(0 if p.scaled else 1, 1)
    bw.put(p.bands, 4)
    if p.fmt != "Y":          # chroma centering (co-sited) and reserved bits
        bw.put(0, 8)
    if depth == BD16:
        bw.put(params.shift_bits, 8)
    bw.put(int(p.dc[0] == "image"), 1)
    if p.dc[0] == "image":
        _put_q(bw, p.dc[1], nch)
    if p.bands != 3:
        bw.put(int(p.lp[0] == "use_dc"), 1)
        if p.lp[0] != "use_dc":
            bw.put(int(p.lp[0] == "image"), 1)
            if p.lp[0] == "image":
                _put_q(bw, p.lp[1], nch)
        if p.bands < 2:
            bw.put(int(p.hp[0] == "use_lp"), 1)
            if p.hp[0] != "use_lp":
                bw.put(int(p.hp[0] == "image"), 1)
                if p.hp[0] == "image":
                    _put_q(bw, p.hp[1], nch)
    bw.align()


def _tile_headers(bw: BitWriter, pc: PlaneCoder, t: int, which) -> None:
    p, nch = pc.p, pc.nch
    lp_tile = p.lp[0] == "tile" or (p.lp[0] == "use_dc" and
                                    p.dc[0] == "tile")
    hp_tile = p.hp[0] == "tile" or (p.hp[0] == "use_lp" and lp_tile)
    if "dc" in which and p.dc[0] == "tile":
        _put_q(bw, p.dc[1][t], nch)
    if "lp" in which and p.bands != 3 and lp_tile:
        e = p.lp[1][t] if p.lp[0] == "tile" else "use_dc"
        bw.put(int(e == "use_dc"), 1)
        if e != "use_dc":
            bw.put(len(e) - 1, 4)
            for q in e:
                _put_q(bw, q, nch)
    if "hp" in which and p.bands < 2 and hp_tile:
        e = p.hp[1][t] if p.hp[0] == "tile" else "use_lp"
        bw.put(int(e == "use_lp"), 1)
        if e != "use_lp":
            bw.put(len(e) - 1, 4)
            for q in e:
                _put_q(bw, q, nch)


def _packet(bw: BitWriter, kind: int, t: int) -> None:
    for b in (0, 0, 1):
        bw.put(b, 8)
    bw.put(((t & 31) << 3) | kind, 8)


def codestream(img: np.ndarray, params: Params, plane: Plane,
               alpha: np.ndarray | None, alpha_plane: Plane | None,
               depth: int, spans: list | None = None
               ) -> tuple[bytes, np.ndarray]:
    """One JPEG XR codestream of ``img`` ((H, W, 1 or 3) in R, G, B
    order) and ``alpha`` ((H, W) or None, interleaved as an alpha image
    plane); returns it and its reconstruction (H, W, channels). Into
    ``spans``, if given, goes each tile packet's (start, end) in the
    codestream and its tile's (y0, y1, x0, x1) in image pixels."""
    H, W = img.shape[:2]
    top, left, bottom, right = params.window or (
        0, 0, (-H) % 16, (-W) % 16)
    ch_, cw_ = top + H + bottom, left + W + right
    if ch_ % 16 or cw_ % 16:
        raise ValueError("the window does not make whole macroblocks")
    mbh, mbw = ch_ // 16, cw_ // 16
    tx = _tile_bounds(params.tile_w, mbw)
    ty = _tile_bounds(params.tile_h, mbh)
    tiled = len(tx) > 2 or len(ty) > 2
    index = params.index_table or tiled or params.frequency
    sb = params.shift_bits if depth == BD16 else 0

    def pad(a):
        return np.pad(a, ((top, bottom), (left, right)) + ((0, 0),) *
                      (a.ndim - 2), mode="edge")

    def internal(a, p):
        x = _to_internal(pad(a), depth, sb, p.scaled)
        if p.fmt == "Y":
            return [x[..., 0]]
        y, u, v = _cc(x[..., 0], x[..., 1], x[..., 2])
        if p.fmt in ("422", "420"):
            u = (u[:, 0::2] + u[:, 1::2] + 1) >> 1
            v = (v[:, 0::2] + v[:, 1::2] + 1) >> 1
        if p.fmt == "420":
            u = (u[0::2] + u[1::2] + 1) >> 1
            v = (v[0::2] + v[1::2] + 1) >> 1
        return [y, u, v]

    coders = [PlaneCoder(internal(img, plane), plane, params, tx, ty, mbh,
                         mbw)]
    if alpha is not None:
        coders.append(PlaneCoder(internal(alpha[..., None], alpha_plane),
                                 alpha_plane, params, tx, ty, mbh, mbw))
    nch = img.shape[2]
    bw = BitWriter()
    for b in b"WMPHOTO\0":
        bw.put(b, 8)
    bw.put(1, 4)
    bw.put(int(params.hard), 1)
    bw.put(1, 3)
    bw.put(int(tiled), 1)
    bw.put(int(params.frequency), 1)
    bw.put(0, 3)
    bw.put(int(index), 1)
    bw.put(params.overlap, 2)
    bw.put(int(params.short_header), 1)
    bw.put(int(depth == BD16), 1)
    bw.put(int(params.window is not None), 1)
    bw.put(int(params.trim > 0), 1)
    bw.put(0, 3)
    bw.put(int(alpha is not None), 1)
    bw.put(YONLY if nch == 1 else CLR_RGB, 4)
    bw.put(depth, 4)
    nb = 16 if params.short_header else 32
    bw.put(W - 1, nb)
    bw.put(H - 1, nb)
    if tiled:
        bw.put(len(tx) - 2, 12)
        bw.put(len(ty) - 2, 12)
        for s in params.tile_w:
            bw.put(s, 8 if params.short_header else 16)
        for s in params.tile_h:
            bw.put(s, 8 if params.short_header else 16)
    if params.window is not None:
        for m in (top, left, bottom, right):
            bw.put(m, 6)
    bw.align()
    _plane_header(bw, plane, nch, depth, params)
    if alpha is not None:
        _plane_header(bw, alpha_plane, 1, depth, params)

    nbands = 4 - min(c.p.bands for c in coders)
    packets = []
    for j in range(len(ty) - 1):
        for i in range(len(tx) - 1):
            t = j * (len(tx) - 1) + i
            mbs = [(my, mx) for my in range(ty[j], ty[j + 1])
                   for mx in range(tx[i], tx[i + 1])]
            for c in coders:
                c.start_tile()
                c.cbp = [{} for _ in range(c.nch)]
                c.flex_data = {}
            if not params.frequency:
                w = BitWriter()
                _packet(w, 0, t)
                if params.trim:
                    w.put(params.trim, 4)
                for c in coders:
                    _tile_headers(w, c, t, ("dc", "lp", "hp"))
                for my, mx in mbs:
                    for c in coders:
                        c.code_mb_indices(w, my, mx, t, ("lp", "hp"))
                        c.code_dc(w, my, mx, tx[i], ty[j])
                        if c.p.bands != 3:
                            c.code_lp(w, my, mx, tx[i], ty[j])
                        if c.p.bands < 2:
                            c.code_hp(w, my, mx, tx[i], ty[j])
                        if c.p.bands == 0:
                            c.code_flex(w, my, mx)
                packets.append([w.data()])
                continue
            ws = [BitWriter() for _ in range(nbands)]
            for k, w in enumerate(ws):
                _packet(w, k + 1, t)
            if nbands == 4 and params.trim:
                ws[3].put(params.trim, 4)
            for c in coders:
                _tile_headers(ws[0], c, t, ("dc",))
                if nbands > 1:
                    _tile_headers(ws[1], c, t, ("lp",))
                if nbands > 2:
                    _tile_headers(ws[2], c, t, ("hp",))
            for my, mx in mbs:
                for c in coders:
                    c.code_dc(ws[0], my, mx, tx[i], ty[j])
            for my, mx in mbs:
                for c in coders:
                    if nbands > 1 and c.p.bands != 3:
                        c.code_mb_indices(ws[1], my, mx, t, ("lp",))
                        c.code_lp(ws[1], my, mx, tx[i], ty[j])
            for my, mx in mbs:
                for c in coders:
                    if nbands > 2 and c.p.bands < 2:
                        c.code_mb_indices(ws[2], my, mx, t, ("hp",))
                        c.code_hp(ws[2], my, mx, tx[i], ty[j])
            for my, mx in mbs:
                for c in coders:
                    if nbands > 3 and c.p.bands == 0:
                        c.code_flex(ws[3], my, mx)
            packets.append([w.data() for w in ws])
    if index:
        bw.put(1, 16)
        off = 0
        for pk in packets:
            for d in pk:
                vlw_esc(bw, off)
                off += len(d)
    vlw_esc(bw, 0)              # SUBSEQUENT_BYTES
    head = bw.data()
    out = head + b"".join(d for pk in packets for d in pk)
    if spans is not None:
        at = len(head)
        for t, pk in enumerate(packets):
            j, i = divmod(t, len(tx) - 1)
            box = (max(ty[j] * 16 - top, 0), min(ty[j + 1] * 16 - top, H),
                   max(tx[i] * 16 - left, 0), min(tx[i + 1] * 16 - left, W))
            for d in pk:
                spans.append(((at, at + len(d)), box))
                at += len(d)

    recs = [reconstruct(c, params, depth, sb) for c in coders]
    rec = recs[0]
    if alpha is not None:
        rec = np.concatenate([rec, recs[1]], -1)
    rec = rec[top:top + H, left:left + W]
    return out, rec


def reconstruct(pc: PlaneCoder, params: Params, depth: int, sb: int
                ) -> np.ndarray:
    """What a decoder makes of the plane: dequantized levels, the inverse
    transforms, the inverse colour transform and the output clip, on the
    coded (padded) image."""
    chans = []
    for c in range(pc.nch):
        bh, bw = pc.lay[c]
        lpl = pc.lp_lev[c]
        hpl = pc.hp_rec[c]
        qdc = np.zeros(lpl.shape[:2], np.int64)
        qlp = np.zeros(lpl.shape[:2], np.int64)
        qhp = np.zeros(lpl.shape[:2], np.int64)
        for my in range(pc.mbh):
            for mx in range(pc.mbw):
                t = pc.tile_of(my, mx)
                qdc[my, mx] = pc.dc_qp[t][c]
                qlp[my, mx] = pc.lp_q[t][pc.lp_idx[my, mx]][c]
                qhp[my, mx] = pc.hp_q[t][pc.hp_idx[my, mx]][c]
        lp = lpl * qlp[..., None]
        lp[..., 0] = lpl[..., 0] * qdc
        hp = hpl * qhp[..., None, None]
        mbd = ict4(lp) if bh * bw == 16 else (
            ict422(lp) if bh == 4 else ict420(lp))
        dcimg = from_blocks(mbd, bh, bw)
        if params.overlap == 2:
            sv, sh = (2 if bh == 4 else 1), (2 if bw == 4 else 1)
            overlap(dcimg, pc._regions(bh, bw), (bh, bw), (sv, sh), True)
        blk = from_blocks_mb(hp, bh, bw)
        blk[..., 0] = dcimg
        x = from_blocks(ict4(blk), 4, 4)
        if params.overlap >= 1:
            overlap(x, pc._regions(4 * bh, 4 * bw), (4, 4), (2, 2), True)
        chans.append(x)
    if pc.fmt == "Y":
        out = [chans[0]]
    else:
        y, u, v = chans
        if pc.fmt == "420":
            u, v = _upsample(u, 0), _upsample(v, 0)
        if pc.fmt in ("420", "422"):
            u, v = _upsample(u, 1), _upsample(v, 1)
        out = list(_icc(y, u, v))
    return np.stack([_to_output(o, depth, sb, pc.p.scaled) for o in out],
                    -1)


# ------------------------------------------------------------ the container

TAG_PIXEL_FORMAT, TAG_WIDTH, TAG_HEIGHT = 0xBC01, 0xBC80, 0xBC81
TAG_IMAGE_OFFSET, TAG_IMAGE_BYTES = 0xBCC0, 0xBCC1
TAG_ALPHA_OFFSET, TAG_ALPHA_BYTES = 0xBCC2, 0xBCC3


def container(guid: bytes, w: int, h: int, image: bytes,
              alpha: bytes | None = None) -> bytes:
    """The tag-based file: ``II`` 0xBC 0x01, the IFD at 8, the GUID, then
    the codestreams."""
    n = 6 + (2 if alpha is not None else 0)
    ifd_size = 2 + 12 * n + 4
    guid_at = 8 + ifd_size
    img_at = guid_at + 16
    entries = [(TAG_PIXEL_FORMAT, 1, 16, guid_at), (TAG_WIDTH, 4, 1, w),
               (TAG_HEIGHT, 4, 1, h), (TAG_IMAGE_OFFSET, 4, 1, img_at),
               (TAG_IMAGE_BYTES, 4, 1, len(image))]
    if alpha is not None:
        entries += [(TAG_ALPHA_OFFSET, 4, 1, img_at + len(image)),
                    (TAG_ALPHA_BYTES, 4, 1, len(alpha))]
    entries.append((0xBC82, 11, 1, struct.unpack("<I", struct.pack(
        "<f", 96.0))[0]))
    entries.sort()
    out = b"II\xbc\x01" + struct.pack("<I", 8) + struct.pack("<H", n)
    for tag, typ, cnt, val in entries:
        out += struct.pack("<HHII", tag, typ, cnt, val)
    out += struct.pack("<I", 0) + guid + image + (alpha or b"")
    return out


def lossless(params: Params) -> bool:
    """Whether the settings keep every sample: QP index 0 in every band,
    every band, 4:4:4 or grey, no SHIFT_BITS and no trimmed flexbits."""
    planes = [p for p in (params.plane, params.alpha, params.planar_alpha)
              if p is not None]
    return params.trim == 0 and params.shift_bits == 0 and all(
        p.fmt in ("Y", "444") and p.bands == 0 and
        p.dc == ("image", (0, (0,))) and p.lp == ("use_dc",) and
        p.hp == ("use_lp",) for p in planes)


def guid(pixel_format: str | int) -> bytes:
    last = pixel_format if isinstance(pixel_format, int) else \
        PIXEL_FORMATS[pixel_format][0]
    return GUID_PREFIX + bytes([last])


def encode(pixels: np.ndarray, params: Params, spans: list | None = None
           ) -> tuple[bytes, np.ndarray]:
    """A JPEG XR file of ``pixels`` ((H, W[, C]) uint8 or uint16 in the
    pixel format's channel order) and the (H, W, C) pixels a decoder must
    return (its reconstruction; the source itself at lossless
    settings). ``spans`` gets the image codestream's tile packets as
    :func:`codestream` gives them, offset into the file."""
    code, nch, nbytes, order = PIXEL_FORMATS[params.pixel_format]
    px = np.asarray(pixels)
    if px.ndim == 2:
        px = px[..., None]
    H, W = px.shape[:2]
    depth = BD8 if nbytes == 1 else BD16
    rgb = px[..., [order.index(k) for k in "RGB"]] if nch >= 3 else px
    a = px[..., order.index("A")] if "A" in order else None
    inter = a if params.alpha is not None else None
    cs_spans = []
    cs, rec = codestream(rgb, params, params.plane, inter, params.alpha,
                         depth, cs_spans)
    alpha_cs = None
    if a is not None and params.alpha is None:
        if params.planar_alpha is None:
            raise ValueError("32bppBGRA needs alpha or planar_alpha")
        alpha_cs, arec = codestream(a[..., None], params,
                                    params.planar_alpha, None, None, depth)
        rec = np.concatenate([rec, arec], -1)
    out = np.empty_like(px)
    src = "RGBA"[:rec.shape[-1]] if nch >= 3 else "Y"
    for i, k in enumerate(order):
        out[..., i] = rec[..., src.index(k)]
    dtype = np.uint8 if depth == BD8 else np.uint16
    out = out.astype(dtype)
    if lossless(params) and not np.array_equal(out, px):
        raise AssertionError("lossless settings lost samples")
    data = container(guid(params.pixel_format), W, H, cs, alpha_cs)
    if spans is not None:
        at = len(data) - len(cs) - len(alpha_cs or b"")
        spans += [((at + a, at + b), box) for (a, b), box in cs_spans]
    return data, out


# ------------------------------------------------------------ the goldens

def _texture(rng, h: int, w: int, c: int, dtype=np.uint8) -> np.ndarray:
    """Blurred noise stretched to the sample range: edges and flat parts."""
    from scipy.ndimage import uniform_filter
    hi = 256 if dtype == np.uint8 else 65536
    x = uniform_filter(rng.integers(0, hi, (h, w, c)).astype(float),
                       (5, 5, 1))
    return np.clip((x - hi / 2) * 3 + hi / 2, 0, hi - 1).astype(dtype)


def _qp(mode: int, *idx: int) -> tuple:
    return (mode, idx)


def goldens() -> dict[str, tuple[np.ndarray, Params, bool]]:
    """name -> (source pixels, settings, lossless) of every golden."""
    rng = np.random.default_rng(18)
    tq = dict(dc=("tile", [_qp(0, 3), _qp(1, 5, 9), _qp(2, 1, 2, 3),
                           _qp(0, 0)]),
              lp=("tile", ["use_dc", [_qp(0, 4), _qp(0, 9)],
                           [_qp(1, 10, 12), _qp(2, 1, 5, 9), _qp(0, 7)],
                           "use_dc"]),
              hp=("tile", [[_qp(0, 20), _qp(0, 30)], "use_lp", "use_lp",
                           [_qp(2, 5, 6, 7)]]))
    lossy = Plane(scaled=True, dc=("image", _qp(0, 4)),
                  lp=("image", _qp(1, 8, 20)), hp=("image", _qp(2, 10, 30, 40)))
    g = {
        # lossless, one tile, each overlap mode, both orders
        "jxr_gray8_ol0": (_texture(rng, 23, 17, 1)[..., 0], Params(
            pixel_format="8bppGray", plane=Plane(fmt="Y"), overlap=0),
            True),
        "jxr_bgr24_ol1": (_texture(rng, 37, 29, 3), Params(), True),
        "jxr_rgb24_ol2_frequency_uniform_tiles": (
            _texture(rng, 64, 64, 3), Params(
                pixel_format="24bppRGB", overlap=2, frequency=True,
                tile_w=(2,), tile_h=(2,)), True),
        "jxr_bgr24_hard_nonuniform_tiles": (_texture(rng, 60, 80, 3), Params(
            overlap=2, tile_w=(1, 3), tile_h=(2,), hard=True), True),
        "jxr_bgr24_long_header_index_table": (_texture(rng, 16, 32, 3),
                                              Params(short_header=False,
                                                     index_table=True), True),
        "jxr_bgra32_interleaved_alpha": (_texture(rng, 21, 33, 4), Params(
            pixel_format="32bppBGRA", alpha=Plane(fmt="Y")), True),
        "jxr_bgra32_planar_alpha": (_texture(rng, 30, 18, 4), Params(
            pixel_format="32bppBGRA", planar_alpha=Plane(fmt="Y"),
            frequency=True, overlap=2), True),
        "jxr_rgb48_ol2": (_texture(rng, 19, 26, 3, np.uint16), Params(
            pixel_format="48bppRGB", overlap=2), True),
        "jxr_gray16_ol1": (_texture(rng, 18, 18, 1, np.uint16)[..., 0],
                           Params(pixel_format="16bppGray",
                                  plane=Plane(fmt="Y")), True),
        "jxr_1x1": (_texture(rng, 1, 1, 3), Params(overlap=2), True),
        "jxr_window": (_texture(rng, 20, 30, 3), Params(
            window=(3, 5, 9, 13), overlap=2), True),
        # lossy: reconstructions
        "jxr_rgb48_shift_bits": (_texture(rng, 24, 20, 3, np.uint16), Params(
            pixel_format="48bppRGB", shift_bits=4, plane=Plane(
                scaled=True, dc=("image", _qp(0, 2)), hp=("image", _qp(0, 12)))),
            False),
        "jxr_gray16_scaled": (_texture(rng, 20, 21, 1, np.uint16)[..., 0],
                              Params(pixel_format="16bppGray", overlap=2,
                                     plane=Plane(fmt="Y", scaled=True,
                                                 dc=("image", _qp(0, 40)))),
                              False),
        "jxr_yuv420_scaled_ol2": (_texture(rng, 40, 40, 3), Params(
            plane=Plane(fmt="420", scaled=True, dc=lossy.dc, lp=lossy.lp,
                        hp=lossy.hp), overlap=2), False),
        "jxr_yuv420_ol1_tiles": (_texture(rng, 34, 50, 3), Params(
            plane=Plane(fmt="420", dc=("image", _qp(0, 9))), overlap=1,
            tile_w=(2,)), False),
        "jxr_yuv422_ol1": (_texture(rng, 40, 40, 3), Params(plane=Plane(
            fmt="422", dc=("image", _qp(0, 4)), lp=("use_dc",),
            hp=("image", _qp(0, 20))), overlap=1), False),
        "jxr_yuv422_frequency_ol2_tiles": (_texture(rng, 40, 50, 3), Params(
            plane=Plane(fmt="422", scaled=True, dc=("image", _qp(0, 4)),
                        hp=("image", _qp(0, 20))), overlap=2, frequency=True,
            tile_w=(2,)), False),
        "jxr_yuv444_scaled_quant": (_texture(rng, 32, 48, 3), Params(
            plane=lossy, overlap=2), False),
        "jxr_noflexbits_frequency": (_texture(rng, 40, 40, 3), Params(
            plane=Plane(bands=1), frequency=True), False),
        "jxr_noflexbits_spatial": (_texture(rng, 30, 40, 3), Params(
            plane=Plane(bands=1, dc=("image", _qp(1, 3, 8)))), False),
        "jxr_nohighpass": (_texture(rng, 40, 40, 3), Params(
            plane=Plane(bands=2)), False),
        "jxr_nohighpass_frequency": (_texture(rng, 40, 40, 3), Params(
            plane=Plane(bands=2), frequency=True, overlap=2), False),
        "jxr_dconly": (_texture(rng, 40, 40, 3), Params(
            plane=Plane(bands=3), overlap=2), False),
        "jxr_dconly_frequency": (_texture(rng, 33, 40, 3), Params(
            plane=Plane(bands=3, dc=("image", _qp(2, 1, 8, 16))),
            frequency=True), False),
        "jxr_trim_flexbits": (_texture(rng, 40, 40, 3), Params(trim=2),
                              False),
        "jxr_trim_flexbits_frequency": (_texture(rng, 40, 40, 3), Params(
            plane=Plane(hp=("image", _qp(0, 9))), trim=1, frequency=True),
            False),
        "jxr_tile_quantizers": (_texture(rng, 40, 70, 3), Params(
            tile_w=(2,), tile_h=(2,), plane=Plane(scaled=True, **tq)),
            False),
        "jxr_tile_quantizers_frequency_hard": (
            _texture(rng, 40, 70, 3), Params(
                frequency=True, tile_w=(2,), tile_h=(2,), hard=True,
                overlap=2, plane=Plane(scaled=True, **tq)), False),
        "jxr_bgra32_alpha_lossy": (_texture(rng, 26, 35, 4), Params(
            pixel_format="32bppBGRA", plane=lossy, alpha=Plane(
                fmt="Y", scaled=True, dc=("image", _qp(0, 6)), bands=1),
            frequency=True), False),
    }
    return g


# (file stem, GUID byte, OUTPUT_CLR_FMT, OUTPUT_BITDEPTH, INTERNAL_CLR_FMT,
#  what the container's refusal names, what the codestream's names)
REFUSALS = [
    ("cmyk", 0x1C, 4, 1, 4, "32bppCMYK", "OUTPUT_CLR_FMT CMYK"),
    ("cmykdirect", 0x1F, 5, 2, 4, "64bppCMYK", "OUTPUT_CLR_FMT CMYKDIRECT"),
    ("yuvk", 0x2C, 7, 1, 4, "40bppCMYKAlpha", "INTERNAL_CLR_FMT YUVK"),
    ("ncomponent", 0x20, 6, 1, 6, "24bpp3Channels",
     "OUTPUT_CLR_FMT NCOMPONENT"),
    ("ncomponent_internal", 0x20, 7, 1, 6, "24bpp3Channels",
     "INTERNAL_CLR_FMT NCOMPONENT"),
    ("signed16", 0x12, 7, 3, 3, "48bppRGBFixedPoint",
     "OUTPUT_BITDEPTH BD16S"),
    ("signed32", 0x3F, 0, 6, 0, "32bppGrayFixedPoint",
     "OUTPUT_BITDEPTH BD32S"),
    ("half", 0x3B, 7, 4, 3, "48bppRGBHalf", "OUTPUT_BITDEPTH BD16F"),
    ("float", 0x11, 0, 7, 0, "32bppGrayFloat", "OUTPUT_BITDEPTH BD32F"),
    ("rgbe", 0x3D, 8, 1, 3, "32bppRGBE", "OUTPUT_CLR_FMT RGBE"),
    ("bgr555", 0x09, 7, 8, 3, "16bppBGR555", "OUTPUT_BITDEPTH BD5"),
    ("bgr101010", 0x14, 7, 9, 3, "32bppBGR101010", "OUTPUT_BITDEPTH BD10"),
    ("bgr565", 0x0A, 7, 10, 3, "16bppBGR565", "OUTPUT_BITDEPTH BD565"),
    ("blackwhite", 0x05, 0, 0, 0, "BlackWhite", "OUTPUT_BITDEPTH BD1WHITE1"),
    ("blackwhite_bd1black1", 0x05, 0, 15, 0, "BlackWhite",
     "OUTPUT_BITDEPTH BD1BLACK1"),
]


def refused_codestream(out_fmt: int, depth: int, internal: int) -> bytes:
    """The header of a 16 × 16 image in a format the port refuses, and a
    plane header that names the internal colour format."""
    bw = BitWriter()
    for b in b"WMPHOTO\0":
        bw.put(b, 8)
    for v, n in ((1, 4), (0, 1), (1, 3), (0, 1), (0, 1), (0, 3), (0, 1),
                 (1, 2), (1, 1), (0, 1), (0, 1), (0, 1), (0, 3), (0, 1),
                 (out_fmt, 4), (depth, 4), (15, 16), (15, 16)):
        bw.put(v, n)
    bw.align()
    bw.put(internal, 3)
    bw.put(1, 1)
    bw.put(0, 4)
    return bw.data() + bytes(64)


def sha256(a: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def main():
    golden = {"files": {}, "refused": {}}
    for old in HERE.glob("jxr_*.jxr"):
        old.unlink()
    for name, (src, params, exact) in goldens().items():
        data, rec = encode(src, params)
        if exact != lossless(params):
            raise AssertionError(f"{name}: lossless is {not exact}")
        (HERE / f"{name}.jxr").write_bytes(data)
        golden["files"][name] = {
            "pixel_format": params.pixel_format, "shape": list(rec.shape),
            "dtype": str(rec.dtype), "lossless": exact,
            "sha256": sha256(rec)}
    for stem, g, out_fmt, depth, internal, fmt_name, field_name in REFUSALS:
        name = f"jxr_refused_{stem}"
        cs = refused_codestream(out_fmt, depth, internal)
        (HERE / f"{name}.jxr").write_bytes(container(guid(g), 16, 16, cs))
        golden["refused"][name] = {"format": fmt_name,
                                   "codestream": field_name}
    (HERE / JSON_NAME).write_text(json.dumps(golden, indent=1) + "\n")
    total = sum(p.stat().st_size for p in HERE.glob("jxr_*"))
    print("regenerated:", len(golden["files"]), "goldens,",
          len(golden["refused"]), "refusals,", total, "bytes")


if __name__ == "__main__":
    main()
