"""Regenerate the JPEG 2000 goldens, written by PIL (OpenJPEG 2.5), whose
decoded pixels the port's decoder must reproduce bit for bit
(``tests/test_torch_jpeg2000.py`` and ``chip_smoke.py``, which has no
PIL):

- ``j2k_*.j2k``: small raw codestreams, each a feature of the decoder
  (``STREAMS`` through PIL's ``save``; ``OPJ_STREAMS`` through
  :func:`opj_encode`, for what ``save`` does not expose);
- ``j2k_region.svs``: an Aperio-style TIFF with JPEG 2000 tiles
  (compression 33005): the ``[0:2048, 0:2048]`` region of
  ``synthetic_wsi(6144, 6144, n_cells=4000, mpp=0.4, seed=0)`` (the WSI
  phase's slide of ``chip_smoke.py``), 16 tiles of 512², irreversible
  9/7 with the ICT at rate 60, MPP 0.4 in its description;
- ``j2k_ext_*``: small streams past Aperio's 8-bit raw codestreams
  (:func:`ext_streams`): component precisions up to 20 bits, signed and
  mixed; JP2 files (PIL's default container, OpenJPEG's sYCC and 12-bit
  grey, a palette, an ICC profile with cdef and XLBox); packed packet
  headers (PPM over several segments, PPT over several tile-parts);
  and the streams the decoder still refuses or PIL refuses too
  (:func:`refused_streams`);
- ``j2k_ext_region.svs``: the same region and tiling as
  ``j2k_region.svs``, every tile lossless 5/3 with the RCT, the tiles in
  turn (row-major) 12-bit holding the samples times 16, JP2-boxed, with
  PPM and with PPT headers;
- ``j2k_sub_*``: small streams with subsampled components
  (:func:`sub_streams`: 4:2:0, 4:2:2, Cr alone, 4 × 4, odd sizes, alpha,
  several tiles at odd sizes and offsets, the position-driven orders
  with precincts, component 0, a JP2 ``colr`` of sYCC and of sRGB) and
  those PIL raises on too (:func:`sub_refused_streams`);
- ``j2k_sub_region.svs``: the same region and tiling as
  ``j2k_region.svs`` at compression 33003 as Aperio writes it: Y, Cb and
  Cr as plain components (no MCT), Cb and Cr at every second sample,
  the tiles 4:2:0 and 4:2:2 in turn, irreversible 9/7 at rate 60;
- ``j2k_golden.json``: the SHA-256 of PIL's RGB decode of every stream
  and of every tile of the three SVSs, with their shapes, and the word
  each refused stream's error names.

:func:`write_j2k_tiff` is also what the tests write their 33003 and 33005
files with, :func:`opj_encode` their streams with code-block style
flags, SOP/EPH, ROI, POC, precisions and OpenJPEG's JP2 container,
:func:`pack_headers` their PPM and PPT streams and :func:`wrap_jp2` (with
the box helpers) their JP2 variants.

Run: python tests/golden/regenerate_j2k.py
"""

import ctypes
import glob
import hashlib
import io
import json
import os
import struct
from pathlib import Path

import numpy as np
from PIL import Image

HERE = Path(__file__).parent
SVS_NAME, JSON_NAME = "j2k_region.svs", "j2k_golden.json"
EXT_SVS_NAME = "j2k_ext_region.svs"
EXT_KINDS = ("prec12", "jp2", "ppm", "ppt")  # the tiles' kinds, in turn
SUB_SVS_NAME = "j2k_sub_region.svs"
# the tiles' chroma sampling, in turn: (dx, dy) of Y, Cb and Cr
SUB_KINDS = {"4:2:0": ((1, 2, 2), (1, 2, 2)), "4:2:2": ((1, 2, 2), 1)}
SVS_REGION, SVS_TILE, SVS_MPP, SVS_RATE = 2048, 512, 0.4, 60
SLIDE = dict(width=6144, height=6144, n_cells=4000, mpp=SVS_MPP, seed=0)

# name -> (height, width, mode, PIL save options)
STREAMS = {
    "j2k_53_rgb": (37, 45, "RGB", dict(mct=0)),
    "j2k_grey": (40, 33, "L", dict(irreversible=True, quality_layers=[8])),
    "j2k_rpcl_precincts": (61, 70, "RGB", dict(
        irreversible=True, mct=1, progression="RPCL", num_resolutions=4,
        precinct_size=(16, 16), codeblock_size=(8, 16),
        quality_layers=[40, 20, 10])),
    "j2k_tiles_offsets": (50, 45, "RGB", dict(
        mct=1, progression="PCRL", tile_size=(16, 24), offset=(5, 3),
        tile_offset=(2, 1), num_resolutions=3, quality_layers=[10, 2])),
    "j2k_signed_cprl": (33, 47, "RGBA", dict(
        irreversible=True, signed=True, progression="CPRL",
        quality_mode="dB", quality_layers=[30, 40])),
}


# name -> (height, width, channels, opj_encode options); SOP/EPH and POC
# are not combined: PIL fails on the streams OpenJPEG writes with both
OPJ_STREAMS = {
    "j2k_flags_sop_eph_roi": (45, 52, 3, dict(
        irreversible=True, mct=1, numres=3, cblk=(16, 16), csty=6,
        mode=63, rates=(20, 6), roi=(1, 3))),
    "j2k_poc": (45, 52, 3, dict(
        numres=3, cblk=(8, 8), rates=(20, 6),
        poc=[(0, 0, 1, 2, 3, 1), (0, 0, 2, 3, 3, 2)])),
}


def image(h: int, w: int, channels: int, seed: int) -> np.ndarray:
    """Smooth colour ramps plus noise: every subband has coefficients."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:h, :w]
    img = np.stack([128 + 90 * np.sin(xx / 5.0 + yy / 9.0 + k)
                    + 20 * np.cos(yy / 4.0) for k in range(channels)], -1)
    img = np.clip(img + rng.normal(0, 14, img.shape), 0, 255)
    return img.astype(np.uint8)


def encode(img: np.ndarray, mode: str | None = None, **kw) -> bytes:
    """A raw codestream (no JP2 boxes) of ``img`` as PIL writes it."""
    buf = io.BytesIO()
    Image.fromarray(img, mode).save(buf, "JPEG2000", no_jp2=True, **kw)
    return buf.getvalue()


_OPJ = []


def _openjpeg() -> ctypes.CDLL:
    """The libopenjp2 that PIL bundles (``pillow.libs``)."""
    if not _OPJ:
        import PIL

        libs = os.path.join(os.path.dirname(PIL.__file__), os.pardir,
                            "pillow.libs")
        o = ctypes.CDLL(glob.glob(os.path.join(libs, "libopenjp2*"))[0])
        vp = ctypes.c_void_p
        o.opj_image_create.restype = vp
        o.opj_image_create.argtypes = [ctypes.c_uint32, vp, ctypes.c_int]
        o.opj_create_compress.restype = vp
        o.opj_stream_create_default_file_stream.restype = vp
        o.opj_stream_create_default_file_stream.argtypes = [
            ctypes.c_char_p, ctypes.c_int]
        for f in ("opj_setup_encoder", "opj_start_compress"):
            getattr(o, f).argtypes = [vp, vp, vp]
        for f in ("opj_encode", "opj_end_compress"):
            getattr(o, f).argtypes = [vp, vp]
        for f in ("opj_stream_destroy", "opj_destroy_codec",
                  "opj_image_destroy", "opj_set_default_encoder_parameters"):
            getattr(o, f).argtypes = [vp]
        _OPJ.append(o)
    return _OPJ[0]


# byte offsets in OpenJPEG 2.5's opj_cparameters_t (openjpeg.h, LP64),
# checked against opj_set_default_encoder_parameters' defaults below
_P_DISTO, _P_CSTY, _P_POC, _P_POC_SIZE, _P_NUMPOCS = 20, 48, 56, 148, 4792
_P_LAYERS, _P_RATES, _P_NUMRES, _P_ROI, _P_MCT = 4796, 4800, 5600, 5620, 18698
_P_TILES, _P_PROG = 0, 52  # tile_size_on, cp_tx0, cp_ty0, cp_tdx, cp_tdy
_P_RES_SPEC = 5628  # res_spec, then prcw_init[33] and prch_init[33]
_ORDERS = {"LRCP": 0, "RLCP": 1, "RPCL": 2, "PCRL": 3, "CPRL": 4}
_CODECS = {"j2k": 0, "jp2": 2}  # OPJ_CODEC_J2K, OPJ_CODEC_JP2
_COLOUR_SPACES = {"srgb": 1, "grey": 2, "sycc": 3}  # OPJ_COLOR_SPACE


def opj_encode(img: np.ndarray, path, *, irreversible: bool = False,
               mct: int = 0, numres: int = 6, cblk=(64, 64), csty: int = 0,
               mode: int = 0, rates=(), roi=None, poc=(),
               signed=False, prec=8, codec: str = "j2k",
               colour_space: str = "srgb", tiles=None,
               order: str = "LRCP", dx=1, dy=1, origin=(0, 0),
               tile_origin=(0, 0), precincts=()) -> bytes:
    """A codestream of an (H, W[, C]) image written by OpenJPEG's own
    encoder through ctypes, for what PIL's ``save`` does not expose:
    ``csty`` (2: SOP, 4: EPH), ``mode`` (the code-block style flags: 1
    bypass, 2 reset, 4 termall, 8 vertically causal, 16 predictable
    termination, 32 segmentation symbols), ``roi`` (component, shift),
    ``poc`` ((res0, comp0, layer end, res1, comp1, order), ...) and the
    layers' ``rates``. ``prec`` and ``signed`` are one value or one per
    component; samples are given unsigned, in [0, 2^prec), and a signed
    component is stored less 2^(prec - 1). ``codec`` "jp2" boxes the
    stream in OpenJPEG's JP2 container, whose ``colr`` box names
    ``colour_space`` ("srgb", "grey" or "sycc"). ``tiles`` is the tile
    size (width, height), ``tile_origin`` its offset (XTOsiz, YTOsiz),
    ``origin`` the image's (XOsiz, YOsiz) and ``order`` the progression;
    ``precincts`` ((width, height), ...) the precinct sizes from the
    highest resolution down. ``dx`` and ``dy`` (one value or one per
    component) subsample a component: its plane holds every dx-th sample
    of ``img`` from the first reference-grid multiple of dx, at the size
    OpenJPEG's encoder reads, ceil(W / dx) x ceil(H / dy). The stream goes
    through the file ``path``."""
    o = _openjpeg()
    img = np.asarray(img)
    if img.ndim == 2:
        img = img[..., None]
    h, w, nc = img.shape
    precs = [prec] * nc if np.isscalar(prec) else list(prec)
    sgnds = [signed] * nc if np.isscalar(signed) else list(signed)
    dxs = [dx] * nc if np.isscalar(dx) else list(dx)
    dys = [dy] * nc if np.isscalar(dy) else list(dy)
    x0, y0 = origin
    # opj_image_cmptparm_t: dx, dy, w, h, x0, y0, prec, bpp, sgnd
    parm = (ctypes.c_uint32 * (9 * nc))()
    planes = []
    for c in range(nc):
        a, b = -x0 % dxs[c], -y0 % dys[c]  # the first sample's position
        cw, ch = -(-w // dxs[c]), -(-h // dys[c])
        full = np.pad(img[..., c], ((0, b + ch * dys[c]),
                                    (0, a + cw * dxs[c])), mode="edge")
        planes.append(full[b::dys[c], a::dxs[c]][:ch, :cw])
        parm[9 * c:9 * c + 9] = [dxs[c], dys[c], cw, ch, -(-x0 // dxs[c]),
                                 -(-y0 // dys[c]), precs[c], precs[c],
                                 int(sgnds[c])]
    im = o.opj_image_create(nc, parm, _COLOUR_SPACES[colour_space])
    ctypes.memmove(im, struct.pack("<4I", x0, y0, x0 + w, y0 + h), 16)
    comps = ctypes.c_void_p.from_address(im + 24).value
    for c in range(nc):  # opj_image_comp_t is 64 bytes, data at 48
        plane = np.ascontiguousarray(planes[c], np.int32)
        if sgnds[c]:
            plane = plane - (1 << (precs[c] - 1))
        data = ctypes.c_void_p.from_address(comps + 64 * c + 48).value
        ctypes.memmove(data, plane.ctypes.data, plane.nbytes)
    p = (ctypes.c_ubyte * 20000)()
    o.opj_set_default_encoder_parameters(p)
    if struct.unpack_from("<3i", p, _P_NUMRES) != (6, 64, 64):
        raise RuntimeError("unexpected opj_cparameters_t layout")

    def put(off, fmt, *v):
        struct.pack_into(fmt, p, off, *v)

    put(_P_CSTY, "<i", csty | (1 if precincts else 0))
    if precincts:
        put(_P_RES_SPEC, "<i", len(precincts))
        for i, (pw, ph) in enumerate(precincts):
            put(_P_RES_SPEC + 4 + 4 * i, "<i", pw)
            put(_P_RES_SPEC + 136 + 4 * i, "<i", ph)
    put(_P_PROG, "<i", _ORDERS[order])
    if tiles:
        put(_P_TILES, "<5i", 1, *tile_origin, *tiles)
    put(_P_NUMRES, "<5i", numres, cblk[0], cblk[1], mode, int(irreversible))
    if roi:
        put(_P_ROI, "<2i", *roi)
    put(_P_MCT, "<b", mct)
    rates = tuple(rates) or (0.0,)
    put(_P_DISTO, "<i", 1)
    put(_P_LAYERS, "<i", len(rates))
    put(_P_RATES, f"<{len(rates)}f", *rates)
    put(_P_NUMPOCS, "<I", len(poc))
    for i, (r0, c0, l1, r1, c1, prog) in enumerate(poc):
        at = _P_POC + _P_POC_SIZE * i  # opj_poc_t
        put(at, "<5I", r0, c0, l1, r1, c1)
        put(at + 32, "<i", prog)
        put(at + 48, "<I", 1)  # the tile it applies to, from 1
    codec = o.opj_create_compress(_CODECS[codec])
    ok = o.opj_setup_encoder(codec, p, im)
    stream = o.opj_stream_create_default_file_stream(str(path).encode(), 0)
    ok = (ok and o.opj_start_compress(codec, im, stream)
          and o.opj_encode(codec, stream)
          and o.opj_end_compress(codec, stream))
    o.opj_stream_destroy(stream)
    o.opj_destroy_codec(codec)
    o.opj_image_destroy(im)
    if not ok:
        raise RuntimeError("OpenJPEG's encoder failed")
    return Path(path).read_bytes()


# ------------------------------------------------- packed packet headers

def _marker_segments(cs: bytes, at: int):
    """(offset, marker, segment end) of the marker segments from ``at``
    up to the first SOT or SOD."""
    while True:
        m = struct.unpack_from(">H", cs, at)[0]
        if m in (0xFF90, 0xFF93):
            return
        end = at + 2 + struct.unpack_from(">H", cs, at + 2)[0]
        yield at, m, end
        at = end


def _packets(data: bytes, eph: bytes) -> list[tuple[bytes, bytes, bytes]]:
    """A tile-part's data written with SOP and EPH as (SOP, header, body)
    per packet: the header runs from its SOP segment to its EPH, which no
    header byte can imitate (a byte after 0xFF is below 0x90), and the
    body to the next SOP."""
    out, i = [], 0
    while i < len(data):
        if data[i:i + 2] != b"\xff\x91":
            raise ValueError("a packet without SOP")
        e = data.index(b"\xff\x92", i + 6)
        nxt = data.find(b"\xff\x91", e + 2)
        nxt = len(data) if nxt < 0 else nxt
        out.append((data[i:i + 6], data[i + 6:e] + eph, data[e + 2:nxt]))
        i = nxt
    return out


def _split(blob: bytes, n: int) -> list[bytes]:
    """``blob`` in ``n`` pieces of near-equal length."""
    cuts = [len(blob) * k // n for k in range(n + 1)]
    return [blob[a:b] for a, b in zip(cuts[:-1], cuts[1:])]


def pack_headers(cs: bytes, where: str, *, parts: int = 1,
                 segments: int = 1, keep_markers: bool = False,
                 nppm_shift: int = 0, nppm_extra: int = 0) -> bytes:
    """A codestream OpenJPEG wrote with SOP and EPH (``csty=6``), its
    packet headers moved into PPM segments of the main header (``where``
    "ppm") or PPT segments of the tile-part headers ("ppt"); each tile's
    packets split over ``parts`` tile-parts, the packed headers over
    ``segments`` segments (PPM: Zppm order, each tile-part's Nppm run
    going on across segments; PPT: Zppt numbered across a tile's parts,
    as OpenJPEG reads it; more where a segment would pass its 64 KiB).
    ``keep_markers`` keeps SOP in the bodies and
    EPH after each packed header, else both go and the COD no longer
    announces them. ``nppm_shift`` moves that many header bytes from the
    first tile-part's Nppm to the second's (the runs then cut the headers
    elsewhere); ``nppm_extra`` adds to the last Nppm."""
    first_sot = cs.index(b"\xff\x90")
    main = bytearray(cs[:first_sot])
    cod = None
    for at, m, _ in _marker_segments(cs, 2):
        if m == 0xFF52:
            cod = at
    if cod is None or cs[cod + 4] & 6 != 6:
        raise ValueError("the stream has no SOP and EPH")
    if not keep_markers:
        main[cod + 4] &= ~6 & 0xFF
    eph = b"\xff\x92" if keep_markers else b""
    tile_parts = []  # (tile index, tile-part header markers, packets)
    at = first_sot
    while cs[at:at + 2] == b"\xff\x90":
        isot, psot = struct.unpack_from(">HI", cs, at + 4)
        end = at + psot if psot else len(cs) - 2
        markers = b"".join(cs[a:e] for a, _, e in
                           _marker_segments(cs, at + 12))
        sod = at + 12 + len(markers)
        assert cs[sod:sod + 2] == b"\xff\x93"
        pk = _packets(cs[sod + 2:end], eph)
        chunks = [c for c in _split(pk, parts) if c]
        for k, c in enumerate(chunks):
            tile_parts.append((isot, markers if k == 0 else b"", c,
                               k, len(chunks)))
        at = end
    runs, out, zppt = [], bytearray(), {}
    for isot, markers, pk, k, n in tile_parts:
        headers = b"".join(h for _, h, _ in pk)
        body = b"".join((s if keep_markers else b"") + b for s, _, b in pk)
        if where == "ppt":
            for piece in _split(headers, max(segments,
                                             -(-len(headers) // 65000))):
                z = zppt.setdefault(isot, 0)
                zppt[isot] = z + 1
                markers += (b"\xff\x61" + struct.pack(">HB", 3 + len(piece),
                                                        z) + piece)
        else:
            runs.append(headers)
        psot = 12 + len(markers) + 2 + len(body)
        out += (b"\xff\x90" + struct.pack(">HHIBB", 10, isot, psot, k, n)
                + markers + b"\xff\x93" + body)
    if where == "ppm":
        lens = [len(r) for r in runs]
        if nppm_shift:
            lens[0] -= nppm_shift
            lens[1] += nppm_shift
        lens[-1] += nppm_extra
        blob, fields = b"", []
        for n, r in zip(lens, _regroup(runs, lens)):
            fields.append(len(blob))
            blob += struct.pack(">I", n) + r
        n = max(segments, -(-len(blob) // 65000))
        # a segment may cut a run, never its Nppm field
        cuts = [len(blob) * k // n for k in range(n + 1)]
        cuts = [next((f for f in fields if f < c < f + 4), c) for c in cuts]
        pieces = [blob[a:b] for a, b in zip(cuts[:-1], cuts[1:])]
        for z, piece in enumerate(pieces):
            main += b"\xff\x60" + struct.pack(">HB", 3 + len(piece), z) + piece
    return bytes(main) + bytes(out) + b"\xff\xd9"


def _regroup(runs: list[bytes], lens: list[int]) -> list[bytes]:
    """The bytes of ``runs`` joined and cut again at ``lens`` (the last
    run takes what is left)."""
    blob, out, at = b"".join(runs), [], 0
    for k, n in enumerate(lens):
        out.append(blob[at:] if k == len(lens) - 1 else blob[at:at + n])
        at += n
    return out


# ---------------------------------------------------------------- JP2

JP2_SIGNATURE = b"\0\0\0\x0cjP  \r\n\x87\n"


def box(kind: bytes, payload: bytes, xl: bool = False,
        to_end: bool = False) -> bytes:
    """A JP2 box: LBox and TBox, or LBox 1 and a 64-bit XLBox, or LBox 0
    (the box runs to the end of the file)."""
    if to_end:
        return struct.pack(">I4s", 0, kind) + payload
    if xl:
        return struct.pack(">I4sQ", 1, kind, 16 + len(payload)) + payload
    return struct.pack(">I4s", 8 + len(payload), kind) + payload


def ihdr(h: int, w: int, nc: int, bpc: int) -> bytes:
    return box(b"ihdr", struct.pack(">IIHBBBB", h, w, nc, bpc, 7, 0, 0))


def colr(enumcs: int | None = None, icc: bytes | None = None) -> bytes:
    """An enumerated (method 1) or restricted ICC (method 2) colr box."""
    if icc is not None:
        return box(b"colr", bytes([2, 0, 0]) + icc)
    return box(b"colr", bytes([1, 0, 0]) + struct.pack(">I", enumcs))


def pclr(entries, depths) -> bytes:
    """A palette of ``entries`` (tuples, one value a column) whose columns
    have the raw bit-depth bytes ``depths``."""
    out = struct.pack(">HB", len(entries), len(depths)) + bytes(depths)
    for e in entries:
        for v, d in zip(e, depths):
            out += int(v).to_bytes(((d & 0x7F) + 8) // 8, "big")
    return box(b"pclr", out)


def cmap(entries) -> bytes:
    """(component, mapping type, palette column) per channel."""
    return box(b"cmap", b"".join(struct.pack(">HBB", *e) for e in entries))


def cdef(entries) -> bytes:
    """(channel, type, association) per channel."""
    return box(b"cdef", struct.pack(">H", len(entries)) + b"".join(
        struct.pack(">HHH", *e) for e in entries))


def wrap_jp2(cs: bytes, header: list[bytes], *, before: bytes = b"",
             after: bytes = b"", jp2h_xl: bool = False,
             jp2c: str = "plain") -> bytes:
    """``cs`` boxed as a JP2 file: the signature, ftyp, the boxes
    ``before``, a jp2h superbox of ``header``, the boxes ``after`` and the
    jp2c box (``jp2c`` "plain", "xl" or "to_end")."""
    ftyp = box(b"ftyp", b"jp2 " + struct.pack(">I", 0) + b"jp2 ")
    return (JP2_SIGNATURE + ftyp + before
            + box(b"jp2h", b"".join(header), xl=jp2h_xl) + after
            + box(b"jp2c", cs, xl=jp2c == "xl", to_end=jp2c == "to_end"))


def pil_rgb(data: bytes) -> np.ndarray:
    """What the JAX reader's PIL call gives for a tile."""
    return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))


def sha256(rgb: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(rgb).tobytes()).hexdigest()


def write_j2k_tiff(path, level0: np.ndarray, tile: int, mpp: float,
                   compression: int = 33005, n_levels: int = 1,
                   encode_tile=None, **kw) -> list[bytes]:
    """A classic little-endian tiled TIFF in Aperio's layout with JPEG 2000
    tiles encoded by PIL: 2× decimated levels, edge tiles coded at their
    own (partial) size, the MPP in the description. 33005 tiles hold the
    RGB components (``kw`` as PIL's save options); 33003 tiles hold the
    YCbCr values as plain components with no MCT, as Aperio writes them.
    ``encode_tile(k, rgb)``, if given, writes tile ``k`` of each level
    instead. Returns level 0's tile streams."""
    levels = [np.ascontiguousarray(level0, np.uint8)]
    for _ in range(1, n_levels):
        levels.append(np.ascontiguousarray(levels[-1][::2, ::2]))
    pages = []
    for img in levels:
        h, w = img.shape[:2]
        if compression == 33003:
            img = np.asarray(Image.fromarray(img).convert("YCbCr"))
        crops = [np.ascontiguousarray(img[y:y + tile, x:x + tile])
                 for y in range(0, h, tile) for x in range(0, w, tile)]
        streams = [encode_tile(k, c) if encode_tile else
                   encode(c, "RGB", **kw) for k, c in enumerate(crops)]
        pages.append((w, h, streams))
    desc = (f"Aperio Image Library v12.0.15\r\n{levels[0].shape[1]}x"
            f"{levels[0].shape[0]} ({tile}x{tile}) J2K|AppMag = 20|"
            f"MPP = {mpp}")
    write_tiff(path, pages, tile, desc, compression,
               6 if compression == 33003 else 2)
    return pages[0][2]


def write_tiff(path, pages, tile: int, desc: str, compression: int,
               photometric: int):
    """A classic little-endian tiled TIFF in Aperio's layout: ``pages`` as
    (width, height, tile streams in row-major order), RGB, the
    description on the first page."""
    out = bytearray(b"II*\0\0\0\0\0")
    ifds = []
    for i, (w, h, streams) in enumerate(pages):
        offsets = []
        for s in streams:
            offsets.append(len(out))
            out += s + b"\0" * (len(s) % 2)
        d = (desc if i == 0 else f"level {i}").encode() + b"\0"
        blobs = {"desc": d, "bps": struct.pack("<3H", 8, 8, 8),
                 "offs": struct.pack(f"<{len(offsets)}I", *offsets),
                 "cnts": struct.pack(f"<{len(streams)}I",
                                     *[len(s) for s in streams])}
        at = {}
        for k, b in blobs.items():
            at[k] = len(out)
            out += b + b"\0" * (len(b) % 2)
        n = len(streams)
        tags = [(256, 4, 1, w), (257, 4, 1, h), (258, 3, 3, at["bps"]),
                (259, 3, 1, compression),
                (262, 3, 1, photometric),
                (270, 2, len(d), at["desc"]), (277, 3, 1, 3),
                (284, 3, 1, 1), (322, 3, 1, tile), (323, 3, 1, tile),
                (324, 4, n, at["offs"] if n > 1 else offsets[0]),
                (325, 4, n, at["cnts"] if n > 1 else len(streams[0]))]
        ifds.append(len(out))
        out += struct.pack("<H", len(tags))
        for tag, type_, count, value in tags:
            fmt = "<HHIHH" if type_ == 3 and count == 1 else "<HHII"
            out += struct.pack(fmt, tag, type_, count, value,
                               *([0] if fmt == "<HHIHH" else []))
        out += struct.pack("<I", 0)
    struct.pack_into("<I", out, 4, ifds[0])
    for a, b in zip(ifds[:-1], ifds[1:]):
        nxt = a + 2 + 12 * struct.unpack_from("<H", out, a)[0]
        struct.pack_into("<I", out, nxt, b)
    Path(path).write_bytes(bytes(out))


def _ext_image(h, w, nc, prec, seed):
    """``image`` scaled to ``prec`` bits, low bits from the noise."""
    img = image(h, w, nc, seed).astype(np.int64)
    rng = np.random.default_rng(seed + 100)
    if prec >= 8:
        return (img << (prec - 8)) | rng.integers(0, 1 << (prec - 8),
                                                  img.shape)
    return img >> (8 - prec)


def _opj(img, **kw) -> bytes:
    import tempfile
    with tempfile.TemporaryDirectory() as tmp:
        return opj_encode(img, Path(tmp) / "s", **kw)


def _pil_jp2(img, mode=None, **kw) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(img, mode).save(buf, "JPEG2000", **kw)
    return buf.getvalue()


def _sop_eph(img, **kw) -> bytes:
    """A stream with SOP and EPH, for ``pack_headers``."""
    return _opj(img, csty=6, numres=3, cblk=(16, 16), **kw)


PALETTE = [(230, 20, 40), (20, 200, 60), (230, 20, 40), (40, 60, 250),
           (250, 250, 250), (20, 200, 60), (0, 0, 0), (120, 80, 30)]


def ext_streams() -> dict[str, bytes]:
    """The ``j2k_ext_*`` goldens PIL decodes, by file name."""
    rgb = image(29, 37, 3, seed=30)
    idx = (image(29, 37, 1, seed=31)[..., 0] // 32).astype(np.int64)
    return {
        "j2k_ext_prec12_rct.j2k": _opj(_ext_image(29, 37, 3, 12, 32),
                                       prec=12, mct=1, numres=3),
        "j2k_ext_prec16_grey_97.j2k": _opj(
            _ext_image(29, 37, 1, 16, 33), prec=16, irreversible=True,
            numres=3, rates=(4,)),
        "j2k_ext_prec_mixed_signed.j2k": _opj(np.stack(
            [_ext_image(29, 37, 1, p, 34 + p)[..., 0] for p in (1, 9, 15, 4)],
            -1), prec=(1, 9, 15, 4), signed=(False, True, False, True),
            numres=3),
        "j2k_ext_prec20_signed_97.j2k": _opj(
            _ext_image(29, 37, 3, 20, 35), prec=20, signed=True,
            irreversible=True, mct=1, numres=3),
        "j2k_ext_pil.jp2": _pil_jp2(rgb, mct=1),
        "j2k_ext_sycc.jp2": _opj(rgb, codec="jp2", colour_space="sycc",
                                 numres=3),
        "j2k_ext_grey12.jp2": _opj(_ext_image(29, 37, 1, 12, 36), prec=12,
                                   codec="jp2", colour_space="grey",
                                   numres=3),
        "j2k_ext_pclr.jp2": wrap_jp2(_opj(idx, numres=3), [
            ihdr(29, 37, 1, 7), colr(16), pclr(PALETTE, [7, 7, 7]),
            cmap([(0, 1, 0), (0, 1, 1), (0, 1, 2)])]),
        "j2k_ext_icc_cdef_xl.jp2": wrap_jp2(_opj(rgb, numres=3, mct=1), [
            ihdr(29, 37, 3, 7), colr(icc=bytes(range(64))),
            cdef([(0, 0, 3), (1, 0, 2), (2, 0, 1)])],
            before=box(b"xml ", b"<slide/>"), jp2h_xl=True,
            jp2c="to_end"),
        "j2k_ext_ppm.j2k": pack_headers(_sop_eph(
            image(45, 52, 3, seed=37), mct=1, tiles=(32, 24),
            order="RPCL", rates=(12, 3)), "ppm", parts=2, segments=3,
            nppm_shift=3),
        "j2k_ext_ppt.j2k": pack_headers(_sop_eph(
            image(45, 52, 3, seed=38), irreversible=True, mct=1,
            rates=(20, 6)), "ppt", parts=3, segments=2, keep_markers=True),
        # SIZ's XRsiz and YRsiz of Cb patched to 2 over data coded at
        # full size: PIL reads it by its subsampling rule all the same
        "j2k_ext_patched_subsampling.j2k": _patched(
            _opj(image(16, 20, 3, seed=40), numres=2), 0x51, 44,
            b"\x02\x02"),
        # Part 15 signalling over Part 1 code-blocks, which OpenJPEG
        # decodes by each code-block's style: Rsiz 0x4000, then CAP
        # (Pcap 0x00020000, one Ccap) and CPF segments after SIZ
        "j2k_ext_part15_rsiz.j2k": part15(_opj(image(16, 20, 3, seed=40),
                                               numres=2)),
        "j2k_ext_part15_cap_cpf.j2k": part15(
            _opj(image(16, 20, 3, seed=40), numres=2), CAP + CPF),
    }


def _patched(data: bytes, marker: int, at: int, value: bytes) -> bytes:
    i = data.index(bytes([0xFF, marker])) + at
    return data[:i] + value + data[i + len(value):]


# Part 15's capabilities (Pcap bit 17: one Ccap15, here 0) and
# corresponding profile (Pcpf 0) marker segments
CAP = b"\xff\x50" + struct.pack(">HIH", 8, 0x00020000, 0)
CPF = b"\xff\x59" + struct.pack(">HH", 4, 0)


def part15(data: bytes, segments: bytes = b"", rsiz: int = 0x4000) -> bytes:
    """A Part 1 stream as Part 15 signals it: Rsiz set to ``rsiz``, then
    ``segments`` put right after SIZ."""
    data = _patched(data, 0x51, 4, struct.pack(">H", rsiz))
    i = data.index(b"\xff\x51")
    end = i + 2 + struct.unpack(">H", data[i + 2:i + 4])[0]
    return data[:end] + segments + data[end:]


def refused_streams() -> dict[str, tuple[bytes, str]]:
    """The ``j2k_ext_refused_*`` goldens, by file name, with the word the
    decoder's error names: what stays refused (Part 1 data under the HT
    style, which PIL fails on too; Part 2; more than four components) and
    what PIL refuses too."""
    base = _opj(image(16, 20, 3, seed=40), numres=2)
    ppm = pack_headers(_sop_eph(image(16, 20, 3, seed=41)), "ppm")
    sot = ppm.index(b"\xff\x90")
    psot = struct.unpack_from(">I", ppm, sot + 6)[0]
    ppt = b"\xff\x61\x00\x04\x00\x00"
    both = (ppm[:sot + 6] + struct.pack(">I", psot + len(ppt))
            + ppm[sot + 10:sot + 12] + ppt + ppm[sot + 12:])
    return {
        # Part 1 data read by the HT block decoder: OpenJPEG refuses its
        # 19 passes (at most 3: placeholder passes are not supported)
        "j2k_ext_refused_ht_style.j2k": (_patched(part15(base), 0x52, 12,
                                                  b"\x40"),
                                         "19 coding passes"),
        "j2k_ext_refused_part2_mct.j2k": (_patched(base, 0x52, 8, b"\x02"),
                                          "multiple component transform"),
        "j2k_ext_refused_five_components.j2k": (
            _patched(base, 0x51, 38, b"\x00\x05"), "5 components"),
        "j2k_ext_refused_precision_32.j2k": (
            _patched(base, 0x51, 40, b"\x1f"), "component precision 32"),
        "j2k_ext_refused_ppm_and_ppt.j2k": (both, "PPT marker in a "
                                            "codestream with PPM"),
        "j2k_ext_refused_ihdr.jp2": (wrap_jp2(base, [
            ihdr(16, 21, 3, 7), colr(16)]), "JP2: ihdr"),
    }


def sub_streams() -> dict[str, bytes]:
    """The ``j2k_sub_*`` goldens PIL decodes, by file name: components
    subsampled by OpenJPEG's encoder (each plane at its own size), read
    by PIL as sYCC where Cb or Cr is subsampled, else as sRGB."""
    img = image(40, 52, 3, seed=50)
    return {
        "j2k_sub_420.j2k": _opj(img, numres=3, dx=(1, 2, 2), dy=(1, 2, 2)),
        "j2k_sub_422_97.j2k": _opj(img, irreversible=True, numres=3,
                                   dx=(1, 2, 2), rates=(8,)),
        "j2k_sub_cr_only.j2k": _opj(img, numres=3, dx=(1, 1, 2),
                                    dy=(1, 1, 2)),
        "j2k_sub_44.j2k": _opj(img, numres=3, dx=(1, 4, 4), dy=(1, 4, 4)),
        "j2k_sub_odd.j2k": _opj(image(53, 37, 3, seed=51), irreversible=True,
                                numres=3, dx=(1, 2, 2), dy=(1, 2, 2)),
        "j2k_sub_alpha.j2k": _opj(image(37, 45, 4, seed=52), numres=3,
                                  dx=(1, 2, 2, 1), dy=(1, 2, 2, 1)),
        "j2k_sub_alpha_only.j2k": _opj(image(37, 45, 4, seed=53), numres=3,
                                       dx=(1, 1, 1, 2), dy=(1, 1, 1, 2)),
        "j2k_sub_tiles.j2k": _opj(image(53, 45, 3, seed=54), numres=2,
                                  dx=(1, 2, 2), dy=(1, 2, 2), tiles=(17, 11),
                                  tile_origin=(3, 1), origin=(7, 9)),
        "j2k_sub_rpcl_97.j2k": _opj(
            image(61, 70, 3, seed=55), irreversible=True, numres=4,
            cblk=(8, 8), dx=(1, 2, 2), dy=(1, 2, 2), order="RPCL",
            precincts=[(16, 16)], rates=(10, 3)),
        "j2k_sub_pcrl_53.j2k": _opj(
            image(61, 70, 3, seed=56), numres=4, cblk=(8, 8), dx=(1, 3, 3),
            dy=(1, 3, 3), order="PCRL", precincts=[(32, 16), (8, 8)],
            tiles=(40, 33), tile_origin=(1, 2), origin=(3, 5)),
        "j2k_sub_cprl_97.j2k": _opj(
            image(61, 70, 3, seed=57), irreversible=True, numres=4,
            cblk=(8, 8), dx=(1, 2, 2), order="CPRL", precincts=[(16, 16)]),
        # component 0 subsampled, every component alike: sRGB, the MCT on
        "j2k_sub_comp0_mct.j2k": _opj(img, numres=3, mct=1, dx=2, dy=2),
        "j2k_sub_sycc.jp2": _opj(img, numres=3, dx=(1, 2, 2), dy=(1, 2, 2),
                                 codec="jp2", colour_space="sycc"),
        "j2k_sub_srgb.jp2": _opj(img, numres=3, dx=(1, 2, 2), dy=(1, 2, 2),
                                 codec="jp2", colour_space="srgb"),
    }


def sub_refused_streams() -> dict[str, tuple[bytes, str]]:
    """The ``j2k_sub_refused_*`` goldens, by file name, with the word the
    decoder's error names; PIL raises on each: one or two components
    with subsampling (no unpacker of PIL's reads them) and the RCT over
    components of different sizes (OpenJPEG fails the tile)."""
    return {
        "j2k_sub_refused_one.j2k": (_opj(image(16, 20, 1, seed=58)[..., 0],
                                         numres=2, dx=2, dy=2),
                                    "component subsampling"),
        "j2k_sub_refused_two.j2k": (_opj(image(16, 20, 2, seed=59), numres=2,
                                         dx=(1, 2), dy=(1, 2)),
                                    "component subsampling"),
        "j2k_sub_refused_mct.j2k": (_patched(_opj(
            image(16, 20, 3, seed=60), numres=2, dx=(1, 2, 2), dy=(1, 2, 2)),
            0x52, 8, b"\x01"), "components of different sizes"),
    }


def sub_tile(k: int, ycc: np.ndarray) -> bytes:
    """Tile ``k`` of ``j2k_sub_region.svs`` from its YCbCr crop: 9/7 at
    ``SVS_RATE``, no MCT, the chroma sampled as ``SUB_KINDS``, in turn."""
    dx, dy = list(SUB_KINDS.values())[k % len(SUB_KINDS)]
    return _opj(ycc, irreversible=True, rates=(SVS_RATE,), dx=dx, dy=dy)


def ext_tile(k: int, rgb: np.ndarray) -> bytes:
    """Tile ``k`` of ``j2k_ext_region.svs``: lossless 5/3 with the RCT,
    as ``EXT_KINDS[k % 4]``."""
    kind = EXT_KINDS[k % len(EXT_KINDS)]
    if kind == "prec12":  # PIL gives back (16 v + 8) >> 4 = v
        return _opj(rgb.astype(np.int64) * 16, prec=12, mct=1)
    if kind == "jp2":
        return _pil_jp2(rgb, mct=1)
    return pack_headers(_opj(rgb, mct=1, csty=6), kind, parts=2,
                        segments=2)


# ------------------------------------------------------- HT code-blocks

HT_SVS_NAME = "j2k_ht_region.svs"


def _ht():
    try:
        from golden import htj2k
    except ImportError:  # run as a script: this directory is on the path
        import htj2k
    return htj2k


def ht_streams() -> dict[str, bytes]:
    """The ``j2k_ht_*`` goldens PIL decodes, by file name: HT code-blocks
    written by ``htj2k.encode`` (lossless ones first: PIL must give back
    their sources), then truncated blocks (cleanup only, with SigProp,
    with MagRef), the vertically causal style, several tiles at offsets,
    several layers, SOP/EPH, Part 1 style bits beside HT, a JP2 file."""
    ht = _ht()
    rgb = image(61, 70, 3, seed=70)
    grey12 = _ext_image(29, 37, 1, 12, 71)[..., 0]
    rgba16 = _ext_image(33, 45, 4, 16, 72)
    allp = ht.Plan(plane=lambda rng, mb, bits: min(2, bits - 1),
                   passes=lambda rng, p: 3)
    return {
        "j2k_ht_lossless_rgb.j2k": ht.encode(rgb, nl=5, cblk=(6, 6)),
        "j2k_ht_lossless_grey12_nl0.j2k": ht.encode(grey12, prec=12, nl=0,
                                                    cblk=(2, 2)),
        "j2k_ht_lossless_rgba16.j2k": ht.encode(rgba16, prec=16, nl=3,
                                                cblk=(4, 5)),
        "j2k_ht_97_rgba16_layers.j2k": ht.encode(
            rgba16, prec=16, rev=False, nl=3, cblk=(5, 3), nlayers=2,
            plan=ht.random_plan(), seed=73),
        "j2k_ht_97_sigprop_grey.j2k": ht.encode(
            image(40, 47, 1, seed=74)[..., 0], rev=False, nl=4, cblk=(5, 3),
            step_shift=2, plan=ht.Plan(
                plane=lambda rng, mb, bits: min(3, bits - 1),
                passes=lambda rng, p: 2)),
        "j2k_ht_three_passes_causal.j2k": ht.encode(
            image(45, 52, 3, seed=75), nl=2, cblk=(3, 4), causal=True,
            plan=allp),
        "j2k_ht_three_passes.j2k": ht.encode(
            image(45, 52, 3, seed=75), nl=2, cblk=(3, 4), plan=allp),
        "j2k_ht_tiles_offsets.j2k": ht.encode(
            image(50, 45, 3, seed=76), nl=2, cblk=(4, 4), tile=(24, 20),
            origin=(5, 3), tile_origin=(2, 1), nlayers=3,
            plan=ht.random_plan(), seed=77),
        "j2k_ht_sop_eph_styles.j2k": _patched(ht.encode(
            image(37, 45, 3, seed=78), rev=False, nl=3, cblk=(4, 4),
            sop_eph=True, nlayers=2, plan=ht.random_plan(), seed=79),
            0x52, 12, b"\x57"),
        "j2k_ht_lossless.jp2": wrap_jp2(ht.encode(image(29, 37, 3, seed=80),
                                                  nl=2, cblk=(4, 4)),
                                        [ihdr(29, 37, 3, 7), colr(16)]),
    }


def _ht_damaged(base: bytes, word: str, seed: int, at=None) -> bytes:
    """``base`` with one to three bytes of its last tile-part changed (at
    offsets from its end in ``at``, else anywhere): the first seed on
    from ``seed`` whose stream PIL refuses and the port's decoder refuses
    naming ``word``."""
    from classpose_tpu_torch.io import jpeg2000
    sod = base.rindex(b"\xff\x93") + 2
    for s in range(seed, seed + 20000):
        rng = np.random.default_rng(s)
        data = bytearray(base)
        for _ in range(int(rng.integers(1, 4))):
            i = (len(data) - 2 - int(rng.choice(at)) if at is not None
                 else int(rng.integers(sod, len(data) - 2)))
            data[i] = int(rng.integers(0, 256))
        data = bytes(data)
        try:
            jpeg2000.decode(data)
            continue
        except ValueError as e:
            if word not in str(e):
                continue
        try:
            pil_rgb(data)
        except Exception:
            return data
    raise AssertionError(f"no damaged stream raises {word!r}")


def ht_refused_streams() -> dict[str, tuple[bytes, str]]:
    """The ``j2k_ht_refused_*`` goldens, by file name, with the word the
    decoder's error names; PIL raises on each: mixed HT / Part 1 blocks,
    ROI, a fourth (placeholder) pass, more than 30 bit planes, more zero
    bit planes than bit planes, and blocks damaged into each of
    OpenJPEG's malformed-block errors."""
    ht = _ht()
    img = image(29, 37, 3, seed=81)
    base = ht.encode(img, nl=2, cblk=(4, 4))
    one = image(15, 13, 1, seed=82)[..., 0]
    single = ht.encode(one, nl=0, cblk=(4, 4))
    qcd = base.index(b"\xff\x5c")
    tail = list(range(1, 4))
    return {
        "j2k_ht_refused_mixed.j2k": (_patched(base, 0x52, 12, b"\xc0"),
                                     "mixed HT and Part 1"),
        "j2k_ht_refused_roi.j2k": (ht.encode(img, nl=2, cblk=(4, 4),
                                             roi=(1, 3)), "ROI"),
        "j2k_ht_refused_placeholder.j2k": (ht.encode(
            img, nl=2, cblk=(4, 4), plan=ht.Plan(
                plane=lambda rng, mb, bits: min(2, bits - 1),
                passes=lambda rng, p: 3, extra=1)), "4 coding passes"),
        "j2k_ht_refused_bit_planes.j2k": (
            base[:qcd + 5] + bytes([31 << 3]) + base[qcd + 6:],
            "31 bit planes"),
        "j2k_ht_refused_zero_planes.j2k": (
            base[:qcd + 5] + bytes([1 << 3]) + base[qcd + 6:],
            "zero bit planes"),
        "j2k_ht_refused_scup.j2k": (_ht_damaged(single, "Scup", 83, tail),
                                    "Scup"),
        "j2k_ht_refused_mel.j2k": (_ht_damaged(single, "MEL", 84),
                                   "incorrect MEL segment sequence"),
        "j2k_ht_refused_u_q.j2k": (_ht_damaged(single, "U_q", 85), "U_q"),
        "j2k_ht_refused_outside.j2k": (_ht_damaged(single, "outside", 86),
                                       "outside the code-block"),
    }


def ht_tile(k: int, rgb: np.ndarray) -> bytes:
    """Tile ``k`` of ``j2k_ht_region.svs``: lossless 5/3 with the RCT,
    HT code-blocks of 64², five levels."""
    return _ht().encode(rgb, nl=5, cblk=(6, 6))


def write_ht(golden: dict, region: np.ndarray) -> None:
    """The HT goldens, the HT SVS and their entries in ``golden``."""
    golden["ht_streams"] = {}
    for name, data in ht_streams().items():
        (HERE / name).write_bytes(data)
        rgb = pil_rgb(data)
        golden["ht_streams"][name] = {"sha256": sha256(rgb),
                                      "shape": list(rgb.shape)}
    golden["ht_refused"] = {}
    for name, (data, word) in ht_refused_streams().items():
        (HERE / name).write_bytes(data)
        golden["ht_refused"][name] = word
    streams = write_j2k_tiff(HERE / HT_SVS_NAME, region, SVS_TILE, SVS_MPP,
                             encode_tile=ht_tile)
    tiles = [pil_rgb(s) for s in streams]
    if not np.array_equal(np.concatenate([np.concatenate(
            tiles[r * 4:r * 4 + 4], 1) for r in range(4)]), region):
        raise AssertionError("the HT SVS does not decode to its region")
    golden["ht_svs"] = {"tiles": [sha256(t) for t in tiles]}


def main():
    import sys
    sys.path.insert(0, str(HERE.parents[1]))
    from classpose_tpu_torch.io.array_reader import synthetic_wsi

    golden = {"streams": {}, "svs": {}}
    for k, (name, (h, w, mode, kw)) in enumerate(STREAMS.items()):
        ch = {"L": 1, "RGB": 3, "RGBA": 4}[mode]
        img = image(h, w, ch, seed=k)
        data = encode(img[..., 0] if ch == 1 else img, mode, **kw)
        (HERE / f"{name}.j2k").write_bytes(data)
        rgb = pil_rgb(data)
        golden["streams"][name] = {"sha256": sha256(rgb),
                                   "shape": list(rgb.shape)}
    for k, (name, (h, w, ch, kw)) in enumerate(OPJ_STREAMS.items()):
        data = opj_encode(image(h, w, ch, seed=10 + k), HERE / f"{name}.j2k",
                          **kw)
        rgb = pil_rgb(data)
        golden["streams"][name] = {"sha256": sha256(rgb),
                                   "shape": list(rgb.shape)}
    slide, _ = synthetic_wsi(**SLIDE)
    region = slide._level0[:SVS_REGION, :SVS_REGION]
    streams = write_j2k_tiff(HERE / SVS_NAME, region, SVS_TILE, SVS_MPP,
                             irreversible=True, mct=1,
                             quality_layers=[SVS_RATE])
    golden["svs"] = {
        "slide": SLIDE, "region": SVS_REGION, "tile": SVS_TILE,
        "rate": SVS_RATE, "tiles": [sha256(pil_rgb(s)) for s in streams]}
    golden["ext_streams"] = {}
    for name, data in ext_streams().items():
        (HERE / name).write_bytes(data)
        rgb = pil_rgb(data)
        golden["ext_streams"][name] = {"sha256": sha256(rgb),
                                       "shape": list(rgb.shape)}
    golden["refused"] = {}
    for name, (data, word) in refused_streams().items():
        (HERE / name).write_bytes(data)
        golden["refused"][name] = word
    streams = write_j2k_tiff(HERE / EXT_SVS_NAME, region, SVS_TILE, SVS_MPP,
                             encode_tile=ext_tile)
    tiles = [pil_rgb(s) for s in streams]
    if not np.array_equal(np.concatenate([np.concatenate(
            tiles[r * 4:r * 4 + 4], 1) for r in range(4)]), region):
        raise AssertionError("the lossless SVS does not decode to its region")
    golden["ext_svs"] = {"kinds": list(EXT_KINDS),
                         "tiles": [sha256(t) for t in tiles]}
    golden["sub_streams"] = {}
    for name, data in sub_streams().items():
        (HERE / name).write_bytes(data)
        rgb = pil_rgb(data)
        golden["sub_streams"][name] = {"sha256": sha256(rgb),
                                       "shape": list(rgb.shape)}
    golden["sub_refused"] = {}
    for name, (data, word) in sub_refused_streams().items():
        (HERE / name).write_bytes(data)
        golden["sub_refused"][name] = word
    streams = write_j2k_tiff(HERE / SUB_SVS_NAME, region, SVS_TILE, SVS_MPP,
                             compression=33003, encode_tile=sub_tile)
    golden["sub_svs"] = {"kinds": list(SUB_KINDS),
                         "tiles": [sha256(pil_rgb(s)) for s in streams]}
    write_ht(golden, region)
    (HERE / JSON_NAME).write_text(json.dumps(golden, indent=1) + "\n")
    total = sum(p.stat().st_size for p in HERE.glob("j2k_*"))
    print("regenerated:", len(STREAMS) + len(OPJ_STREAMS)
          + len(golden["ext_streams"]) + len(golden["refused"])
          + len(golden["sub_streams"]) + len(golden["sub_refused"]),
          "streams,", 3 * len(streams), "SVS tiles,", total, "bytes")


def main_ht():
    """Only the HT goldens and SVS, into the existing ``j2k_golden.json``
    (and the refused Part 1 stream's word, which the HT decoder names)."""
    import sys
    sys.path.insert(0, str(HERE.parents[1]))
    from classpose_tpu_torch.io.array_reader import synthetic_wsi

    golden = json.loads((HERE / JSON_NAME).read_text())
    for name, (_, word) in refused_streams().items():
        golden["refused"][name] = word
    slide, _ = synthetic_wsi(**SLIDE)
    write_ht(golden, slide._level0[:SVS_REGION, :SVS_REGION])
    (HERE / JSON_NAME).write_text(json.dumps(golden, indent=1) + "\n")
    print("regenerated:", len(golden["ht_streams"]) + len(
        golden["ht_refused"]), "HT streams,", len(golden["ht_svs"]["tiles"]),
          "HT SVS tiles")


if __name__ == "__main__":
    import sys
    main_ht() if sys.argv[1:] == ["--ht"] else main()
