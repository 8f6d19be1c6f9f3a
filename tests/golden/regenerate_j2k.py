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
- ``j2k_golden.json``: the SHA-256 of PIL's RGB decode of every stream
  and of every tile of the SVS, with their shapes.

:func:`write_j2k_tiff` is also what the tests write their 33003 and 33005
files with, and :func:`opj_encode` their streams with code-block style
flags, SOP/EPH, ROI and POC.

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


def opj_encode(img: np.ndarray, path, *, irreversible: bool = False,
               mct: int = 0, numres: int = 6, cblk=(64, 64), csty: int = 0,
               mode: int = 0, rates=(), roi=None, poc=(),
               signed: bool = False) -> bytes:
    """A raw codestream of an (H, W[, C]) uint8 image written by OpenJPEG's
    own encoder through ctypes, for what PIL's ``save`` does not expose:
    ``csty`` (2: SOP, 4: EPH), ``mode`` (the code-block style flags: 1
    bypass, 2 reset, 4 termall, 8 vertically causal, 16 predictable
    termination, 32 segmentation symbols), ``roi`` (component, shift),
    ``poc`` ((res0, comp0, layer end, res1, comp1, order), ...) and the
    layers' ``rates``. The stream goes through the file ``path``."""
    o = _openjpeg()
    img = np.asarray(img, np.uint8)
    if img.ndim == 2:
        img = img[..., None]
    h, w, nc = img.shape
    # opj_image_cmptparm_t: dx, dy, w, h, x0, y0, prec, bpp, sgnd
    parm = (ctypes.c_uint32 * (9 * nc))()
    for c in range(nc):
        parm[9 * c:9 * c + 9] = [1, 1, w, h, 0, 0, 8, 8, int(signed)]
    im = o.opj_image_create(nc, parm, 1)
    ctypes.memmove(im, struct.pack("<4I", 0, 0, w, h), 16)  # x0 y0 x1 y1
    comps = ctypes.c_void_p.from_address(im + 24).value
    for c in range(nc):  # opj_image_comp_t is 64 bytes, data at 48
        plane = np.ascontiguousarray(img[..., c], np.int32)
        if signed:
            plane = plane - 128
        data = ctypes.c_void_p.from_address(comps + 64 * c + 48).value
        ctypes.memmove(data, plane.ctypes.data, plane.nbytes)
    p = (ctypes.c_ubyte * 20000)()
    o.opj_set_default_encoder_parameters(p)
    if struct.unpack_from("<3i", p, _P_NUMRES) != (6, 64, 64):
        raise RuntimeError("unexpected opj_cparameters_t layout")

    def put(off, fmt, *v):
        struct.pack_into(fmt, p, off, *v)

    put(_P_CSTY, "<i", csty)
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
    codec = o.opj_create_compress(0)  # OPJ_CODEC_J2K
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


def pil_rgb(data: bytes) -> np.ndarray:
    """What the JAX reader's PIL call gives for a tile."""
    return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))


def sha256(rgb: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(rgb).tobytes()).hexdigest()


def write_j2k_tiff(path, level0: np.ndarray, tile: int, mpp: float,
                   compression: int = 33005, n_levels: int = 1,
                   **kw) -> list[bytes]:
    """A classic little-endian tiled TIFF in Aperio's layout with JPEG 2000
    tiles encoded by PIL: 2× decimated levels, edge tiles coded at their
    own (partial) size, the MPP in the description. 33005 tiles hold the
    RGB components (``kw`` as PIL's save options); 33003 tiles hold the
    YCbCr values as plain components with no MCT, as Aperio writes them.
    Returns level 0's tile streams."""
    levels = [np.ascontiguousarray(level0, np.uint8)]
    for _ in range(1, n_levels):
        levels.append(np.ascontiguousarray(levels[-1][::2, ::2]))
    pages = []
    for img in levels:
        h, w = img.shape[:2]
        if compression == 33003:
            img = np.asarray(Image.fromarray(img).convert("YCbCr"))
        streams = [encode(np.ascontiguousarray(img[y:y + tile, x:x + tile]),
                          "RGB", **kw)
                   for y in range(0, h, tile) for x in range(0, w, tile)]
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
    (HERE / JSON_NAME).write_text(json.dumps(golden, indent=1) + "\n")
    total = sum(p.stat().st_size for p in HERE.glob("j2k_*"))
    print("regenerated:", len(STREAMS) + len(OPJ_STREAMS), "streams,",
          len(streams),
          "SVS tiles,", total, "bytes")


if __name__ == "__main__":
    main()
