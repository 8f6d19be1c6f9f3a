"""Regenerate the JPEG goldens, whose pixels as PIL (libjpeg-turbo) decodes
them the port's decoder must reproduce bit for bit
(``tests/test_torch_tiff.py``, ``tests/test_torch_jpeg_processes.py`` and
``chip_smoke.py``, which has no PIL):

- ``jpeg_golden.jpg`` and ``jpeg_golden_rgb.npy``: a baseline 4:2:0
  stream written by PIL and the RGB array PIL decodes from it;
- ``jpeg_<name>.jpg``: small streams, each a process or feature of the
  decoder (``STREAMS``): progressive Huffman (SOF2) with complete and
  incomplete scripts (block smoothing), sequential scans of some
  components and a component no scan holds, arithmetic coding (SOF9,
  SOF10, DAC), CMYK and YCCK, sampling factors up to 4, lossless (SOF3);
- ``jpeg_refused_<name>.jpg``: streams PIL refuses (``REFUSED``), each
  with the word the port's ``ValueError`` must name: hierarchical and
  arithmetic-lossless processes, other precisions, DNL, fractional
  sampling, MCUs over 10 blocks, bad scan parameters, 2 components,
  colour conversion of lossless streams, and an arithmetic scan that
  reads past the 64 KiB read holding its header (PIL reads a stream in
  64 KiB pieces and libjpeg cannot suspend an arithmetic decoder);
- ``jpeg_region.svs``: an Aperio-style TIFF with JPEG tiles (compression
  7): the ``[0:2048, 0:2048]`` region of ``synthetic_wsi(6144, 6144,
  n_cells=4000, mpp=0.4, seed=0)`` (the region of ``j2k_region.svs``),
  16 tiles of 512² at quality 80 and a 2× level of 4, MPP 0.4 in its
  description, the tiles' processes SOF2 (PIL's ``progressive=True``),
  SOF10, SOF9 and 4:1:1 baseline, all four in every 2 × 2 block;
- ``jpeg_golden.json``: the SHA-256 and shape of PIL's ``convert("RGB")``
  pixels of every stream and every tile of the SVS, and the refusals.

``jpeg_writer.c`` writes what PIL's ``save`` cannot; it is compiled here
with ``gcc`` against the system's libjpeg-turbo (``-ljpeg``, 2.1 or later:
arithmetic coding, scan scripts, sampling factors, YCCK) and against
Pillow's bundled libjpeg-turbo 3 (``-DTURBO3``: ``jpeg_enable_lossless``,
12- and 16-bit samples). :func:`lossless_jpeg` writes the lossless
streams libjpeg-turbo 3.1 does not (subsampled, other component ids).
The tests need no compiler: they read the committed bytes.

Run: python tests/golden/regenerate_jpeg.py
"""

import glob
import hashlib
import io
import json
import os
import struct
import subprocess
import tempfile
import zlib
from pathlib import Path

import numpy as np
from PIL import Image

HERE = Path(__file__).parent
SVS_NAME, JSON_NAME = "jpeg_region.svs", "jpeg_golden.json"
SVS_REGION, SVS_TILE, SVS_MPP, SVS_QUALITY = 2048, 512, 0.4, 80
SLIDE = dict(width=6144, height=6144, n_cells=4000, mpp=SVS_MPP, seed=0)
# the SVS tiles' processes (:func:`svs_process`): (name, jpeg_writer
# options or None for PIL's progressive save)
SVS_PROCESSES = [("SOF2", None), ("SOF10", ["arith=1", "prog=1"]),
                 ("SOF9", ["arith=1"]), ("SOF0 4:1:1", ["samp=4x1,1x1,1x1"])]

# a script whose bands and bits arrive in no simple order
SCRAMBLED = ("0/0/0/0/2;1/0/0/0/2;2/0/0/0/2;0/1/9/0/1;012/0/0/2/1;"
             "0/10/63/0/2;1/1/63/0/1;0/1/9/1/0;2/1/63/0/0;0/10/63/2/1;"
             "012/0/0/1/0;1/1/63/1/0;0/10/63/1/0")

# name -> (height, width, channels, how): how is ("pil", save options),
# ("writer", options) with the system libjpeg, ("writer3", options) with
# Pillow's libjpeg-turbo 3, ("lossless", lossless_jpeg options), or
# ("drop_scan", k, how): that stream without its k-th scan
STREAMS = {
    # progressive Huffman (SOF2); the scripts that stop early take
    # libjpeg's block smoothing
    "sof2_pil": (37, 45, 3, ("pil", dict(quality=80, progressive=True))),
    "sof2_pil_grey_odd": (33, 29, 1, ("pil", dict(quality=90,
                                                  progressive=True))),
    "sof2_restart_eobrun": (45, 52, 3, ("writer", ["prog=1", "opt=1",
                                                   "restart=2"])),
    "sof2_scrambled": (40, 47, 3, ("writer", ["scans=" + SCRAMBLED])),
    "sof2_dc_only": (45, 52, 3, ("writer", ["scans=012/0/0/0/0"])),
    "sof2_dc_only_grey_2x2": (41, 30, 1, ("writer", [
        "samp=2x2", "scans=0/0/0/0/1"])),
    "sof2_dc_low_ac": (45, 52, 3, ("writer", [
        "scans=012/0/0/0/0;0/1/5/0/0;1/1/5/0/0;2/1/5/0/0"])),
    "sof2_al_no_refine": (45, 52, 3, ("writer", [
        "scans=012/0/0/0/1;0/1/63/0/2;1/1/63/0/2;2/1/63/0/2"])),
    "sof2_component_no_ac": (45, 52, 3, ("writer", [
        "scans=012/0/0/0/0;0/1/63/0/0;1/1/63/0/0"])),
    # sequential scans of one or two components; a component no scan
    # holds (libjpeg's zero coefficients and zero IDCT table: 128)
    "sof1_multiscan": (37, 45, 3, ("writer", [
        "samp=2x2,1x1,1x1", "scans=0/0/63/0/0;12/0/63/0/0"])),
    "sof1_component_never_scanned": (37, 45, 3, ("drop_scan", 2, (
        "writer", ["scans=0/0/63/0/0;1/0/63/0/0;2/0/63/0/0"]))),
    # arithmetic coding
    "sof9": (37, 45, 3, ("writer", ["arith=1"])),
    "sof9_restart_dac": (45, 52, 3, ("writer", [
        "arith=1", "restart=3", "dac=2,4,2"])),
    "sof10": (37, 45, 3, ("writer", ["arith=1", "prog=1", "restart=5"])),
    "sof10_partial": (45, 52, 3, ("writer", [
        "arith=1", "scans=012/0/0/0/1;0/1/9/0/1;1/1/2/0/0;2/1/63/0/1"])),
    # four components
    "cmyk_adobe": (37, 45, 4, ("writer", ["cs=cmyk"])),
    "cmyk_no_adobe": (37, 45, 4, ("writer", ["cs=cmyk", "adobe=0"])),
    "ycck": (37, 45, 4, ("writer", ["cs=ycck", "samp=2x2,1x1,1x1,2x2"])),
    "cmyk_pil_sof2": (37, 45, 4, ("pil", dict(quality=85,
                                              progressive=True))),
    # sampling factors 3 and 4 (int_upsample), and a chroma 1x2
    "samp_411": (37, 45, 3, ("writer", ["samp=4x1,1x1,1x1"])),
    "samp_32": (37, 45, 3, ("writer", ["samp=3x2,1x1,1x1"])),
    "samp_14": (37, 45, 3, ("writer", ["samp=1x4,1x1,1x1", "arith=1"])),
    "samp_22_12": (37, 45, 3, ("writer", ["samp=2x2,1x2,1x2", "prog=1"])),
    # lossless (SOF3)
    "sof3_p1": (37, 45, 3, ("writer3", ["lossless=1,0"])),
    "sof3_p7_pt2_restart": (37, 45, 3, ("writer3", [
        "lossless=7,2", "restart=90"])),
    "sof3_grey_p4": (37, 45, 1, ("writer3", ["lossless=4,0"])),
    "sof3_cmyk_p5": (37, 45, 4, ("writer3", ["lossless=5,1"])),
    "sof3_sub_22_p6": (37, 45, 3, ("lossless", dict(
        samp=[(2, 2), (1, 1), (1, 1)], psv=6, pt=0, restart_rows=4))),
}

JFIF = b"\xff\xe0\x00\x10JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00"
ADOBE_YCCK = b"\xff\xee\x00\x0eAdobe\x00\x64\x00\x00\x00\x00\x02"


def _set_sof(data: bytes, marker: int | None = None, **fields) -> bytes:
    """``data`` with its frame header's marker or fields replaced:
    ``height``, ``width``, ``precision``, ``sampling`` (a list of
    factors as ``0xHV`` bytes)."""
    out = bytearray(data)
    i = next(i for i in range(len(out) - 1)
             if out[i] == 0xFF and out[i + 1] in (0xC0, 0xC1, 0xC2, 0xC3))
    if marker is not None:
        out[i + 1] = marker
    if "precision" in fields:
        out[i + 4] = fields["precision"]
    if "height" in fields:
        struct.pack_into(">H", out, i + 5, fields["height"])
    if "width" in fields:
        struct.pack_into(">H", out, i + 7, fields["width"])
    for k, hv in enumerate(fields.get("sampling", [])):
        out[i + 11 + 3 * k] = hv
    return bytes(out)


def _set_scan(data: bytes, nth: int, ss_se_a: tuple) -> bytes:
    """``data`` with the ``nth`` scan header's Ss, Se and Ah/Al bytes
    replaced."""
    out = bytearray(data)
    pos = [i for i in range(len(out) - 1)
           if out[i] == 0xFF and out[i + 1] == 0xDA][nth]
    n = struct.unpack_from(">H", out, pos + 2)[0]
    out[pos + 2 + n - 3:pos + 2 + n] = bytes(ss_se_a)
    return bytes(out)


# name -> (height, width, channels, how, then, word): ``then`` patches the
# stream (None: as written), ``word`` is what the port's message names
REFUSED = {
    "precision_12": (37, 45, 3, ("writer3", ["prec=12"]), None,
                     "precision 12"),
    "precision_16_lossless": (37, 45, 3, ("writer3", [
        "prec=16", "lossless=1,0"]), None, "precision 16"),
    "sof11": (37, 45, 3, ("writer3", ["lossless=1,0"]),
              lambda d: _set_sof(d, 0xCB), "SOF11"),
    **{f"sof{m - 0xC0}": (37, 45, 3, ("pil", dict(quality=80)),
                          lambda d, m=m: _set_sof(d, m), f"SOF{m - 0xC0}")
       for m in (0xC5, 0xC6, 0xC7, 0xCD, 0xCE, 0xCF)},
    "dnl_height_0": (37, 45, 3, ("pil", dict(quality=80)),
                     lambda d: _set_sof(d, height=0), "DNL"),
    "fractional_sampling": (37, 45, 3, ("writer", ["samp=3x1,1x1,1x1"]),
                            lambda d: _set_sof(d, sampling=[0x31, 0x21]),
                            "fractional"),
    "mcu_11_blocks": (37, 45, 4, ("writer", ["cs=cmyk"]),
                      lambda d: _set_sof(d, sampling=[0x42]),
                      "interleaved"),
    "bad_progression": (37, 45, 3, ("pil", dict(quality=80,
                                                progressive=True)),
                        lambda d: _set_scan(d, 1, (1, 5, 0x0E)),
                        "progression"),
    "two_components": (37, 45, 2, ("lossless", dict(
        samp=[(1, 1), (1, 1)], psv=1)), None, "2 components"),
    # an arithmetic scan read past the 64 KiB read that holds its header:
    # libjpeg cannot suspend there, so PIL's chunked reads fail
    "arith_past_64k": (0, 0, 3, ("arith_64k", None), None, "64 KiB"),
    "lossless_ycbcr": (37, 45, 3, ("lossless", dict(
        samp=[(1, 1)] * 3, psv=1)), lambda d: d[:2] + JFIF + d[2:],
        "YCbCr in a lossless"),
    "lossless_ycck": (37, 45, 4, ("lossless", dict(
        samp=[(1, 1)] * 4, psv=1)), lambda d: d[:2] + ADOBE_YCCK + d[2:],
        "YCCK in a lossless"),
}


def image(h: int, w: int, channels: int, seed: int) -> np.ndarray:
    """Smooth colour ramps plus noise: every block has AC terms."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:h, :w]
    img = np.stack([128 + 90 * np.sin(xx / 5.0 + yy / 9.0 + k)
                    + 20 * np.cos(yy / 4.0 + k) for k in range(channels)],
                   -1)
    img = np.clip(img + rng.normal(0, 14, img.shape), 0, 255)
    return img.astype(np.uint8)


# ------------------------------------------------------------ writers

def _pillow_libjpeg() -> str:
    import PIL
    libs = Path(PIL.__file__).parents[1] / "pillow.libs"
    return glob.glob(str(libs / "libjpeg-*.so*"))[0]


def build_writers(out_dir) -> dict:
    """``jpeg_writer.c`` built against the system libjpeg-turbo
    (``writer``) and Pillow's (``writer3``)."""
    src = str(HERE / "jpeg_writer.c")
    lib3 = _pillow_libjpeg()
    exe = {"writer": os.path.join(out_dir, "jpeg_writer"),
           "writer3": os.path.join(out_dir, "jpeg_writer3")}
    subprocess.run(["gcc", "-O2", "-o", exe["writer"], src, "-ljpeg"],
                   check=True)
    subprocess.run(["gcc", "-O2", "-DTURBO3", "-o", exe["writer3"], src, lib3,
                    f"-Wl,-rpath,{os.path.dirname(lib3)}"], check=True)
    return exe


def write_with(exe: str, img: np.ndarray, options: list) -> bytes:
    """A stream from ``jpeg_writer`` of an (H, W) or (H, W, C) image."""
    img = np.ascontiguousarray(img, np.uint8)
    nc = 1 if img.ndim == 2 else img.shape[2]
    with tempfile.TemporaryDirectory() as tmp:
        raw, out = os.path.join(tmp, "in.raw"), os.path.join(tmp, "o.jpg")
        Path(raw).write_bytes(img.tobytes())
        r = subprocess.run([exe, raw, out, str(img.shape[1]),
                            str(img.shape[0]), str(nc), *options],
                           capture_output=True, text=True)
        if r.returncode:
            raise RuntimeError(f"jpeg_writer {options}: {r.stderr}")
        return Path(out).read_bytes()


def pil_jpeg(img: np.ndarray, **kw) -> bytes:
    mode = "L" if img.ndim == 2 else {3: "RGB", 4: "CMYK"}[img.shape[2]]
    buf = io.BytesIO()
    Image.fromarray(img, mode).save(buf, "JPEG", **kw)
    return buf.getvalue()


_DC_BITS = [0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0]


def lossless_jpeg(planes, samp, psv: int, pt: int = 0,
                  restart_rows: int = 0, ids=None) -> bytes:
    """A lossless (SOF3) stream of 8-bit component planes, each at its
    downsampled size for ``samp`` ((h, v) factors), predictor ``psv``,
    point transform ``pt``, a restart every ``restart_rows`` MCU rows, the
    Annex K luminance DC table. The predictions follow T.81 H.1.2: the
    first row of the scan and of each restart interval from the left (its
    first sample from 2^(7 - pt)), the first column from above."""
    nc = len(planes)
    hmax = max(h for h, _ in samp)
    vmax = max(v for _, v in samp)
    H = planes[0].shape[0] * vmax // samp[0][1]
    W = planes[0].shape[1] * hmax // samp[0][0]
    mcux, mcuy = -(-W // hmax), -(-H // vmax)
    ids = ids or list(range(1, nc + 1))
    codes, code, k = {}, 0, 0
    for n in range(1, 17):
        for _ in range(_DC_BITS[n - 1]):
            codes[k] = (code, n)
            code, k = code + 1, k + 1
        code <<= 1
    out = bytearray(b"\xff\xd8\xff\xc3")
    out += struct.pack(">HBHHB", 8 + 3 * nc, 8, H, W, nc)
    for i, (h, v) in enumerate(samp):
        out += bytes([ids[i], h << 4 | v, 0])
    out += b"\xff\xc4" + struct.pack(">H", 31) + bytes([0, *_DC_BITS,
                                                        *range(12)])
    if restart_rows:
        out += b"\xff\xdd" + struct.pack(">HH", 4, restart_rows * mcux)
    out += b"\xff\xda" + struct.pack(">HB", 6 + 2 * nc, nc)
    for i in range(nc):
        out += bytes([ids[i], 0])
    out += bytes([psv, 0, pt])
    diffs = []
    for p, (h, v) in zip(planes, samp):
        x = p.astype(np.int64) >> pt
        d = np.zeros((mcuy * v, mcux * h), np.int64)
        for y in range(x.shape[0]):
            r = y // v
            first = y % v == 0 and (r == 0 or (restart_rows
                                               and r % restart_rows == 0))
            for c in range(x.shape[1]):
                if first:
                    pr = x[y, c - 1] if c else 1 << (7 - pt)
                elif c == 0:
                    pr = x[y - 1, 0]
                else:
                    ra, rb, rc = x[y, c - 1], x[y - 1, c], x[y - 1, c - 1]
                    pr = (ra, rb, rc, ra + rb - rc, ra + ((rb - rc) >> 1),
                          rb + ((ra - rc) >> 1), (ra + rb) >> 1)[psv - 1]
                d[y, c] = (x[y, c] - pr) & 0xFFFF
        diffs.append(d)
    bits = []

    def flush():
        bits.extend([1] * (-len(bits) % 8))
        for i in range(0, len(bits), 8):
            b = int("".join(map(str, bits[i:i + 8])), 2)
            out.append(b)
            if b == 0xFF:
                out.append(0)
        bits.clear()

    for my in range(mcuy):
        if restart_rows and my and my % restart_rows == 0:
            flush()
            out += bytes([0xFF, 0xD0 + (my // restart_rows - 1) % 8])
        for mx in range(mcux):
            for d, (h, v) in zip(diffs, samp):
                for yy in range(v):
                    for xx in range(h):
                        t = int(d[my * v + yy, mx * h + xx])
                        t = t - 65536 if t >= 32768 else t
                        n = abs(t).bit_length()
                        c, length = codes[n]
                        bits.extend((c >> (length - 1 - i)) & 1
                                    for i in range(length))
                        t = t if t > 0 else t - 1 + (1 << n)
                        bits.extend((t >> (n - 1 - i)) & 1 for i in range(n))
    flush()
    return bytes(out + b"\xff\xd9")


def arith_over_64k(writers: dict) -> bytes:
    """The smallest SOF9 stream over 64 KiB of images growing from 200²
    (PIL refuses it: its one scan crosses the first 64 KiB read)."""
    for side in range(200, 600, 2):
        data = write_with(writers["writer"], image(side, side, 3, seed=side),
                          ["q=95", "arith=1"])
        if len(data) > 65536:
            return data
    raise RuntimeError("no stream over 64 KiB")


def drop_scan(data: bytes, k: int) -> bytes:
    """``data`` without its ``k``-th scan (header and entropy data)."""
    sos = [i for i in range(len(data) - 1)
           if data[i] == 0xFF and data[i + 1] == 0xDA]
    i = sos[k]
    j = i + 2 + struct.unpack_from(">H", data, i + 2)[0]
    while not (data[j] == 0xFF and data[j + 1] != 0
               and not 0xD0 <= data[j + 1] <= 0xD7):
        j += 1
    return data[:i] + data[j:]


def make(how, img: np.ndarray, writers: dict) -> bytes:
    kind, opts = how[:2]
    if kind == "drop_scan":
        return drop_scan(make(how[2], img, writers), opts)
    if kind == "arith_64k":
        return arith_over_64k(writers)
    if kind == "pil":
        return pil_jpeg(img, **opts)
    if kind == "lossless":
        hmax = max(h for h, _ in opts["samp"])
        vmax = max(v for _, v in opts["samp"])
        planes = [img[::vmax // v, ::hmax // h, i]
                  for i, (h, v) in enumerate(opts["samp"])]
        return lossless_jpeg(planes, **opts)
    return write_with(writers[kind], img, opts)


def pil_rgb(data: bytes) -> np.ndarray:
    """What the JAX reader's PIL call gives for a tile."""
    return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))


def sha256(rgb: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(rgb).tobytes()).hexdigest()


def svs_process(row: int, col: int) -> int:
    """The index in ``SVS_PROCESSES`` of a tile: every 2 × 2 block of
    tiles holds all four processes."""
    return (col + 2 * row) % len(SVS_PROCESSES)


def svs_tile_streams(level: np.ndarray, tile: int, writers: dict,
                     quality: int = SVS_QUALITY) -> list:
    """The tiles of one level, row-major, each coded by its process."""
    streams = []
    h, w = level.shape[:2]
    for y in range(0, h, tile):
        for x in range(0, w, tile):
            t = np.ascontiguousarray(level[y:y + tile, x:x + tile])
            _, opts = SVS_PROCESSES[svs_process(y // tile, x // tile)]
            streams.append(
                pil_jpeg(t, quality=quality, progressive=True)
                if opts is None else
                write_with(writers["writer"], t, [f"q={quality}", *opts]))
    return streams


def main():
    import sys
    sys.path.insert(0, str(HERE.parents[1]))
    sys.path.insert(0, str(HERE))
    from classpose_tpu_torch.io.array_reader import synthetic_wsi
    from regenerate_j2k import write_tiff

    rng = np.random.default_rng(10)
    # the baseline pair: odd sides, so the chroma planes end in half-covered
    # MCUs and the fancy upsampler's edge cases are in the golden; smooth
    # colour ramps plus noise, so every block has AC terms
    h, w = 37, 45
    yy, xx = np.mgrid[:h, :w]
    img = np.stack([120 + 100 * np.sin(xx / 7.0), 90 + 3 * yy,
                    200 - 2 * xx + yy], -1)
    img = np.clip(img + rng.normal(0, 12, img.shape), 0, 255)
    buf = io.BytesIO()
    Image.fromarray(img.astype(np.uint8)).save(buf, "JPEG", quality=80)
    (HERE / "jpeg_golden.jpg").write_bytes(buf.getvalue())
    rgb = pil_rgb(buf.getvalue())
    np.save(HERE / "jpeg_golden_rgb.npy", rgb)

    for old in HERE.glob("jpeg_[rs]*.jpg"):
        old.unlink()
    golden = {"streams": {}, "refused": {}, "svs": {}}
    with tempfile.TemporaryDirectory() as tmp:
        writers = build_writers(tmp)
        for name, (h, w, ch, how) in STREAMS.items():
            img = image(h, w, ch, seed=zlib.crc32(name.encode()))
            data = make(how, img[..., 0] if ch == 1 else img, writers)
            (HERE / f"jpeg_{name}.jpg").write_bytes(data)
            rgb = pil_rgb(data)
            golden["streams"][name] = {"sha256": sha256(rgb),
                                       "shape": list(rgb.shape)}
        for name, (h, w, ch, how, then, word) in REFUSED.items():
            img = image(h, w, ch, seed=zlib.crc32(name.encode()))
            data = make(how, img, writers)
            data = then(data) if then else data
            try:
                pil_rgb(data)
            except Exception:
                pass
            else:
                raise RuntimeError(f"PIL decodes the refused {name}")
            (HERE / f"jpeg_refused_{name}.jpg").write_bytes(data)
            golden["refused"][name] = word

        slide, _ = synthetic_wsi(**SLIDE)
        level0 = np.ascontiguousarray(slide._level0[:SVS_REGION,
                                                    :SVS_REGION])
        levels = [level0, np.ascontiguousarray(level0[::2, ::2])]
        pages = [(lv.shape[1], lv.shape[0],
                  svs_tile_streams(lv, SVS_TILE, writers)) for lv in levels]
    desc = (f"Aperio Image Library v12.0.15\r\n{SVS_REGION}x{SVS_REGION} "
            f"({SVS_TILE}x{SVS_TILE}) JPEG/RGB Q={SVS_QUALITY}|AppMag = 20|"
            f"MPP = {SVS_MPP}")
    write_tiff(HERE / SVS_NAME, pages, SVS_TILE, desc, 7, 6)
    golden["svs"] = {
        "slide": SLIDE, "region": SVS_REGION, "tile": SVS_TILE,
        "quality": SVS_QUALITY,
        "processes": [p for p, _ in SVS_PROCESSES],
        "levels": [[{"sha256": sha256(pil_rgb(s)),
                     "shape": list(pil_rgb(s).shape),
                     "process": SVS_PROCESSES[svs_process(*divmod(
                         k, -(-w // SVS_TILE)))][0]}
                    for k, s in enumerate(streams)]
                   for w, _, streams in pages]}
    (HERE / JSON_NAME).write_text(json.dumps(golden, indent=1) + "\n")
    total = sum(p.stat().st_size for p in HERE.glob("jpeg_*"))
    print("regenerated:", len(STREAMS), "streams,", len(REFUSED),
          "refused,", sum(len(s) for _, _, s in pages), "SVS tiles,",
          total, "bytes")


if __name__ == "__main__":
    main()
