"""Two damaged copies of ``jpeg_region.svs``, for the decoder's faults
against PIL (libjpeg-turbo 3.1) on the slide path:

- ``truncated``: one tile's byte count cut by 2 in its IFD, so its stream
  ends without its EOI marker. PIL raises "image file is truncated" (a
  progressive tile: libjpeg reads every scan up to EOI before the first
  row); the JAX reader thread stops the WSI run with ``RuntimeError("slide
  reader thread failed")``, and so must the port's.
- ``edited``: one byte of one 4:1:1 baseline tile's entropy-coded data set
  to 0x55, where the decode runs a coefficient past position 63 and the
  SIMD inverse DCT saturates (the decoder before its repair gave 7 other
  pixels). PIL decodes it; the port must give PIL's pixels, whose SHA-256
  ``jpeg_damaged.json`` records.

:func:`damaged` applies a damage to the SVS bytes with no third-party
module (``chip_smoke.py`` uses it on the card's machine, which has no
PIL). Run ``python tests/golden/jpeg_damage.py`` to rewrite
``jpeg_damaged.json`` (PIL's digest of the edited tile).
"""

import json
import struct
from pathlib import Path

HERE = Path(__file__).parent
SVS, JSON_NAME = HERE / "jpeg_region.svs", "jpeg_damaged.json"
# (IFD, tile) of each damage: the first tile of each level is SOF2 (read
# first by a run at either level), level 1's last is 4:1:1
DAMAGES = {
    "truncated": {"ifd": 0, "tile": 0, "cut": 2},
    "edited": {"ifd": 1, "tile": 3, "offset": 628, "value": 0x55},
}


def _tile_arrays(raw: bytes, ifd_index: int):
    """(offsets, counts, position of the counts array) of the
    ``ifd_index``-th IFD of a little-endian classic TIFF whose tiles are
    LONG arrays."""
    if raw[:4] != b"II*\0":
        raise ValueError("not a little-endian classic TIFF")
    ifd = struct.unpack_from("<I", raw, 4)[0]
    for _ in range(ifd_index):
        n = struct.unpack_from("<H", raw, ifd)[0]
        ifd = struct.unpack_from("<I", raw, ifd + 2 + 12 * n)[0]
    n = struct.unpack_from("<H", raw, ifd)[0]
    tags = {}
    for i in range(n):
        tag, typ, count, value = struct.unpack_from("<HHII", raw,
                                                    ifd + 2 + 12 * i)
        tags[tag] = (typ, count, value)
    (t_off, n_off, p_off), (t_cnt, n_cnt, p_cnt) = tags[324], tags[325]
    if t_off != 4 or t_cnt != 4 or n_off < 2:
        raise ValueError("tile arrays other than LONG arrays")
    offsets = struct.unpack_from(f"<{n_off}I", raw, p_off)
    counts = struct.unpack_from(f"<{n_cnt}I", raw, p_cnt)
    return offsets, counts, p_cnt


def tile_stream(raw: bytes, ifd: int, tile: int) -> bytes:
    offsets, counts, _ = _tile_arrays(raw, ifd)
    return raw[offsets[tile]:offsets[tile] + counts[tile]]


def damaged(raw: bytes, kind: str) -> bytes:
    """The SVS bytes with the damage ``kind`` of :data:`DAMAGES`."""
    spec = DAMAGES[kind]
    offsets, counts, pos = _tile_arrays(raw, spec["ifd"])
    out = bytearray(raw)
    t = spec["tile"]
    if kind == "truncated":
        struct.pack_into("<I", out, pos + 4 * t, counts[t] - spec["cut"])
    else:
        out[offsets[t] + spec["offset"]] = spec["value"]
    return bytes(out)


def main():
    import hashlib
    import io

    import numpy as np
    from PIL import Image

    raw = SVS.read_bytes()
    golden = {"damages": DAMAGES, "pil": {}}
    for kind, spec in DAMAGES.items():
        data = tile_stream(damaged(raw, kind), spec["ifd"], spec["tile"])
        try:
            rgb = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
        except OSError as e:
            golden["pil"][kind] = {"raises": str(e).split(" (")[0]}
        else:
            golden["pil"][kind] = {"sha256": hashlib.sha256(
                np.ascontiguousarray(rgb).tobytes()).hexdigest(),
                "shape": list(rgb.shape)}
    (HERE / JSON_NAME).write_text(json.dumps(golden, indent=1) + "\n")
    print(json.dumps(golden["pil"]))


if __name__ == "__main__":
    main()
