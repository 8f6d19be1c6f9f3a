"""Regenerate the JPEG golden pair: a baseline 4:2:0 stream written by
PIL and the RGB array PIL (libjpeg-turbo) decodes from it. The port's
decoder must return that array bit for bit (``tests/test_torch_tiff.py``
and ``chip_smoke.py``, which has no PIL).

Run: python tests/golden/regenerate_jpeg.py
"""

import io
from pathlib import Path

import numpy as np
from PIL import Image

HERE = Path(__file__).parent


def main():
    rng = np.random.default_rng(10)
    # odd sides, so the chroma planes end in half-covered MCUs and the
    # fancy upsampler's edge cases are in the golden; smooth colour
    # ramps plus noise, so every block has AC terms
    h, w = 37, 45
    yy, xx = np.mgrid[:h, :w]
    img = np.stack([120 + 100 * np.sin(xx / 7.0), 90 + 3 * yy,
                    200 - 2 * xx + yy], -1)
    img = np.clip(img + rng.normal(0, 12, img.shape), 0, 255)
    buf = io.BytesIO()
    Image.fromarray(img.astype(np.uint8)).save(buf, "JPEG", quality=80)
    (HERE / "jpeg_golden.jpg").write_bytes(buf.getvalue())
    rgb = np.asarray(Image.open(io.BytesIO(buf.getvalue())).convert("RGB"))
    np.save(HERE / "jpeg_golden_rgb.npy", rgb)
    print("regenerated:", len(buf.getvalue()), "bytes,", rgb.shape)


if __name__ == "__main__":
    main()
