"""The port's zstd decoder (``classpose_tpu_torch/native/zstd.cpp``,
``io/zstd.py``) against ``zstandard`` (libzstd), on the CPU.

- exactly ``zstandard``'s bytes at levels -7, 1, 3, 9, 19 and 22, on
  sizes 0, 1, 127, 128 KiB - 1, 128 KiB, 128 KiB + 1 and about 2 MiB, of
  random bytes (raw blocks), constant bytes (RLE), text-like bytes and
  slide bytes, in frames with and without a content size and with and
  without a checksum; with long-distance matching; after and between
  skippable frames;
- every cut and random 1-3-byte edits of several frames raise where
  libzstd's streaming decoder (``decompressobj``, frame after frame)
  raises, and decode to its bytes where it does not;
- a dictionary ID raises by name; a fixed output size is held to."""

from __future__ import annotations

import functools
import io
import threading
from pathlib import Path

import numpy as np
import pytest
import zstandard

from classpose_tpu_torch.io import zstd

GOLDEN = Path(__file__).parent / "golden"
KIB = 1024
SIZES = (0, 1, 127, 128 * KIB - 1, 128 * KIB, 128 * KIB + 1)
BIG = 2 * 1024 * KIB + 333
WORDS = [b"the", b"nucleus", b"of", b"a", b"cell", b"stains", b"dark",
         b"tile", b"slide", b"zeiss", b"\n", b"0.4", b"um"]


def source(kind: str, n: int, seed: int = 0) -> bytes:
    rng = np.random.default_rng(seed)
    if kind == "random":
        return rng.integers(0, 256, n, np.uint8).tobytes()
    if kind == "constant":
        return bytes([0xA7]) * n
    if kind == "text":
        words = rng.choice(len(WORDS), n // 3 + 2)
        return b" ".join(WORDS[i] for i in words)[:n]
    rgb = np.load(GOLDEN / "jpeg_golden_rgb.npy")           # slide bytes
    raw = rgb.tobytes()
    return (raw * (n // len(raw) + 1))[:n] if n else b""


@functools.lru_cache(maxsize=None)
def _compressor(level: int, content_size: bool, checksum: bool):
    return zstandard.ZstdCompressor(level=level, write_checksum=checksum,
                                    write_content_size=content_size)


def frame(src: bytes, level: int, content_size: bool, checksum: bool
          ) -> bytes:
    """A frame of ``src``; without a content size through the stream
    writer, as CZI writers and ``zstandard``'s stream writer leave it
    out."""
    c = _compressor(level, content_size, checksum)
    if content_size:
        return c.compress(src)
    buf = io.BytesIO()
    with c.stream_writer(buf, closefd=False) as w:
        w.write(src)
    return buf.getvalue()


def reference(data: bytes) -> bytes:
    """libzstd's streaming decoder frame after frame (skippable frames
    skipped): the bytes, or the error where it raises or the data ends
    inside a frame."""
    d = zstandard.ZstdDecompressor()
    out = b""
    while data:
        o = d.decompressobj()
        out += o.decompress(data)
        if not o.eof:
            raise zstandard.ZstdError("the data ends inside a frame")
        data = o.unused_data
    return out


@pytest.mark.parametrize("kind", ["random", "constant", "text", "slide"])
@pytest.mark.parametrize("level", [-7, 1, 3, 9, 19, 22])
def test_matches_zstandard(level, kind):
    """Every size in each of the four frame kinds (content size and
    checksum on and off in turn); about 2 MiB at the fast levels and on
    two kinds at level 19."""
    sizes = list(SIZES)
    if level <= 3 or (level, kind) in ((19, "slide"), (19, "text")):
        sizes.append(BIG)
    for i, n in enumerate(sizes):
        src = source(kind, n, seed=i)
        fcs, ck = (i % 2 == 0), (i // 2 % 2 == 0)
        f = frame(src, level, fcs, ck)
        assert reference(f) == src
        got = zstd.decompress(f)
        assert got.dtype == np.uint8 and got.tobytes() == src, (n, fcs, ck)
        assert zstd.decompress(f, len(src)).tobytes() == src


def test_long_distance_matching():
    """``enable_ldm=True`` with a 128 MiB window (``window_log=27``, the
    decoder's limit): matches reach back past 1 MiB."""
    rng = np.random.default_rng(5)
    block = rng.integers(0, 256, 700 * KIB, np.uint8).tobytes()
    src = block + source("text", 500 * KIB) + block
    params = zstandard.ZstdCompressionParameters.from_level(
        19, enable_ldm=True, window_log=27)
    f = zstandard.ZstdCompressor(compression_params=params).compress(src)
    assert len(f) < len(src) // 2
    assert zstd.decompress(f).tobytes() == reference(f) == src


def test_skippable_frames():
    """Skippable frames (every magic 0x184D2A5?) before, between and
    after frames are skipped; one cut short raises."""
    skip = [bytes([0x50 + k, 0x2A, 0x4D, 0x18]) + n.to_bytes(4, "little")
            + bytes(i % 256 for i in range(n))
            for k, n in ((0, 0), (7, 5), (15, 300))]
    a, b = source("text", 3000, 1), source("random", 200, 2)
    data = skip[0] + frame(a, 3, True, True) + skip[1] + \
        frame(b, 1, False, False) + skip[2]
    assert zstd.decompress(data).tobytes() == reference(data) == a + b
    for cut in (skip[2][:6], skip[2][:-1]):
        with pytest.raises(zstandard.ZstdError):
            reference(cut)
        with pytest.raises(ValueError, match="skippable"):
            zstd.decompress(cut)


CASES = {
    "text_checksum": (source("text", 9000, 3), 3, True, True),
    "slide_bare": (source("slide", 150 * KIB, 4), 1, False, False),
    "text_22_no_checksum": (source("text", 40 * KIB, 6), 22, True, False),
    "mixed_19": (source("random", 400, 7) + bytes(3000)
                 + source("text", 5000, 8), 19, False, True),
}


@pytest.mark.parametrize("case", list(CASES))
def test_cuts_and_edits_raise_as_zstandard(case):
    """Every cut (or 300 of a long frame) and 400 random edits of 1 to 3
    bytes: the decoder raises ValueError exactly where libzstd raises,
    and gives its bytes elsewhere."""
    src, level, fcs, ck = CASES[case]
    f = frame(src, level, fcs, ck)
    rng = np.random.default_rng(len(f))
    cuts = range(len(f)) if len(f) <= 3000 else \
        sorted(rng.choice(len(f), 300, replace=False))
    datas = [f[:k] for k in cuts]
    for _ in range(400):
        b = bytearray(f)
        for _ in range(rng.integers(1, 4)):
            b[rng.integers(0, len(b))] = rng.integers(0, 256)
        datas.append(bytes(b))
    raised = 0
    for d in datas:
        try:
            want = reference(d)
        except zstandard.ZstdError:
            want = None
        if want is None:
            raised += 1
            with pytest.raises(ValueError):
                zstd.decompress(d)
        else:
            assert zstd.decompress(d).tobytes() == want
    assert raised >= len(cuts)          # a cut frame always raises


def test_dictionary_and_sizes_raise():
    """A frame naming a dictionary raises by name (libzstd refuses it
    without that dictionary); a fixed output size other than the frame's
    raises; a frame whose window exceeds 128 MiB raises."""
    src = source("text", 4000, 9)
    f = bytearray(frame(src, 3, True, True))
    fhd = f[4]
    with_dict = bytes(f[:4]) + bytes([fhd | 1]) + bytes(f[5:6]) + b"\x2a" \
        + bytes(f[6:])
    with pytest.raises(zstandard.ZstdError):
        reference(with_dict)
    with pytest.raises(ValueError, match="dictionary"):
        zstd.decompress(with_dict)
    for n in (len(src) - 1, len(src) + 1):
        with pytest.raises(ValueError):
            zstd.decompress(bytes(f), n)
    big = frame(src, 3, False, True)
    wd = bytearray(big)
    assert not wd[4] & 0x20            # the frame has a window descriptor
    wd[5] = (28 - 10) << 3             # 256 MiB
    with pytest.raises(zstandard.ZstdError):
        reference(bytes(wd))
    with pytest.raises(ValueError, match="window"):
        zstd.decompress(bytes(wd))
    assert zstd.decompress(b"").tobytes() == b""


def test_threads_decode_in_parallel():
    """ctypes releases the GIL: frames decoded on several threads at once
    give the same bytes."""
    srcs = [source("slide", 300 * KIB + k, k) for k in range(6)]
    frames = [frame(s, 3, k % 2 == 0, True) for k, s in enumerate(srcs)]
    out = [None] * 12

    def work(i):
        out[i] = zstd.decompress(frames[i % 6]).tobytes()

    threads = [threading.Thread(target=work, args=(i,)) for i in range(12)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert out == [srcs[i % 6] for i in range(12)]
