"""Slide readers (counterpart of ``classpose_tpu/io`` and the
``WSIReader`` facade of ``classpose_tpu/__init__.py``).

``WSI_READER`` selects the backend:

- ``tiff`` and the default ``openslide``:
  :class:`~classpose_tpu_torch.io.tiff_reader.TiffSlide`, the package's
  own TIFF/SVS reader. The JAX package takes OpenSlide when it can import
  it and this reader otherwise; this package never uses OpenSlide.
- ``array``: the in-memory
  :class:`~classpose_tpu_torch.io.array_reader.ArraySlide`, which also
  reads ``.npy`` paths.
- ``czi``/``czi-zeiss``: :class:`~classpose_tpu_torch.io.czi_reader.CZISlide`,
  the package's own Zeiss CZI reader (uncompressed, JpgFile, JpgXrFile
  (JPEG XR, on the package's own decoder), Zstd0 and Zstd1 subblocks;
  LZW, camera-specific compressions and multi-file CZIs raise,
  ``READERS_ITEM``).
"""

from __future__ import annotations

import os

from classpose_tpu_torch.io.array_reader import ArraySlide
from classpose_tpu_torch.io.czi_reader import CZISlide
from classpose_tpu_torch.io.tiff_reader import TiffSlide

READERS_ITEM = 'ROADMAP.md queue 1, "slide readers"'

__all__ = ["ArraySlide", "CZISlide", "TiffSlide", "WSIReader", "get_wsi_reader"]


def get_wsi_reader():
    """The slide reader class that ``WSI_READER`` selects."""
    reader = os.getenv("WSI_READER", "openslide").lower()
    if reader == "array":
        return ArraySlide
    if reader in ("czi", "czi-zeiss"):
        return CZISlide
    return TiffSlide


class _WSIReaderMeta(type):
    def __call__(cls, *args, **kwargs):
        return get_wsi_reader()(*args, **kwargs)


class WSIReader(metaclass=_WSIReaderMeta):
    """Facade: ``WSIReader(path)`` instantiates the selected backend."""
