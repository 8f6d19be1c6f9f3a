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
- ``czi``/``czi-zeiss`` raise: the CZI reader needs pylibCZIrw's JPEG-XR
  decoder.
"""

from __future__ import annotations

import os

from classpose_tpu_torch.io.array_reader import ArraySlide
from classpose_tpu_torch.io.tiff_reader import TiffSlide

READERS_ITEM = 'ROADMAP.md queue 1, "slide readers"'

__all__ = ["ArraySlide", "TiffSlide", "WSIReader", "get_wsi_reader"]


def get_wsi_reader():
    """The slide reader class that ``WSI_READER`` selects."""
    reader = os.getenv("WSI_READER", "openslide").lower()
    if reader == "array":
        return ArraySlide
    if reader in ("czi", "czi-zeiss"):
        raise NotImplementedError(
            f"WSI_READER={reader}: the CZI reader needs pylibCZIrw (a "
            f"JPEG-XR decoder), which this package does not have; "
            f"{READERS_ITEM} lists what still raises")
    return TiffSlide


class _WSIReaderMeta(type):
    def __call__(cls, *args, **kwargs):
        return get_wsi_reader()(*args, **kwargs)


class WSIReader(metaclass=_WSIReaderMeta):
    """Facade: ``WSIReader(path)`` instantiates the selected backend."""
