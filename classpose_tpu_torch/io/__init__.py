"""Slide readers (counterpart of ``classpose_tpu/io`` and the
``WSIReader`` facade of ``classpose_tpu/__init__.py``).

``WSI_READER`` selects the backend. ``array`` (the in-memory
:class:`~classpose_tpu_torch.io.array_reader.ArraySlide`, which also reads
``.npy`` paths) is the one this package has. The TIFF/SVS, CZI and
OpenSlide readers (``tiff``, ``czi``/``czi-zeiss`` and the default
``openslide``) need JPEG and JPEG-XR decoders and raise.
"""

from __future__ import annotations

import os

READERS_ITEM = 'ROADMAP.md queue 1, "slide readers"'


def get_wsi_reader():
    """The slide reader class that ``WSI_READER`` selects."""
    reader = os.getenv("WSI_READER", "openslide").lower()
    if reader == "array":
        from classpose_tpu_torch.io.array_reader import ArraySlide

        return ArraySlide
    raise NotImplementedError(
        f"WSI_READER={reader}: this package reads slides with "
        f"WSI_READER=array only; the TIFF, CZI and OpenSlide readers wait "
        f"for {READERS_ITEM}")


class _WSIReaderMeta(type):
    def __call__(cls, *args, **kwargs):
        return get_wsi_reader()(*args, **kwargs)


class WSIReader(metaclass=_WSIReaderMeta):
    """Facade: ``WSIReader(path)`` instantiates the selected backend."""
