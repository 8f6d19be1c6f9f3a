"""Tiled network runner (counterpart of ``classpose_tpu/runner/core.py``
``TileRunner``, ``run_net`` and ``chunk_plan``, and of
``classpose_tpu/runner/model.py`` ``resolve_precision``).

One image at a time: pad to at least bsize², cut the overlapping bsize²
crop grid (the TTA flip grid with ``augment``), run the network over the
crops in chunks, undo the TTA flips, blend the overlaps with the taper
window and crop the padding. The class channels are split from the seg
channels as the reference's ``_forward`` does.
"""

from __future__ import annotations

import logging

import numpy as np
import torch

from classpose_tpu_torch.ops.tiles import (
    average_tiles_separable,
    compute_tile_grid,
    get_pad_yx,
    make_tiles,
    unaugment_class_tiles,
    unaugment_tiles,
)

logger = logging.getLogger(__name__)

PRECISION_DTYPES = {"fp32": "float32", "bf16": "bfloat16", "fp16": "bfloat16"}


def chunk_plan(nt: int, batch_size: int) -> tuple[int, int, int]:
    """(nchunk, bs, pad_tiles) for running ``nt`` crops in chunks of at
    most ``batch_size``, with the per-chunk batch shrunk to the smallest
    value that keeps the chunk count (nt=25, batch_size=8 → 4 chunks of
    7). The port runs the last chunk short instead of padding it."""
    nchunk = int(np.ceil(nt / min(batch_size, nt)))
    bs = int(np.ceil(nt / nchunk))
    return nchunk, bs, nchunk * bs - nt


def resolve_precision(precision: str) -> str:
    """Precision flag → compute dtype name. fp16 maps to bf16, as in the
    JAX package, so both run the same arithmetic."""
    if precision not in PRECISION_DTYPES:
        raise ValueError(f"Unknown precision '{precision}'. Expected one of "
                         f"{sorted(PRECISION_DTYPES)}.")
    if precision == "fp16":
        logger.warning("fp16 runs as bf16")
    return PRECISION_DTYPES[precision]


class TileRunner:
    """Tiled forward of ``net`` (``x (B, C, b, b) → (y, style)``, run under
    ``no_grad``) for one image at a time; ``n_cell_classes`` sets the
    class/seg channel split."""

    def __init__(self, net, n_cell_classes: int, bsize: int = 256,
                 batch_size: int = 8, tile_overlap: float = 0.1,
                 augment: bool = False):
        self.net = net
        self.n_cell_classes = int(n_cell_classes or 1)
        self.bsize = bsize
        self.batch_size = batch_size
        self.tile_overlap = tile_overlap
        self.augment = augment

    @torch.no_grad()
    def __call__(self, img_chw: torch.Tensor) -> dict:
        """img (C, Ly, Lx) → dict(y=(3, Ly, Lx) f32, y_class=(ncls, Ly,
        Lx) f32 when ncls > 1, style=(256,) f32), on img's device."""
        _, Ly, Lx = img_chw.shape
        b = self.bsize
        ypad1, ypad2, xpad1, xpad2 = get_pad_yx(Ly, Lx, (b, b))
        grid = compute_tile_grid(Ly + ypad1 + ypad2, Lx + xpad1 + xpad2, b,
                                 self.tile_overlap, self.augment)
        nchunk, bs, _ = chunk_plan(grid.ntiles, self.batch_size)
        tiles = make_tiles(torch.nn.functional.pad(
            img_chw, (xpad1, xpad2, ypad1, ypad2)), grid)
        ys, styles = [], []
        for c in range(nchunk):
            y, style = self.net(tiles[c * bs:(c + 1) * bs])
            ys.append(y)
            styles.append(style.float())
        y = torch.cat(ys)
        ncls = self.n_cell_classes
        y_class, y_seg = (y[:, :ncls], y[:, ncls:]) if ncls > 1 else (None, y)
        if self.augment:
            y_seg = unaugment_tiles(y_seg, grid)
            if y_class is not None:
                y_class = unaugment_class_tiles(y_class, grid)
        crop = (slice(None), slice(ypad1, ypad1 + Ly),
                slice(xpad1, xpad1 + Lx))
        out = {"y": average_tiles_separable(y_seg, grid)[crop]}
        if y_class is not None:
            out["y_class"] = average_tiles_separable(y_class, grid)[crop]
        style = torch.cat(styles).sum(dim=0)
        norm = torch.sqrt(torch.sum(style ** 2))
        out["style"] = torch.where(norm > 0, style / norm, style)
        return out


def run_net(net, imgi: np.ndarray, n_cell_classes: int = 1,
            batch_size: int = 8, augment: bool = False,
            tile_overlap: float = 0.1, bsize: int = 256, device=None):
    """Run the network on a stack of images (reference core.py:75-231).
    ``imgi`` (nimg, Ly, Lx, nchan) float; ``device`` defaults to the
    network's. Returns ``(yf, y_classf, styles)`` as numpy: yf (nimg, Ly,
    Lx, 3), y_classf (nimg, Ly, Lx, ncls) or None, styles (nimg, 256)."""
    nimg, Ly, Lx, _ = imgi.shape
    if device is None:
        device = next(net.parameters()).device
    runner = TileRunner(net, n_cell_classes, bsize=bsize,
                        batch_size=batch_size, tile_overlap=tile_overlap,
                        augment=augment)
    yf = np.zeros((nimg, Ly, Lx, 3), np.float32)
    y_classf = (np.zeros((nimg, Ly, Lx, n_cell_classes), np.float32)
                if n_cell_classes and n_cell_classes > 1 else None)
    styles = np.zeros((nimg, 256), np.float32)
    for i in range(nimg):
        x = torch.from_numpy(np.ascontiguousarray(
            imgi[i].transpose(2, 0, 1), np.float32)).to(device)
        out = runner(x)
        yf[i] = out["y"].cpu().numpy().transpose(1, 2, 0)
        if y_classf is not None:
            y_classf[i] = out["y_class"].cpu().numpy().transpose(1, 2, 0)
        styles[i] = out["style"].cpu().numpy()
    return yf, y_classf, styles
