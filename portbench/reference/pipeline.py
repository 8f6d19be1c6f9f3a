"""The reference's two routes from pixels to masks: a slide tile as the
WSI pipeline's batched device program segments it, and an image as the
per-image API does. Plain float32 PyTorch (``net.forward`` in ``mode``)
and numpy; nothing of the program."""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference import dynamics, net, tiles
from portbench.reference.normalize import normalize99


def _net_field(sd, m, img_hwc: torch.Tensor, mode: str, block: int):
    """Normalized (H, W, 3) image → blended (ncls + 3, H, W) float32."""
    H, W = img_hwc.shape[:2]
    b = m["bsize"]
    y1, y2, x1, x2 = tiles.get_pad_yx(H, W, (b, b))
    chw = torch.nn.functional.pad(img_hwc.permute(2, 0, 1), (x1, x2, y1, y2))
    grid = tiles.compute_tile_grid(H + y1 + y2, W + x1 + x2, b)
    crops = tiles.make_tiles(chw, grid)
    y = net.forward_blocks(sd, m, crops, mode, block)
    return tiles.average_tiles(y, grid)[:, y1:y1 + H, x1:x1 + W]


def _split(field, ncls):
    if ncls > 1:
        return field[:ncls], field[ncls:]
    return None, field


def segment_tile(sd, m, tile_u8: np.ndarray, mode: str, device,
                 block: int = 5, niter: int = 200, flow_threshold=0.4,
                 cellprob_threshold=0.0, min_size=15,
                 max_size_fraction=0.4) -> dict:
    """One uint8 (S, S, 3) slide tile at model MPP → dict of numpy arrays:
    ``dP`` (2, S, S), ``masks`` and ``class_masks`` (S, S) int32."""
    ncls = m["n_cell_classes"]
    img = normalize99(torch.as_tensor(tile_u8, device=device))
    cls, seg = _split(_net_field(sd, m, img, mode, block), ncls)
    dP = seg[:2].contiguous()
    iscell = seg[2] > cellprob_threshold
    p = dynamics.follow_flows(dP[None], iscell[None], niter)
    raw = dynamics.masks_from_positions(p, iscell[None])
    raw = dynamics.qc_filter(raw, dP[None], flow_threshold,
                             max_size_fraction)[0]
    masks = dynamics.densify(raw.cpu().numpy())
    if masks.max():
        masks = dynamics.fill_holes_and_remove_small(masks, min_size)
    class_masks = (dynamics.class_vote(masks, cls.argmax(0).cpu().numpy(),
                                       ncls)
                   if ncls > 1 else np.zeros_like(masks))
    return dict(dP=dP.cpu().numpy(), masks=masks.astype(np.int32),
                class_masks=class_masks)


def segment_image(sd, m, image: np.ndarray, mode: str, device,
                  block: int = 5, niter: int = 200, flow_threshold=0.4,
                  cellprob_threshold=0.0, min_size=15,
                  max_size_fraction=0.4) -> dict:
    """One float (H, W, 3) image → dict of numpy arrays: ``dP`` (2, H,
    W), ``cellprob`` (H, W), ``y_class`` (ncls, H, W), ``masks`` and
    ``class_masks`` (H, W) int32."""
    ncls = m["n_cell_classes"]
    img = normalize99(torch.as_tensor(np.asarray(image, np.float32),
                                      device=device))
    cls, seg = _split(_net_field(sd, m, img, mode, block), ncls)
    dP, cellprob = seg[:2].contiguous(), seg[2].contiguous()
    masks = dynamics.compute_masks(
        dP, cellprob, niter=niter, cellprob_threshold=cellprob_threshold,
        flow_threshold=flow_threshold, min_size=min_size,
        max_size_fraction=max_size_fraction)
    y_class = (cls.cpu().numpy() if ncls > 1
               else np.zeros((1,) + tuple(cellprob.shape), np.float32))
    class_masks = (dynamics.class_vote(masks, y_class.argmax(0), ncls)
                   if ncls > 1 and masks.max() else np.zeros_like(masks))
    return dict(dP=dP.cpu().numpy(), cellprob=cellprob.cpu().numpy(),
                y_class=y_class, masks=masks.astype(np.int32),
                class_masks=class_masks)
