"""ClassposeModel: batched tile segmentation (counterpart of
``classpose_tpu/runner/model.py`` ``ClassposeModel.eval_batch``, the
library entry point the WSI pipeline calls).

One batch of same-sized tiles runs on the device in this order:
normalize (exact uint8 percentiles) → pad → 5×5 grid of bsize² crops →
ClassTransformer forward → TTA unaugment → taper blend → Euler flow
following → histogram/seeds/basins/label lookup → max-size filter and
flow-error QC. The host then densifies the labels, fills holes, drops
small instances and takes each instance's majority class.
"""

from __future__ import annotations

import logging

import numpy as np
import torch

from classpose_tpu_torch.dynamics.masks import (
    densify_labels,
    fill_holes_and_remove_small_masks,
    follow_flows_batched,
    get_masks_from_positions_batched,
    qc_filter_masks,
)
from classpose_tpu_torch.nn.convert import (
    load_into,
    load_npz_checkpoint,
    params_from_jax,
)
from classpose_tpu_torch.nn.vit_sam import (
    JAX_ONLY_FIELDS,
    ClassTransformer,
    ClassTransformerConfig,
)
from classpose_tpu_torch.ops.normalize import normalize_img
from classpose_tpu_torch.ops.tiles import (
    average_tiles_separable,
    compute_tile_grid,
    get_pad_yx,
    make_tiles,
    unaugment_class_tiles,
    unaugment_tiles,
)
from classpose_tpu_torch.runner.core import chunk_plan, resolve_precision

logger = logging.getLogger(__name__)

FAST_QC_ITEM = 'ROADMAP.md queue 1, "--fast_qc"'


def compute_class_masks_from_pixels(masks: np.ndarray, pixel_cls: np.ndarray,
                                    n_classes: int) -> np.ndarray:
    """Per-instance majority vote over a pixelwise class-argmax map: one
    bincount over the combined (instance, class) index."""
    inst = masks.ravel()
    cls = pixel_cls.ravel().astype(np.int64)
    max_inst = int(inst.max())
    valid = inst > 0
    idx = inst[valid].astype(np.int64) * n_classes + cls[valid]
    counts = np.bincount(idx, minlength=(max_inst + 1) * n_classes)
    major = counts.reshape(max_inst + 1, n_classes).argmax(axis=1)
    major[0] = 0
    return major[masks].astype(np.int32)


class ClassposeModel:
    """Network + tiled inference + mask dynamics.

    Weights: a native ``.npz`` checkpoint (the JAX package's format),
    ``params`` as a port ``state_dict`` or a flax parameter tree, or
    neither for PyTorch's default random init drawn from ``seed``. ``cfg``
    defaults to ViT-L with ``nclasses`` classes and the class head
    ``feature_transformation_structure`` (a UNet ladder, or None for a
    1×1 conv); a checkpoint's metadata replaces it. Runs on ``device``
    (CUDA unless the caller asks for the CPU)."""

    def __init__(self, pretrained_model: str | None = None,
                 nclasses: int | None = None,
                 feature_transformation_structure=None,
                 precision: str = "fp32",
                 cfg: ClassTransformerConfig | None = None,
                 params=None, device: str | torch.device = "cuda",
                 seed: int = 0):
        self.precision = precision
        dtype = resolve_precision(precision)
        self.device = torch.device(device)
        if cfg is None:
            fts = feature_transformation_structure
            cfg = ClassTransformerConfig(
                n_cell_classes=nclasses or 1,
                feature_transformation_structure=tuple(fts) if fts else None)
        sd = None
        if pretrained_model is not None:
            logger.info("loading model %s", pretrained_model)
            flat, meta = load_npz_checkpoint(str(pretrained_model))
            sd = params_from_jax(flat)
            if meta is not None:
                meta = {k: v for k, v in meta.items()
                        if k not in JAX_ONLY_FIELDS}
                fts = meta.get("feature_transformation_structure")
                meta["feature_transformation_structure"] = (
                    tuple(fts) if fts else None)
                cfg = ClassTransformerConfig(**meta)
        elif params is not None:
            sd = (params_from_jax(params)
                  if any(isinstance(v, dict) for v in params.values())
                  else params)
        self.cfg = ClassTransformerConfig(**{**cfg.__dict__, "dtype": dtype})
        self.nclasses = self.cfg.n_cell_classes
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            self.net = ClassTransformer(self.cfg)
        if sd is not None:
            load_into(self.net, sd)
        else:
            logger.warning("no weights given: random init from seed %d", seed)
        self.net.to(self.device).eval()

    @torch.no_grad()
    def _device_program(self, x, batch_size, augment, niter, flow_threshold,
                        cellprob_threshold, max_size_fraction):
        """uint8 or f32 tiles (B, S, S, 3) on the device → (raw labels
        (B, S, S) int32, class argmax (B, S, S) int8 or None)."""
        B, S = x.shape[0], x.shape[1]
        bsize = self.cfg.bsize
        ncls = self.nclasses
        ypad1, ypad2, xpad1, xpad2 = get_pad_yx(S, S, (bsize, bsize))
        grid = compute_tile_grid(S + ypad1 + ypad2, S + xpad1 + xpad2,
                                 bsize, 0.1, augment)
        nchunk, bs, _ = chunk_plan(grid.ntiles, batch_size)
        integral = x.dtype == torch.uint8

        ys = []
        for b in range(B):
            img = normalize_img(x[b].to(torch.float32), axis=-1,
                                integral_stats=integral)
            chw = torch.nn.functional.pad(
                img.permute(2, 0, 1), (xpad1, xpad2, ypad1, ypad2))
            t = make_tiles(chw, grid)
            ys.append(torch.cat([
                self.net(t[c * bs:(c + 1) * bs])[0] for c in range(nchunk)
            ]))
        y = torch.stack(ys)  # (B, nt, ncls+3, b, b), compute dtype

        crop = (Ellipsis, slice(ypad1, ypad1 + S), slice(xpad1, xpad1 + S))
        class_pix = None
        if ncls > 1:
            y_class, y_seg = y[:, :, :ncls], y[:, :, ncls:]
            if augment:
                y_class = unaugment_class_tiles(y_class, grid)
            ycf = average_tiles_separable(y_class, grid)[crop]
            class_pix = torch.argmax(ycf, dim=1).to(torch.int8)
        else:
            y_seg = y
        if augment:
            y_seg = unaugment_tiles(y_seg, grid)
        yf = average_tiles_separable(y_seg, grid)[crop]
        dP = yf[:, :2].contiguous()
        iscell = yf[:, 2] > cellprob_threshold

        p = follow_flows_batched(dP, iscell, niter=niter)
        raw = get_masks_from_positions_batched(p, iscell)
        raw = qc_filter_masks(raw, dP, flow_threshold=flow_threshold,
                              max_size_fraction=max_size_fraction)
        return raw, class_pix

    def eval_batch(self, tiles, batch_size: int = 8, augment: bool = False,
                   niter: int = 200, flow_threshold: float = 0.4,
                   cellprob_threshold: float = 0.0, min_size: int = 15,
                   max_size_fraction: float = 0.4, qc_downsample: int = 1,
                   percentile_subsample: int = 1
                   ) -> list[tuple[np.ndarray, np.ndarray]]:
        """Segment (B, S, S, 3) tiles (uint8, or float at model MPP; a
        numpy array or a tensor, which may already be on the device).
        Returns one (masks, class_masks) pair of int32 arrays per tile.

        ``qc_downsample`` and ``percentile_subsample`` are the JAX
        signature's ``--fast_qc`` approximations; only 1 (full fidelity)
        is ported."""
        if qc_downsample != 1 or percentile_subsample != 1:
            raise NotImplementedError(
                f"qc_downsample={qc_downsample}, percentile_subsample="
                f"{percentile_subsample}: the --fast_qc approximations wait "
                f"for {FAST_QC_ITEM}")
        x = torch.as_tensor(np.asarray(tiles) if not isinstance(
            tiles, torch.Tensor) else tiles)
        if x.dtype != torch.uint8:
            x = x.to(torch.float32)
        x = x.to(self.device)
        raw, class_pix = self._device_program(
            x, batch_size, augment, niter, flow_threshold,
            cellprob_threshold, max_size_fraction)
        raw = raw.cpu().numpy()
        class_pix = None if class_pix is None else class_pix.cpu().numpy()

        out = []
        for i in range(raw.shape[0]):
            masks = densify_labels(raw[i])
            if masks.max():
                masks = fill_holes_and_remove_small_masks(masks, min_size)
            if self.nclasses > 1 and masks.max():
                cm = compute_class_masks_from_pixels(masks, class_pix[i],
                                                     self.nclasses)
            else:
                cm = np.zeros_like(masks)
            out.append((masks.astype(np.int32), cm))
        return out
