"""ClassposeModel: the per-image API and batched tile segmentation
(counterpart of ``classpose_tpu/runner/model.py``).

``eval_batch`` (the entry point the WSI pipeline calls) runs one batch of
same-sized tiles on the device in this order: normalize (exact uint8
percentiles) → pad → 5×5 grid of bsize² crops → ClassTransformer forward
→ TTA unaugment → taper blend → Euler flow following →
histogram/seeds/basins/label lookup → max-size filter and flow-error QC.
The host then densifies the labels, fills holes, drops small instances
and takes each instance's majority class. With ``qc_downsample > 1``
(``--fast_qc``) the QC runs after the host's labels instead, on every
d-th pixel, in one batched diffusion.

``eval`` (the reference's per-image API, which ``classpose-evaluate``
calls) segments one image, a list, or a 3D stack: convert → optional
``diameter`` rescale → normalize (sorted percentiles, optionally tiled)
→ ``TileRunner`` → optional resample → ``compute_masks`` (the flow QC
recomputed per image by ``masks_to_flows``) → class vote. Resizes follow
``jax.image.resize`` (``ops/resize.py``).
"""

from __future__ import annotations

import copy
import logging
import time

import numpy as np
import torch

from classpose_tpu_torch.dynamics.flows import (
    _bucket,
    _diffuse_dyn,
    _max_instance_extent,
    grad_from_T,
    instance_center_map,
)
from classpose_tpu_torch.dynamics.masks import (
    compute_masks as _dyn_compute_masks,
    densify_labels,
    fill_holes_and_remove_small_masks,
    follow_flows_batched,
    get_masks_from_positions_batched,
    qc_filter_masks,
)
from classpose_tpu_torch.nn.convert import (
    load_checkpoint,
    load_into,
    params_from_jax,
)
from classpose_tpu_torch.nn.vit_sam import (
    ClassTransformer,
    ClassTransformerConfig,
)
from classpose_tpu_torch.ops.normalize import NORMALIZE_DEFAULT, normalize_img
from classpose_tpu_torch.parallel.mesh import replicate
from classpose_tpu_torch.ops.resize import resize
from classpose_tpu_torch.ops.tiles import (
    average_tiles_separable,
    compute_tile_grid,
    get_pad_yx,
    make_tiles,
    unaugment_class_tiles,
    unaugment_tiles,
)
from classpose_tpu_torch.runner.core import (
    TileRunner,
    chunk_plan,
    resolve_precision,
    run_net,
)
from classpose_tpu_torch.runner.run3d import compute_masks_3d, run_3D, stitch3D

logger = logging.getLogger(__name__)


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


def compute_class_masks(masks: np.ndarray, y_class: np.ndarray
                        ) -> tuple[np.ndarray, np.ndarray]:
    """Per-instance majority class vote (reference models.py:191-230):
    pixelwise argmax of the class logits, then the vote."""
    squeezed = np.squeeze(y_class)
    pixel_cls = squeezed.argmax(axis=0)
    class_masks = compute_class_masks_from_pixels(masks, pixel_cls,
                                                  int(squeezed.shape[0]))
    return class_masks, np.unique(masks)


def convert_image(x: np.ndarray, channel_axis: int | None = None
                  ) -> np.ndarray:
    """An image array → (Ly, Lx, 3) float32 (cellpose ``convert_image`` at
    models.py:615-625): the channel axis is the smallest axis ≤ 5 unless
    given; grayscale is replicated, 2 channels zero-padded, more than 3
    cut to the first 3."""
    x = np.asarray(x)
    if x.ndim == 2:
        x = x[:, :, None]
    elif x.ndim == 3:
        if channel_axis is None:
            sizes = x.shape
            cand = [i for i, s in enumerate(sizes) if s <= 5]
            channel_axis = (min(cand, key=lambda i: sizes[i]) if cand
                            else int(np.argmin(sizes)))
        x = np.moveaxis(x, channel_axis, -1)
    else:
        raise ValueError(f"expected 2D/3D image, got shape {x.shape}")
    c = x.shape[-1]
    if c == 1:
        x = np.repeat(x, 3, axis=-1)
    elif c == 2:
        x = np.concatenate([x, np.zeros_like(x[..., :1])], axis=-1)
    elif c > 3:
        x = x[..., :3]
    return np.ascontiguousarray(x, np.float32)


def convert_image_stack(x: np.ndarray) -> np.ndarray:
    """(Lz, ..., C?) stack → (Lz, Ly, Lx, 3) float32."""
    return np.stack([convert_image(p) for p in x])


def dx_to_circ(dP: np.ndarray) -> np.ndarray:
    """Flow field → HSV-style RGB uint8 picture (cellpose
    ``plot.dx_to_circ``, in the eval return tuple, models.py:824)."""
    dP = np.asarray(dP, np.float32)
    mag = np.clip(np.sqrt(np.sum(dP ** 2, axis=0)), 0, 1e6)
    mag = mag / (mag.max() + 1e-12)
    ang = (np.arctan2(dP[0], dP[1]) + np.pi) / (2 * np.pi)
    H, W = mag.shape
    h6 = ang * 6.0
    i = np.floor(h6).astype(int) % 6
    f = h6 - np.floor(h6)
    v = mag
    p = np.zeros_like(v)
    q = v * (1 - f)
    t = v * f
    rgb = np.zeros((H, W, 3), np.float32)
    conds = [(v, t, p), (q, v, p), (p, v, t), (p, q, v), (t, p, v),
             (v, p, q)]
    for k, (r, g, b) in enumerate(conds):
        m = i == k
        rgb[m, 0], rgb[m, 1], rgb[m, 2] = r[m], g[m], b[m]
    return (rgb * 255).astype(np.uint8)


def _resize_chw(arr: np.ndarray, Ly: int, Lx: int, nearest: bool = False
                ) -> np.ndarray:
    """Resize (C, H, W) or (H, W) numpy arrays over the last two axes with
    ``jax.image.resize`` semantics; no-op when the shape matches."""
    arr = np.asarray(arr)
    if arr.shape[-2:] == (Ly, Lx):
        return arr
    out = resize(torch.from_numpy(np.ascontiguousarray(arr)),
                 arr.shape[:-2] + (Ly, Lx),
                 "nearest" if nearest else "linear")
    return out.numpy()


def _norm_params(normalize, invert: bool) -> dict:
    params = dict(NORMALIZE_DEFAULT)
    if isinstance(normalize, dict):
        params.update(normalize)
    elif isinstance(normalize, bool):
        params["normalize"] = normalize
        params["invert"] = invert
    else:
        raise ValueError("normalize parameter must be a bool or a dict")
    return params


class ClassposeModel:
    """Network + tiled inference + mask dynamics.

    Weights: a checkpoint file, native ``.npz`` (the JAX package's format)
    or published ``.pt`` (loaded on the CPU, then moved to the device),
    ``params`` as a port ``state_dict`` or a flax parameter tree, or
    neither for PyTorch's default random init drawn from ``seed``. ``cfg``
    defaults to ViT-L with ``nclasses`` classes and the class head
    ``feature_transformation_structure`` (a UNet ladder, or None for a
    1×1 conv); an ``.npz``'s metadata, or the config a ``.pt``'s tensor
    shapes give (``infer_config_from_state_dict``), replaces it. Runs on
    ``device`` (CUDA unless the caller asks for the CPU)."""

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
            sd, ck_cfg = load_checkpoint(str(pretrained_model))
            cfg = cfg if ck_cfg is None else ck_cfg
        elif params is not None:
            sd = (params_from_jax(params)
                  if any(isinstance(v, dict) for v in params.values())
                  else params)
        self.cfg = ClassTransformerConfig(**{**cfg.__dict__, "dtype": dtype})
        self.nclasses = self.cfg.n_cell_classes
        self.timing: list[float] = []
        if sd is not None:
            # every tensor comes from sd: allocate on the device, no init
            with torch.device("meta"):
                self.net = ClassTransformer(self.cfg)
            self.net.to_empty(device=self.device)
            load_into(self.net, sd)
        else:
            logger.warning("no weights given: random init from seed %d", seed)
            with torch.random.fork_rng(devices=[]):
                torch.manual_seed(seed)
                self.net = ClassTransformer(self.cfg)
        self.net.to(self.device).eval()

    def replicate(self, devices) -> list["ClassposeModel"]:
        """One model per entry of ``devices`` (the counterpart of the JAX
        package's ``shard_over``): this model for the first entry when it
        lies there, else a copy whose ``net`` is copied once onto that
        device in the same dtype. The LayerNorm switch is read from the
        environment at every call, so every replica follows it. Replicas
        share no mutable state (each has its own net and timings); the
        launch counts they add to are under ``_build``'s lock."""
        out = []
        for dev, net in zip(devices, replicate(self.net, devices)):
            if net is self.net:
                out.append(self)
                continue
            r = copy.copy(self)
            r.net, r.device, r.timing = net, torch.device(dev), []
            out.append(r)
        return out

    @torch.no_grad()
    def _device_program(self, x, batch_size, augment, niter, flow_threshold,
                        cellprob_threshold, max_size_fraction,
                        percentile_subsample=1, qc=True):
        """uint8 or f32 tiles (B, S, S, 3) on the device → (raw labels
        (B, S, S) int32, class argmax (B, S, S) int8 or None, flows dP
        (B, 2, S, S)). With ``qc`` the labels have been through the
        max-size filter and the flow-error QC; without, they are the
        seeds' raw labels."""
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
                                percentile_subsample=percentile_subsample,
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
        if qc:
            raw = qc_filter_masks(raw, dP, flow_threshold=flow_threshold,
                                  max_size_fraction=max_size_fraction)
        return raw, class_pix, dP

    def eval_batch(self, tiles, batch_size: int = 8, augment: bool = False,
                   niter: int = 200, flow_threshold: float = 0.4,
                   cellprob_threshold: float = 0.0, min_size: int = 15,
                   max_size_fraction: float = 0.4, qc_downsample: int = 1,
                   percentile_subsample: int = 1
                   ) -> list[tuple[np.ndarray, np.ndarray]]:
        """Segment (B, S, S, 3) tiles (uint8, or float at model MPP; a
        numpy array or a tensor, which may already be on the device).
        Returns one (masks, class_masks) pair of int32 arrays per tile.

        ``qc_downsample`` and ``percentile_subsample`` are ``--fast_qc``'s
        approximations. ``percentile_subsample = s > 1`` takes a float
        tile's percentiles from every s-th pixel (uint8 tiles take exact
        histogram percentiles either way). ``qc_downsample = d > 1`` moves
        the QC off the device program: the host densifies each tile's
        labels and drops instances over ``max_size_fraction``, then one
        batched diffusion recomputes the flows of every tile's labels at
        every d-th pixel, with one horizon for the batch, and the host
        drops the instances whose mean squared error against ``dP/5``
        there exceeds ``flow_threshold``."""
        x = torch.as_tensor(np.asarray(tiles) if not isinstance(
            tiles, torch.Tensor) else tiles)
        if x.dtype != torch.uint8:
            x = x.to(torch.float32)
        x = x.to(self.device)
        fast = qc_downsample > 1
        raw, class_pix, dP = self._device_program(
            x, batch_size, augment, niter, flow_threshold,
            cellprob_threshold, max_size_fraction, percentile_subsample,
            qc=not fast)
        raw = raw.cpu().numpy()
        class_pix = None if class_pix is None else class_pix.cpu().numpy()
        masks_list = [densify_labels(m) for m in raw]
        if fast:
            self._fast_qc(masks_list, dP, qc_downsample, flow_threshold,
                          max_size_fraction)

        out = []
        for i, masks in enumerate(masks_list):
            if masks.max():
                masks = fill_holes_and_remove_small_masks(masks, min_size)
            if self.nclasses > 1 and masks.max():
                cm = compute_class_masks_from_pixels(masks, class_pix[i],
                                                     self.nclasses)
            else:
                cm = np.zeros_like(masks)
            out.append((masks.astype(np.int32), cm))
        return out

    def _fast_qc(self, masks_list: list[np.ndarray], dP: torch.Tensor,
                 d: int, flow_threshold: float,
                 max_size_fraction: float) -> None:
        """``eval_batch``'s host QC at ``qc_downsample = d`` (the JAX
        package's unfused path): zeroes, in place, the instances of each
        tile's dense labels that are too large or whose flows disagree."""
        S = masks_list[0].shape[0]
        for masks in masks_list:
            nmax = int(masks.max())
            if nmax:
                too_big = np.bincount(masks.ravel(), minlength=nmax + 1) \
                    > max_size_fraction * S * S
                too_big[0] = False
                if too_big.any():
                    masks[too_big[masks]] = 0
        if not flow_threshold or flow_threshold <= 0:
            return
        ms = np.stack([m[::d, ::d] for m in masks_list])
        niter_qc = _bucket(min(max(
            2 * max(_max_instance_extent(m) for m in ms), 40), 400), 40)
        cms = np.stack([instance_center_map(m) for m in ms])
        ms_dev = torch.from_numpy(ms.astype(np.int32)).to(self.device)
        T = _diffuse_dyn(ms_dev, torch.from_numpy(cms).to(self.device),
                         niter_qc)
        mu = grad_from_T(ms_dev, T).cpu().numpy()
        dP_ds = dP[:, :, ::d, ::d].float().cpu().numpy()
        for i, masks in enumerate(masks_list):
            nmax = int(masks.max())
            if nmax == 0:
                continue
            err_map = ((mu[i] - dP_ds[i] / 5.0) ** 2).sum(axis=0)
            ids = ms[i].ravel().astype(np.int64)
            fg = ids > 0
            n = np.bincount(ids[fg], minlength=nmax + 1)
            ssum = np.bincount(ids[fg], weights=err_map.ravel()[fg],
                               minlength=nmax + 1)
            bad = (ssum / np.maximum(n, 1)).astype(np.float32) \
                > flow_threshold
            bad[0] = False
            if bad.any():
                masks[bad[masks]] = 0

    # ------------------------------------------------------ per-image API

    @torch.no_grad()
    def eval(self, x, batch_size: int = 8, resample: bool = True,
             channel_axis: int | None = None, normalize=True,
             invert: bool = False, diameter: float | None = None,
             flow_threshold: float = 0.4, cellprob_threshold: float = 0.0,
             min_size: int = 15, max_size_fraction: float = 0.4,
             niter: int | None = None, augment: bool = False,
             tile_overlap: float = 0.1, bsize: int | None = None,
             compute_masks: bool = True, qc_downsample: int = 1,
             do_3D: bool = False, stitch_threshold: float = 0.0,
             anisotropy: float | None = None, **_unused):
        """Segment an image, a list of images, or a 3D stack (reference
        models.py:478-827). Returns ``(masks, flows, class_masks,
        styles)`` with flows = (dx_to_circ(dP), dP, cellprob, y_class,
        input shape), numpy arrays.

        3D: ``do_3D`` runs the net over the three orthogonal plane stacks
        and recovers instances with 3D dynamics; ``stitch_threshold > 0``
        segments each plane in 2D and links instances across planes by
        IoU."""
        if bsize is None:
            bsize = self.cfg.bsize
        if do_3D or stitch_threshold > 0:
            return self._eval_3d(
                x, batch_size=batch_size, normalize=normalize, invert=invert,
                flow_threshold=flow_threshold,
                cellprob_threshold=cellprob_threshold, min_size=min_size,
                niter=niter, augment=augment, tile_overlap=tile_overlap,
                bsize=bsize, do_3D=do_3D, stitch_threshold=stitch_threshold,
                anisotropy=anisotropy)
        kw = dict(batch_size=batch_size, resample=resample,
                  channel_axis=channel_axis, normalize=normalize,
                  invert=invert, diameter=diameter,
                  flow_threshold=flow_threshold,
                  cellprob_threshold=cellprob_threshold, min_size=min_size,
                  max_size_fraction=max_size_fraction, niter=niter,
                  augment=augment, tile_overlap=tile_overlap, bsize=bsize,
                  compute_masks=compute_masks, qc_downsample=qc_downsample)
        if isinstance(x, list):
            self.timing = []
            results = ([], [], [], [])
            for xi in x:
                tic = time.time()
                for acc, v in zip(results, self.eval(xi, **kw)):
                    acc.append(v)
                self.timing.append(time.time() - tic)
            return results
        return self._eval_2d(x, **kw)

    def _eval_2d(self, x, batch_size, resample, channel_axis, normalize,
                 invert, diameter, flow_threshold, cellprob_threshold,
                 min_size, max_size_fraction, niter, augment, tile_overlap,
                 bsize, compute_masks, qc_downsample):
        dev = self.device
        img = torch.from_numpy(convert_image(x, channel_axis)).to(dev)
        Ly0, Lx0 = img.shape[:2]
        image_scaling = None
        if diameter is not None and diameter > 0:
            image_scaling = 30.0 / diameter
            img = resize(img, (int(Ly0 * image_scaling),
                               int(Lx0 * image_scaling), img.shape[-1]))
        norm = _norm_params(normalize, invert)
        if norm["normalize"]:
            img = normalize_img(
                img, axis=-1, lowhigh=norm["lowhigh"],
                percentile=norm["percentile"], invert=norm["invert"],
                sharpen_radius=norm["sharpen_radius"],
                smooth_radius=norm["smooth_radius"],
                tile_norm_blocksize=norm["tile_norm_blocksize"],
                percentile_subsample=norm["percentile_subsample"])
        out = TileRunner(self.net, self.nclasses, bsize=bsize,
                         batch_size=batch_size, tile_overlap=tile_overlap,
                         augment=augment)(img.permute(2, 0, 1).contiguous())
        y = out["y"]
        dP, cellprob = y[:2], y[2]
        y_class = out["y_class"] if self.nclasses > 1 else torch.zeros(
            (1,) + tuple(cellprob.shape), device=dev)
        styles = out["style"].cpu().numpy()
        if resample and tuple(dP.shape[1:]) != (Ly0, Lx0):
            dP = resize(dP, (2, Ly0, Lx0))
            cellprob = resize(cellprob, (Ly0, Lx0))
            y_class = resize(y_class, (y_class.shape[0], Ly0, Lx0))
        dP_np, cellprob_np = dP.cpu().numpy(), cellprob.cpu().numpy()
        y_class_np = y_class.cpu().numpy()

        if compute_masks:
            masks = _dyn_compute_masks(
                dP, cellprob, niter=200 if not niter else niter,
                cellprob_threshold=cellprob_threshold,
                flow_threshold=flow_threshold, min_size=min_size,
                max_size_fraction=max_size_fraction,
                qc_downsample=qc_downsample, device=dev)
            # the vote at the resolution the masks were computed at
            if self.nclasses > 1:
                class_masks, _ = compute_class_masks(masks, y_class_np)
            else:
                class_masks = np.zeros_like(masks)
            if not resample and masks.shape != (Ly0, Lx0):
                masks = _resize_chw(masks.astype(np.int32), Ly0, Lx0, True)
                class_masks = _resize_chw(class_masks.astype(np.int32), Ly0,
                                          Lx0, True)
        else:
            masks = np.zeros(0)
            class_masks = np.zeros(0)

        if image_scaling is not None and compute_masks:
            masks = _resize_chw(masks.astype(np.int32), Ly0, Lx0, True)
            class_masks = _resize_chw(class_masks.astype(np.int32), Ly0, Lx0,
                                      True)
            dP_np = _resize_chw(dP_np, Ly0, Lx0)
            cellprob_np = _resize_chw(cellprob_np, Ly0, Lx0)
            y_class_np = _resize_chw(y_class_np, Ly0, Lx0)
        return (masks,
                (dx_to_circ(dP_np), dP_np, cellprob_np, y_class_np,
                 tuple(img.shape)),
                class_masks, styles)

    def _eval_3d(self, x, batch_size, normalize, invert, flow_threshold,
                 cellprob_threshold, min_size, niter, augment, tile_overlap,
                 bsize, do_3D, stitch_threshold, anisotropy):
        """3D segmentation: flows summed over the three plane orders and 3D
        dynamics (``do_3D``), or per-plane 2D masks linked by IoU
        (``stitch_threshold``)."""
        x = np.asarray(x, np.float32)
        if x.ndim == 3:
            x = np.repeat(x[..., None], 3, axis=-1)
        if x.shape[-1] != 3:
            x = convert_image_stack(x)
        Lz, Ly, Lx = x.shape[:3]
        xt = torch.from_numpy(np.ascontiguousarray(x)).to(self.device)
        if anisotropy and anisotropy != 1.0 and do_3D:
            xt = resize(xt, (int(Lz * anisotropy), Ly, Lx, 3))
            Lz = xt.shape[0]
        norm = _norm_params(bool(normalize) if not isinstance(
            normalize, dict) else normalize, invert)
        if norm["normalize"]:
            # norm3D: statistics over the whole stack
            xt = normalize_img(xt, axis=-1, lowhigh=norm["lowhigh"],
                               percentile=norm["percentile"],
                               invert=norm["invert"])
        x = xt.cpu().numpy()
        niter_eff = 200 if not niter else niter
        run_kw = dict(n_cell_classes=self.nclasses, batch_size=batch_size,
                      augment=augment, tile_overlap=tile_overlap,
                      bsize=bsize)
        if do_3D:
            yf, y_classf, _ = run_3D(self.net, x, **run_kw)
            cellprob = yf[..., -1]
            dP = yf[..., :-1].transpose(3, 0, 1, 2)  # (3, Lz, Ly, Lx)
            masks = compute_masks_3d(
                dP, cellprob, niter=niter_eff,
                cellprob_threshold=cellprob_threshold,
                flow_threshold=flow_threshold, min_size=min_size,
                device=self.device)
        else:
            yf, y_classf, _ = run_net(self.net, x, **run_kw)
            cellprob = yf[..., -1]
            dP = yf[..., :2].transpose(3, 0, 1, 2)
            planes = [
                _dyn_compute_masks(
                    dP[:, z], cellprob[z], niter=niter_eff,
                    cellprob_threshold=cellprob_threshold,
                    flow_threshold=flow_threshold,
                    min_size=-1,  # no size filter before stitching
                    device=self.device)
                for z in range(Lz)]
            masks = stitch3D(np.stack(planes),
                             stitch_threshold=stitch_threshold)
            if min_size > 0 and masks.max() > 0:
                counts = np.bincount(masks.ravel())
                small = counts < min_size
                small[0] = False
                masks[small[masks]] = 0
        y_class = (y_classf.transpose(3, 0, 1, 2) if y_classf is not None
                   else np.zeros((1,) + cellprob.shape, np.float32))
        if self.nclasses > 1 and masks.max():
            class_masks, _ = compute_class_masks(masks, y_class)
        else:
            class_masks = np.zeros_like(masks)
        return (masks, (None, dP, cellprob, y_class, x.shape), class_masks,
                np.zeros(256, np.float32))
