"""Real-weight parity check (``classpose-parity-check-torch``), the
counterpart of the JAX package's ``classpose-parity-check``.

Given a published torch checkpoint (cpsam or one of the classpose
configs), it runs the acceptance check offline and writes a JSON report:

1. **Conversion**: the state dict through the port's name map
   (``nn/convert.py``) with the config inferred from its shapes; for the
   published ViT-L conv-head geometry, :func:`manifest_diff` against the
   hand-transcribed manifest (``nn/manifest.py``).
2. **Per-layer fp32 parity**: the port's ``ClassTransformer``, loaded
   through the map on ``--device``, against the torch replica
   (``nn/torch_replica.py``), loaded strictly under the published names
   from the same file, on the same device with TF32 off, compared at the
   patch embed, every block, the neck, the seg/class heads and the final
   logits (forward hooks on both).
3. **End-to-end masks**: ``ClassposeModel.eval`` at fp32 on a fixed tile
   set (``--tiles`` or deterministic synthetic H&E-like tiles); with
   ``--reference_masks`` (from the PyTorch reference, run elsewhere),
   detection F1/PQ and the class agreement.

One command validates a published checkpoint, or a directory of them::

    classpose-parity-check-torch --checkpoint ~/.classpose_models/conic.pt \\
        --reference_masks ref_masks.npy --output parity_report.json
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np
import torch

from classpose_tpu_torch.log import get_logger

logger = get_logger(__name__)


def synthetic_tiles(n: int = 2, size: int = 256, seed: int = 0) -> np.ndarray:
    """Deterministic H&E-like tiles (N, S, S, 3) float32 in 0..255."""
    rng = np.random.default_rng(seed)
    tiles = np.zeros((n, size, size, 3), np.float32)
    yy, xx = np.mgrid[:size, :size]
    for t in range(n):
        img = np.full((size, size, 3), (225.0, 195.0, 215.0), np.float32)
        for _ in range(12):
            cy, cx = rng.integers(16, size - 16, 2)
            r = rng.integers(6, 14)
            m = (yy - cy) ** 2 + (xx - cx) ** 2 <= r * r
            img[m] = (100.0, 60.0, 140.0)
        img += rng.normal(0, 3, img.shape)
        tiles[t] = np.clip(img, 0, 255)
    return tiles


def _align(a: np.ndarray, b: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Align layouts: try NCHW↔NHWC transposes until shapes agree."""
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    if a.shape == b.shape:
        return a, b
    if a.ndim == 4 and np.transpose(a, (0, 3, 1, 2)).shape == b.shape:
        return np.transpose(a, (0, 3, 1, 2)), b
    if a.ndim == 4 and np.transpose(a, (0, 2, 3, 1)).shape == b.shape:
        return np.transpose(a, (0, 2, 3, 1)), b
    raise ValueError(f"cannot align shapes {a.shape} vs {b.shape}")


def _hooked(net, modules: dict) -> tuple[dict, list]:
    """Forward hooks on ``modules`` (name → module of ``net``) that keep
    each output, as fp32 numpy; returns (outputs, handles)."""
    captured: dict[str, np.ndarray] = {}

    def hook(name):
        def fn(_m, _i, out):
            captured[name] = out.detach().float().cpu().numpy()
        return fn

    return captured, [m.register_forward_hook(hook(n))
                      for n, m in modules.items()]


def _layers(enc, blocks, out, out_class, patch_embed) -> dict:
    mods = {"patch_embed": patch_embed, "encoder": enc, "out": out}
    mods.update({f"block_{i}": b for i, b in enumerate(blocks)})
    if out_class is not None:
        mods["out_class"] = out_class
    return mods


def per_layer_parity(sd: dict, net, cfg, x_nchw: np.ndarray,
                     device) -> dict:
    """Compare the port's ``net`` (on ``device``, fp32) with the torch
    replica loaded from the published state dict ``sd``, layer by layer,
    on one input."""
    from classpose_tpu_torch.nn.torch_replica import RefClassTransformer

    # fp32 on both sides: no TF32 in either network's products
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    replica = RefClassTransformer(
        ps=cfg.ps, bsize=cfg.bsize, nout=cfg.nout,
        n_cell_classes=cfg.n_cell_classes,
        structure=cfg.feature_transformation_structure,
        embed_dim=cfg.embed_dim, depth=cfg.depth, num_heads=cfg.num_heads,
        mlp_ratio=cfg.mlp_ratio, neck_dim=cfg.neck_dim,
    )
    load = replica.load_state_dict(sd, strict=True)
    report: dict = {"missing_keys": list(load.missing_keys),
                    "unexpected_keys": list(load.unexpected_keys)}
    replica.to(device).eval()
    x = torch.from_numpy(x_nchw).to(device)
    two = cfg.n_cell_classes > 1

    ref_out, ref_h = _hooked(replica, _layers(
        replica.encoder, replica.encoder.blocks, replica.out,
        replica.out_class if two else None,
        replica.encoder.patch_embed.proj))
    got_out, got_h = _hooked(net, _layers(
        net.encoder, net.encoder.blocks, net.out,
        net.out_class if two else None, net.encoder.patch_embed))
    try:
        with torch.no_grad():
            y_ref = replica(x).cpu().numpy()
            y = net(x)[0].float().cpu().numpy()
    finally:
        for h in ref_h + got_h:
            h.remove()
    del replica
    report["layers"] = {}
    for name in ref_out:
        a, b = _align(got_out[name], ref_out[name])
        report["layers"][name] = float(np.abs(a - b).max())
    report["final_logits_max_diff"] = float(np.abs(y - y_ref).max())
    return report


def detection_f1(gt: np.ndarray, pred: np.ndarray) -> dict:
    """Binary detection PQ/DQ/SQ + precision/recall/F1 at IoU 0.5 (the
    reference's metric of record, metrics/pq.py:95-158)."""
    from classpose_tpu_torch.metrics.pq import compute_binary_pq_metrics

    row = compute_binary_pq_metrics([gt], [pred])[0]
    return {k: float(row[k])
            for k in ("pq", "dq", "sq", "precision", "recall", "f1")}


def run_parity(checkpoint: str, tiles: np.ndarray,
               reference_masks: np.ndarray | None = None,
               reference_class_masks: np.ndarray | None = None,
               atol: float = 2e-4, niter: int = 200, device=None) -> dict:
    from classpose_tpu_torch.nn.convert import (
        infer_config_from_state_dict,
        load_torch_checkpoint,
        state_dict_from_published,
    )
    from classpose_tpu_torch.nn.manifest import manifest_diff, vit_l_manifest
    from classpose_tpu_torch.runner import ClassposeModel
    from classpose_tpu_torch.utils import get_device

    device = get_device(device) if not isinstance(
        device, torch.device) else device
    report: dict = {"checkpoint": str(checkpoint), "atol": atol}

    if str(checkpoint).endswith(".npz"):
        model = ClassposeModel(pretrained_model=str(checkpoint),
                               precision="fp32", device=device)
        cfg = model.cfg
        report["per_layer"] = None
        report["note"] = (
            ".npz checkpoint: conversion already done; per-layer torch "
            "parity requires the original torch .pt")
    else:
        sd = load_torch_checkpoint(str(checkpoint))
        cfg = infer_config_from_state_dict(sd)
        model = ClassposeModel(cfg=cfg, params=state_dict_from_published(sd),
                               precision="fp32", device=device)
        # the published ViT-L conv-head geometry has a manifest; other
        # geometries (test checkpoints, UNet heads) say why not
        if cfg.depth == 24 and cfg.bsize == 256 \
                and not cfg.feature_transformation_structure:
            report["manifest_diff"] = manifest_diff(
                sd, vit_l_manifest(cfg.n_cell_classes))
        else:
            report["manifest_diff"] = {
                "skipped": "no published-checkpoint manifest for this "
                "geometry (ViT-L conv-head only)"}
        x = np.ascontiguousarray(
            (tiles[:1] / 255.0).transpose(0, 3, 1, 2), np.float32)
        report["per_layer"] = per_layer_parity(sd, model.net, cfg, x,
                                               device)
        del sd
        report["logit_parity_pass"] = bool(
            report["per_layer"]["final_logits_max_diff"] <= atol)

    report["config"] = {
        "n_cell_classes": cfg.n_cell_classes,
        "structure": cfg.feature_transformation_structure,
        "bsize": cfg.bsize, "depth": cfg.depth,
    }

    masks_out, class_out = [], []
    for t in tiles:
        m, _flows, cm, _ = model.eval(t.astype(np.float32), niter=niter,
                                      batch_size=4)
        masks_out.append(np.asarray(m, np.int32))
        class_out.append(np.asarray(cm, np.int32))
    report["n_cells_per_tile"] = [int(m.max()) for m in masks_out]

    if reference_masks is not None:
        f1s = [detection_f1(g.astype(np.int32), p)
               for g, p in zip(reference_masks, masks_out)]
        report["detection"] = {k: float(np.mean([f[k] for f in f1s]))
                               for k in f1s[0]}
        if reference_class_masks is not None and cfg.n_cell_classes > 1:
            agree = []
            for gcm, pcm, pm in zip(reference_class_masks, class_out,
                                    masks_out):
                fg = (pm > 0) & (gcm > 0)
                agree.append(float((gcm[fg] == pcm[fg]).mean())
                             if fg.any() else 1.0)
            report["classification_pixel_agreement"] = float(np.mean(agree))
    return report


def main_with_args(argv=None) -> dict:
    p = argparse.ArgumentParser(
        description="fp32 parity check: the port's model on a published "
        "torch checkpoint against the torch replica (per-layer logits + "
        "end-to-end masks).")
    p.add_argument("--checkpoint", required=True,
                   help="torch .pt/.pth state dict or converted .npz, or a "
                   "directory of checkpoints, validated in one run with a "
                   "consolidated report")
    p.add_argument("--tiles", default=None,
                   help=".npy (N,H,W,3) fixed tile set; default synthetic")
    p.add_argument("--n_tiles", type=int, default=2)
    p.add_argument("--tile_size", type=int, default=256)
    p.add_argument("--reference_masks", default=None,
                   help=".npy (N,H,W) int masks from the torch reference")
    p.add_argument("--reference_class_masks", default=None)
    p.add_argument("--output", default="parity_report.json")
    p.add_argument("--atol", type=float, default=2e-4)
    p.add_argument("--niter", type=int, default=200)
    p.add_argument("--device", type=str, default=None,
                   help="'cuda' (default) or 'cpu'")
    args = p.parse_args(argv)

    tiles = (np.load(args.tiles).astype(np.float32) if args.tiles
             else synthetic_tiles(args.n_tiles, args.tile_size))
    ref = np.load(args.reference_masks) if args.reference_masks else None
    refc = (np.load(args.reference_class_masks)
            if args.reference_class_masks else None)
    kw = dict(reference_masks=ref, reference_class_masks=refc,
              atol=args.atol, niter=args.niter, device=args.device)

    def summarize(rep):
        return {
            "final_logits_max_diff": (
                rep.get("per_layer") or {}).get("final_logits_max_diff"),
            "logit_parity_pass": rep.get("logit_parity_pass"),
            "detection_f1": (rep.get("detection") or {}).get("f1"),
        }

    ckpt = Path(args.checkpoint)
    if ckpt.is_dir():
        paths = sorted(q for q in ckpt.iterdir()
                       if q.suffix in (".pt", ".pth", ".npz"))
        if not paths:
            raise SystemExit(f"no .pt/.pth/.npz checkpoints in {ckpt}")
        report = {"checkpoints": {}, "summary": {}}
        for pth in paths:
            logger.info("parity-checking %s", pth.name)
            try:
                rep = run_parity(str(pth), tiles, **kw)
            except Exception as exc:  # keep going; report the failure
                rep = {"error": f"{type(exc).__name__}: {exc}"}
            report["checkpoints"][pth.name] = rep
            report["summary"][pth.name] = (
                summarize(rep) if "error" not in rep
                else {"error": rep["error"]})
        summary = report["summary"]
    else:
        report = run_parity(str(ckpt), tiles, **kw)
        summary = summarize(report)
    Path(args.output).write_text(json.dumps(report, indent=2, default=str))
    logger.info("parity report → %s", args.output)
    print(json.dumps(summary))
    return report


if __name__ == "__main__":
    main_with_args()
