"""Weights carried across from the JAX package (counterpart of
``classpose_tpu/nn/convert.py``).

The native checkpoint is a flat ``.npz``: ``/``-joined flax parameter
paths (``params/encoder/blocks_0/attn/qkv/kernel``) plus an optional
``__meta__`` entry, the JSON of the ``ClassTransformerConfig`` as uint8
bytes. :func:`params_from_jax` maps that tree, nested or flat, to the
port's ``state_dict``:

- Dense ``kernel (in, out)`` → Linear ``weight (out, in)``;
- Conv ``kernel`` HWIO → ``weight`` OIHW;
- ConvTranspose ``kernel`` (kh, kw, in, out) → ``weight`` (in, out, kh, kw)
  with the taps flipped (flax applies the kernel mirrored relative to
  PyTorch);
- LayerNorm ``scale`` → ``weight``; ``blocks_3`` → ``blocks.3``;
- everything else (biases, ``rel_pos_h/w``, ``pos_embed``) as it is.

:func:`params_to_jax` is its exact inverse and :func:`save_params` writes
the native ``.npz`` (with ``__meta__``) that the JAX package loads.
"""

from __future__ import annotations

import dataclasses
import json
import re

import numpy as np
import torch

_INDEXED = re.compile(r"^(blocks|encoder_blocks|decoder_blocks)_(\d+)$")
_INDEXED_TORCH = re.compile(r"^(blocks|encoder_blocks|decoder_blocks)$")


def flatten_tree(tree, prefix: str = "") -> dict[str, np.ndarray]:
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, dict):
            out.update(flatten_tree(v, key))
        else:
            out[key] = np.asarray(v)
    return out


def load_npz_checkpoint(path: str) -> tuple[dict[str, np.ndarray],
                                            dict | None]:
    """(flat params, meta | None) from a native ``.npz`` checkpoint."""
    meta = None
    flat = {}
    with np.load(path) as z:
        for k in z.files:
            if k == "__meta__":
                meta = json.loads(bytes(z[k]).decode())
            else:
                flat[k] = z[k]
    return flat, meta


def _torch_key_and_value(path: str, v: np.ndarray):
    parts = path.split("/")
    if parts[0] == "params":
        parts = parts[1:]
    parts = [
        (lambda m: f"{m.group(1)}.{m.group(2)}" if m else p)(_INDEXED.match(p))
        for p in parts
    ]
    leaf = parts[-1]
    if leaf == "kernel":
        parts[-1] = "weight"
        if v.ndim == 2:
            v = v.T
        elif v.ndim == 4 and "upconv" in parts:
            v = np.transpose(v, (2, 3, 0, 1))[:, :, ::-1, ::-1]
        elif v.ndim == 4:
            v = np.transpose(v, (3, 2, 0, 1))
    elif leaf == "scale":
        parts[-1] = "weight"
    return ".".join(parts), v


def params_from_jax(tree_or_flat) -> dict[str, torch.Tensor]:
    """Flax param tree (``{"params": ...}`` or the bare tree) or flat
    ``/``-keyed dict → the port's ``state_dict`` (fp32 CPU tensors)."""
    flat = tree_or_flat
    if any(isinstance(v, dict) for v in flat.values()):
        flat = flatten_tree(flat)
    sd = {}
    for path, v in flat.items():
        if path == "__meta__":
            continue
        key, val = _torch_key_and_value(path, np.asarray(v))
        sd[key] = torch.from_numpy(
            np.ascontiguousarray(val, dtype=np.float32))
    return sd


def _jax_key_and_value(key: str, v: np.ndarray):
    parts = key.split(".")
    joined = []
    for p in parts:
        if p.isdigit() and joined and _INDEXED_TORCH.match(joined[-1]):
            joined[-1] = f"{joined[-1]}_{p}"
        else:
            joined.append(p)
    parts = joined
    if parts[-1] == "weight":
        if v.ndim == 1:
            # flax LayerNorm "scale"; the neck's LayerNorm2d keeps "weight"
            if not parts[-2].startswith("neck_ln"):
                parts[-1] = "scale"
        else:
            parts[-1] = "kernel"
            if v.ndim == 2:
                v = v.T
            elif v.ndim == 4 and "upconv" in parts:
                v = np.transpose(v[:, :, ::-1, ::-1], (2, 3, 0, 1))
            elif v.ndim == 4:
                v = np.transpose(v, (2, 3, 1, 0))
    return "/".join(["params", *parts]), v


def params_to_jax(sd) -> dict[str, np.ndarray]:
    """The port's ``state_dict`` → flat ``/``-keyed flax params
    (``params/...``), fp32 numpy: the exact inverse of
    :func:`params_from_jax`."""
    flat = {}
    for key, val in sd.items():
        v = val.detach().to("cpu", torch.float32).numpy()
        path, v = _jax_key_and_value(key, v)
        flat[path] = np.ascontiguousarray(v)
    return flat


def save_params(sd, path: str, cfg=None) -> None:
    """Write a port ``state_dict`` as the native ``.npz`` checkpoint; with
    ``cfg`` (a ``ClassTransformerConfig``) its fields go into ``__meta__``
    as JSON, as the JAX package's ``save_params`` writes them."""
    flat = params_to_jax(sd)
    if cfg is not None:
        meta = dataclasses.asdict(cfg)
        for k, v in list(meta.items()):
            if isinstance(v, tuple):
                meta[k] = list(v)
        flat["__meta__"] = np.frombuffer(json.dumps(meta).encode(), np.uint8)
    np.savez_compressed(path, **flat)


def load_into(net: torch.nn.Module, sd: dict[str, torch.Tensor]) -> None:
    """``net.load_state_dict(sd)`` (strict), except that a rel-pos table
    of another length replaces the parameter: the attention resizes it to
    its grid at use, as the JAX package does."""
    own = net.state_dict()
    for key, val in sd.items():
        if key.endswith(("rel_pos_h", "rel_pos_w")) and key in own \
                and own[key].shape != val.shape:
            mod_name, attr = key.rsplit(".", 1)
            mod = net.get_submodule(mod_name)
            setattr(mod, attr, torch.nn.Parameter(
                torch.empty_like(val, device=own[key].device)))
    net.load_state_dict(sd, strict=True)


def infer_structure(path: str) -> tuple[list[int] | None, int]:
    """(feature_transformation_structure, n_classes) of a native ``.npz``
    checkpoint: from its ``__meta__``, or else the class count from the
    ``out_class`` kernel's width over ps² (a 1×1 class head; a UNet head
    without ``__meta__`` raises)."""
    with np.load(path) as z:
        if "__meta__" in z.files:
            meta = json.loads(bytes(z["__meta__"]).decode())
            s = meta.get("feature_transformation_structure")
            return (list(s) if s else None), int(
                meta.get("n_cell_classes", 1))
        if any("out_class/encoder_blocks" in k for k in z.files):
            raise ValueError(f"{path}: a UNet class head needs the "
                             "checkpoint's __meta__ (save_params with cfg)")
        ock = "params/out_class/kernel"
        if ock not in z.files:
            return None, 1
        ps = int(z["params/encoder/patch_embed/kernel"].shape[0])
        return None, int(z[ock].shape[-1]) // (ps * ps)
