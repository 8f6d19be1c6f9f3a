"""Checkpoints: the JAX package's native ``.npz`` and the published
torch ``.pt`` files (counterpart of ``classpose_tpu/nn/convert.py``).

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

A published checkpoint (cpsam and the six classpose models) is a state
dict of the reference ``ClassTransformer``, already in PyTorch layout:
:func:`state_dict_from_published` renames it onto the port's
``state_dict`` (``encoder.patch_embed.proj`` → ``encoder.patch_embed``,
``encoder.neck.0/1/2/3`` → ``neck_conv1``/``neck_ln1``/``neck_conv2``/
``neck_ln2``; the blocks and heads keep their names), refusing W2/W3
that are not the identity pixel-shuffle and tensors the map does not
take. :func:`infer_config_from_state_dict` reads the architecture off
the tensor shapes.
"""

from __future__ import annotations

import dataclasses
import json
import re

import numpy as np
import torch

from classpose_tpu_torch.log import get_logger
from classpose_tpu_torch.nn.vit_sam import (
    JAX_ONLY_FIELDS,
    ClassTransformerConfig,
)

logger = get_logger(__name__)

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


def _torch_key_and_value(path: str, v: torch.Tensor):
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
            v = v.t()
        elif v.ndim == 4 and "upconv" in parts:
            v = v.permute(2, 3, 0, 1).flip(2, 3)
        elif v.ndim == 4:
            v = v.permute(3, 2, 0, 1)
    elif leaf == "scale":
        parts[-1] = "weight"
    return ".".join(parts), v


def params_from_jax(tree_or_flat) -> dict[str, torch.Tensor]:
    """Flax param tree (``{"params": ...}`` or the bare tree) or flat
    ``/``-keyed dict → the port's ``state_dict`` (contiguous fp32 CPU
    tensors; the layout changes run in torch, whose copies are blocked
    and threaded: a ViT-L's in ~1 s where numpy's strided copies took
    ~3 s on the card's host)."""
    flat = tree_or_flat
    if any(isinstance(v, dict) for v in flat.values()):
        flat = flatten_tree(flat)
    sd = {}
    for path, v in flat.items():
        if path == "__meta__":
            continue
        key, val = _torch_key_and_value(path, torch.from_numpy(
            np.ascontiguousarray(v, dtype=np.float32)))
        sd[key] = val.contiguous()
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
    ``cfg`` (a ``ClassTransformerConfig``) its fields, and the JAX-only
    ones at their defaults, go into ``__meta__`` as JSON, as the JAX
    package's ``save_params`` writes them."""
    flat = params_to_jax(sd)
    if cfg is not None:
        meta = {**dataclasses.asdict(cfg), **JAX_ONLY_FIELDS}
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


def config_from_meta(meta: dict) -> ClassTransformerConfig:
    """The ``ClassTransformerConfig`` of a native checkpoint's
    ``__meta__`` (the JAX-only fields dropped)."""
    meta = {k: v for k, v in meta.items() if k not in JAX_ONLY_FIELDS}
    fts = meta.get("feature_transformation_structure")
    meta["feature_transformation_structure"] = tuple(fts) if fts else None
    return ClassTransformerConfig(**meta)


# ------------------------------------------------------ published .pt

# Keys a published cellpose/classpose checkpoint carries that have no
# parameter in the port: cellpose's Transformer registers diam_mean and
# diam_labels as frozen Parameters (training bookkeeping; inference
# rescales by the fixed 30/diameter), and W2/W3 are checked to be the
# identity pixel-shuffle, which the port's readout computes as a reshape.
IGNORED_CHECKPOINT_KEYS = frozenset({"diam_mean", "diam_labels", "W2", "W3"})

_BLOCK_LEAVES = (
    "norm1.weight", "norm1.bias", "attn.qkv.weight", "attn.qkv.bias",
    "attn.proj.weight", "attn.proj.bias", "attn.rel_pos_h",
    "attn.rel_pos_w", "norm2.weight", "norm2.bias", "mlp.lin1.weight",
    "mlp.lin1.bias", "mlp.lin2.weight", "mlp.lin2.bias",
)
# published name → the port's, where they differ
_RENAMED = {
    "encoder.patch_embed.proj.weight": "encoder.patch_embed.weight",
    "encoder.patch_embed.proj.bias": "encoder.patch_embed.bias",
    "encoder.neck.0.weight": "encoder.neck_conv1.weight",
    "encoder.neck.1.weight": "encoder.neck_ln1.weight",
    "encoder.neck.1.bias": "encoder.neck_ln1.bias",
    "encoder.neck.2.weight": "encoder.neck_conv2.weight",
    "encoder.neck.3.weight": "encoder.neck_ln2.weight",
    "encoder.neck.3.bias": "encoder.neck_ln2.bias",
}


def load_torch_checkpoint(path: str) -> dict[str, torch.Tensor]:
    """A published torch checkpoint → its state dict, fp32 CPU tensors.

    Loaded with ``weights_only=True``: a plain state dict or one wrapped
    as ``{"model_state_dict": ...}`` loads; a pickle of other objects
    raises."""
    obj = torch.load(str(path), map_location="cpu", weights_only=True)
    if isinstance(obj, dict) and "model_state_dict" in obj:
        obj = obj["model_state_dict"]
    return {k: torch.as_tensor(v).detach().to(torch.float32)
            for k, v in obj.items()}


def _is_identity_pixel_shuffle(W: torch.Tensor) -> bool:
    """True iff W (C·ps², C, ps, ps) is eye(C·ps²) reshaped."""
    n = W.shape[0]
    return bool(torch.equal(W.reshape(n, n), torch.eye(n, dtype=W.dtype)))


def _unet_keys(sd, prefix: str) -> list[str]:
    """The class-head UNet's published keys (the port's are the same)."""
    def conv(name):
        return [f"{prefix}{name}.weight", f"{prefix}{name}.bias"]

    def block(name):
        return conv(f"{name}.conv1") + conv(f"{name}.conv2")

    keys = []
    for side, conv_name in (("encoder_blocks", "downconv"),
                            ("decoder_blocks", "upconv")):
        i = 0
        while f"{prefix}{side}.{i}.block.conv1.weight" in sd:
            keys += (block(f"{side}.{i}.block")
                     + conv(f"{side}.{i}.{conv_name}"))
            i += 1
    keys += block("bottleneck_down.block") + conv("bottleneck_down.downconv")
    keys += block("bottleneck_up.block") + conv("bottleneck_up.upconv")
    return keys


def published_names(sd) -> dict[str, str]:
    """Published key → the port's ``state_dict`` key, for every key the
    map takes from ``sd``: the blocks while ``encoder.blocks.{i}`` has a
    ``norm1``, the class head as a 1×1 conv or, when ``out_class.*`` keys
    hold no ``out_class.weight``, as the UNet."""
    keys = ["encoder.patch_embed.proj.weight",
            "encoder.patch_embed.proj.bias", "encoder.pos_embed"]
    i = 0
    while f"encoder.blocks.{i}.norm1.weight" in sd:
        keys += [f"encoder.blocks.{i}.{leaf}" for leaf in _BLOCK_LEAVES]
        i += 1
    keys += [k for k in _RENAMED if k.startswith("encoder.neck.")]
    keys += ["out.weight", "out.bias"]
    if "out_class.weight" in sd:
        keys += ["out_class.weight", "out_class.bias"]
    elif any(k.startswith("out_class.") for k in sd):
        keys += _unet_keys(sd, "out_class.")
    return {k: _RENAMED.get(k, k) for k in keys}


def state_dict_from_published(sd: dict[str, torch.Tensor],
                              strict_readout: bool = True,
                              strict_consume: bool = True
                              ) -> dict[str, torch.Tensor]:
    """A published ClassTransformer state dict → the port's
    ``state_dict`` (the same tensors under the port's names; the UNet's
    transposed-conv weights as they are, PyTorch layout on both sides).

    A missing key raises ``KeyError``. With ``strict_readout``, W2 or W3
    other than the identity pixel-shuffle raises ``ValueError``. With
    ``strict_consume``, a tensor the map does not take (beyond
    :data:`IGNORED_CHECKPOINT_KEYS`) raises ``ValueError``; without, it
    is logged as a warning."""
    names = published_names(sd)
    out = {port: sd[pub] for pub, port in names.items()}
    for name in ("W2", "W3"):
        if name in sd and strict_readout \
                and not _is_identity_pixel_shuffle(sd[name]):
            raise ValueError(
                f"checkpoint {name} is not the identity pixel-shuffle; "
                "the readout assumes the frozen identity kernel "
                "(reference vit_sam.py:139-144)")
    unconsumed = sorted(k for k in sd if k not in names
                        and k not in IGNORED_CHECKPOINT_KEYS)
    if unconsumed:
        msg = (f"checkpoint has {len(unconsumed)} tensor(s) the converter "
               f"did not map: {unconsumed[:12]}"
               + (" ..." if len(unconsumed) > 12 else ""))
        if strict_consume:
            raise ValueError(msg)
        logger.warning(msg)
    return out


def _unet_structure_from_keys(keys, sep: str, getter) -> list[int]:
    """The UNet's encoder ladder from its conv1 shapes: published keys
    (``sep="."``, OIHW) or native flat keys (``sep="/"``, HWIO)."""
    chans = []
    i = 0
    while True:
        key = (f"out_class.encoder_blocks.{i}.block.conv1.weight"
               if sep == "." else
               f"params/out_class/encoder_blocks_{i}/block/conv1/kernel")
        if key not in keys:
            return chans
        shape = np.shape(getter(key))
        chans.append(int(shape[0] if sep == "." else shape[-1]))
        i += 1


def _published_structure(sd) -> tuple[list[int] | None, int]:
    n_classes = int(sd["W3"].shape[1]) if "W3" in sd else 1
    unet = any(k.startswith("out_class.encoder_blocks") for k in sd)
    structure = (_unet_structure_from_keys(list(sd), ".", sd.__getitem__)
                 if unet else None)
    return structure, n_classes


def infer_config_from_state_dict(sd) -> ClassTransformerConfig:
    """The full ``ClassTransformerConfig`` of a published state dict, from
    its tensor shapes (patch size, bsize, depth, heads, neck width, class
    count and head): what ``classpose-convert-weights-torch`` writes into
    ``__meta__``."""
    pe = sd["encoder.patch_embed.proj.weight"]  # (E, 3, ps, ps)
    embed_dim, ps = int(pe.shape[0]), int(pe.shape[2])
    thw = int(sd["encoder.pos_embed"].shape[1])
    head_dim = int(sd["encoder.blocks.0.attn.rel_pos_h"].shape[1])
    depth = 0
    while f"encoder.blocks.{depth}.norm1.weight" in sd:
        depth += 1
    structure, n_classes = _published_structure(sd)
    return ClassTransformerConfig(
        ps=ps, bsize=thw * ps, embed_dim=embed_dim, depth=depth,
        num_heads=max(1, embed_dim // head_dim),
        neck_dim=int(sd["encoder.neck.0.weight"].shape[0]),
        n_cell_classes=max(n_classes, 1),
        feature_transformation_structure=(
            tuple(structure) if structure else None))


def infer_structure(path: str) -> tuple[list[int] | None, int]:
    """(feature_transformation_structure, n_classes) of a checkpoint.

    A published ``.pt``: the class count from W3, the UNet ladder from
    its encoder convs. A native ``.npz``: from ``__meta__``, or else from
    the keys: the ladder as above and the class count from the class
    head's output width over ps² (the 1×1 conv's kernel, or the UNet's
    last upconv)."""
    path = str(path)
    if not path.endswith(".npz"):
        return _published_structure(load_torch_checkpoint(path))
    with np.load(path) as z:
        keys = list(z.files)
        if "__meta__" in keys:
            meta = json.loads(bytes(z["__meta__"]).decode())
            s = meta.get("feature_transformation_structure")
            return (list(s) if s else None), int(
                meta.get("n_cell_classes", 1))
        structure = (_unet_structure_from_keys(keys, "/", z.__getitem__)
                     if any("out_class/encoder_blocks" in k for k in keys)
                     else None)
        pk = "params/encoder/patch_embed/kernel"
        ps = int(z[pk].shape[0]) if pk in keys else None
        head = ("params/out_class/kernel" if structure is None else
                "params/out_class/decoder_blocks_"
                f"{len(structure) - 1}/upconv/kernel")
        if head not in keys or not ps:
            return structure, 1
        return structure, int(z[head].shape[-1]) // (ps * ps)


def load_checkpoint(path: str) -> tuple[dict[str, torch.Tensor],
                                        ClassTransformerConfig | None]:
    """(the port's ``state_dict``, its config or None) of a checkpoint: a
    native ``.npz`` (config from ``__meta__`` when it has one) or a
    published ``.pt`` (config inferred from its shapes)."""
    path = str(path)
    if path.endswith(".npz"):
        flat, meta = load_npz_checkpoint(path)
        return (params_from_jax(flat),
                None if meta is None else config_from_meta(meta))
    sd = load_torch_checkpoint(path)
    cfg = infer_config_from_state_dict(sd)
    out = state_dict_from_published(sd)
    logger.info("mapped torch checkpoint %s (%d tensors)", path, len(sd))
    return out, cfg


def load_params(path: str) -> dict[str, torch.Tensor]:
    """The port's ``state_dict`` of a native ``.npz`` or a published
    ``.pt`` checkpoint."""
    return load_checkpoint(path)[0]


def load_classification_head(sd: dict[str, torch.Tensor],
                             checkpoint_path: str) -> dict[str, torch.Tensor]:
    """``sd`` with its ``out`` and ``out_class`` heads replaced by those of
    another checkpoint (``.npz`` or ``.pt``), each where that checkpoint
    has it (reference vit_sam.py:251-267); returns a new dict."""
    donor = load_params(checkpoint_path)
    out = dict(sd)
    for head in ("out", "out_class"):
        sub = {k: v for k, v in donor.items() if k.startswith(head + ".")}
        if sub:
            out = {k: v for k, v in out.items()
                   if not k.startswith(head + ".")}
            out.update(sub)
            logger.info("loaded %s head from %s", head, checkpoint_path)
    return out
