"""GrandQC weights: smp state dicts and the native ``.npz`` (counterpart
of ``classpose_tpu/grandqc/convert.py``).

The published GrandQC weights are smp ``UnetPlusPlus`` checkpoints on the
``timm-efficientnet-b0`` encoder. :class:`~.nets.UnetPlusPlus` carries
smp's names, so :func:`convert_grandqc_checkpoint` grafts a checkpoint
key for key, with the JAX converter's refusals: a checkpoint with some
but not all decoder tensors raises ``ValueError``; a missing encoder or
head tensor raises ``KeyError``; a tensor of another shape, or a bias on
a conv that has none, raises ``ValueError``; a tensor left over (other
than the BatchNorm ``num_batches_tracked`` counters) is logged, and
raises under ``strict``. An encoder-only checkpoint grafts the encoder
and leaves the decoder and head at their random initialisation.

The native ``.npz`` is the JAX package's layout (the flax tree of
``classpose_tpu.grandqc.nets.UnetPlusPlus`` flattened with ``/``, conv
kernels HWIO, ``__meta__`` the ``UnetPlusPlusConfig`` as JSON), so both
packages read the files either one writes: :func:`grandqc_params_to_jax`
and :func:`state_dict_from_jax_grandqc` translate.
"""

from __future__ import annotations

import dataclasses
import json
import re

import numpy as np
import torch

from classpose_tpu_torch.grandqc.nets import UnetPlusPlus, UnetPlusPlusConfig
from classpose_tpu_torch.log import get_logger
from classpose_tpu_torch.nn.convert import load_npz_checkpoint

logger = get_logger(__name__)

# the encoder and decoder convs behind TF "SAME" padding: a flax ConvSame
# holds its kernel one level down, under "conv"
_SAME_CONVS = ("conv_stem", "conv_pw", "conv_dw", "conv_pwl")
_BN_LEAVES = {"weight": "scale", "bias": "bias", "running_mean": "mean",
              "running_var": "var"}
_BLOCK = re.compile(r"^blocks_(\d+)_(\d+)$")
_DEC_LAYER = re.compile(r"^conv(\d)_(\d)$")


def _np(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        return v.detach().to("cpu", torch.float32).numpy()
    return np.asarray(v)


def _module_kind(key: str) -> str:
    """'bn', 'same' (a padded conv), 'conv' (SE, head) of an smp key."""
    parts = key.split(".")
    if parts[0] == "decoder":
        return "bn" if parts[-2] == "1" else "same"
    mod = parts[-2]
    if mod.startswith("bn"):
        return "bn"
    return "same" if mod in _SAME_CONVS else "conv"


def convert_grandqc_checkpoint(sd: dict, classes: int, strict: bool = False
                               ) -> tuple[dict[str, torch.Tensor], float]:
    """Graft an smp UnetPlusPlus(timm-efficientnet-b0) state dict onto
    :class:`UnetPlusPlus` with ``classes`` classes. Returns (the port's
    state dict, the grafted share of its tensors)."""
    net = UnetPlusPlus(UnetPlusPlusConfig(classes=classes))
    own = net.state_dict()
    has_decoder = any(k.startswith("decoder.") for k in sd)
    used: set[str] = set()
    out: dict[str, torch.Tensor] = {}

    def graft(part: str, keys: list[str]):
        for k in keys:
            if _module_kind(k) == "same" and k.endswith(".weight"):
                bias = k[: -len("weight")] + "bias"
                if bias in sd:
                    raise ValueError(f"{part}: converted tree structure "
                                     f"mismatch: {bias} has no place")
            v = _np(sd[k])
            used.add(k)
            if tuple(v.shape) != tuple(own[k].shape):
                raise ValueError(
                    f"{part}: shape mismatch at {k}: expected "
                    f"{tuple(own[k].shape)}, got {tuple(v.shape)}")
            out[k] = torch.from_numpy(np.array(v, np.float32))

    graft("encoder", [k for k in own if k.startswith("encoder.")])
    n_grafted = len(out)
    if has_decoder:
        dec = [k for k in own if k.startswith("decoder.")]
        missing = [k for k in dec if k not in sd]
        if missing:
            raise ValueError(
                f"checkpoint has decoder.* keys but not the full smp "
                f"UnetPlusPlus decoder layout (missing {missing[0]!r})")
        graft("decoder", dec)
        graft("segmentation_head",
              ["segmentation_head.0.weight", "segmentation_head.0.bias"])
        n_grafted = len(out)
    for k, v in own.items():
        out.setdefault(k, v.clone())

    leftovers = [k for k in sd if k not in used
                 and not k.endswith("num_batches_tracked")]
    if leftovers:
        msg = (f"GrandQC conversion left {len(leftovers)} checkpoint "
               f"tensors unconsumed: {leftovers[:8]}")
        if strict:
            raise ValueError(msg)
        logger.warning(msg)
    logger.info("GrandQC conversion: grafted %d/%d tensors (%s)", n_grafted,
                len(own), "encoder+decoder+head" if has_decoder else
                "encoder only — decoder randomly initialized")
    return out, n_grafted / len(own)


def _flax_path(key: str) -> list[str]:
    parts = key.split(".")
    leaf, kind = parts[-1], _module_kind(key)
    if parts[0] == "segmentation_head":
        mods = ["segmentation_head"]
    elif parts[0] == "decoder":  # decoder.blocks.x_d_l.convN.{0,1}
        mods = ["decoder", parts[2], f"{parts[3]}_{parts[4]}"]
    elif parts[1] == "blocks":  # encoder.blocks.s.i.<mod...>
        mods = ["encoder", f"blocks_{parts[2]}_{parts[3]}", *parts[4:-1]]
    else:
        mods = parts[:-1]
    if kind == "bn":
        return ["params", *mods, _BN_LEAVES[leaf]]
    if kind == "same":
        mods.append("conv")
    return ["params", *mods, "kernel" if leaf == "weight" else leaf]


def grandqc_params_to_jax(sd: dict) -> dict[str, np.ndarray]:
    """The port's state dict → the flat ``/``-keyed flax params of
    ``classpose_tpu.grandqc.nets.UnetPlusPlus`` (conv kernels HWIO; a
    depthwise ``(C, 1, kh, kw)`` becomes ``(kh, kw, 1, C)``), fp32."""
    flat = {}
    for key, val in sd.items():
        if key.endswith("num_batches_tracked"):
            continue
        v = _np(val).astype(np.float32)
        path = _flax_path(key)
        if path[-1] == "kernel":
            v = np.transpose(v, (2, 3, 1, 0))
        flat["/".join(path)] = np.ascontiguousarray(v)
    return flat


def state_dict_from_jax_grandqc(flat: dict) -> dict[str, torch.Tensor]:
    """Flat ``/``-keyed flax params (with or without the ``params/``
    root) → the port's state dict: the inverse of
    :func:`grandqc_params_to_jax`."""
    bn_leaves = {v: k for k, v in _BN_LEAVES.items()}
    sd = {}
    for path, val in flat.items():
        if path == "__meta__":
            continue
        parts = [p for p in path.split("/") if p not in ("params", "conv")]
        leaf, mods = parts[-1], parts[:-1]
        v = np.asarray(val, np.float32)
        if mods[0] == "segmentation_head":
            mods = ["segmentation_head", "0"]
        elif mods[0] == "decoder":
            n, i = _DEC_LAYER.match(mods[2]).groups()
            mods = ["decoder", "blocks", mods[1], f"conv{n}", i]
        else:
            m = _BLOCK.match(mods[1]) if len(mods) > 1 else None
            if m:
                mods = [mods[0], "blocks", *m.groups(), *mods[2:]]
        if leaf == "kernel":
            leaf, v = "weight", np.transpose(v, (3, 2, 0, 1))
        elif leaf in bn_leaves:
            leaf = bn_leaves[leaf]
        sd[".".join([*mods, leaf])] = torch.from_numpy(
            np.ascontiguousarray(v))
    return sd


def save_grandqc_npz(sd: dict, path: str, cfg: UnetPlusPlusConfig) -> None:
    """Write the port's state dict as the JAX package's GrandQC ``.npz``
    (flax params, ``__meta__`` the config), as ``save_params`` does."""
    flat = grandqc_params_to_jax(sd)
    meta = {k: list(v) if isinstance(v, tuple) else v
            for k, v in dataclasses.asdict(cfg).items()}
    flat["__meta__"] = np.frombuffer(json.dumps(meta).encode(), np.uint8)
    np.savez_compressed(path, **flat)


def load_grandqc_npz(path: str, classes: int | None = None
                     ) -> tuple[dict[str, torch.Tensor], UnetPlusPlusConfig]:
    """(state dict, config) of a native GrandQC ``.npz``. The config is
    ``__meta__``'s; ``classes`` fills it in where ``__meta__`` lacks it
    (or the file has none), as the JAX loader does."""
    flat, meta = load_npz_checkpoint(path)
    meta = {k: tuple(v) if isinstance(v, list) else v
            for k, v in (meta or {}).items()}
    if "classes" not in meta and classes is not None:
        meta["classes"] = classes
    return state_dict_from_jax_grandqc(flat), UnetPlusPlusConfig(**meta)
