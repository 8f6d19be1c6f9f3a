"""Hand-transcribed key/shape manifests of the published torch
checkpoints, the ViT-L classpose models and the GrandQC UNet++ models, and
a diff helper (counterpart of ``classpose_tpu/nn/manifest.py``).

The manifest pins what a published checkpoint's state dict must look
like, transcribed from the reference source, not generated from this
package's converter or replica: the tests hold the replica and the name
map against it, and ``classpose-parity-check-torch`` reports
:func:`manifest_diff` against any real checkpoint it is given.

Source: reference vit_sam.py:129-144 (``out_class`` + the frozen W3), the
cellpose Transformer contract (patch embed ps = 8, 32×32 tokens, 24
blocks with decomposed rel-pos, a 4-stage neck, ``out`` + W2,
``diam_mean``/``diam_labels`` buffers; reference train.py:440).
"""

from __future__ import annotations

import numpy as np


def vit_l_manifest(n_classes: int = 6) -> dict[str, tuple]:
    """Key→shape manifest of a published ViT-L classpose checkpoint (1×1
    conv class head; ``n_classes=1`` → plain cpsam, no class head)."""
    E, D, H, TH, PS, NECK = 1024, 24, 16, 32, 8, 256
    hd = E // H
    m: dict[str, tuple] = {
        "diam_mean": (1,),
        "diam_labels": (1,),
        "encoder.patch_embed.proj.weight": (E, 3, PS, PS),
        "encoder.patch_embed.proj.bias": (E,),
        "encoder.pos_embed": (1, TH, TH, E),
        "encoder.neck.0.weight": (NECK, E, 1, 1),
        "encoder.neck.1.weight": (NECK,),
        "encoder.neck.1.bias": (NECK,),
        "encoder.neck.2.weight": (NECK, NECK, 3, 3),
        "encoder.neck.3.weight": (NECK,),
        "encoder.neck.3.bias": (NECK,),
        "out.weight": (3 * PS * PS, NECK, 1, 1),
        "out.bias": (3 * PS * PS,),
        "W2": (3 * PS * PS, 3, PS, PS),
    }
    for i in range(D):
        pre = f"encoder.blocks.{i}"
        m[f"{pre}.norm1.weight"] = (E,)
        m[f"{pre}.norm1.bias"] = (E,)
        m[f"{pre}.attn.qkv.weight"] = (3 * E, E)
        m[f"{pre}.attn.qkv.bias"] = (3 * E,)
        m[f"{pre}.attn.proj.weight"] = (E, E)
        m[f"{pre}.attn.proj.bias"] = (E,)
        m[f"{pre}.attn.rel_pos_h"] = (2 * TH - 1, hd)
        m[f"{pre}.attn.rel_pos_w"] = (2 * TH - 1, hd)
        m[f"{pre}.norm2.weight"] = (E,)
        m[f"{pre}.norm2.bias"] = (E,)
        m[f"{pre}.mlp.lin1.weight"] = (4 * E, E)
        m[f"{pre}.mlp.lin1.bias"] = (4 * E,)
        m[f"{pre}.mlp.lin2.weight"] = (E, 4 * E)
        m[f"{pre}.mlp.lin2.bias"] = (E,)
    if n_classes > 1:
        m["out_class.weight"] = (n_classes * PS * PS, NECK, 1, 1)
        m["out_class.bias"] = (n_classes * PS * PS,)
        m["W3"] = (n_classes * PS * PS, n_classes, PS, PS)
    return m


# efficientnet-b0 per-stage (blocks, out_ch, kernel, expand); SE reduce
# width = max(1, int(0.25 * block input channels)) — timm semantics
_B0_SPEC = [
    (1, 16, 3, 1),
    (2, 24, 3, 6),
    (2, 40, 5, 6),
    (3, 80, 3, 6),
    (3, 112, 5, 6),
    (4, 192, 5, 6),
    (1, 320, 3, 6),
]

# UNet++ decoder blocks over pyramid (3, 32, 24, 40, 112, 320) with
# decoder channels (256, 128, 64, 32, 16): name → (conv1_in, out_ch),
# derived from smp UnetPlusPlusDecoder's channel spec (in_channels =
# [head]+dec[:-1]; skip_channels = reversed-shallower-features + [0];
# conv1 input = block input + Σ skips). conv2 is out_ch → out_ch.
_UNETPP_B0_BLOCKS = {
    "x_0_0": (320 + 112, 256),
    "x_1_1": (112 + 40, 40),
    "x_2_2": (40 + 24, 24),
    "x_3_3": (24 + 32, 32),
    "x_0_1": (256 + 40 + 40, 128),
    "x_1_2": (40 + 24 + 24, 24),
    "x_2_3": (24 + 32 + 32, 32),
    "x_0_2": (128 + 24 + 24 + 24, 64),
    "x_1_3": (24 + 32 + 32 + 32, 32),
    "x_0_3": (64 + 32 + 32 + 32 + 32, 32),
    "x_0_4": (32, 16),
}


def _bn_keys(m: dict, prefix: str, c: int, counters: bool):
    m[f"{prefix}.weight"] = (c,)
    m[f"{prefix}.bias"] = (c,)
    m[f"{prefix}.running_mean"] = (c,)
    m[f"{prefix}.running_var"] = (c,)
    if counters:
        m[f"{prefix}.num_batches_tracked"] = ()


def grandqc_manifest(
    classes: int = 2, bn_counters: bool = True
) -> dict[str, tuple]:
    """Key→shape manifest for a published GrandQC Zenodo checkpoint
    (smp ``UnetPlusPlus(timm-efficientnet-b0)``; tissue ``classes=2``,
    artefact ``classes=8``). ``bn_counters`` includes the
    ``num_batches_tracked`` step counters real torch checkpoints carry
    (no inference effect; the converter ignores them)."""
    m: dict[str, tuple] = {}
    m["encoder.conv_stem.weight"] = (32, 3, 3, 3)
    _bn_keys(m, "encoder.bn1", 32, bn_counters)
    c_in = 32
    for s, (n_blocks, c_out, k, expand) in enumerate(_B0_SPEC):
        for i in range(n_blocks):
            t = f"encoder.blocks.{s}.{i}"
            r = max(1, int(0.25 * c_in))
            if expand == 1:  # DepthwiseSeparableConv (stage 0)
                m[f"{t}.conv_dw.weight"] = (c_in, 1, k, k)
                _bn_keys(m, f"{t}.bn1", c_in, bn_counters)
                m[f"{t}.se.conv_reduce.weight"] = (r, c_in, 1, 1)
                m[f"{t}.se.conv_reduce.bias"] = (r,)
                m[f"{t}.se.conv_expand.weight"] = (c_in, r, 1, 1)
                m[f"{t}.se.conv_expand.bias"] = (c_in,)
                m[f"{t}.conv_pw.weight"] = (c_out, c_in, 1, 1)
                _bn_keys(m, f"{t}.bn2", c_out, bn_counters)
            else:  # InvertedResidual
                e = c_in * expand
                m[f"{t}.conv_pw.weight"] = (e, c_in, 1, 1)
                _bn_keys(m, f"{t}.bn1", e, bn_counters)
                m[f"{t}.conv_dw.weight"] = (e, 1, k, k)
                _bn_keys(m, f"{t}.bn2", e, bn_counters)
                m[f"{t}.se.conv_reduce.weight"] = (r, e, 1, 1)
                m[f"{t}.se.conv_reduce.bias"] = (r,)
                m[f"{t}.se.conv_expand.weight"] = (e, r, 1, 1)
                m[f"{t}.se.conv_expand.bias"] = (e,)
                m[f"{t}.conv_pwl.weight"] = (c_out, e, 1, 1)
                _bn_keys(m, f"{t}.bn3", c_out, bn_counters)
            c_in = c_out
    for name, (cin, cout) in _UNETPP_B0_BLOCKS.items():
        t = f"decoder.blocks.{name}"
        m[f"{t}.conv1.0.weight"] = (cout, cin, 3, 3)
        _bn_keys(m, f"{t}.conv1.1", cout, bn_counters)
        m[f"{t}.conv2.0.weight"] = (cout, cout, 3, 3)
        _bn_keys(m, f"{t}.conv2.1", cout, bn_counters)
    m["segmentation_head.0.weight"] = (classes, 16, 3, 3)
    m["segmentation_head.0.bias"] = (classes,)
    return m


def manifest_diff(sd: dict, manifest: dict[str, tuple]) -> dict:
    """Compare a (real) checkpoint state dict against a manifest.

    Returns {"missing": [...], "unexpected": [...],
    "shape_mismatch": [{"key", "expected", "got"}, ...], "match": bool}."""
    missing = sorted(k for k in manifest if k not in sd)
    unexpected = sorted(k for k in sd if k not in manifest)
    mismatch = []
    for k in manifest:
        if k in sd:
            got = tuple(np.shape(sd[k]))
            if got != tuple(manifest[k]):
                mismatch.append(
                    {"key": k, "expected": list(manifest[k]),
                     "got": list(got)}
                )
    return {
        "missing": missing,
        "unexpected": unexpected,
        "shape_mismatch": mismatch,
        "match": not (missing or unexpected or mismatch),
    }
