"""Hand-transcribed key/shape manifest of the published ViT-L torch
checkpoints, and a diff helper (counterpart of
``classpose_tpu/nn/manifest.py``; its GrandQC manifest comes with the
GrandQC models).

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
