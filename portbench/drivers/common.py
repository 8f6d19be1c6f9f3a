"""What every driver builds the same way."""

from __future__ import annotations


def model_config(cell):
    """The program's ``ClassTransformerConfig`` of the cell's
    configuration file (its ``model`` block)."""
    from classpose_tpu_torch.nn.vit_sam import ClassTransformerConfig

    m = dict(cell.config["model"])
    fts = m.pop("feature_transformation_structure")
    return ClassTransformerConfig(
        feature_transformation_structure=tuple(fts) if fts else None, **m)
