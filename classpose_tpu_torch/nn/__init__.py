from classpose_tpu_torch.nn.vit_sam import (  # noqa: F401
    ClassTransformer,
    ClassTransformerConfig,
)
