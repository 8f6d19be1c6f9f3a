"""Named augmentation configurations (counterpart of
``classpose_tpu/transforms/augmentation_configs.py``)."""

from __future__ import annotations

AUGMENTATION_CONFIGS: dict[str, dict] = {
    "hed_only": {
        "color": {"hed_p": 1.0, "he_p": 0.0, "magnitude": 0.25},
        "quality": {"blur_p": 0.0, "noise_p": 0.0, "hbs_p": 0.0},
    },
    "enhanced": {
        "color": {"hed_p": 0.5, "he_p": 0.5, "magnitude": 0.25},
        "quality": {"blur_p": 0.1, "noise_p": 0.8, "hbs_p": 0.9},
    },
}


def get_config(name: str) -> dict:
    if name not in AUGMENTATION_CONFIGS:
        raise ValueError(
            f"Unknown augmentation config '{name}'. "
            f"Available: {sorted(AUGMENTATION_CONFIGS)}"
        )
    return AUGMENTATION_CONFIGS[name]


def create_custom_config(
    hed_p: float = 0.5,
    he_p: float = 0.5,
    magnitude: float = 0.25,
    blur_p: float = 0.1,
    noise_p: float = 0.8,
    hbs_p: float = 0.9,
) -> dict:
    return {
        "color": {"hed_p": hed_p, "he_p": he_p, "magnitude": magnitude},
        "quality": {"blur_p": blur_p, "noise_p": noise_p, "hbs_p": hbs_p},
    }
