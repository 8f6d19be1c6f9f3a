"""Host helpers (counterpart of ``classpose_tpu/utils.py``): output
filename templates, downloads, slide resolution, device parsing and label
sparsification."""

from __future__ import annotations

import os
import shutil
import urllib.request
from pathlib import Path

import numpy as np
import torch

ALLOW_UNSAFE_REQUESTS = os.getenv("ALLOW_UNSAFE_REQUESTS", "false").lower() \
    in ("true", "1")

GEOJSON_OUTPUT_TEMPLATES = {
    "cell_contours": os.getenv(
        "CLASSPOSE_CELL_CONTOURS_GEOJSON", "{base_name}_cell_contours.geojson"
    ),
    "cell_centroids": os.getenv(
        "CLASSPOSE_CELL_CENTROIDS_GEOJSON",
        "{base_name}_cell_centroids.geojson"
    ),
    "tissue_contours": os.getenv(
        "CLASSPOSE_TISSUE_CONTOURS_GEOJSON",
        "{base_name}_tissue_contours.geojson",
    ),
    "artefact_contours": os.getenv(
        "CLASSPOSE_ARTEFACT_CONTOURS_GEOJSON",
        "{base_name}_artefact_contours.geojson",
    ),
    "roi": os.getenv("CLASSPOSE_ROI_GEOJSON", "{base_name}_roi.geojson"),
}

def get_geojson_output_filename(output_kind: str, base_name: str) -> str:
    """Output filename for one of the GeoJSON artefact kinds (the QuPath
    extension's import convention; env overrides as in the JAX package)."""
    if output_kind not in GEOJSON_OUTPUT_TEMPLATES:
        valid = ", ".join(GEOJSON_OUTPUT_TEMPLATES)
        raise ValueError(
            f"Invalid output kind: {output_kind}. Valid options are: {valid}"
        )
    return GEOJSON_OUTPUT_TEMPLATES[output_kind].format(base_name=base_name)


def download_if_unavailable(path: str, url: str,
                            chunk_size: int = 1 << 20) -> str:
    """Stream ``url`` to ``path`` unless it already exists. Plain-http URLs
    are refused unless ``ALLOW_UNSAFE_REQUESTS`` is set."""
    path = str(path)
    if os.path.exists(path):
        return path
    if url.startswith("http://") and not ALLOW_UNSAFE_REQUESTS:
        raise ValueError(
            f"Refusing insecure download from {url}; set "
            "ALLOW_UNSAFE_REQUESTS=true to override."
        )
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    tmp = path + ".part"
    with urllib.request.urlopen(url, timeout=60) as r, open(tmp, "wb") as f:
        shutil.copyfileobj(r, f, chunk_size)
    os.replace(tmp, path)
    return path


def get_slide_resolution(slide) -> tuple[float, float] | None:
    """(mpp_x, mpp_y) of a slide reader: ``openslide.mpp-x/y`` (or
    ``mpp-x/y``, ``mpp``) properties first, then the TIFF resolution tags
    with centimetre/inch conversion; None if neither is there."""
    props = getattr(slide, "properties", {}) or {}

    def _get(keys):
        for key in keys:
            if key in props:
                try:
                    return float(props[key])
                except (TypeError, ValueError):
                    pass
        return None

    x = _get(("openslide.mpp-x", "mpp-x", "mpp"))
    y = _get(("openslide.mpp-y", "mpp-y", "mpp"))
    if x is not None:
        return (x, y if y is not None else x)
    unit = props.get("tiff.ResolutionUnit", "inch")

    def _from_res(key):
        try:
            res = float(props.get(key) or 0)
        except (TypeError, ValueError):
            return None
        if res <= 0:
            return None
        if str(unit).lower().startswith("cent"):
            return 10_000.0 / res
        return 25_400.0 / res

    x = _from_res("tiff.XResolution")
    y = _from_res("tiff.YResolution")
    if x is not None:
        return (x, y if y is not None else x)
    return None


def get_devices(device: str | None) -> list[torch.device]:
    """Parse a ``--device`` flag into the list of devices to run on, by
    the JAX package's ``get_device`` rules on CUDA cards: ``None``/``""``
    is the first card; ``cuda`` or ``gpu`` without an index every visible
    card; ``cuda:0,1`` (``gpu:0,1``) those cards, in that order; ``cpu``
    (or ``cpu:0``) the CPU. An index past ``torch.cuda.device_count()``,
    a card named twice, another CPU index (torch has one CPU device),
    ``tpu*`` and an unknown platform raise ``ValueError``. A CUDA choice
    on a machine without CUDA raises ``RuntimeError``: it never falls
    back to the CPU."""
    spec = (device or "cuda:0").strip().lower()
    platform, _, idx_str = spec.partition(":")
    try:
        indices = [int(i) for i in idx_str.split(",") if i.strip()]
    except ValueError:
        raise ValueError(f"bad device indices in --device {device!r}")
    if len(set(indices)) != len(indices):
        raise ValueError(f"--device {device}: a card is named twice")
    if platform == "cpu":
        if indices not in ([], [0]):
            raise ValueError(f"--device {device}: torch has one CPU device "
                             "(cpu or cpu:0)")
        return [torch.device("cpu")]
    if platform in ("tpu", "accelerator"):
        raise ValueError(f"--device {device}: this package runs on CUDA "
                         "cards or the CPU, not on a TPU")
    if platform not in ("cuda", "gpu"):
        raise ValueError(f"unknown --device {device!r}")
    if not torch.cuda.is_available():
        raise RuntimeError(f"--device {device or 'cuda'} asks for a CUDA "
                           "card and this machine has none; pass --device "
                           "cpu to run on the CPU")
    count = torch.cuda.device_count()
    if not indices:
        indices = list(range(count))
    bad = [i for i in indices if not 0 <= i < count]
    if bad:
        raise ValueError(f"--device {device}: no card {bad[0]}; this "
                         f"machine has {count} (0 to {count - 1})")
    return [torch.device("cuda", i) for i in indices]


def get_device(device: str | None) -> torch.device:
    """The first device of :func:`get_devices`: the one device of the
    single-card entry points (evaluate, detect-tissue/artefacts,
    parity-check, the WSI model's first replica)."""
    return get_devices(device)[0]


def make_sparse(labels: np.ndarray, keep_fraction: float,
                rng: np.random.Generator | None = None) -> np.ndarray:
    """Sparsify class annotations: keep the class labels of only
    ``keep_fraction`` of the annotated instances and set the rest to 0
    (unannotated). ``labels`` is (N, C, H, W) or one (C, H, W) sample with
    channel 0 the class channel and channel 1 the instance channel."""
    rng = rng or np.random.default_rng()
    labels = labels.copy()
    squeeze = labels.ndim == 3
    if squeeze:
        labels = labels[None]
    for i in range(labels.shape[0]):
        cls, inst = labels[i, 0], labels[i, 1]
        ids = np.unique(inst)
        ids = ids[ids > 0]
        if len(ids) == 0:
            continue
        n_keep = max(1, int(round(keep_fraction * len(ids))))
        keep = rng.choice(ids, size=n_keep, replace=False)
        cls[(inst > 0) & ~np.isin(inst, keep)] = 0
        labels[i, 0] = cls
    return labels[0] if squeeze else labels
