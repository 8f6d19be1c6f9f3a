"""Runner helpers (counterpart of ``classpose_tpu/runner/core.py``
``chunk_plan`` and ``classpose_tpu/runner/model.py``
``resolve_precision``)."""

from __future__ import annotations

import logging

import numpy as np

logger = logging.getLogger(__name__)

PRECISION_DTYPES = {"fp32": "float32", "bf16": "bfloat16", "fp16": "bfloat16"}


def chunk_plan(nt: int, batch_size: int) -> tuple[int, int, int]:
    """(nchunk, bs, pad_tiles) for running ``nt`` crops in chunks of at
    most ``batch_size``, with the per-chunk batch shrunk to the smallest
    value that keeps the chunk count (nt=25, batch_size=8 → 4 chunks of
    7). The port runs the last chunk short instead of padding it."""
    nchunk = int(np.ceil(nt / min(batch_size, nt)))
    bs = int(np.ceil(nt / nchunk))
    return nchunk, bs, nchunk * bs - nt


def resolve_precision(precision: str) -> str:
    """Precision flag → compute dtype name. fp16 maps to bf16, as in the
    JAX package, so both run the same arithmetic."""
    if precision not in PRECISION_DTYPES:
        raise ValueError(f"Unknown precision '{precision}'. Expected one of "
                         f"{sorted(PRECISION_DTYPES)}.")
    if precision == "fp16":
        logger.warning("fp16 runs as bf16")
    return PRECISION_DTYPES[precision]
