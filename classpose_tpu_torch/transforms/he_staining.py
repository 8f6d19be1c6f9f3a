"""H&E staining transform: stain-matrix estimate by NMF, then a random
perturbation of the stain vectors and concentrations (counterpart of
``classpose_tpu/transforms/he_staining.py``, the StarDist CoNIC recipe).

The JAX package factorises with scikit-learn's ``NMF``; the port with
:func:`~classpose_tpu_torch.transforms.nmf.nmf_random_cd`, which gives
the same components bit for bit.
"""

from __future__ import annotations

import numpy as np

from classpose_tpu_torch.transforms.nmf import nmf_random_cd


def extract_stain_matrix(
    rgb01: np.ndarray, n_stains: int = 2, od_threshold: float = 0.15,
    max_pixels: int = 50_000, seed: int = 0,
) -> tuple[np.ndarray, None] | None:
    """Estimate the unit stain matrix (n_stains, 3), hematoxylin first,
    from an RGB image in [0, 1] by NMF on the optical densities of its
    foreground (any channel above ``od_threshold``); ``None`` under 100
    foreground pixels. Returns (stain_matrix, None) as the JAX package
    does."""
    od = -np.log(np.clip(rgb01.reshape(-1, 3), 1e-6, 1.0))
    mask = (od > od_threshold).any(axis=1)
    od_fg = od[mask]
    if od_fg.shape[0] < 100:
        return None
    if od_fg.shape[0] > max_pixels:
        idx = np.random.default_rng(seed).choice(
            od_fg.shape[0], max_pixels, replace=False
        )
        od_fit = od_fg[idx]
    else:
        od_fit = od_fg
    H, _ = nmf_random_cd(od_fit, n_stains, seed, max_iter=200)
    norms = np.linalg.norm(H, axis=1, keepdims=True)
    H = H / np.maximum(norms, 1e-8)
    # hematoxylin (more blue OD) first
    if H[0, 2] < H[1, 2]:
        H = H[::-1]
    return H, None


class HEStainingTransform:
    """Randomly perturb the image's own estimated H&E stain basis."""

    def __init__(
        self,
        sigma_matrix: float = 0.05,
        sigma_concentration: float = 0.2,
        p: float = 1.0,
        seed=None,
    ):
        self.sigma_matrix = sigma_matrix
        self.sigma_concentration = sigma_concentration
        self.p = p
        self.rng = np.random.default_rng(seed)

    def transform(self, img: np.ndarray) -> np.ndarray:
        if self.rng.random() > self.p:
            return img
        img = np.asarray(img, np.float32)
        chw = img.ndim == 3 and img.shape[0] in (1, 3)
        rgb = np.moveaxis(img, 0, -1) if chw else img
        shift = min(0.0, float(rgb.min()))
        rgb_pos = rgb - shift
        scale = float(rgb_pos.max())
        if scale <= 0:
            return img
        unit = np.clip(rgb_pos / scale, 1e-6, 1.0)

        est = extract_stain_matrix(
            unit, seed=int(self.rng.integers(0, 2**31))
        )
        if est is None:
            return img
        stain_matrix, _ = est
        od = -np.log(unit.reshape(-1, 3))
        conc, *_ = np.linalg.lstsq(stain_matrix.T, od.T, rcond=None)
        conc = np.maximum(conc, 0)  # (2, N)

        m_pert = stain_matrix * (
            1 + self.rng.normal(0, self.sigma_matrix, stain_matrix.shape)
        )
        c_pert = conc * (
            1 + self.rng.normal(0, self.sigma_concentration, (2, 1))
        )
        od_new = (m_pert.T @ c_pert).T.reshape(unit.shape)
        rgb_new = np.exp(-od_new)
        out = (np.clip(rgb_new, 0, 1) * scale + shift).astype(np.float32)
        return np.moveaxis(out, -1, 0) if chw else out

    __call__ = transform
