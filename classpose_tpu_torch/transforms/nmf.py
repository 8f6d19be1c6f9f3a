"""Non-negative matrix factorisation by coordinate descent, in numpy.

The stain-matrix estimate of ``he_staining.py`` factorises optical
densities X (N, F) ≈ W (N, k) · H (k, F). :func:`nmf_random_cd` is
scikit-learn's ``NMF(init="random", solver="cd")`` with the Frobenius loss
and no regularisation, step for step, so that it gives the same ``H`` and
iteration count bit for bit:

- init: H, then W, from ``RandomState(seed).standard_normal`` cast to X's
  dtype and scaled by ``sqrt(X.mean() / k)``, then ``abs``;
- one iteration updates W, then H (the same update on the transposed
  problem); an update forms ``HHt = Ht.T · Ht`` and ``XHt = X · Ht`` and
  sweeps the components in order, all rows of one component at once:
  ``g = -XHt[:, t] + Σ_r HHt[t, r] W[:, r]`` (r in order), then
  ``W[:, t] = max(W[:, t] - g / HHt[t, t], 0)``;
- the projected-gradient violation (``min(g, 0)`` where W was 0, else g)
  is summed in X's dtype row after row, component after component (a
  ``cumsum``, not numpy's pairwise ``sum``), and the run stops once the
  violation falls to ``tol`` times the first iteration's.
"""

from __future__ import annotations

import numpy as np


def _update(X: np.ndarray, W: np.ndarray, Ht: np.ndarray) -> float:
    """One coordinate sweep over W's components in place; returns the
    summed projected-gradient violation."""
    HHt = np.dot(Ht.T, Ht)
    XHt = X @ Ht
    k = W.shape[1]
    parts = []
    for t in range(k):
        grad = -XHt[:, t]
        for r in range(k):
            grad = grad + HHt[t, r] * W[:, r]
        parts.append(np.abs(np.where(W[:, t] == 0,
                                     np.minimum(grad, 0), grad)))
        hess = HHt[t, t]
        if hess != 0:
            W[:, t] = np.maximum(W[:, t] - grad / hess, 0)
    viol = np.cumsum(np.concatenate(parts), dtype=W.dtype)
    return float(viol[-1]) if viol.size else 0.0


def nmf_random_cd(X: np.ndarray, n_components: int, seed: int,
                  max_iter: int = 200, tol: float = 1e-4
                  ) -> tuple[np.ndarray, int]:
    """Factorise non-negative X (N, F), float32 or float64; returns
    (components H (n_components, F), iterations run)."""
    X = np.asarray(X)
    if X.dtype not in (np.float32, np.float64):
        X = X.astype(np.float64)
    if X.ndim != 2 or (X < 0).any():
        raise ValueError("nmf_random_cd needs a non-negative 2-D array")
    n, f = X.shape
    avg = np.sqrt(X.mean() / n_components)
    rng = np.random.RandomState(seed)
    H = avg * rng.standard_normal(size=(n_components, f)).astype(X.dtype)
    W = avg * rng.standard_normal(size=(n, n_components)).astype(X.dtype)
    np.abs(H, out=H)
    np.abs(W, out=W)

    W = np.ascontiguousarray(W)
    Ht = np.ascontiguousarray(H.T)
    for n_iter in range(1, max_iter + 1):
        violation = 0.0
        violation += _update(X, W, Ht)
        violation += _update(X.T, Ht, W)
        if n_iter == 1:
            violation_init = violation
        if violation_init == 0:
            break
        if violation / violation_init <= tol:
            break
    return Ht.T, n_iter
