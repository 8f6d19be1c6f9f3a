"""Training losses (counterpart of ``classpose_tpu/train/losses.py``).

- seg loss: MSE between predicted flows and 5× the unit target flows,
  halved, plus BCE-with-logits of the cell probability against the
  binary mask;
- masked cross-entropy over the class logits, ignore index −100, optional
  class weights (weighted mean, as torch ``CrossEntropyLoss``);
- focal Tversky loss, α = 0.3, γ = 1.33, −100 pixels masked out;
- Kendall uncertainty aggregation with learnable log-variances:
  total = Σ exp(−s)·L (+ s when learned).

Label layout (B, 4, H, W): [class (−100 masked), binary, flow_y, flow_x];
prediction layout (B, n_classes+3, H, W): [class logits..., flow_y,
flow_x, cellprob logit]. Callers pass ``y.float()``.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def loss_fn_seg(lbl: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Flows MSE (scaled 5, halved) + cellprob BCE."""
    veci = 5.0 * lbl[:, -2:]
    mse = torch.mean((y[:, -3:-1] - veci) ** 2) / 2.0
    logits = y[:, -1]
    target = (lbl[:, -3] > 0.5).to(torch.float32)
    bce = torch.mean(torch.clamp(logits, min=0) - logits * target
                     + torch.log1p(torch.exp(-logits.abs())))
    return mse + bce


def loss_fn_class(lbl: torch.Tensor, y: torch.Tensor,
                  class_weights: torch.Tensor | None = None) -> torch.Tensor:
    """Masked (ignore −100), optionally class-weighted cross-entropy."""
    logits = y[:, :-3]
    target = lbl[:, 0].to(torch.int64)
    valid = target != -100
    safe = torch.where(valid, target, 0)
    logp = F.log_softmax(logits, dim=1)
    picked = torch.gather(logp, 1, safe[:, None])[:, 0]
    if class_weights is not None:
        w = torch.as_tensor(class_weights, dtype=torch.float32,
                            device=y.device)[safe]
    else:
        w = torch.ones_like(picked)
    w = w * valid
    return -(picked * w).sum() / torch.clamp(w.sum(), min=1e-12)


def loss_fn_tversky(lbl: torch.Tensor, y: torch.Tensor, n_classes: int,
                    class_weights: torch.Tensor | None = None,
                    alpha: float = 0.3, gamma: float = 1.33,
                    eps: float = 1e-6) -> torch.Tensor:
    """Focal Tversky loss over the class channels."""
    beta = 1.0 - alpha
    target = lbl[:, 0].to(torch.int64)
    valid = (target != -100).to(torch.float32)[:, None]
    safe = torch.where(target == -100, 0, target)
    one_hot = F.one_hot(safe, n_classes).permute(0, 3, 1, 2).to(
        torch.float32)
    probs = torch.softmax(y[:, :-3], dim=1)
    tp = torch.sum(probs * one_hot * valid, dim=(2, 3))
    fp = torch.sum(probs * (1 - one_hot) * valid, dim=(2, 3))
    fn = torch.sum((1 - probs) * one_hot * valid, dim=(2, 3))
    loss = 1.0 - tp / (tp + alpha * fp + beta * fn + 1e-30)
    loss = torch.clamp(loss, eps, 1 - eps) ** (1.0 / gamma)
    if class_weights is not None:
        loss = loss * torch.as_tensor(class_weights, dtype=torch.float32,
                                      device=y.device)
    return loss.mean()


def aggregate_losses(log_var: torch.Tensor, losses: torch.Tensor,
                     optimise: bool = True) -> torch.Tensor:
    """Kendall et al. multi-task weighting: Σ exp(−s)·L (+ s if learned)."""
    weighted = torch.exp(-log_var) * losses
    if optimise:
        weighted = weighted + log_var
    return weighted.sum()


def uncertainty_factors(log_var, seg_trainable: bool = True
                        ) -> dict[str, float]:
    """exp(−s) per loss, for the log."""
    if isinstance(log_var, torch.Tensor):
        log_var = log_var.detach().cpu().numpy()
    w = np.exp(-np.asarray(log_var))
    out = {}
    i = 0
    if seg_trainable:
        out["seg_weight"] = float(w[i])
        i += 1
    out["ce_weight"] = float(w[i])
    out["tversky_weight"] = float(w[i + 1])
    return out
