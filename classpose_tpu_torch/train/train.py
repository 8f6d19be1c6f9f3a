"""Training loop: ``train_class_seg`` (counterpart of
``classpose_tpu/train/train.py``).

- AdamW with the hand-built LR schedule: a 10-epoch linear warm-up from
  0, a plateau, and a step-halving tail for long runs. ``torch.optim.AdamW``
  is optax's ``adamw`` here: decoupled decay (0.1) on every trainable
  network parameter, eps 1e-8; the learning rate of step k is
  ``lr_by_step[min(k, len − 1)]``, set before the step as the optax
  schedule reads it;
- three losses (seg / masked CE / focal Tversky) combined by the Kendall
  uncertainty aggregator, whose log-variances train in a second parameter
  group at 0.1× the learning rate and no decay; the seg loss is left out
  when the seg head is frozen;
- freezing by module (``encoder`` minus its neck, the neck, ``out``):
  frozen parameters get ``requires_grad=False`` and stay out of the
  optimizer;
- deterministic sampling (``DistributedEpochSampler``), validation on
  epoch 5 and every 10th (or every epoch);
- data parallelism over a process group (``torchrun``, one process per
  rank): each rank takes its share of the global batch, and a step is the
  JAX package's step on the global batch, whose losses reduce over the
  whole sharded batch (see :func:`make_train_step`); the weights start
  from rank 0's, checkpoints and the final weights are written by rank 0,
  validation sums are all-reduced;
- checkpoints ``checkpoint_last.train`` / ``checkpoint_best.train``: a
  ``torch.save`` of the network, log-variances, optimizer, step and the
  layer-drop generator, plus the JAX package's ``meta.json`` keys; full
  resume; final weights as the native ``.npz`` (``nn/convert.py``).
"""

from __future__ import annotations

import json
import logging
import time
from pathlib import Path
from typing import Any, Callable

import numpy as np
import torch

from classpose_tpu_torch.nn.convert import save_params
from classpose_tpu_torch.nn.vit_sam import draw_drop_mask
from classpose_tpu_torch.parallel.distributed import (
    all_reduce_,
    all_reduce_sum,
    allgather_object,
    barrier,
    broadcast_,
    get_rank,
    get_world_size,
    is_main_process,
)
from classpose_tpu_torch.train.losses import (
    aggregate_losses,
    class_weight_sum,
    loss_fn_class,
    loss_fn_seg,
    loss_fn_tversky,
    uncertainty_factors,
)
from classpose_tpu_torch.train.samplers import (
    DistributedEpochSampler,
    SequentialDistributedSampler,
)

train_logger = logging.getLogger(__name__)


def build_lr_schedule(learning_rate: float, n_epochs: int) -> np.ndarray:
    """Learning rate per epoch."""
    LR = np.linspace(0, learning_rate, 10)
    LR = np.append(LR, learning_rate * np.ones(max(0, n_epochs - 10)))
    if n_epochs > 300:
        LR = LR[:-100]
        for _ in range(10):
            LR = np.append(LR, LR[-1] / 2 * np.ones(10))
    elif n_epochs > 99:
        LR = LR[:-50]
        for _ in range(10):
            LR = np.append(LR, LR[-1] / 2 * np.ones(5))
    return LR[:n_epochs]


def freeze_labels(net: torch.nn.Module, freeze: dict | None = None
                  ) -> dict[str, str]:
    """Parameter name → "net" or "frozen", by top-level module: the
    encoder (``backbone``, its neck separately under ``neck``) and the
    seg head ``out`` (``instance_classification``); the class head's own
    UNet blocks stay trainable under ``backbone``."""
    freeze = freeze or {}
    labels = {}
    for name, _ in net.named_parameters():
        parts = name.split(".")
        frozen = False
        if parts[0] == "encoder":
            is_neck = any(p.startswith("neck") for p in parts)
            frozen = freeze.get("neck" if is_neck else "backbone", False)
        elif parts[0] == "out":
            frozen = freeze.get("instance_classification", False)
        labels[name] = "frozen" if frozen else "net"
    return labels


def make_optimizer(net: torch.nn.Module, log_var: torch.Tensor,
                   weight_decay: float = 0.1, freeze: dict | None = None,
                   use_uncertainty_weighting: bool = False
                   ) -> torch.optim.AdamW:
    """AdamW over the trainable network parameters (decay
    ``weight_decay``) and, with uncertainty weighting, ``log_var``
    (learning-rate scale 0.1, no decay). Frozen parameters and an
    unweighted ``log_var`` get ``requires_grad=False``."""
    labels = freeze_labels(net, freeze)
    params = []
    for name, p in net.named_parameters():
        p.requires_grad_(labels[name] == "net")
        if labels[name] == "net":
            params.append(p)
    groups = [dict(params=params, weight_decay=weight_decay, lr_scale=1.0)]
    log_var.requires_grad_(use_uncertainty_weighting)
    if use_uncertainty_weighting:
        groups.append(dict(params=[log_var], weight_decay=0.0,
                           lr_scale=0.1))
    return torch.optim.AdamW(groups, lr=0.0, betas=(0.9, 0.999), eps=1e-8)


def _losses(y, lbl, n_classes, log_var, seg_trainable, cw, optimise,
            weight_sum=None, world: int = 1):
    """(total, seg, ce, tversky). With ``weight_sum`` (the global batch's
    class weight sum) ``ce`` is ``world`` × this share's part of the
    global CE, so that its mean over the ranks is the global CE."""
    y = y.float()
    seg = torch.zeros((), device=y.device)
    losses = []
    if seg_trainable:
        seg = loss_fn_seg(lbl, y)
        losses.append(seg)
    ce = loss_fn_class(lbl, y, class_weights=cw, weight_sum=weight_sum)
    if weight_sum is not None:
        ce = ce * world
    tv = loss_fn_tversky(lbl, y, n_classes, class_weights=cw)
    losses.extend([ce, tv])
    total = aggregate_losses(log_var, torch.stack(losses), optimise=optimise)
    return total, seg, ce, tv


def make_train_step(
    net: torch.nn.Module,
    optimizer: torch.optim.Optimizer,
    log_var: torch.Tensor,
    lr_by_step: np.ndarray,
    n_classes: int,
    seg_trainable: bool = True,
    use_uncertainty_weighting: bool = False,
    class_weights=None,
    rdrop: bool = True,
    generator: torch.Generator | None = None,
    world: int = 1,
    rank: int = 0,
):
    """Return ``train_step(X, lbl, drop_mask=None) -> metrics``: forward
    (with the layer-drop when ``rdrop``, from ``drop_mask`` or
    ``generator``), the three losses, their aggregate, backward and one
    optimizer step at this step's learning rate. The step count lives on
    the returned function (``train_step.step``); gradients stay on the
    parameters until the next step.

    At ``world`` > 1 this process is rank ``rank`` of a process group of
    that size, ``X`` and ``lbl`` are its share of the global batch (equal
    shares in rank order), and the step is the global batch's: the
    layer-drop mask is drawn for the global batch from ``generator`` and
    the rank takes its rows; the class CE divides by the global batch's
    weight sum (all-reduced first: shares may hold different numbers of
    valid pixels, so the mean of per-share means is not the global mean);
    the seg and Tversky losses are means over equal shares, and the
    aggregate is linear in the losses, so the mean of the ranks'
    gradients, taken in one all-reduce of a flat buffer of every trained
    tensor's gradient (``log_var`` included), is the global batch's; the
    returned metrics are the global values."""
    dev = log_var.device
    cw = None if class_weights is None else torch.as_tensor(
        np.asarray(class_weights, np.float32), device=dev)
    lrs = np.asarray(lr_by_step, np.float64)
    trained = [p for group in optimizer.param_groups for p in group["params"]]

    def train_step(X, lbl, drop_mask=None):
        lr = float(lrs[min(train_step.step, len(lrs) - 1)])
        for group in optimizer.param_groups:
            group["lr"] = lr * group["lr_scale"]
        weight_sum = None
        if world > 1:
            if rdrop and drop_mask is None and generator is not None \
                    and net.cfg.rdrop > 0:
                n = X.shape[0]
                drop_mask = draw_drop_mask(net.cfg, world * n, generator)[
                    rank * n:(rank + 1) * n]
            weight_sum = all_reduce_(class_weight_sum(lbl, cw))
        y, _ = net(X, train=rdrop, drop_mask=drop_mask, generator=generator)
        total, seg, ce, tv = _losses(y, lbl, n_classes, log_var,
                                     seg_trainable, cw,
                                     use_uncertainty_weighting, weight_sum,
                                     world)
        optimizer.zero_grad(set_to_none=True)
        total.backward()
        if world > 1:
            _average_gradients(trained, world)
        optimizer.step()
        train_step.step += 1
        metrics = torch.stack([seg, ce, tv, total]).detach()
        if world > 1:
            metrics = all_reduce_(metrics.double()) / world
        return dict(zip(("seg", "ce", "tversky", "total"), metrics))

    train_step.step = 0
    return train_step


def _average_gradients(params: list[torch.Tensor], world: int) -> None:
    """Replace each parameter's gradient by its mean over the ranks: one
    all-reduce of one flat buffer (a missing gradient counts as zeros, so
    every rank's buffer has the same layout)."""
    grads = [torch.zeros_like(p) if p.grad is None else p.grad
             for p in params]
    flat = torch.cat([g.reshape(-1) for g in grads])
    all_reduce_(flat).div_(world)
    off = 0
    for p in params:
        p.grad = flat[off:off + p.numel()].view_as(p)
        off += p.numel()


def _save_checkpoint(path: Path, net, log_var, optimizer, step: int,
                     generator, epoch: int, best_val_loss: float,
                     train_losses, test_losses, config_snapshot,
                     host_rng: np.random.Generator | None,
                     rng_state_by_rank: list | None = None) -> None:
    """Write a full train-state checkpoint from rank 0, then synchronize."""
    path = Path(path).absolute()
    if is_main_process():
        path.mkdir(parents=True, exist_ok=True)
        torch.save({
            "params": net.state_dict(),
            "log_var": log_var.detach().cpu(),
            "opt_state": optimizer.state_dict(),
            "step": int(step),
            "generator": None if generator is None else generator.get_state(),
        }, path / "state.pt")
        meta = {
            "epoch": int(epoch),
            "best_val_loss": float(best_val_loss),
            "train_losses": np.asarray(train_losses).tolist(),
            "test_losses": np.asarray(test_losses).tolist(),
            "config_snapshot": config_snapshot,
        }
        if rng_state_by_rank is not None:
            meta["rng_state_by_rank"] = json.loads(
                json.dumps(rng_state_by_rank))
        if host_rng is not None:
            meta["host_rng_state"] = json.loads(
                json.dumps(host_rng.bit_generator.state))
        (path / "meta.json").write_text(json.dumps(meta, default=str))
    barrier("classpose_checkpoint")


def _load_checkpoint(path: Path, device) -> tuple[dict, dict]:
    path = Path(path).absolute()
    state = torch.load(path / "state.pt", map_location=device,
                       weights_only=False)
    meta = json.loads((path / "meta.json").read_text())
    return state, meta


def train_class_seg(
    model,
    train_dataset,
    train_probs: np.ndarray | None = None,
    test_dataset=None,
    batch_size: int = 1,
    learning_rate: float = 5e-5,
    n_epochs: int = 100,
    weight_decay: float = 0.1,
    save_path: str | None = None,
    save_every: int = 100,
    save_each: bool = False,
    nimg_per_epoch: int | None = None,
    model_name: str | None = None,
    class_weights=None,
    use_uncertainty_weighting: bool = False,
    validate_every_epoch: bool = False,
    log_file_path: str | None = None,
    random_seed: int = 42,
    resume_checkpoint: str | None = None,
    config_snapshot: dict[str, Any] | None = None,
    freeze: dict | None = None,
    seg_trainable: bool = True,
    on_step: Callable[[int, dict], None] | None = None,
):
    """Train the class+seg network of ``model`` (a ``ClassposeModel``: its
    ``.net`` is trained in place on ``model.device``). In a process group
    (``parallel/distributed.py``) ``batch_size`` is the global batch and
    every rank calls this with the same arguments.

    ``on_step(step, metrics)``, when given, is called after each step with
    the step's index and its global losses as floats.

    Returns (path of the final ``.npz``, train losses, validation losses)
    per epoch."""
    if log_file_path is not None:
        train_logger.addHandler(logging.FileHandler(log_file_path))

    net = model.net
    cfg = model.cfg
    dev = model.device
    n_classes = cfg.n_cell_classes
    rank, world = get_rank(), get_world_size()

    # per-rank host RNG (augmentation); one layer-drop generator
    host_rng = np.random.default_rng(random_seed + rank)
    generator = torch.Generator(device=dev).manual_seed(random_seed)

    if hasattr(train_dataset, "diameter_array"):
        train_dataset.initialise_diameter_array_if_necessary()
    if class_weights is not None:
        class_weights = np.asarray(class_weights, np.float32)

    nimg = len(train_dataset)
    nimg_per_epoch = nimg if nimg_per_epoch is None else nimg_per_epoch
    global_batch = batch_size
    if global_batch % world:
        global_batch = int(world * np.ceil(global_batch / world))
    per_rank_batch = global_batch // world

    LR = build_lr_schedule(learning_rate, n_epochs)
    sampler = DistributedEpochSampler(
        dataset_length=nimg, train_probs=train_probs,
        nimg_per_epoch=nimg_per_epoch, batch_size=per_rank_batch,
        rank=rank, num_replicas=world, seed=random_seed,
    )
    steps_per_epoch = max(1, len(sampler) // per_rank_batch)
    lr_by_step = np.repeat(LR, steps_per_epoch)

    n_active = 2 + int(seg_trainable)
    log_var = torch.zeros(n_active, dtype=torch.float32, device=dev)
    optimizer = make_optimizer(net, log_var, weight_decay, freeze,
                               use_uncertainty_weighting)
    train_step = make_train_step(
        net, optimizer, log_var, lr_by_step, n_classes,
        seg_trainable=seg_trainable,
        use_uncertainty_weighting=use_uncertainty_weighting,
        class_weights=class_weights, rdrop=cfg.rdrop > 0,
        generator=generator, world=world, rank=rank,
    )

    t0 = time.time()
    model_name = model_name or f"classpose_{int(t0)}"
    save_path = Path.cwd() if save_path is None else Path(save_path)
    model_dir = save_path / model_name
    model_dir.mkdir(parents=True, exist_ok=True)
    filename = model_dir / f"{model_name}.npz"
    checkpoint_last = model_dir / "checkpoint_last.train"
    checkpoint_best = model_dir / "checkpoint_best.train"

    train_losses = np.zeros(n_epochs)
    test_losses = np.zeros(n_epochs)
    best_val_loss = np.inf
    start_epoch = 0

    if resume_checkpoint is not None:
        state, meta = _load_checkpoint(Path(resume_checkpoint), dev)
        net.load_state_dict(state["params"])
        with torch.no_grad():
            log_var.copy_(state["log_var"])
        optimizer.load_state_dict(state["opt_state"])
        train_step.step = int(state["step"])
        if state["generator"] is not None:
            generator.set_state(state["generator"])
        start_epoch = meta["epoch"] + 1
        best_val_loss = meta["best_val_loss"]
        saved_tl = np.asarray(meta["train_losses"])
        train_losses[:len(saved_tl)] = saved_tl[:n_epochs]
        saved_vl = np.asarray(meta["test_losses"])
        test_losses[:len(saved_vl)] = saved_vl[:n_epochs]
        rng_by_rank = meta.get("rng_state_by_rank")
        if rng_by_rank and rank < len(rng_by_rank):
            host_rng.bit_generator.state = rng_by_rank[rank]
        elif "host_rng_state" in meta:
            host_rng.bit_generator.state = meta["host_rng_state"]
        if hasattr(train_dataset, "_rng"):
            train_dataset._rng = host_rng
        if start_epoch >= n_epochs:
            raise ValueError(
                f"Resume checkpoint already completed epoch "
                f"{start_epoch - 1}; requested n_epochs={n_epochs} leaves "
                "no training steps to run.")
        train_logger.info("Resumed from %s at epoch %d", resume_checkpoint,
                          start_epoch)

    if world > 1:
        # every rank starts from rank 0's weights
        with torch.no_grad():
            for t in [*net.state_dict().values(), log_var]:
                broadcast_(t)

    val_sampler = (SequentialDistributedSampler(
        len(test_dataset), rank=rank, num_replicas=world)
        if test_dataset is not None else None)
    cw = None if class_weights is None else torch.as_tensor(
        class_weights, device=dev)

    def _collect(dataset, indices):
        items = [dataset[int(i)] for i in indices]
        X = torch.from_numpy(np.stack([x for x, _ in items]))
        lbl = torch.from_numpy(np.stack([lb for _, lb in items]))
        return X.to(dev), lbl.to(dev)

    def _save(path, epoch):
        _save_checkpoint(path, net, log_var, optimizer, train_step.step,
                         generator, epoch, best_val_loss, train_losses,
                         test_losses, config_snapshot, host_rng,
                         allgather_object(host_rng.bit_generator.state))

    for iepoch in range(start_epoch, n_epochs):
        sampler.set_epoch(iepoch)
        local = sampler.local_indices()
        sums = {"seg": 0.0, "ce": 0.0, "tversky": 0.0, "total": 0.0}
        count = 0
        for s in range(0, len(local), per_rank_batch):
            idx = local[s:s + per_rank_batch]
            if len(idx) < per_rank_batch:
                break
            X, lbl = _collect(train_dataset, idx)
            metrics = {k: float(v) for k, v in train_step(X, lbl).items()}
            if on_step is not None:
                on_step(train_step.step - 1, metrics)
            count += global_batch
            for k in sums:
                sums[k] += metrics[k] * global_batch
        train_losses[iepoch] = sums["total"] / max(count, 1)

        n = max(count, 1)
        train_logger.info(
            f"Epoch {iepoch}, Segmentation Loss: {sums['seg'] / n:.4f}, "
            f"Classification CE Loss: {sums['ce'] / n:.4f}, Tversky Loss: "
            f"{sums['tversky'] / n:.4f}, Total Loss: "
            f"{train_losses[iepoch]:.4f}, LR={LR[iepoch]:.6f}, "
            f"time {time.time() - t0:.2f}s")
        if use_uncertainty_weighting:
            train_logger.info("Uncertainty weights: %s",
                              uncertainty_factors(log_var, seg_trainable))

        validate = validate_every_epoch or iepoch == 5 or iepoch % 10 == 0
        if validate and test_dataset is not None:
            vtotal, vcount = 0.0, 0
            with torch.no_grad():
                for i in val_sampler.indices():
                    X, lbl = _collect(test_dataset, [i])
                    y, _ = net(X)
                    vtotal += float(_losses(
                        y, lbl, n_classes, log_var, seg_trainable, cw,
                        use_uncertainty_weighting)[0])
                    vcount += 1
            reduced = all_reduce_sum(np.array([vtotal, float(vcount)],
                                              np.float64))
            val = float(reduced[0]) / max(float(reduced[1]), 1.0)
            test_losses[iepoch] = val
            train_logger.info(f"Epoch {iepoch}, Validation Loss: {val:.4f}")
            if val < best_val_loss:
                best_val_loss = val
                _save(checkpoint_best, iepoch)

        _save(checkpoint_last, iepoch)
        if save_each and iepoch % save_every == 0:
            _save(model_dir / f"checkpoint_epoch_{iepoch}.train", iepoch)

    if is_main_process():
        save_params(net.state_dict(), str(filename), cfg)
        train_logger.info("saved final weights to %s", filename)
    barrier("classpose_final_weights")
    return str(filename), train_losses, test_losses
