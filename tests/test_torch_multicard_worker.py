"""Rank worker of ``tests/test_torch_multicard.py``, run by path under

    python -m torch.distributed.run --standalone --nproc_per_node 2 \\
        tests/test_torch_multicard_worker.py OUT_DIR
    python -m torch.distributed.run --standalone --nproc_per_node 2 \\
        tests/test_torch_multicard_worker.py --cli OUT_DIR ARG...

The first joins a gloo group on the CPU, checks the object and tensor
collectives, then trains a tiny network with ``train_class_seg`` at
global batch 8 on unaugmented items with uneven −100 class pixels under
class weights: without layer-drop, with layer-drop (depth 3, ``rdrop``
0.9), then 4 epochs straight and 2 epochs resumed for 2 more. It writes
``OUT_DIR/rank<r>.json``: per-step and per-epoch losses and a SHA-256 of
its final weights. The test runs :func:`train` at world size 1 in its own
process, and JAX ``train_class_seg``, for the references.

The second runs ``classpose_tpu_torch.entrypoints.run_training`` with the
ARGs and writes ``OUT_DIR/cli_rank<r>.json`` with a SHA-256 of the
weights the rank holds when ``train_class_seg`` returns.

pytest collects this module and finds no test in it.
"""

from __future__ import annotations

import hashlib
import json
import os
import sys
from pathlib import Path

import numpy as np
import torch

CFG = dict(n_cell_classes=3, embed_dim=32, depth=3, num_heads=2,
           neck_dim=16, bsize=64, rdrop=0.9)
PLAIN_CFG = {**CFG, "rdrop": 0.0}  # the run held against JAX
CLASS_WEIGHTS = np.array([0.5, 1.0, 2.0], np.float32)
N_TRAIN, N_VAL, SIZE, GLOBAL_BATCH = 16, 3, 64, 8


def make_data(n: int, seed: int) -> tuple[np.ndarray, np.ndarray]:
    """Images (n, 3, S, S) and labels (n, 5, S, S) [instance, class,
    binary, flow_y, flow_x] of random discs. Image i leaves
    ``i % 4`` of its discs unannotated and marks them −100, so the shares
    of a batch hold different numbers of −100 pixels."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:SIZE, :SIZE]
    imgs, labs = [], []
    for i in range(n):
        inst = np.zeros((SIZE, SIZE), np.float32)
        cls = np.zeros((SIZE, SIZE), np.float32)
        k = 0
        for _ in range(6):
            r = int(rng.integers(5, 10))
            cy, cx = (int(v) for v in rng.integers(r, SIZE - r, 2))
            m = ((yy - cy) ** 2 + (xx - cx) ** 2 <= r * r) & (inst == 0)
            if m.sum() < 10:
                continue
            k += 1
            inst[m] = k
            cls[m] = -100 if k <= i % 4 else int(rng.integers(1, 3))
        img = 200 - 60 * (inst > 0) + rng.uniform(0, 40, (3, SIZE, SIZE))
        flow = rng.uniform(-1, 1, (2, SIZE, SIZE)) * (inst > 0)
        imgs.append(img.astype(np.float32))
        labs.append(np.concatenate([inst[None], cls[None],
                                    (inst > 0)[None], flow]).astype(
                                        np.float32))
    return np.stack(imgs), np.stack(labs)


def weights_sha(sd: dict[str, torch.Tensor]) -> str:
    """SHA-256 of a ``state_dict``'s names, dtypes and values."""
    h = hashlib.sha256()
    for k in sorted(sd):
        v = sd[k].detach().cpu().contiguous()
        h.update(f"{k} {v.dtype}".encode())
        h.update(v.numpy().tobytes())
    return h.hexdigest()


def train(out_dir: str, name: str, n_epochs: int,
          resume: str | None = None, cfg: dict = CFG) -> dict:
    """``train_class_seg`` on :func:`make_data` (no augmentation) from the
    seed-0 weights of ``cfg``; every rank of a group calls it alike."""
    from classpose_tpu_torch.nn.vit_sam import ClassTransformerConfig
    from classpose_tpu_torch.runner import ClassposeModel
    from classpose_tpu_torch.train.dataset import ClassposeTrainingDataset
    from classpose_tpu_torch.train.train import train_class_seg

    imgs, labs = make_data(N_TRAIN + N_VAL, seed=1)
    kw = dict(augment=False, bsize=SIZE, seed=0)
    ds = ClassposeTrainingDataset(imgs[:N_TRAIN], labs[:N_TRAIN], **kw)
    val = ClassposeTrainingDataset(imgs[N_TRAIN:], labs[N_TRAIN:], **kw)
    model = ClassposeModel(cfg=ClassTransformerConfig(**cfg),
                           precision="fp32", device="cpu", seed=0)
    steps = []
    path, tl, vl = train_class_seg(
        model, ds, test_dataset=val, batch_size=GLOBAL_BATCH,
        n_epochs=n_epochs, learning_rate=1e-3, save_path=out_dir,
        model_name=name, class_weights=CLASS_WEIGHTS,
        use_uncertainty_weighting=True, validate_every_epoch=True,
        random_seed=0, resume_checkpoint=resume,
        on_step=lambda s, m: steps.append([s, m["total"], m["ce"]]))
    return dict(path=path, train=tl.tolist(), val=vl.tolist(), steps=steps,
                sha=weights_sha(model.net.state_dict()))


def main(out_dir: str) -> None:
    from classpose_tpu_torch.parallel.distributed import (
        all_reduce_mean,
        allgather_object,
        broadcast_object,
        setup_distributed,
        teardown_distributed,
    )

    ctx = setup_distributed("cpu")
    assert (ctx.world_size, ctx.backend, ctx.device) == \
        (2, "gloo", torch.device("cpu")), ctx
    blob = broadcast_object({"data": b"x" * 200_000, "n": 7}
                            if ctx.rank == 0 else None)
    assert len(blob["data"]) == 200_000 and blob["n"] == 7
    assert [g["rank"] for g in allgather_object({"rank": ctx.rank})] == [0, 1]
    assert float(all_reduce_mean(np.array([ctx.rank + 1.0]))[0]) == 1.5

    res = {"rank": ctx.rank,
           "plain": train(out_dir, "plain", 3, cfg=PLAIN_CFG),
           "drop": train(out_dir, "drop", 3),
           "straight4": train(f"{out_dir}/straight", "s4", 4),
           "first2": train(f"{out_dir}/resumable", "r", 2)}
    res["resumed"] = train(f"{out_dir}/resumable", "r", 4, resume=(
        f"{out_dir}/resumable/r/checkpoint_last.train"))
    Path(out_dir, f"rank{ctx.rank}.json").write_text(json.dumps(res))
    teardown_distributed()


def cli(out_dir: str, argv: list[str]) -> None:
    """The training CLI as ``torchrun`` runs it; records the weights this
    rank holds when ``train_class_seg`` returns."""
    import classpose_tpu_torch.train.train as train_mod
    from classpose_tpu_torch.entrypoints.run_training import main_with_args

    inner, shas = train_mod.train_class_seg, []

    def recording(model, *args, **kwargs):
        out = inner(model, *args, **kwargs)
        shas.append(weights_sha(model.net.state_dict()))
        return out

    train_mod.train_class_seg = recording
    main_with_args(argv)
    Path(out_dir, f"cli_rank{os.environ['RANK']}.json").write_text(
        json.dumps({"sha": shas}))


if __name__ == "__main__":
    if sys.argv[1] == "--cli":
        cli(sys.argv[2], sys.argv[3:])
    else:
        main(sys.argv[1])
