"""The evaluate CLI's path: ``ClassposeModel.eval`` on each image, as
``classpose_tpu_torch/entrypoints/run_inference.py`` calls it at its
defaults (``batch_size`` 8, flow threshold 0.4, cellprob threshold 0,
float32 input in HWC).

Set-up makes the test split's images from the seed, in memory, the
weights on the card and the model, and warms up on the first image. The
window cycles through the images until ``seconds`` have passed; the rate
is images over the window's wall. Each image's first results in the
window (masks, class masks, flows, cellprob, class logits) are kept; a
sample of them drawn from the seed is compared with the reference after
the window.
"""

from __future__ import annotations

import gc
import time

import numpy as np
import torch

from portbench.drivers.common import model_config
from portbench.harness import compare, inputs, weights
from portbench.reference import pipeline, tiles as tiles_mod


def _kwargs(cell) -> dict:
    t = cell.params
    return dict(batch_size=t["batch_size"],
                flow_threshold=t["flow_threshold"],
                cellprob_threshold=t["cellprob_threshold"])


def _picks(cell, done: int) -> list[int]:
    """The checked images: drawn from the seed among those the window
    ran."""
    rng = np.random.default_rng(cell.seed)
    n = min(done, cell.params["images"])
    k = min(n, cell.params["check_images"])
    return sorted(int(i) for i in rng.choice(n, k, replace=False))


def setup(cell) -> dict:
    from classpose_tpu_torch.runner import ClassposeModel

    t = cell.params
    images = [inputs.he_pixels(t["image_px"], t["image_px"], t["nuclei"],
                               cell.seed + i, cell.device).astype(np.float32)
              for i in range(t["images"])]
    sd = weights.make_weights(cell.config["model"], cell.config["weights"],
                              cell.seed, cell.device)
    model = ClassposeModel(cfg=model_config(cell), params=sd,
                           precision=cell.config["precision"],
                           device=cell.device)
    del sd
    model.eval(images[0], **_kwargs(cell))
    if cell.device.startswith("cuda"):
        torch.cuda.synchronize(cell.device)
    return dict(model=model, images=images, kept={})


def window(cell, state, seconds: float) -> dict:
    model, images, kept = state["model"], state["images"], state["kept"]
    kw = _kwargs(cell)
    n = 0
    t0 = time.perf_counter()
    while True:
        i = n % len(images)
        masks, flows, class_masks, _ = model.eval(images[i], **kw)
        if i not in kept:
            kept[i] = dict(masks=masks, class_masks=class_masks,
                           dP=flows[1], cellprob=flows[2], y_class=flows[3])
        n += 1
        if time.perf_counter() - t0 >= seconds:
            break
    wall = time.perf_counter() - t0
    side = cell.params["image_px"]
    crops = tiles_mod.compute_tile_grid(
        side, side, cell.config["model"]["bsize"]).ntiles
    return dict(attempted=n, failed=0,
                metrics={"eval_images_per_s": n / wall},
                counters=dict(images=n, crops=n * crops, wall_s=wall))


def release(cell, state) -> None:
    state.pop("model", None)
    gc.collect()
    if cell.device.startswith("cuda"):
        torch.cuda.empty_cache()


def check(cell, state, control: str | None = None) -> dict:
    """The numbers of the sampled images, each the worst image's: the
    program's outputs against the float32 reference, or with ``control``
    set, the reference in that arithmetic in the program's place."""
    m = cell.config["model"]
    t = cell.params
    sd = weights.make_weights(m, cell.config["weights"], cell.seed,
                              cell.device)
    out = {"flow_gap": 0.0, "flow_mean_gap": 0.0, "cellprob_gap": 0.0,
           "class_logit_gap": 0.0,
           "mask_disagree_pct": 0.0, "class_disagree_pct": 0.0}
    for i in _picks(cell, len(state["kept"])):
        ref = pipeline.segment_image(sd, m, state["images"][i], "fp32",
                                     cell.device, block=t["ref_block"])
        got = state["kept"][i] if control is None else pipeline.segment_image(
            sd, m, state["images"][i], control, cell.device,
            block=t["ref_block"])
        row = {"flow_gap": compare.max_gap(got["dP"], ref["dP"]),
               "flow_mean_gap": compare.mean_gap(got["dP"], ref["dP"]),
               "cellprob_gap": compare.max_gap(got["cellprob"],
                                               ref["cellprob"]),
               "class_logit_gap": compare.max_gap(got["y_class"],
                                                  ref["y_class"]),
               "mask_disagree_pct": compare.mask_disagree_pct(
                   got["masks"], ref["masks"]),
               "class_disagree_pct": compare.class_disagree_pct(
                   got["masks"], ref["masks"], got["class_masks"],
                   ref["class_masks"])}
        out = {k: max(out[k], v) for k, v in row.items()}
    return out
