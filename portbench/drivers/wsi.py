"""The WSI CLI's path as QuPath drives it:
``classpose_tpu_torch.pipeline.predict_wsi.main(args,
model_override=model)`` with ``args`` from the CLI's own parser, on
synthetic slides read by the array reader (``WSI_READER=array``).

Set-up makes one slide from the seed (``.npy`` under the run's
directory), the weights on the card and the model, and warms up on a
slide of 3 × 3 tiles cut from it (batches of 8 and 1 tiles, the shapes
the measured slides take). The window runs the slide through ``main``
back to back until ``seconds`` have passed; the rate counts the tiles of
every slide started in the window over the wall to the end of the last.

The first slide of the window is the one checked: a delegating wrapper
on the model keeps each tile's blended flows (the net's output, from
``_device_program``) and its masks and class masks (``eval_batch``),
keyed by the tile's first pixels; ``main`` returns its cells. After the
window the reference reads the sampled tiles from the slide again and
segments them at float32.
"""

from __future__ import annotations

import gc
import os
import threading
import time
from pathlib import Path

import numpy as np
import torch

from portbench.drivers.common import model_config
from portbench.harness import compare, inputs, weights
from portbench.reference import pipeline, slide as ref_slide
from portbench.reference import tiles as tiles_mod

FINGERPRINT = 8  # the tile's top-left FINGERPRINT² pixels identify it
NUMBERS = ("flow_gap", "flow_mean_gap", "mask_disagree_pct",
           "class_disagree_pct", "cells_mismatch_pct")


def _plan(cell):
    t = cell.params
    return ref_slide.tile_plan(t["slide_px"], t["slide_px"], t["slide_mpp"],
                               cell.config["mpp"], t["tile_size"],
                               t["overlap"])


class _Capture:
    """Delegating wrapper state: while ``on``, every tile's outputs."""

    def __init__(self):
        self.on = False
        self.tiles: list[dict] = []
        self.lock = threading.Lock()
        self.local = threading.local()


def _instrument(model, cap: _Capture) -> None:
    device_program = model._device_program
    eval_batch = model.eval_batch

    def _device_program_kept(x, *a, **kw):
        out = device_program(x, *a, **kw)
        if cap.on:
            cap.local.kept = (x[:, :FINGERPRINT, :FINGERPRINT].clone(),
                              out[2])
        return out

    def _eval_batch_kept(tiles, *a, **kw):
        cap.local.kept = None
        results = eval_batch(tiles, *a, **kw)
        kept = cap.local.kept
        if cap.on and kept is not None:
            fps, dP = kept
            with cap.lock:
                for b, (masks, cm) in enumerate(results):
                    cap.tiles.append(dict(fp=fps[b], dP=dP[b], masks=masks,
                                          class_masks=cm))
        return results

    model._device_program = _device_program_kept
    model.eval_batch = _eval_batch_kept


def _args(cell, slide_path: str, out_dir: Path):
    from classpose_tpu_torch.entrypoints.predict_wsi import build_parser
    from classpose_tpu_torch.model_configs import ModelConfig

    t = cell.params
    argv = ["--model_config", "conic", "--slide_path", slide_path,
            "--output_folder", str(out_dir),
            "--tile_size", str(t["tile_size"]), "--overlap", str(t["overlap"]),
            "--batch_size", str(t["batch_size"]),
            "--precision", cell.config["precision"],
            "--mpp", str(t["slide_mpp"]),
            "--output_type", *t["output_type"]]
    if cell.device != "cuda":  # QuPath passes no --device: the first card
        argv += ["--device", cell.device]
    args = build_parser().parse_args(argv)
    args.slide_path = slide_path  # one slide a call, as main_with_args does
    args.model_config = ModelConfig(path=str(out_dir / "weights-on-device"),
                                    mpp=cell.config["mpp"],
                                    cell_types=cell.config["cell_types"])
    return args


def setup(cell) -> dict:
    from classpose_tpu_torch.pipeline.predict_wsi import main
    from classpose_tpu_torch.runner import ClassposeModel
    from classpose_tpu_torch.utils import get_device

    os.environ["WSI_READER"] = "array"
    t = cell.params
    plan = _plan(cell)
    px = inputs.he_pixels(t["slide_px"], t["slide_px"], t["nuclei"],
                          cell.seed, cell.device)
    slide_path = cell.workdir / "slide.npy"
    np.save(slide_path, px)
    warm_px = plan["read"] + 2 * (plan["origins"][1][1]
                                  - plan["origins"][0][1])
    warm_path = cell.workdir / "warm.npy"
    np.save(warm_path, px[:warm_px, :warm_px])
    del px
    sd = weights.make_weights(cell.config["model"], cell.config["weights"],
                              cell.seed, cell.device)
    out = cell.workdir / "out"
    warm_args = _args(cell, str(warm_path), out)
    # the card the CLI builds its model on (main_with_args: get_device)
    model = ClassposeModel(cfg=model_config(cell), params=sd,
                           precision=cell.config["precision"],
                           device=get_device(warm_args.device))
    del sd
    cap = _Capture()
    _instrument(model, cap)
    main(warm_args, model_override=model)
    return dict(model=model, cap=cap, main=main, plan=plan,
                args=_args(cell, str(slide_path), out),
                slide_path=slide_path, cells=None)


def window(cell, state, seconds: float) -> dict:
    main, model, cap = state["main"], state["model"], state["cap"]
    plan = state["plan"]
    per_slide = len(plan["origins"])
    b = cell.config["model"]["bsize"]
    crops = tiles_mod.compute_tile_grid(plan["out"], plan["out"], b).ntiles
    stages: dict[str, float] = {}
    tiles = slides = cells = 0
    cap.on = True
    t0 = time.perf_counter()
    while True:
        res = main(state["args"], model_override=model)
        if slides == 0:
            cap.on = False
            state["cells"] = res["features"]
        slides += 1
        tiles += res["n_tiles"]
        cells += res["n_cells"]
        for k, v in res["stage_seconds"].items():
            stages[k] = stages.get(k, 0.0) + v
        if time.perf_counter() - t0 >= seconds:
            break
    wall = time.perf_counter() - t0
    return dict(attempted=slides * per_slide,
                failed=slides * per_slide - tiles,
                metrics={"slide_tiles_per_s": tiles / wall},
                counters=dict(tiles=tiles, slides=slides, cells=cells,
                              crops=tiles * crops, stage_seconds=stages,
                              wall_s=wall))


def release(cell, state) -> None:
    """Keep the checked tiles' outputs on the host; free the program."""
    for t in state["cap"].tiles:
        t["fp"] = t["fp"].cpu().numpy()
        t["dP"] = t["dP"].float().cpu().numpy()
    state["tiles"] = state["cap"].tiles
    for k in ("model", "cap", "main"):
        state.pop(k, None)
    gc.collect()
    if cell.device.startswith("cuda"):
        torch.cuda.empty_cache()


def _cells_from_features(features, labels) -> np.ndarray:
    index = {name: i for i, name in enumerate(labels)}
    out = np.empty((len(features), 3))
    for n, f in enumerate(features):
        meas = {m["name"]: m["value"]
                for m in f["properties"]["measurements"]}
        out[n] = (meas["centroidX"], meas["centroidY"],
                  index[f["properties"]["classification"]["name"]])
    return out


def check(cell, state, control: str | None = None) -> dict:
    """The numbers of the sampled tiles, each the worst tile's: the
    program's outputs against the float32 reference, or with ``control``
    set, the reference in that arithmetic in the program's place."""
    t = cell.params
    plan = state["plan"]
    m = cell.config["model"]
    rng = np.random.default_rng(cell.seed)
    picks = rng.choice(len(plan["origins"]), t["check_tiles"], replace=False)
    slide = np.load(state["slide_path"], mmap_mode="r")
    sd = weights.make_weights(m, cell.config["weights"], cell.seed,
                              cell.device)
    got_cells = _cells_from_features(state["cells"],
                                     cell.config["cell_types"])
    margin = t["check_margin_px"] * plan["scale"]
    side = plan["out"] * plan["scale"]
    gaps, means, mask_pct, cls_pct, cells_pct, n_ref = [], [], [], [], [], 0
    for k in picks:
        origin = plan["origins"][int(k)]
        tile = ref_slide.read_tile(slide, origin, plan["read"], plan["out"])
        kept = [x for x in state["tiles"]
                if np.array_equal(x["fp"], tile[:FINGERPRINT, :FINGERPRINT])]
        if len(kept) != 1:  # a tile that never came, or came twice
            return {k: float("inf") for k in NUMBERS}
        ref = pipeline.segment_tile(sd, m, tile, "fp32", cell.device,
                                    block=t["ref_block"])
        if control is None:
            got = kept[0]
            got_c = got_cells
        else:
            got = pipeline.segment_tile(sd, m, tile, control, cell.device,
                                        block=t["ref_block"])
            got_c = compare.cells_from_masks(
                got["masks"], np.maximum(got["class_masks"] - 1, 0), origin,
                plan["scale"])
        ref_c = compare.cells_from_masks(
            ref["masks"], np.maximum(ref["class_masks"] - 1, 0), origin,
            plan["scale"])
        gaps.append(compare.max_gap(got["dP"], ref["dP"]))
        means.append(compare.mean_gap(got["dP"], ref["dP"]))
        mask_pct.append(compare.mask_disagree_pct(got["masks"],
                                                  ref["masks"]))
        cls_pct.append(compare.class_disagree_pct(
            got["masks"], ref["masks"], got["class_masks"],
            ref["class_masks"]))
        box = (origin[0] + margin, origin[1] + margin,
               origin[0] + side - margin, origin[1] + side - margin)
        pct, n = compare.cells_mismatch_pct(ref_c, got_c, box,
                                            t["cell_tol_px"])
        cells_pct.append(pct * n)
        n_ref += n
    return {"flow_gap": max(gaps), "flow_mean_gap": max(means),
            "mask_disagree_pct": max(mask_pct),
            "class_disagree_pct": max(cls_pct),
            "cells_mismatch_pct": sum(cells_pct) / max(n_ref, 1)}
