#!/usr/bin/env python3
"""A/B of the one-card WSI pipeline between two copies of the package on
one card.

    python3 ab_wsi.py --old DIR [--rounds 2] [--out FILE]

``DIR`` holds another copy of ``classpose_tpu_torch`` (for a commit:
``git archive <rev> classpose_tpu_torch | tar -x -C _archive/<rev>``;
the card's copy of the repository has no ``.git/``, so unpack it before
the call). The new copy is the one beside this script. It writes the
WSI phase's slide of ``chip_smoke.py`` (step 6: 6144² synthetic at
0.4 µm/px, 25 tiles of 1024² at the config's 0.5 µm/px) and its seeded
ViT-L weights (``perturbed_structured_params`` with ``attn_ripple``, 6
classes) as an uncompressed ``.npz``, builds the kernels of both copies
(one process each, started together), then runs the WSI CLI
(``main_with_args``: bf16, ``--device cuda:0``, ``CLASSPOSE_LN_PALLAS=1``,
the WSI phase's flags) in a process of its own for each copy in turns
(old, new, new, old in each round). Every run must find the same cells as
the first. Prints the card's name and power limit, one line per run
(pipeline seconds, stage seconds, cells), then one JSON line with the
runs and each copy's median pipeline seconds; ``--out`` also writes it.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from unittest import mock

import numpy as np
import torch

HERE = Path(__file__).resolve().parent
SEED = 0
SLIDE_PX, SLIDE_MPP, MODEL_MPP, SLIDE_CELLS = 6144, 0.4, 0.5, 4000
RUN_LIMIT_S = 300

# one WSI run in a process of its own, on the package of its cwd
RUN = """
import json, sys
from classpose_tpu_torch.entrypoints.predict_wsi import main_with_args
r = main_with_args(sys.argv[1:])[0]
print("AB_RUN " + json.dumps({k: r[k] for k in
      ("seconds", "n_cells", "n_tiles", "stage_seconds")}))
"""
BUILD = """
from classpose_tpu_torch import _build
print(_build.build_all())
"""


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def env_for(tree: Path) -> dict:
    return {**os.environ, "PYTHONPATH": str(tree), "WSI_READER": "array",
            "CLASSPOSE_LN_PALLAS": "1"}


def build_both(trees: dict[str, Path]) -> None:
    procs = {name: subprocess.Popen(
        [sys.executable, "-c", BUILD], cwd=tree, env=env_for(tree),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for name, tree in trees.items()}
    for name, p in procs.items():
        out, _ = p.communicate(timeout=RUN_LIMIT_S)
        if p.returncode:
            raise SystemExit(f"ab_wsi: {name} build failed:\n{out[-3000:]}")
        log(f"{name} build: {out.strip().splitlines()[-1]}")


def write_inputs(work: Path) -> list[str]:
    """The slide, the weights and the config; returns the CLI's flags."""
    from classpose_tpu_torch.io.array_reader import synthetic_wsi
    from classpose_tpu_torch.model_configs import DEFAULT_MODEL_CONFIGS
    from classpose_tpu_torch.nn.convert import save_params
    from classpose_tpu_torch.nn.synthetic import perturbed_structured_params
    from classpose_tpu_torch.nn.vit_sam import ClassTransformerConfig

    slide, _ = synthetic_wsi(width=SLIDE_PX, height=SLIDE_PX,
                             n_cells=SLIDE_CELLS, mpp=SLIDE_MPP, seed=SEED)
    np.save(work / "slide.npy", slide._level0)
    cfg = ClassTransformerConfig(n_cell_classes=6, dtype="bfloat16")
    sd = perturbed_structured_params(cfg, ripple=0.5, seed=SEED,
                                     attn_ripple=0.5)
    # uncompressed: zlib takes about a minute on ViT-L's weights
    with mock.patch.object(np, "savez_compressed", np.savez):
        save_params(sd, str(work / "vitl.npz"), cfg)
    labels = DEFAULT_MODEL_CONFIGS["conic"]["cell_types"]
    (work / "config.yaml").write_text(
        f"path: {work}/vitl.npz\nmpp: {MODEL_MPP}\ncell_types:\n"
        + "".join(f"- {c}\n" for c in labels))
    return ["--model_config", str(work / "config.yaml"),
            "--slide_path", str(work / "slide.npy"), "--device", "cuda:0",
            "--precision", "bf16", "--batch_size", "32", "--tile_size",
            "1024", "--overlap", "64", "--mpp", str(SLIDE_MPP),
            "--output_type", "csv", "spatialdata"]


def run_once(tree: Path, argv: list[str], out: Path) -> dict:
    t0 = time.perf_counter()
    p = subprocess.run(
        [sys.executable, "-c", RUN, *argv, "--output_folder", str(out)],
        cwd=tree, env=env_for(tree), capture_output=True, text=True,
        timeout=RUN_LIMIT_S)
    wall = time.perf_counter() - t0
    lines = [ln for ln in p.stdout.splitlines() if ln.startswith("AB_RUN ")]
    if p.returncode or not lines:
        raise SystemExit(f"ab_wsi: run in {tree} failed (rc {p.returncode})"
                         f":\n{p.stderr[-4000:]}")
    return {**json.loads(lines[-1][len("AB_RUN "):]), "process_s": wall}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--old", required=True,
                    help="directory holding the other classpose_tpu_torch")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--out", help="also write the JSON line here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("ab_wsi: no CUDA device")
    old = Path(args.old).resolve()
    if not (old / "classpose_tpu_torch").is_dir():
        raise SystemExit(f"ab_wsi: no classpose_tpu_torch in {old}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    print(smi)
    trees = {"old": old, "new": HERE}
    build_both(trees)
    runs = []
    with tempfile.TemporaryDirectory() as tmp:
        work = Path(tmp)
        argv = write_inputs(work)
        order = ["old", "new", "new", "old"] * args.rounds
        for i, name in enumerate(order):
            r = run_once(trees[name], argv, work / f"out{i}")
            r["copy"] = name
            runs.append(r)
            log(f"{i} {name}: {r['seconds']:.3f} s, {r['n_cells']} cells, "
                f"stages {r['stage_seconds']}, process {r['process_s']:.1f} s")
            if (r["n_cells"], r["n_tiles"]) != (runs[0]["n_cells"],
                                                runs[0]["n_tiles"]):
                raise SystemExit(f"ab_wsi: run {i} found {r['n_cells']} "
                                 f"cells, run 0 {runs[0]['n_cells']}")
    result = {"card": smi, "old": str(old), "runs": runs, "median_s": {
        name: statistics.median(r["seconds"] for r in runs
                                if r["copy"] == name) for name in trees}}
    line = json.dumps(result)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
