"""A run with the timed path broken underneath comes out not correct.

Each cell runs here on the CPU at a small size (a 2-block net at width
256, a 2 × 2-tile slide, two 600² images: large enough that one pixel
of rounding is under the mask limit), past the harness's look for a
card: a sound run is correct, and each fault of ``harness/faults.py``
that the cell's path can have makes ``correct`` false: an answer altered
where it is produced (the net's flow output shifted; every 8th instance
dropped from the finished masks; every 8th class vote moved; every 8th
exported cell moved), half of the batch left out with the mean of the
rest in its place, and the flow-error QC gone wrong. Inference keeps no
state and the cells run on one chip, so the faults of a step that
returns its state unchanged and of a missing exchange between chips do
not apply.

A run in which the check or a metric reader loads JAX after the window
prints no result."""

import sys
import types

import pytest
import torch

from portbench import run
from portbench.harness import compare, faults

SEED = 2 ** 31 + 12345
TINY = {"embed_dim": 256, "depth": 2, "num_heads": 4, "neck_dim": 256}
PARAMS = {
    "wsi.conic-bf16.slide40x": {"slide_px": 1969, "tile_size": 512,
                                "nuclei": 150, "check_tiles": 2,
                                "check_margin_px": 64},
    "eval.consep-fp32.images1000": {"images": 2, "image_px": 600,
                                    "nuclei": 60, "check_images": 2},
}
CASES = [(cell, fault) for cell in sorted(PARAMS)
         for fault in faults.FOR_DRIVER[run.workload_file(cell)["driver"]]]


def _run(cell, seconds=0.1):
    return run.run_cell(cell, SEED, seconds, False, device="cpu",
                        overrides={"model": TINY, "params": PARAMS[cell]})


@pytest.mark.parametrize("cell", sorted(PARAMS))
def test_sound_run_is_correct(cell):
    out = _run(cell)
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0


@pytest.mark.parametrize("cell,fault", CASES,
                         ids=[f"{c}-{f}" for c, f in CASES])
def test_fault_is_not_correct(cell, fault):
    with faults.planted(fault):
        out = _run(cell)
    assert not out["correct"], out["checks"]


def test_faults_leave_the_program_as_it_was():
    from classpose_tpu_torch.nn import vit_sam
    from classpose_tpu_torch.runner import model

    before = (vit_sam.ClassTransformer.forward,
              model.compute_class_masks_from_pixels, model.qc_filter_masks)
    for name in faults.FAULTS:
        with faults.planted(name):
            pass
    assert (vit_sam.ClassTransformer.forward,
            model.compute_class_masks_from_pixels,
            model.qc_filter_masks) == before


def test_jax_loaded_by_the_check_gives_no_result(monkeypatch, capsys):
    """The look for JAX before the result line catches what the reference
    check loads after the window."""
    cell = "eval.consep-fp32.images1000"
    max_gap, run_cell = compare.max_gap, run.run_cell

    def loading_gap(a, b):
        sys.modules.setdefault("jax", types.ModuleType("jax"))
        return max_gap(a, b)

    def cpu_run(name, seed, seconds, trace):
        return run_cell(name, seed, seconds, trace, device="cpu",
                        overrides={"model": TINY, "params": PARAMS[name]})

    monkeypatch.delitem(sys.modules, "jax", raising=False)
    monkeypatch.setattr(compare, "max_gap", loading_gap)
    monkeypatch.setattr(run, "run_cell", cpu_run)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(run, "device_info", lambda chips: {})
    try:
        rc = run.main(["--workload", cell, "--seed", str(SEED),
                       "--seconds", "0.1", "--trace", "0"])
    finally:
        sys.modules.pop("jax", None)
    captured = capsys.readouterr()
    assert rc != 0
    assert captured.out == ""
    assert "jax" in captured.err
