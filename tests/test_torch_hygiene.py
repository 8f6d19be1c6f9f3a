"""The port stands alone: no module of ``classpose_tpu_torch`` and not
``chip_smoke.py`` imports JAX, flax or the JAX package."""

import ast
import pkgutil
import subprocess
import sys
from pathlib import Path

import classpose_tpu_torch

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "classpose_tpu")


def _forbidden(name: str) -> bool:
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


def test_port_modules_import_no_jax():
    mods = [m.name for m in pkgutil.walk_packages(
        classpose_tpu_torch.__path__, "classpose_tpu_torch.")]
    assert {"classpose_tpu_torch.runner.model",
            "classpose_tpu_torch.train.train",
            "classpose_tpu_torch.entrypoints.run_training"} <= set(mods)
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "print('\\n'.join(sys.modules))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                         capture_output=True, text=True).stdout.split()
    assert not [m for m in out if _forbidden(m)]


def test_chip_smoke_imports_no_jax():
    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.append(node.module)
    assert "classpose_tpu_torch.runner" in names
    assert not [n for n in names if _forbidden(n)]


def test_kernel_sources_ship_with_the_package():
    from classpose_tpu_torch import _build

    for name in _build.SOURCES:
        assert (_build.CSRC / f"{name}.cu").is_file()
    assert (_build.CSRC / "mma.cuh").is_file()
    assert set(_build.LAUNCHES) == {
        "attention_fwd", "attention_bwd", "bilinear_sample",
        "landing_histogram", "masked_diffusion"}
