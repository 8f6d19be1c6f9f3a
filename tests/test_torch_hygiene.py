"""The port stands alone: no module of ``classpose_tpu_torch`` and not
``chip_smoke.py`` imports JAX, flax or the JAX package, nor a host
library the card's machine lacks (cv2, PIL, pandas, yaml, pydantic,
matplotlib, requests, shapely, openslide); its kernel and native sources
ship with the package."""

import ast
import pkgutil
import subprocess
import sys
from pathlib import Path

import classpose_tpu_torch

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "classpose_tpu")
HOST_LIBS = ("cv2", "PIL", "pandas", "yaml", "pydantic", "matplotlib",
             "requests", "shapely", "openslide")


def _forbidden(name: str, names=FORBIDDEN) -> bool:
    return any(name == f or name.startswith(f + ".") for f in names)


def _port_modules() -> list[str]:
    return [m.name for m in pkgutil.walk_packages(
        classpose_tpu_torch.__path__, "classpose_tpu_torch.")]


def _imported_names(path: Path) -> list[str]:
    """Every module an ``import`` statement in ``path`` names, at any
    depth (function-level imports included)."""
    names = []
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.append(node.module)
    return names


def test_port_modules_import_no_jax():
    mods = _port_modules()
    assert {"classpose_tpu_torch.runner.model",
            "classpose_tpu_torch.train.train",
            "classpose_tpu_torch.entrypoints.run_training",
            "classpose_tpu_torch.entrypoints.predict_wsi",
            "classpose_tpu_torch.pipeline.predict_wsi",
            "classpose_tpu_torch.native"} <= set(mods)
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "print('\\n'.join(sys.modules))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                         capture_output=True, text=True).stdout.split()
    assert not [m for m in out if _forbidden(m)]
    assert not [m for m in out if _forbidden(m, HOST_LIBS)]


def test_port_sources_name_no_missing_host_library():
    """No import statement of the port, not even one inside a function
    that the CPU tests never reach, names a library the card's machine
    lacks."""
    pkg = Path(classpose_tpu_torch.__file__).parent
    bad = {str(f.relative_to(ROOT)): n for f in pkg.rglob("*.py")
           for n in _imported_names(f) if _forbidden(n, HOST_LIBS)}
    assert not bad


def test_chip_smoke_imports_no_jax():
    names = _imported_names(ROOT / "chip_smoke.py")
    assert "classpose_tpu_torch.runner" in names
    assert "classpose_tpu_torch.entrypoints.predict_wsi" in names
    assert not [n for n in names if _forbidden(n)]
    assert not [n for n in names if _forbidden(n, HOST_LIBS)]


def test_kernel_sources_ship_with_the_package():
    from classpose_tpu_torch import _build

    for name in _build.SOURCES:
        assert (_build.CSRC / f"{name}.cu").is_file()
    assert (_build.CSRC / "mma.cuh").is_file()
    assert (_build.CSRC / "layernorm.cu").is_file()
    assert "layernorm" in _build.SOURCES
    assert set(_build.LAUNCHES) == {
        "attention_fwd", "attention_bwd", "bilinear_sample",
        "landing_histogram", "masked_diffusion", "layernorm"}


def test_native_source_ships_with_the_package():
    import tomllib

    from classpose_tpu_torch import native

    assert native._SRC.is_file() and native._SRC.parent.name == "native"
    data = tomllib.loads((ROOT / "pyproject.toml").read_text())
    pkg_data = data["tool"]["setuptools"]["package-data"]
    assert "native/*.cpp" in pkg_data["classpose_tpu_torch"]
    assert "csrc/*.cu" in pkg_data["classpose_tpu_torch"]


def test_native_builds_into_the_build_directory():
    """Built on first use into the git-ignored ``_build/``, named by the
    source's hash, never beside the source."""
    from classpose_tpu_torch import native

    lib = native.load_geomfast()
    assert lib is native.load_geomfast()
    assert native._target().parent == native.BUILD_DIR
    assert native._target().is_file()
    assert not list(native._SRC.parent.glob("*.so"))
