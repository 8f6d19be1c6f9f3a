"""The port stands alone: no module of ``classpose_tpu_torch``, not
``chip_smoke.py``, ``ab_attention.py`` (which it imports) or ``ab_wsi.py``
imports JAX, flax or the JAX package, nor a host library the card's
machine lacks (cv2, PIL, pandas, sklearn, yaml, pydantic, matplotlib,
requests, shapely, openslide, h5py, zstandard, pylibCZIrw); its kernel
and native sources ship with the package."""

import ast
import pkgutil
import subprocess
import sys
from pathlib import Path

import classpose_tpu_torch

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "classpose_tpu")
HOST_LIBS = ("cv2", "PIL", "pandas", "sklearn", "yaml", "pydantic",
             "matplotlib", "requests", "shapely", "openslide", "h5py",
             "zstandard", "pylibCZIrw")


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
    # and the A/B module it takes its timing helpers from
    assert "ab_attention" in names
    names += _imported_names(ROOT / "ab_attention.py")
    # and the one-card WSI A/B harness
    names += _imported_names(ROOT / "ab_wsi.py")
    assert not [n for n in names if _forbidden(n)]
    assert not [n for n in names if _forbidden(n, HOST_LIBS)]


def test_kernel_sources_ship_with_the_package():
    from classpose_tpu_torch import _build

    import re

    for name in _build.SOURCES:
        assert (_build.CSRC / f"{name}.cu").is_file()
    # every header a kernel source includes from csrc ships beside it
    for src in _build.CSRC.glob("*.cu*"):
        for header in re.findall(r'#include "([^"]+)"', src.read_text()):
            assert (_build.CSRC / header).is_file(), (src.name, header)
    assert (_build.CSRC / "sm90.cuh").is_file()
    assert (_build.CSRC / "attn_fwd.cuh").is_file()
    assert (_build.CSRC / "layernorm.cu").is_file()
    assert "layernorm" in _build.SOURCES
    assert set(_build.LAUNCHES) == {
        "attention_fwd", "attention_bwd", "bilinear_sample",
        "landing_histogram", "masked_diffusion", "layernorm",
        "diffuse_blocked", "flash_attention_relpos"}


def test_kernel_signatures_match_the_sources():
    """Every ctypes binding names an ``extern "C"`` function of its source
    with as many parameters, pointers where the C side takes pointers;
    a binding that disagrees would fail only on the card."""
    import ctypes
    import re

    from classpose_tpu_torch import _build

    decls = {}
    for name in _build.SOURCES:
        src = (_build.CSRC / f"{name}.cu").read_text()
        for fn, params in re.findall(r'extern "C" int (\w+)\(([^)]*)\)', src):
            decls[fn] = (name, [p.strip() for p in params.split(",")
                                if p.strip() and p.strip() != "void"])
    for fn, (owner, argtypes) in _build._SIGNATURES.items():
        assert decls[fn][0] == owner, fn
        params = decls[fn][1]
        assert len(params) == len(argtypes), fn
        for p, t in zip(params, argtypes):
            assert ("*" in p) == (t is ctypes.c_void_p), (fn, p)


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


def _entry_points_with_stream() -> set[str]:
    """The C entry points that launch work (those that take a stream):
    the package's bindings and ``ab_attention.py``'s bindings of earlier
    bodies (``OLD_SIGNATURES``; the argument-less depth queries launch
    nothing)."""
    from classpose_tpu_torch import _build

    names = set(_build._SIGNATURES)
    tree = ast.parse((ROOT / "ab_attention.py").read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and any(
                getattr(t, "id", None) == "OLD_SIGNATURES"
                for t in node.targets):
            for key, val in zip(node.value.keys, node.value.values):
                if val.elts[1].elts:
                    names.add(key.value)
    assert "diffusion_resident_round" in names
    return names


def test_every_launch_goes_through_the_device_setting_helper():
    """No module outside ``_build.py`` (the package, ``chip_smoke.py``,
    ``ab_attention.py``) calls a kernel's C entry point, or reads a CUDA
    stream for one, except through ``_build.call``: the C side launches
    on the calling thread's current device and sizes its grids and
    shared-memory limits for it, and ``call`` makes the tensors' card
    current first."""
    entry = _entry_points_with_stream()
    pkg = Path(classpose_tpu_torch.__file__).parent
    files = [f for f in pkg.rglob("*.py") if f.name != "_build.py"]
    files += [ROOT / "chip_smoke.py", ROOT / "ab_attention.py"]
    bad, calls = [], {}
    for f in files:
        rel = str(f.relative_to(ROOT))
        for node in ast.walk(ast.parse(f.read_text())):
            if isinstance(node, ast.Attribute) and node.attr in (
                    "cuda_stream", "stream_ptr"):
                bad.append((rel, node.lineno, node.attr))
            if not isinstance(node, ast.Call):
                continue
            fn = node.func
            if isinstance(fn, ast.Attribute) and fn.attr in entry:
                bad.append((rel, node.lineno, fn.attr))
            if isinstance(fn, ast.Call) and getattr(fn.func, "id",
                                                    None) == "getattr":
                bad.append((rel, node.lineno, "getattr(...)(...)"))
            if isinstance(fn, ast.Attribute) and fn.attr == "call" \
                    and getattr(fn.value, "id", None) == "_build":
                calls[rel] = calls.get(rel, 0) + 1
    assert not bad
    # every wrapper module launches through the helper
    assert {"classpose_tpu_torch/ops/sample.py": 2,
            "classpose_tpu_torch/ops/diffusion.py": 2,
            "classpose_tpu_torch/nn/attention.py": 3,
            "classpose_tpu_torch/nn/layernorm.py": 1}.items() \
        <= calls.items()


def test_launch_helper_sets_the_device(monkeypatch):
    """``_build.call`` enters the tensors' device, passes that device's
    current stream after the arguments and before ``tail``, and raises on
    an error code."""
    import contextlib

    import pytest
    import torch

    from classpose_tpu_torch import _build

    seen = []

    @contextlib.contextmanager
    def device(d):
        seen.append(("enter", d))
        yield
        seen.append(("exit", d))

    class Stream:
        def __init__(self, d):
            self.cuda_stream = 1000 + d.index

    class Lib:
        @staticmethod
        def kern(*args):
            seen.append(("launch", args))
            return args[0]

    monkeypatch.setattr(torch.cuda, "device", device)
    monkeypatch.setattr(torch.cuda, "current_stream", Stream)
    card = torch.device("cuda", 1)
    _build.call(Lib, "kern", card, 0, 7, tail=(9,))
    assert seen == [("enter", card), ("launch", (0, 7, 1001, 9)),
                    ("exit", card)]
    with pytest.raises(RuntimeError, match="CUDA error 5 launching kern"):
        _build.call(Lib, "kern", card, 5)
