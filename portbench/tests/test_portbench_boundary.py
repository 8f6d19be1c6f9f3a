"""Nothing the benchmark runs imports JAX or the JAX package, and the
reference imports nothing of the program: top-level module names,
compared whole (``classpose_tpu_torch`` is not ``classpose_tpu``)."""

import ast
import os
import subprocess
import sys

from portbench import run

FORBIDDEN = {"jax", "jaxlib", "flax", "classpose_tpu"}


def imported_tops(path):
    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            tops.add(node.module.split(".")[0])
    return tops


def test_no_module_imports_jax_or_the_jax_package():
    files = sorted(run.BENCH.rglob("*.py"))
    assert len(files) > 20
    for f in files:
        assert not imported_tops(f) & FORBIDDEN, f


def test_reference_imports_nothing_of_the_program():
    for f in sorted((run.BENCH / "reference").rglob("*.py")):
        tops = imported_tops(f)
        assert "classpose_tpu_torch" not in tops, f
        assert tops <= {"__future__", "contextlib", "dataclasses", "math",
                        "numpy", "scipy", "torch", "portbench"}, (f, tops)


def test_whole_names(monkeypatch):
    """A loaded module is flagged by its whole top-level name only."""
    import types

    for name in ("classpose_tpu_torch_like", "jaxtyping_like.sub",
                 "flaxish"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "classpose_tpu.nn",
                        types.ModuleType("classpose_tpu.nn"))
    assert run.forbidden_modules() == ["classpose_tpu"]


def test_no_card_no_result():
    """Without a CUDA device run.py exits non-zero and prints no result
    (it never falls back to the CPU)."""
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    p = subprocess.run(
        [sys.executable, str(run.BENCH / "run.py"), "--workload",
         "wsi.conic-bf16.slide40x", "--seed", "1", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, env=env,
        cwd=run.ROOT, timeout=300)
    assert p.returncode != 0
    assert p.stdout == ""
    assert "CUDA device" in p.stderr
