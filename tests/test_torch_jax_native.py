"""The parity tests' hold on the JAX package's native geometry core
(``tests/golden/jax_native.py``): a worker whose shared ``_geomfast.so``
is cut short, or whose loader cached a failed load, still compares the
port against the JAX *native* path; where that path cannot be had the
helper fails the test instead of skipping it or falling back to numpy."""

import ctypes

import numpy as np
import pytest

import classpose_tpu.geometry as jgeom
import classpose_tpu.native as jnative
import classpose_tpu_torch.geometry as pgeom
from golden import jax_native


def _rings(seed, n):
    rng = np.random.default_rng(seed)
    for _ in range(n):
        c = rng.uniform(0, 1000, 2)
        ang = np.sort(rng.uniform(0, 2 * np.pi, 7))
        r = rng.uniform(5, 60, 7)
        yield c + np.stack([r * np.cos(ang), r * np.sin(ang)], 1)


def _metrics_match():
    for r in _rings(2, 20):
        hole = r.mean(0) + (r - r.mean(0)) * 0.2
        a, b = jgeom.Polygon(r, holes=[hole]), pgeom.Polygon(r, holes=[hole])
        assert (a.area, a.length, a.centroid, a.bounds, a.is_valid) == \
            (b.area, b.length, b.centroid, b.bounds, b.is_valid)


def _fallback_differs():
    """The numpy fallback's metrics are not the port's: a comparison on
    it would fail (which is how the race showed)."""
    return any(
        (a.area, a.length, a.centroid) != (b.area, b.length, b.centroid)
        for r in _rings(2, 20)
        for a, b in [(jgeom.Polygon(r, holes=[r.mean(0) + (r - r.mean(0))
                                              * 0.2]),
                      pgeom.Polygon(r, holes=[r.mean(0) + (r - r.mean(0))
                                              * 0.2]))])


@pytest.fixture
def shared_cut_short(tmp_path, monkeypatch):
    """The JAX loader's shared library path holds a file cut short (a
    linker of another worker half way through), and nothing is loaded."""
    shared = tmp_path / "shared" / "_geomfast.so"
    shared.parent.mkdir()
    shared.write_bytes(b"\x7fELF\x02\x01\x01")
    monkeypatch.setattr(jnative, "_SO", shared)
    monkeypatch.setattr(jnative, "_lib", False)
    return shared


def test_cut_short_library_falls_back_without_the_helper(shared_cut_short):
    """The fault itself: the JAX loader opens the cut file, caches the
    failure and serves numpy, whose metrics differ from the port's."""
    assert jnative.load_geomfast() is None
    assert jnative.load_geomfast() is None  # cached for the worker's life
    assert _fallback_differs()


def test_helper_loads_a_private_copy(shared_cut_short, tmp_path):
    lib = jax_native.load_private(tmp_path / "private")
    assert isinstance(lib, ctypes.CDLL)
    assert (tmp_path / "private" / "_geomfast.so").stat().st_size > 1000
    assert jnative._SO == shared_cut_short  # the module's path restored
    assert shared_cut_short.stat().st_size == 7  # the shared file untouched
    assert jnative.load_geomfast() is lib  # the handle stays loaded
    _metrics_match()


def test_helper_replaces_a_cached_failure(shared_cut_short, tmp_path):
    assert jnative.load_geomfast() is None
    lib = jax_native.load_private(tmp_path / "private")
    assert isinstance(lib, ctypes.CDLL) and jnative._lib is lib
    _metrics_match()


def test_helper_keeps_a_loaded_library(tmp_path, monkeypatch):
    lib = jax_native.load_private(tmp_path / "first")
    monkeypatch.setattr(jnative, "_SO", tmp_path / "elsewhere.so")
    assert jax_native.load_private(tmp_path / "second") is lib
    assert not (tmp_path / "second").exists()


@pytest.mark.parametrize("cause", ["no_source", "disabled"])
def test_helper_fails_instead_of_skipping(cause, shared_cut_short, tmp_path,
                                          monkeypatch):
    """No build (the source missing, or ``CLASSPOSE_NATIVE_GEOM=0``): the
    helper raises pytest's failure, never a skip, and leaves the loader's
    path as it was."""
    if cause == "no_source":
        monkeypatch.setattr(jnative, "_SRC", tmp_path / "missing.cpp")
    else:
        monkeypatch.setenv("CLASSPOSE_NATIVE_GEOM", "0")
    with pytest.raises(pytest.fail.Exception, match="native geometry core"):
        jax_native.load_private(tmp_path / "private")
    assert jnative._SO == shared_cut_short
