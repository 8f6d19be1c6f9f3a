"""The readers of the program's spans and counters: each returns the
registry's seconds of its spans over the window's tiles or images, and
nothing, without raising, where the registry lacks them or the program
has no spans at all (an older version of it)."""

import sys

import pytest

from portbench import run

READERS = {m["name"]: m for m in run.manifest()["per_layer"]
           if m["source"] in ("program_span", "program_counter")
           and m["name"] not in ("wsi.post_cpu_s_per_tile",
                                 "wsi.tail_s_per_tile")}


def _reader(name):
    return run.load_module(run.BENCH / "metrics" / f"{name}.py")


def _ctx(n, per):
    return dict(trace=object(), cell=None,
                result={"counters": {per: n, "crops": 25 * n}})


def test_eight_readers():
    assert len(READERS) == 8


@pytest.mark.parametrize("name", sorted(READERS))
def test_reader_divides_the_registry(name, monkeypatch):
    import classpose_tpu_torch.tracing as tracing

    mod = _reader(name)
    per = "tiles" if mod.MOVES == "slide_tiles_per_s" else "images"
    reg = {k: (1.5 + i, 3 + i) for i, k in enumerate(mod.SPANS)}
    reg["other.span"] = (100.0, 1)
    monkeypatch.setattr(tracing, "profiled", lambda: dict(reg))
    want = sum(reg[k][0] for k in mod.SPANS) / 7
    assert mod.read(_ctx(7, per)) == pytest.approx(want)
    assert mod.read(_ctx(0, per)) is None
    assert mod.read(dict(_ctx(7, per), trace=None)) is None
    monkeypatch.setattr(tracing, "profiled", lambda: {"other.span": (1, 1)})
    assert mod.read(_ctx(7, per)) is None


@pytest.mark.parametrize("name", sorted(READERS))
def test_reader_of_a_program_without_spans(name, monkeypatch):
    monkeypatch.setitem(sys.modules, "classpose_tpu_torch.tracing", None)
    mod = _reader(name)
    per = "tiles" if mod.MOVES == "slide_tiles_per_s" else "images"
    assert mod.read(_ctx(7, per)) is None
