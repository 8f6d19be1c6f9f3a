"""Faults planted in the program underneath a run, each by name, for the
tests that see ``correct`` come out false and for the readings that set
the upper end of a limit (``calibrate.py --fault``).

- ``answer_altered``: the net's flowY output shifted by 1 where the net
  makes it.
- ``half_batch``: the net run on the first half of each chunk of crops,
  the mean of those in place of the rest.
- ``masks_altered``: every 8th instance dropped where the masks are
  finished (after the dynamics, the QC and fill-holes).
- ``qc_strict``: the flow-error QC a hundred times too strict (its
  recomputed flows as wrong as that), on kernel 4 in the WSI path and
  kernel 7 in the per-image path.
- ``class_altered``: every 8th instance's class vote moved to the next
  class.
- ``cells_altered``: every 8th cell the WSI path exports moved by 16 px
  (its polygon and centroid).
"""

from __future__ import annotations

import contextlib
import importlib

import numpy as np
import torch

STRIDE = 8  # the altered share: one instance or cell in STRIDE


def _mod(name: str):
    """The program's module ``classpose_tpu_torch.<name>``."""
    return importlib.import_module("classpose_tpu_torch." + name)


@contextlib.contextmanager
def _patched(targets, make):
    """``make(original)`` in place of each ``(object, attribute)``."""
    saved = [(obj, attr, getattr(obj, attr)) for obj, attr in targets]
    try:
        for obj, attr, orig in saved:
            setattr(obj, attr, make(orig))
        yield
    finally:
        for obj, attr, orig in saved:
            setattr(obj, attr, orig)


def _forward(make):
    vit_sam = _mod("nn.vit_sam")
    return _patched([(vit_sam.ClassTransformer, "forward")], make)


def answer_altered():
    def make(forward):
        def f(self, x, *a, **kw):
            out, style = forward(self, x, *a, **kw)
            out = out.clone()
            out[:, self.cfg.n_cell_classes] += 1.0
            return out, style
        return f
    return _forward(make)


def half_batch():
    def make(forward):
        def f(self, x, *a, **kw):
            n = max(1, x.shape[0] // 2)
            out, style = forward(self, x[:n], *a, **kw)
            rest = x.shape[0] - n
            return (torch.cat([out, out.mean(0, keepdim=True).expand(
                        rest, *out.shape[1:])]),
                    torch.cat([style, style[:1].expand(rest, -1)]))
        return f
    return _forward(make)


def masks_altered():
    masks, model = _mod("dynamics.masks"), _mod("runner.model")

    def make(fill):
        def f(m, *a, **kw):
            out = fill(m, *a, **kw)
            out[(out > 0) & (out % STRIDE == 0)] = 0
            return out
        return f
    return _patched([(model, "fill_holes_and_remove_small_masks"),
                     (masks, "fill_holes_and_remove_small_masks")], make)


@contextlib.contextmanager
def qc_strict():
    masks, model = _mod("dynamics.masks"), _mod("runner.model")

    def make_filter(qc):
        def f(raw, dP, flow_threshold=0.4, max_size_fraction=0.4):
            return qc(raw, dP, flow_threshold=flow_threshold / 100.0,
                      max_size_fraction=max_size_fraction)
        return f

    def make_errors(errors):
        def f(*a, **kw):
            return errors(*a, **kw) * 100.0
        return f

    with _patched([(model, "qc_filter_masks")], make_filter), \
            _patched([(masks, "flow_errors")], make_errors):
        yield


def class_altered():
    model = _mod("runner.model")

    def make(vote):
        def f(m, pixel_cls, n_classes):
            cm = vote(m, pixel_cls, n_classes)
            hit = (m > 0) & (m % STRIDE == 0)
            cm[hit] = (cm[hit] + 1) % n_classes
            return cm
        return f
    return _patched([(model, "compute_class_masks_from_pixels")], make)


def cells_altered():
    predict_wsi = _mod("pipeline.predict_wsi")

    def make(process_tile):
        def f(*a, **kw):
            cells, n_invalid = process_tile(*a, **kw)
            for c in cells[::STRIDE]:
                c["coords"] = (np.asarray(c["coords"]) + 16.0).tolist()
                c["centroid"] = [c["centroid"][0] + 16.0,
                                 c["centroid"][1] + 16.0]
            return cells, n_invalid
        return f
    return _patched([(predict_wsi, "process_tile")], make)


FAULTS = {f.__name__: f for f in (answer_altered, half_batch, masks_altered,
                                  qc_strict, class_altered, cells_altered)}
# the faults a cell's driver can have (cells_altered needs the WSI export)
FOR_DRIVER = {"wsi": tuple(FAULTS),
              "evaluate": tuple(k for k in FAULTS if k != "cells_altered")}


def planted(name: str):
    """A context in which fault ``name`` sits in the program."""
    return FAULTS[name]()
