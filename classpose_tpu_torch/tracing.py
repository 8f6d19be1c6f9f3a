"""Spans and counters of the port's stages.

``span(name, into=None, args=None)`` times a stage. With ``into`` (a
dict of seconds that one call owns, such as the stage totals of one WSI
``main``) it always adds the host seconds there. While a profile records
it also opens ``torch.profiler.record_function("classpose." + name,
args)``, which puts the span on the profiler's clock beside the device's
kernels, and adds (seconds, count) to a process-wide registry that
:func:`profiled` reads. Otherwise it reads one flag and does nothing
else, so an unprofiled run pays next to nothing for its spans.

``add(name, seconds, into=None)`` records a wait measured across threads
(from a queue's put to its get) in the same places.

Seconds on several threads add up as thread-seconds. The registry and
every ``into`` dict are written under one lock, so a dict that several
threads share (a ``DeviceWorker``'s) loses no update. A profile sees a
span on a thread other than the one that started it only when it
profiles all threads (``--profile`` does); the registry counts it
either way.
"""

from __future__ import annotations

import threading
import time

import torch.autograd.profiler as _autograd_profiler
from torch.profiler import record_function

PREFIX = "classpose."

_lock = threading.Lock()
_profiled: dict[str, list] = {}  # name -> [seconds, count]


def recording() -> bool:
    """Whether a profile records now (on any thread)."""
    return _autograd_profiler._is_profiler_enabled


def _record(name: str, seconds: float, into: dict | None,
            profiled: bool) -> None:
    with _lock:
        if into is not None:
            into[name] = into.get(name, 0.0) + seconds
        if profiled:
            rec = _profiled.setdefault(name, [0.0, 0])
            rec[0] += seconds
            rec[1] += 1


class span:
    """Context manager timing one stage (see the module docstring).
    ``args`` (any value, shown as text) goes with the profiler's range,
    such as the number of the batch the stage works on."""

    __slots__ = ("name", "into", "args", "_range", "_t0")

    def __init__(self, name: str, into: dict | None = None, args=None):
        self.name = name
        self.into = into
        self.args = args
        self._range = None
        self._t0 = None

    def __enter__(self):
        if recording():
            self._range = record_function(
                PREFIX + self.name,
                None if self.args is None else str(self.args))
            self._range.__enter__()
        if self._range is not None or self.into is not None:
            self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self._t0 is None:
            return False
        seconds = time.perf_counter() - self._t0
        if self._range is not None:
            self._range.__exit__(*exc)
        _record(self.name, seconds, self.into, self._range is not None)
        return False


def add(name: str, seconds: float, into: dict | None = None) -> None:
    """Record ``seconds`` under ``name`` as one span that ended now."""
    prof = recording()
    if prof or into is not None:
        _record(name, seconds, into, prof)


def profiled() -> dict[str, tuple[float, int]]:
    """A snapshot of the registry: name -> (seconds, count) of the spans
    and waits recorded while a profile recorded."""
    with _lock:
        return {k: (v[0], v[1]) for k, v in _profiled.items()}


def reset_profiled() -> None:
    with _lock:
        _profiled.clear()
