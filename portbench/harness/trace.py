"""Reading a ``torch.profiler`` trace of the measured window.

The window is the ``portbench.window`` range that the harness records
around it. The device is busy where any kernel, copy or memset runs on
any stream: the busy time is the length of the union of those
intervals inside the window, not the sum of their durations, which
counts time twice where streams overlap. A kernel's time is its own
duration inside the window, whatever runs beside it.
"""

from __future__ import annotations

import bisect
import dataclasses

WINDOW = "portbench.window"
DEVICE_ACTIVITIES = ("kernel", "gpu_memcpy", "gpu_memset")


def merge(intervals) -> list[tuple[float, float]]:
    """Sorted, disjoint union of (start, end) intervals."""
    out: list[list[float]] = []
    for s, e in sorted(intervals):
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def union_length(intervals, lo: float, hi: float) -> float:
    """Length of the union of ``intervals`` clipped to [lo, hi]."""
    return sum(min(e, hi) - max(s, lo) for s, e in merge(intervals)
               if e > lo and s < hi)


def gaps(intervals, lo: float, hi: float) -> list[tuple[float, float]]:
    """The stretches of [lo, hi] that no interval covers."""
    out, cur = [], lo
    for s, e in merge(intervals):
        if e <= lo or s >= hi:
            continue
        if s > cur:
            out.append((cur, s))
        cur = max(cur, e)
    if cur < hi:
        out.append((cur, hi))
    return out


@dataclasses.dataclass
class Trace:
    """What the metric readers and the result line take from a trace.
    Times in seconds; ``kernels`` maps a device op's name to [seconds
    inside the window, count]."""

    window_s: float
    busy_s: float
    kernels: dict
    idle_gaps: list

    def seconds(self, names) -> float | None:
        """Device seconds of the ops whose names contain any of
        ``names``; None when no such op ran."""
        hits = [v[0] for k, v in self.kernels.items()
                if any(n in k for n in names)]
        return sum(hits) if hits else None

    def by_class(self, classes) -> dict:
        """Device seconds by class of kernel: ``classes`` is a list of
        (class, marks); a kernel falls in the first class one of whose
        marks its lowercased name contains, else in "other"."""
        out: dict = {}
        for name, (sec, _) in self.kernels.items():
            low = name.lower()
            cls = next((c for c, marks in classes
                        if any(mk in low for mk in marks)), "other")
            out[cls] = out.get(cls, 0.0) + sec
        return dict(sorted(out.items(), key=lambda kv: -kv[1]))

    def breakdown(self, n: int = 10) -> dict:
        ops = sorted(self.kernels.items(), key=lambda kv: -kv[1][0])[:n]
        return {"device_ops": [[k[:120], v[0]] for k, v in ops],
                "idle_gaps": [[lab, s] for lab, s in self.idle_gaps[:n]]}


def _is_device(ev) -> bool:
    kind = str(getattr(ev, "activity_type", lambda: "")()).lower()
    if kind:
        return kind in DEVICE_ACTIVITIES
    return "CUDA" in str(ev.device_type()) and not ev.is_user_annotation()


def summarize(events, n_gaps: int = 10) -> Trace:
    """A :class:`Trace` of the kineto events of one profile
    (``prof.profiler.kineto_results.events()``)."""
    win = [e for e in events if e.name() == WINDOW
           and "CPU" in str(e.device_type())]
    if len(win) != 1:
        raise RuntimeError(f"{len(win)} '{WINDOW}' ranges in the trace")
    lo = win[0].start_ns()
    hi = lo + win[0].duration_ns()
    dev, cpu = [], []
    kernels: dict = {}
    for e in events:
        s = e.start_ns()
        t = s + e.duration_ns()
        if _is_device(e):
            if t <= lo or s >= hi:
                continue
            dev.append((s, t))
            rec = kernels.setdefault(e.name(), [0.0, 0])
            rec[0] += (min(t, hi) - max(s, lo)) * 1e-9
            rec[1] += 1
        elif "CPU" in str(e.device_type()) and e.name() != WINDOW \
                and t > lo and s < hi:
            cpu.append((s, t, e.name()))
    busy = union_length(dev, lo, hi) * 1e-9
    longest = sorted(gaps(dev, lo, hi), key=lambda g: g[0] - g[1])[:n_gaps]
    cpu.sort()
    starts = [c[0] for c in cpu]
    labelled = []
    for g0, g1 in longest:
        mid = (g0 + g1) / 2
        # the innermost host range that covers the gap's middle; else the
        # host op that ended last before it (the host ran Python after it)
        k = bisect.bisect_right(starts, mid)
        cover = [c for c in cpu[:k] if c[1] >= mid]
        if cover:
            label = min(cover, key=lambda c: c[1] - c[0])[2]
        else:
            before = [c for c in cpu[:k] if c[1] < mid]
            label = ("after " + max(before, key=lambda c: c[1])[2]
                     if before else "no host op")
        labelled.append((label, (g1 - g0) * 1e-9))
    return Trace(window_s=(hi - lo) * 1e-9, busy_s=busy, kernels=kernels,
                 idle_gaps=labelled)
