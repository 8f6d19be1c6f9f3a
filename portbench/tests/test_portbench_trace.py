"""The device's busy time is the union of its intervals over every
stream, not their sum."""

import pytest

from portbench.harness import trace


class Ev:
    def __init__(self, name, kind, start, dur, device="CPU"):
        self._n, self._k, self._s, self._d = name, kind, start, dur
        self._dev = device

    def name(self):
        return self._n

    def activity_type(self):
        return self._k

    def device_type(self):
        return f"DeviceType.{self._dev}"

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._d

    def is_user_annotation(self):
        return self._k == "user_annotation"


def test_union_of_overlapping_streams():
    # stream 1: [0, 4) and [10, 12); stream 2: [2, 6) and [11, 15)
    iv = [(0, 4), (10, 12), (2, 6), (11, 15)]
    assert trace.merge(iv) == [(0, 6), (10, 15)]
    assert trace.union_length(iv, 0, 20) == 11  # the sum of durations: 14
    assert trace.union_length(iv, 3, 12) == 5
    assert trace.gaps(iv, 0, 20) == [(6, 10), (15, 20)]


def test_summarize_window_busy_kernels_and_gaps():
    s = 1_000_000_000
    evs = [Ev(trace.WINDOW, "user_annotation", 0, 10 * s),
           Ev("kernel_a", "kernel", 1 * s, 3 * s, "CUDA"),
           Ev("kernel_b", "kernel", 2 * s, 3 * s, "CUDA"),   # overlaps a
           Ev("Memcpy HtoD", "gpu_memcpy", 8 * s, 1 * s, "CUDA"),
           Ev("kernel_a", "kernel", 9 * s, 2 * s, "CUDA"),   # past the end
           Ev("gpu range", "gpu_user_annotation", 0, 10 * s, "CUDA"),
           Ev("aten::densify", "cpu_op", 5 * s, 2 * s),
           Ev("aten::tiny", "cpu_op", 7.5 * s, 0.1 * s)]
    t = trace.summarize(evs)
    assert t.window_s == pytest.approx(10.0)
    # [1, 5) ∪ [8, 9) ∪ [9, 10): 6 s, not the 3 + 3 + 1 + 1 summed
    assert t.busy_s == pytest.approx(6.0)
    assert t.kernels["kernel_a"] == pytest.approx([4.0, 2])
    assert t.seconds(("kernel_b",)) == pytest.approx(3.0)
    assert t.seconds(("absent",)) is None
    # the gaps [5, 8) and [0, 1), longest first, named by the host
    assert t.idle_gaps[0] == ("aten::densify", pytest.approx(3.0))
    assert t.idle_gaps[1][1] == pytest.approx(1.0)
    assert 100 * (1 - t.busy_s / t.window_s) == pytest.approx(40.0)
    b = t.breakdown()
    assert b["device_ops"][0] == ["kernel_a", pytest.approx(4.0)]
    assert len(b["idle_gaps"]) == 2


def test_by_class():
    t = trace.Trace(1.0, 0.5, {"nvjet_tst_x": [0.2, 1],
                               "attn_fwd_kernel<1>": [0.1, 1],
                               "mystery": [0.05, 1]}, [])
    classes = [["attention kernels", ["attn_"]], ["matmul", ["nvjet"]]]
    assert t.by_class(classes) == {"matmul": 0.2, "attention kernels": 0.1,
                                   "other": 0.05}
