"""The benchmark of ``classpose_tpu_torch`` on NVIDIA GPUs.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

Run from the root of a checkout. ``BENCHMARK.json`` names the cells and
metrics; everything else is found by name under ``portbench/``: the
cell's ``workloads/<cell>.json`` (its configuration, driver, traffic
parameters and the limits of its compared numbers), the configuration's
``configs/<config>.json``, the entry module ``drivers/<driver>.py`` and each
per-layer metric's reader ``metrics/<metric>.py``.

A run makes its inputs and weights from the seed, sets up and warms up
(``setup_s``), measures for ``--seconds`` (under ``torch.profiler`` with
``--trace 1``), reads the device's memory peak, frees the program and
compares what the window produced with the plain float32 reference.
The last line of standard output is the result; the compared numbers,
each beside its limit, are the last lines of standard error. Without
enough CUDA devices, or with JAX or the JAX package loaded, it exits
non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import importlib.util
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
BENCH = ROOT / "portbench"
FORBIDDEN = ("jax", "jaxlib", "flax", "classpose_tpu")


@dataclasses.dataclass
class Cell:
    name: str
    workload: dict
    config: dict
    seed: int
    device: str
    workdir: Path

    @property
    def params(self) -> dict:
        return self.workload["params"]


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path):
    """A module of the benchmark by file path (metric files are named
    after metrics, which hold dots)."""
    spec = importlib.util.spec_from_file_location(
        "portbench_" + path.stem.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod
    spec.loader.exec_module(mod)
    return mod


def manifest() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def workload_file(name: str) -> dict:
    return load_json(BENCH / "workloads" / f"{name}.json")


def config_file(name: str) -> dict:
    return load_json(BENCH / "configs" / f"{name}.json")


def driver(name: str):
    return load_module(BENCH / "drivers" / f"{name}.py")


def metrics_of(man: dict, cell: str, kind: str) -> list[dict]:
    """The manifest's ``end_to_end`` or ``per_layer`` entries that this
    cell reports: those listing it, and those without a list whose moved
    metric the cell reports."""
    e2e = {m["name"] for m in man["end_to_end"]
           if "workloads" not in m or cell in m["workloads"]}
    out = []
    for m in man[kind]:
        if "workloads" in m:
            if cell in m["workloads"]:
                out.append(m)
        elif kind == "end_to_end" or m["moves"] in e2e:
            out.append(m)
    return out


def forbidden_modules() -> list[str]:
    """Top-level names in ``sys.modules`` that are JAX or the JAX
    package, compared whole."""
    tops = {name.split(".")[0] for name in list(sys.modules)}
    return sorted(tops.intersection(FORBIDDEN))


def device_info(chips: int) -> dict:
    import torch

    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": chips}
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits", "-i", "0"],
            capture_output=True, text=True, timeout=30)
        info["power_limit_w"] = float(out.stdout.strip().splitlines()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        pass
    return info


@contextlib.contextmanager
def open_cell(name: str, seed: int, device: str = "cuda",
              overrides: dict | None = None):
    """Cell ``name`` with its files merged and a fresh working directory;
    yields ``(cell, driver)``. ``overrides`` ({"model": {...}, "params":
    {...}}) resizes a cell for a test; the benchmark passes none."""
    wl = workload_file(name)
    cfg = config_file(wl["config"])
    overrides = overrides or {}
    cfg = {**cfg, "model": {**cfg["model"], **overrides.get("model", {})}}
    wl = {**wl, "params": {**wl["params"], **overrides.get("params", {})}}
    drv = driver(wl["driver"])
    with tempfile.TemporaryDirectory(prefix="portbench-") as tmp:
        yield Cell(name, wl, cfg, int(seed), device, Path(tmp)), drv


def run_cell(name: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", overrides: dict | None = None) -> dict:
    """One run of cell ``name`` (``overrides`` as for :func:`open_cell`)."""
    import torch

    man = manifest()
    with open_cell(name, seed, device, overrides) as (cell, drv):
        wl = cell.workload
        cuda = device.startswith("cuda")

        def sync():
            if cuda:
                torch.cuda.synchronize(device)

        t0 = time.perf_counter()
        state = drv.setup(cell)
        sync()
        setup_s = time.perf_counter() - t0
        prof = None
        if trace:
            from torch.profiler import ProfilerActivity, profile, \
                record_function

            acts = [ProfilerActivity.CPU] + (
                [ProfilerActivity.CUDA] if cuda else [])
            prof = profile(activities=acts)
            prof.__enter__()
            span = record_function("portbench.window")
        else:
            span = contextlib.nullcontext()
        with span:
            result = drv.window(cell, state, seconds)
            sync()
        if prof is not None:
            prof.__exit__(None, None, None)
        peak = torch.cuda.max_memory_allocated(device) if cuda else 0
        found = forbidden_modules()
        if found:
            raise SystemExit(f"JAX or the JAX package loaded: {found}")
        summary = None
        if prof is not None:
            from portbench.harness.trace import summarize

            summary = summarize(prof.profiler.kineto_results.events())
            del prof
        drv.release(cell, state)
        t1 = time.perf_counter()
        numbers = drv.check(cell, state)
        check_s = time.perf_counter() - t1
    limits = wl["limits"]
    checks = {k: {"value": numbers[k], "limit": limits[k]} for k in limits}
    correct = all(v["value"] <= v["limit"] for v in checks.values())
    values = dict(result["metrics"], setup_s=setup_s)
    if trace:
        ctx = dict(trace=summary, result=result, cell=cell)
        metrics = {}
        for m in metrics_of(man, name, "per_layer"):
            v = load_module(BENCH / "metrics" / f"{m['name']}.py").read(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in metrics_of(man, name, "end_to_end")}
    out = {"correct": correct, "attempted": result["attempted"],
           "failed": result["failed"], "metrics": metrics}
    out["device"] = {"memory_peak_bytes": peak}
    if summary is not None:
        out["device"].update(busy_s=summary.busy_s, window_s=summary.window_s)
        out["breakdown"] = summary.breakdown()
        classes = load_json(BENCH / "metrics" / "kernel_classes.json")
        out["device_s_by_class"] = summary.by_class(classes["classes"])
    out["check_s"] = check_s
    out["checks"] = checks
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = p.parse_args(argv)
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    import torch

    chips = workload_file(a.workload)["chips"]
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < chips:
        print(f"portbench: {a.workload} needs {chips} CUDA device(s), found "
              f"{found}; no result", file=sys.stderr)
        return 2
    dev = device_info(chips)
    try:
        out = run_cell(a.workload, a.seed, a.seconds, bool(a.trace))
    except SystemExit as e:
        print(f"portbench: {e}", file=sys.stderr)
        return 3
    found = forbidden_modules()
    if found:  # loaded by the check or a metric reader after the window
        print(f"portbench: JAX or the JAX package loaded: {found}; "
              "no result", file=sys.stderr)
        return 3
    out["device"] = {**dev, **out["device"]}
    checks = out.pop("checks")
    out["checks"] = checks
    for k, v in checks.items():
        print(f"check {k} = {v['value']!r} (limit {v['limit']!r})",
              file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
