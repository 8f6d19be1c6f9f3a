"""The manifest and every file it names are found by name, agree with
each other and keep to the contract's limits; a cell added as files in
a copy is found without an edit."""

import json
import re
import shutil

import pytest

from portbench import run

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
MAN = run.manifest()


def test_top_level_keys():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert MAN["paths"] == ["portbench"]
    assert 1 <= MAN["run_seconds"] <= 51
    assert len((run.ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_units_and_keys():
    names = [c["name"] for c in MAN["configs"]] + \
        [w["name"] for w in MAN["workloads"]] + \
        [m["name"] for m in MAN["end_to_end"] + MAN["per_layer"]]
    for kind in ("configs", "workloads"):
        assert len({e["name"] for e in MAN[kind]}) == len(MAN[kind])
    metrics = [m["name"] for m in MAN["end_to_end"] + MAN["per_layer"]]
    assert len(set(metrics)) == len(metrics)
    assert all(NAME.match(n) for n in names)
    for m in MAN["end_to_end"] + MAN["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in MAN["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    assert "setup_s" in {m["name"] for m in MAN["end_to_end"]}


@pytest.mark.parametrize("entry", MAN["configs"], ids=lambda e: e["name"])
def test_config_files(entry):
    cfg = run.config_file(entry["name"])
    assert entry["file"] == f"portbench/configs/{entry['name']}.json"
    assert cfg["name"] == entry["name"]
    assert entry["reduced"] == cfg["reduced"] == []
    assert cfg["precision"] in ("bf16", "fp32") and cfg["assumed"]


@pytest.mark.parametrize("entry", MAN["workloads"], ids=lambda e: e["name"])
def test_workload_files(entry):
    wl = run.workload_file(entry["name"])
    for k in ("config", "traffic", "chips", "why"):
        assert wl[k] == entry[k]
    assert entry["chips"] in (1, 4) and len(entry["why"]) <= 200
    assert (run.BENCH / "drivers" / f"{wl['driver']}.py").is_file()
    drv = run.driver(wl["driver"])
    for fn in ("setup", "window", "release", "check"):
        assert callable(getattr(drv, fn))
    assert wl["limits"] and all(v >= 0 for v in wl["limits"].values())
    e2e = run.metrics_of(MAN, entry["name"], "end_to_end")
    assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2
    assert run.metrics_of(MAN, entry["name"], "per_layer")


@pytest.mark.parametrize("entry", MAN["per_layer"], ids=lambda e: e["name"])
def test_metric_files(entry):
    mod = run.load_module(run.BENCH / "metrics" / f"{entry['name']}.py")
    assert (mod.UNIT, mod.LAYER, mod.MOVES) == (
        entry["unit"], entry["layer"], entry["moves"])
    assert entry["moves"] in {m["name"] for m in MAN["end_to_end"]}
    assert callable(mod.read)
    assert mod.read(dict(trace=None, result={"counters": {"tiles": 0,
                                                          "crops": 0}},
                         cell=None)) is None


def test_cell_added_as_files_is_found(tmp_path):
    """A new cell: one workload file and a manifest entry, nothing
    edited; the copy's own harness finds it and its metrics."""
    shutil.copytree(run.BENCH, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    man = json.loads((run.ROOT / "BENCHMARK.json").read_text())
    old = man["workloads"][0]["name"]
    wl = json.loads((run.BENCH / "workloads" / f"{old}.json").read_text())
    wl["traffic"] = "slide20x"
    wl["params"] = {**wl["params"], "slide_mpp": 0.504}
    new = "wsi.conic-bf16.slide20x"
    (tmp_path / "portbench" / "workloads" / f"{new}.json").write_text(
        json.dumps(wl))
    man["workloads"].append({**man["workloads"][0], "name": new,
                             "traffic": "slide20x"})
    for m in man["end_to_end"] + man["per_layer"]:
        if old in m.get("workloads", []):
            m["workloads"].append(new)
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(man))
    copy = run.load_module(tmp_path / "portbench" / "run.py")
    assert copy.ROOT == tmp_path
    assert copy.workload_file(new)["params"]["slide_mpp"] == 0.504
    assert [m["name"] for m in copy.metrics_of(copy.manifest(), new,
                                               "per_layer")] == \
        [m["name"] for m in run.metrics_of(MAN, old, "per_layer")]
    assert copy.driver(wl["driver"]).setup
