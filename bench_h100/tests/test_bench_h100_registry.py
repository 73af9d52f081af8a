"""The benchmark finds every piece by its name, and a cell, a
configuration or a metric can be added as new files alone."""

import json
import shutil

import pytest

from bench_h100 import common

BENCH = common.benchmark()


def test_every_cell_config_and_metric_is_found_from_its_file():
    for cfg in BENCH["configs"]:
        assert cfg["file"] == f"bench_h100/configs/{cfg['name']}.json"
        assert common.config(cfg["name"])["name"] == cfg["name"]
        assert hasattr(common.adapter(cfg["name"]), "step")
        assert hasattr(common.reference(cfg["name"]), "judge")
    for cell in BENCH["workloads"]:
        traffic = common.workload(cell["name"])
        assert traffic["config"] == cell["config"]
        assert traffic["mode"] == cell["traffic"]
        assert traffic["chips"] == cell["chips"] == 1
        assert traffic["why"] == cell["why"]
    for m in BENCH["per_layer"]:
        assert callable(common.reader(m["name"]).read)
    assert set(common.listed("workloads", ".json")) == \
        {c["name"] for c in BENCH["workloads"]}
    assert set(common.listed("metrics", ".py")) == \
        {m["name"] for m in BENCH["per_layer"]}


def test_a_cell_added_as_a_file_is_listed(tmp_path):
    here = tmp_path / "bench_h100"
    shutil.copytree(common.HERE, here)
    before = {p.name: p.read_bytes() for p in here.rglob("*")
              if p.is_file()}
    new = dict(common.workload("denoiser540p.train"), why="a new cell")
    (here / "workloads" / "denoiser540p.train_long.json").write_text(
        json.dumps(new))
    assert "denoiser540p.train_long" in common.listed("workloads", ".json",
                                                      here)
    assert common.workload("denoiser540p.train_long", here)["why"] == \
        "a new cell"
    after = {p.name: p.read_bytes() for p in here.rglob("*")
             if p.is_file() and p.name != "denoiser540p.train_long.json"}
    assert after == before


def test_a_bad_name_is_refused():
    with pytest.raises(ValueError):
        common.workload("../BENCHMARK")
    with pytest.raises(FileNotFoundError):
        common.workload("no_such_cell")


def test_names_and_units_use_the_allowed_characters():
    names = [c["name"] for c in BENCH["configs"]] \
        + [w["name"] for w in BENCH["workloads"]] \
        + [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]] \
        + [w["config"] for w in BENCH["workloads"]] \
        + [w["traffic"] for w in BENCH["workloads"]]
    assert all(common.NAME.match(n) for n in names), names
    for group in (BENCH["configs"], BENCH["workloads"],
                  BENCH["end_to_end"] + BENCH["per_layer"]):
        assert len({g["name"] for g in group}) == len(group)
    units = [m["unit"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert all(common.UNIT.match(u) for u in units), units


def test_the_contract_shape():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["bench_h100"]
    assert BENCH["command"] == ["python3", "bench_h100/run.py"]
    assert 1 <= BENCH["run_seconds"] <= 51
    cells = {w["name"] for w in BENCH["workloads"]}
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        assert set(m["workloads"]) <= cells
    for cell in cells:
        _, layer = common.cell_metrics(BENCH, cell)
        assert layer, cell
    for cfg in BENCH["configs"]:
        assert common.config(cfg["name"])["reduced"] == cfg["reduced"]
    assert len(json.dumps(BENCH)) < 64 * 1024
