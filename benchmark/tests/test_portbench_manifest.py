"""BENCHMARK.json and the files it names: the contract's names, units and
keys, every cell's files found by name, and a cell added as files only."""

import json
import os
import re
import shutil

import pytest

from benchmark.harness import spec
from benchmark.tests.tiny import tiny_run

ROOT = spec.ROOT
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = spec.manifest()
TOP = {"command", "paths", "run_seconds", "configs", "workloads",
       "end_to_end", "per_layer"}


def test_top_level_keys_and_sizes():
    assert set(BENCH) == TOP
    assert len(json.dumps(BENCH)) < 64 * 1024
    assert 1 <= BENCH["run_seconds"] <= 51
    assert BENCH["command"][:2] == ["python3", "benchmark/run.py"]
    assert BENCH["paths"] == ["benchmark"]


@pytest.mark.parametrize("section,keys", [
    ("configs", {"name", "source", "file", "reduced", "why"}),
    ("workloads", {"name", "config", "traffic", "chips", "why"}),
    ("end_to_end", {"name", "unit", "better", "bound", "source"}),
    ("per_layer", {"name", "unit", "better", "source", "layer", "moves"}),
])
def test_entries_have_the_contract_keys_and_names(section, keys):
    for e in BENCH[section]:
        assert set(e) - {"workloads"} == keys, e
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]), e["unit"]
            assert e["better"] in ("lower", "higher")
        for k in ("why", "layer", "source"):
            if k in e:
                assert 1 <= len(e[k]) <= 200 and "\n" not in e[k]
    names = [e["name"] for e in BENCH[section]]
    assert len(names) == len(set(names))


def test_bounds_and_sources():
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])
    cells = {w["name"] for w in BENCH["workloads"]}
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["workloads"], m["name"]
        assert m["moves"] in e2e
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        for c in m["workloads"]:
            assert c in cells
            reports = e2e[m["moves"]].get("workloads", cells)
            assert c in reports
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_layers_are_named_alike():
    layers = {}
    for m in BENCH["per_layer"]:
        layers.setdefault(m["layer"].split(" ")[0], set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_resolves_its_files_by_name(cell):
    c = spec.cell(cell)
    w = next(w for w in BENCH["workloads"] if w["name"] == cell)
    assert (c["config"], c["traffic"], c["chips"], c["why"]) == (
        w["config"], w["traffic"], w["chips"], w["why"])
    assert spec.entry(c["entry"]).Runner
    for section in ("end_to_end", "per_layer"):
        for m in spec.reported(BENCH, cell, section):
            assert callable(spec.reader(m["name"]))
    assert set(c["limits"]) and all(v > 0 for v in c["limits"].values())
    assert c["mix"]["ranks"] == c["chips"]


def test_every_cell_reports_setup_another_e2e_and_a_layer_metric():
    for w in BENCH["workloads"]:
        e2e = {m["name"] for m in spec.reported(BENCH, w["name"],
                                                "end_to_end")}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert spec.reported(BENCH, w["name"], "per_layer")


def test_four_chip_cells_are_at_most_a_quarter():
    four = [w for w in BENCH["workloads"] if w["chips"] == 4]
    assert len(four) <= max(1, len(BENCH["workloads"]) // 4)


RECIPE_SOURCE = re.compile(r"/recipes/([A-Za-z0-9_.-]+\.json)$")
#: configurations held to a recipe of this repository whole
WHOLE = {"ndns_float": "ndns.json", "ndns_w8a16": "ndns.json"}


@pytest.mark.parametrize("config", [c["name"] for c in BENCH["configs"]])
def test_configuration_keeps_the_recipe_whole(config):
    """A configuration whose source is a recipe of ``recipes/`` holds it
    whole but for the keys its ``reduced`` lists; the NDNS ones hold
    ``recipes/ndns.json`` with ``reduced`` empty."""
    c = next(c for c in BENCH["configs"] if c["name"] == config)
    with open(os.path.join(ROOT, c["file"])) as f:
        data = json.load(f)
    assert c["source"] == data["source"]
    assert c["reduced"] == data["reduced"]
    found = RECIPE_SOURCE.search(c["source"])
    if config in WHOLE:
        assert found and found.group(1) == WHOLE[config]
        assert c["reduced"] == []
    if not found:
        return
    with open(os.path.join(ROOT, "recipes", found.group(1))) as f:
        recipe = json.load(f)
    kept = {k: v for k, v in recipe.items() if k not in c["reduced"]}
    assert {k: data["recipe"][k] for k in kept} == kept


def test_a_cell_added_as_files_only_runs(tmp_path):
    """A later PR adds a traffic mix, an entry, a cell file and the
    entries in BENCHMARK.json, and edits no file: the harness runs it,
    with the new entry's own traced stretch."""
    root = tmp_path / "checkout"
    shutil.copytree(os.path.join(ROOT, "benchmark"), root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "_cache"))
    bench = json.loads(json.dumps(BENCH))
    mix = json.load(open(root / "benchmark/traffic/offline_b32.json"))
    mix.update(batch=8, why="8 whole clips a request")
    json.dump(mix, open(root / "benchmark/traffic/offline_b8.json", "w"))
    (root / "benchmark/entries/denoise_short.py").write_text(
        '"""Entry ``denoise_short``: the offline request, three requests '
        'traced."""\n\n'
        "from benchmark.entries.denoise import Runner as _Runner\n"
        "from benchmark.entries.denoise import check  # noqa: F401\n\n\n"
        "class Runner(_Runner):\n    traced_steps = 3\n")
    cell = json.load(open(root / "benchmark/workloads/float_denoise_b32.json"))
    cell.update(traffic="offline_b8", entry="denoise_short",
                why="offline denoising, 8 clips")
    json.dump(cell, open(root / "benchmark/workloads/float_denoise_b8.json",
                         "w"))
    bench["workloads"].append({"name": "float_denoise_b8",
                               "config": "ndns_float",
                               "traffic": "offline_b8", "chips": 1,
                               "why": cell["why"]})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if m["name"] in ("denoise_clips_per_s", "dispatch_ms.denoise"):
            m["workloads"].append("float_denoise_b8")
    json.dump(bench, open(root / "BENCHMARK.json", "w"))
    out = tiny_run("float_denoise_b8", root=str(root))
    assert out["correct"]
    assert set(out["metrics"]) == {"denoise_clips_per_s", "setup_s"}
    traced = tiny_run("float_denoise_b8", root=str(root), trace=True,
                      seconds=0.0)
    assert traced["correct"]
    assert set(traced["metrics"]) == {"dispatch_ms.denoise"}
    # the timed stretch runs the sampled requests, the traced one three
    assert traced["attempted"] == 16 + 3
