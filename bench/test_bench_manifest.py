"""``BENCHMARK.json`` against the benchmark's contract: names, units,
keys, bounds, the files each entry names, the time a full check takes,
and each per-layer metric's ``moves`` reported in every cell it lists."""
import json
import re

import pytest

from bench import manifest

B = manifest.load()
NAMES = [m["name"] for m in B["end_to_end"] + B["per_layer"]]
CELLS = [w["name"] for w in B["workloads"]]


def test_top_level_keys_and_command():
    assert set(B) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert B["command"] == ["python3", "bench/run.py"]
    assert B["paths"] == ["bench"]
    assert (manifest.ROOT / B["command"][1]).exists()


def test_full_check_fits_with_24_cells():
    runs = 2 + 14 * 24
    assert runs * (B["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200
    assert 1 <= B["run_seconds"] <= 51


def test_names_units_and_entry_keys():
    for m in B["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better",
                                          "bound", "source"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in B["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better",
                                          "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
    for m in B["end_to_end"] + B["per_layer"]:
        assert manifest.NAME.match(m["name"]), m["name"]
        assert manifest.UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
        if m["name"].endswith("_roofline") or "_roofline." in m["name"]:
            assert m["unit"] == "%"
    assert len(set(NAMES)) == len(NAMES)
    assert "setup_s" in [m["name"] for m in B["end_to_end"]]
    assert [m["bound"] for m in B["end_to_end"]
            if m["name"] == "setup_s"] == [0.25]


def test_configs_and_cells_name_existing_files():
    for c in B["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert manifest.NAME.match(c["name"])
        assert c["file"].startswith("bench/")
        conf = json.loads((manifest.ROOT / c["file"]).read_text())
        assert conf["name"] == c["name"]
        assert all(manifest.NAME.match(k) for k in c["reduced"])
    assert len(CELLS) == len(set(CELLS))
    pairs = [(w["config"], w["traffic"]) for w in B["workloads"]]
    assert len(pairs) == len(set(pairs))
    for w in B["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
        cell = manifest.cell(w["name"], B)
        assert (manifest.BENCH / "cells" /
                f"{cell.traffic['kind']}.py").exists()
        assert cell.limits


@pytest.mark.parametrize("name", NAMES)
def test_every_metric_has_a_reader(name):
    assert callable(manifest.reader(name))


def test_each_cell_reports_setup_another_metric_and_a_layer():
    for w in CELLS:
        cell = manifest.cell(w, B)
        e2e = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert cell.per_layer


def test_moves_is_reported_where_the_layer_metric_is():
    e2e = {m["name"]: m for m in B["end_to_end"]}
    for m in B["per_layer"]:
        assert m["moves"] in e2e
        for w in m.get("workloads", CELLS):
            assert manifest.applies(e2e[m["moves"]], w), (m["name"], w)


def test_layers_are_one_line_and_consistent():
    for m in B["per_layer"]:
        assert 1 <= len(m["layer"]) <= 200 and "\n" not in m["layer"]
    for text in [w["why"] for w in B["workloads"]] + \
            [c["source"] for c in B["configs"]]:
        assert 1 <= len(text) <= 200 and not re.search(r"[\n\t]", text)
