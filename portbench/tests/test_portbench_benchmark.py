"""BENCHMARK.json against the benchmark's contract, and every file it
names present."""

import json
import re

import pytest

from portbench.core.harness import BENCH, ROOT

BENCHMARK = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def metrics():
    return BENCHMARK["end_to_end"] + BENCHMARK["per_layer"]


def test_top_level_keys_and_sizes():
    assert set(BENCHMARK) == {"command", "paths", "run_seconds", "configs",
                              "workloads", "end_to_end", "per_layer"}
    assert BENCHMARK["command"] == ["python3", "portbench/run.py"]
    assert BENCHMARK["paths"] == ["portbench"]
    assert 1 <= BENCHMARK["run_seconds"] <= 51
    assert 1 <= len(BENCHMARK["configs"]) <= 24
    assert 1 <= len(BENCHMARK["workloads"]) <= 24
    assert 1 <= len(BENCHMARK["end_to_end"]) <= 16
    assert 1 <= len(BENCHMARK["per_layer"]) <= 128
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_units_and_keys():
    names = [m["name"] for m in metrics()]
    assert len(names) == len(set(names))
    for m in metrics():
        assert NAME.match(m["name"]), m["name"]
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for m in BENCHMARK["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better",
                                          "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCHMARK["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better",
                                          "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert 1 <= len(m["layer"]) <= 200 and "\n" not in m["layer"]
    for w in BENCHMARK["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and 1 <= len(w["why"]) <= 200
    for c in BENCHMARK["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and len(c["source"]) <= 200
        assert all(NAME.match(k) for k in c["reduced"])
    setup = [m for m in BENCHMARK["end_to_end"] if m["name"] == "setup_s"]
    assert setup and setup[0]["bound"] <= 0.25


def test_every_cell_reports_what_it_needs():
    e2e = {m["name"]: m for m in BENCHMARK["end_to_end"]}
    cells = {w["name"] for w in BENCHMARK["workloads"]}
    for cell in cells:
        mine = [m for m in metrics() if cell in m.get("workloads", [cell])]
        assert any(m["name"] == "setup_s" for m in mine)
        assert any(m["name"] != "setup_s" for m in mine
                   if m in BENCHMARK["end_to_end"])
        assert any(m in BENCHMARK["per_layer"] for m in mine)
    for m in BENCHMARK["per_layer"]:
        assert m["moves"] in e2e
        # a per-layer metric's cells all report the metric it moves
        moved = e2e[m["moves"]].get("workloads", sorted(cells))
        for cell in m.get("workloads", sorted(cells)):
            assert cell in cells and cell in moved, (m["name"], cell)
    layers = {}
    for m in BENCHMARK["per_layer"]:
        layers.setdefault(m["layer"].lower(), set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())


def test_every_named_file_is_there():
    configs = {c["name"]: c for c in BENCHMARK["configs"]}
    used = set()
    for w in BENCHMARK["workloads"]:
        used.add(w["config"])
        cfg = json.loads((ROOT / configs[w["config"]]["file"]).read_text())
        assert cfg["name"] == w["config"]
        traffic = json.loads(
            (BENCH / "traffic" / f"{w['traffic']}.json").read_text())
        assert (BENCH / "kinds" / f"{traffic['kind']}.py").exists()
        limits = json.loads(
            (BENCH / "limits" / f"{w['name']}.json").read_text())
        assert limits["limits"]
    assert used == set(configs)
    files = [c["file"] for c in configs.values()]
    assert len(files) == len(set(files))
    for f in files:
        assert f.startswith("portbench/")
    for m in metrics():
        if m["name"] != "setup_s":
            assert (BENCH / "metrics" / f"{m['name']}.py").exists()


@pytest.mark.parametrize("name", ["landiff-2b", "cogvideox-5b"])
def test_configs_keep_the_published_widths(name):
    c = json.loads((BENCH / "configs" / f"{name}.json").read_text())
    entry = {e["name"]: e for e in BENCHMARK["configs"]}[name]
    assert c["reduced"] == entry["reduced"] == []
    d = c["dit"]
    assert (d["latent_frames"], d["latent_height"], d["latent_width"]) \
        == (13, 60, 90)
    assert d["text_length"] == 226 and d["text_dim"] == 4096
    assert d["hidden_size"] // d["num_heads"] == 64
    if name == "cogvideox-5b":
        p = c["published"]
        assert d["num_layers"] == p["num_layers"] == 42
        assert d["num_heads"] == p["num_attention_heads"] == 48
        assert d["pos_embed"] == "rotary3d"
    else:
        assert (d["num_layers"], d["control_layers"], d["hidden_size"]) \
            == (30, 15, 1920)
