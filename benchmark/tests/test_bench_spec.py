"""BENCHMARK.json against the contract's shape, and discovery by name: every
cell's parts are found, and a configuration, a mix and a metric added as
files are found with no edit."""

import json
import re
import shutil

import pytest

from benchmark.core import spec

from bench_copy import ROOT, make_copy

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")
PATH = re.compile(r"[A-Za-z0-9_./-]{1,200}")
KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


def _line(text):
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= len(BENCH["paths"]) <= 16
    for p in BENCH["paths"]:
        assert PATH.fullmatch(p) and ".." not in p.split("/")
        assert not p.endswith("_torch")
    assert len(BENCH["command"]) <= 32
    assert all(_line(w) and not w.startswith("/") for w in BENCH["command"])
    assert BENCH["command"][1].startswith(BENCH["paths"][0] + "/")
    assert isinstance(BENCH["run_seconds"], int)
    assert 1 <= BENCH["run_seconds"] <= 51
    cells = 24                          # what later PRs may grow to
    runs = 2 + 14 * cells
    assert runs * (BENCH["run_seconds"] + 60) + cells * 180 + 1200 <= 43200


@pytest.mark.parametrize("section", sorted(KEYS))
def test_entries_keep_to_names_units_and_keys(section):
    entries = BENCH[section]
    assert 1 <= len(entries)
    names = [e["name"] for e in entries]
    assert len(set(names)) == len(names)
    for e in entries:
        extra = set(e) - KEYS[section]
        assert KEYS[section] <= set(e)
        assert extra <= ({"workloads"} if section in ("end_to_end",
                                                      "per_layer") else set())
        assert NAME.fullmatch(e["name"])
        if "unit" in e:
            assert UNIT.fullmatch(e["unit"]) and e["better"] in ("lower",
                                                                  "higher")
        for key in ("why", "layer", "source"):
            if key in e and section in ("configs", "workloads", "per_layer"):
                assert _line(e[key])
    if section == "configs":
        for c in entries:
            assert all(NAME.fullmatch(k) for k in c["reduced"])
            assert len(c["reduced"]) <= 16
            assert c["file"].startswith(BENCH["paths"][0] + "/")
    if section == "end_to_end":
        assert "setup_s" in names
        for m in entries:
            assert 0.01 <= m["bound"] <= 0.25
            assert m["source"] in ("host_clock", "device_trace")
    if section == "per_layer":
        e2e = {m["name"] for m in BENCH["end_to_end"]}
        for m in entries:
            assert m["moves"] in e2e
            assert m["source"] in ("device_trace", "program_span",
                                   "program_counter", "host_clock")


def test_every_cell_reports_setup_another_metric_and_a_layer():
    cells = {w["name"] for w in BENCH["workloads"]}
    for w in BENCH["workloads"]:
        assert w["chips"] in (1, 4) and NAME.fullmatch(w["traffic"])
        cell = spec.load_cell(w["name"])
        e2e = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert cell.per_layer
        for m in cell.end_to_end + cell.per_layer:
            spec.metric_reader(cell.bench_dir, m["name"])
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert set(m.get("workloads", cells)) <= cells
    for m in BENCH["per_layer"]:
        moved = next(e for e in BENCH["end_to_end"] if e["name"] == m["moves"])
        assert set(m["workloads"]) <= set(moved.get("workloads", cells))


def test_sections_resolve():
    from benchmark.core.trace import _resolve
    for targets in spec.sections(spec.BENCH_DIR).values():
        for t in targets:
            owner, attr = _resolve(t)
            assert callable(getattr(owner, attr))


def test_new_config_mix_and_metric_are_found_as_files(tmp_path):
    root = make_copy(tmp_path)
    bench_dir = root / "benchmark"
    cfg = json.loads((bench_dir / "configs" / "whisk124.json").read_text())
    cfg.update(name="whisk60", ell=60, n=64)
    (bench_dir / "configs" / "whisk60.json").write_text(json.dumps(cfg))
    mix = json.loads((bench_dir / "traffic" / "verify_stream.json")
                     .read_text())
    mix["reject_every"] = 8
    (bench_dir / "traffic" / "verify_often_wrong.json").write_text(
        json.dumps(mix))
    (bench_dir / "metrics" / "requests_done.py").write_text(
        "def read(data):\n    return len(data.done)\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "whisk60", "source": "tests",
                             "file": "benchmark/configs/whisk60.json",
                             "reduced": [], "why": "tests"})
    bench["workloads"].append({"name": "whisk60.verify_often_wrong",
                               "config": "whisk60",
                               "traffic": "verify_often_wrong", "chips": 1,
                               "why": "tests"})
    bench["per_layer"].append({"name": "requests_done.verify", "unit": "n",
                               "better": "higher", "source": "host_clock",
                               "layer": "tests", "moves": "setup_s",
                               "workloads": ["whisk60.verify_often_wrong"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = spec.load_cell("whisk60.verify_often_wrong", root=root)
    assert cell.config["ell"] == 60 and cell.traffic["reject_every"] == 8
    assert cell.driver.Driver.__name__ == "Driver"
    assert [m["name"] for m in cell.per_layer] == ["requests_done.verify"]
    reader = spec.metric_reader(cell.bench_dir, "requests_done.verify")
    assert reader.read(type("D", (), {"done": [1, 2]})) == 2
    shutil.rmtree(bench_dir / "drivers")
    with pytest.raises(FileNotFoundError):
        spec.load_cell("whisk60.verify_often_wrong", root=root)
