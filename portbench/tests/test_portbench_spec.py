"""``BENCHMARK.json`` against its format: keys, names, units,
bounds and the files each entry names."""

import json
import re

import pytest

from portbench.tests.tiny import REPO

SPEC = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
TOP = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}


def line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_command_and_paths():
    assert set(SPEC) == TOP
    assert SPEC["command"] == ["python3", "portbench/run.py"]
    assert 1 <= len(SPEC["paths"]) <= 16
    for p in SPEC["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p.split("/")
        assert not p.endswith("_torch") and (REPO / p).is_dir()
    assert isinstance(SPEC["run_seconds"], int) and 1 <= SPEC["run_seconds"] <= 51
    # a check of 24 cells, 14 runs each, fits in 12 hours
    assert 2 + 14 * 24 * (SPEC["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


def test_names_units_and_lines():
    names = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in SPEC[group]:
            assert NAME.match(entry["name"]), entry["name"]
            names.append((group, entry["name"]))
            for key in ("why", "layer", "source"):
                if key in entry and group != "end_to_end" and not (
                        group == "per_layer" and key == "source"):
                    assert line(entry[key]), (entry["name"], key)
            if "unit" in entry:
                assert UNIT.match(entry["unit"]), entry["unit"]
                assert entry["better"] in ("lower", "higher")
    for group in ("configs", "workloads"):
        assert len({e["name"] for e in SPEC[group]}) == len(SPEC[group])
    metrics = [e["name"] for e in SPEC["end_to_end"] + SPEC["per_layer"]]
    assert len(set(metrics)) == len(metrics)
    assert len(json.dumps(SPEC)) <= 64 * 1024


def test_entries_have_just_their_keys():
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert all(NAME.match(k) for k in c["reduced"]) and len(c["reduced"]) <= 16
        assert not any(k.endswith(("_dim", "_rank", "_size")) for k in c["reduced"])
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] in (1, 4)
        assert NAME.match(w["traffic"]) and NAME.match(w["config"])
    for m in SPEC["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in SPEC["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")


def test_every_part_is_a_file_found_by_its_name():
    configs = {c["name"] for c in SPEC["configs"]}
    cells = {w["name"] for w in SPEC["workloads"]}
    for c in SPEC["configs"]:
        assert c["file"].startswith("portbench/configs/") and (REPO / c["file"]).is_file()
    for w in SPEC["workloads"]:
        assert w["config"] in configs
        mix = json.loads((REPO / "portbench" / "traffic" / f"{w['traffic']}.json").read_text())
        assert (REPO / "portbench" / "traffic" / f"{mix['kind']}.py").is_file()
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert (REPO / "portbench" / "metrics" / f"{m['name']}.py").is_file(), m["name"]
        assert set(m.get("workloads", cells)) <= cells
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e
        reports = set(e2e[m["moves"]].get("workloads", cells))
        assert set(m["workloads"]) <= reports, m["name"]
    for cell in cells:  # set-up, another end-to-end metric and a per-layer one
        got = [m["name"] for m in SPEC["end_to_end"] if cell in m.get("workloads", cells)]
        assert "setup_s" in got and len(got) >= 2
        assert any(cell in m.get("workloads", cells) for m in SPEC["per_layer"])
    assert sum(w["chips"] == 4 for w in SPEC["workloads"]) <= max(1, len(cells) // 4)


@pytest.mark.parametrize("m", [m for m in SPEC["per_layer"] if "roofline" in m["name"]
                               or "mfu" in m["name"]], ids=lambda m: m["name"])
def test_rooflines_and_peak_shares_are_percent(m):
    assert m["unit"] == "%" and m["better"] == "higher"
