"""BENCHMARK.json keeps to the contract's names, units and keys, and every
cell, configuration, generator and metric it names has its file."""

import json
import os
import re

from conftest import BENCH, ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
LINE = re.compile(r"^[^\t\n]{1,200}$")


def _bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as fh:
        return json.load(fh)


def test_top_level_keys_and_command():
    b = _bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["benchmark"]
    assert 1 <= b["run_seconds"] <= 51 and isinstance(b["run_seconds"], int)
    assert all(LINE.match(w) for w in b["command"])
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) < 64 << 10


def test_names_units_and_lines():
    b = _bench()
    names = []
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and LINE.match(c["source"])
        assert LINE.match(c["why"])
        assert all(NAME.match(k) for k in c["reduced"])
        assert os.path.exists(os.path.join(ROOT, c["file"]))
        names.append(c["name"])
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["config"] in names and w["chips"] in (1, 4)
        assert LINE.match(w["why"])
        names.append(w["name"])
    e2e = {m["name"] for m in b["end_to_end"]}
    assert "setup_s" in e2e
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        names.append(m["name"])
    for m in b["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                           "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in b["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                           "layer", "moves"}
        assert m["moves"] in e2e and LINE.match(m["layer"])
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
    assert len(names) == len(set(names))


def test_every_named_file_is_there():
    b = _bench()
    for w in b["workloads"]:
        with open(os.path.join(BENCH, "cells", w["traffic"] + ".json")) as fh:
            cell = json.load(fh)
        assert cell["config"] == w["config"]
        assert os.path.exists(os.path.join(BENCH, "traffic",
                                           cell["generator"] + ".py"))
        for k in ("failed", "bad_records", "below_threshold", "duplicates",
                  "missing_planted", "missing_hits", "extra_hits",
                  "thermo_gap"):
            assert k in cell["limits"]
    for c in b["configs"]:
        with open(os.path.join(ROOT, c["file"])) as fh:
            conf = json.load(fh)
        assert conf["source"] == c["source"]
        assert sorted(conf["reduced"]) == sorted(c["reduced"])
        assert conf["assumed"]
    for m in b["per_layer"]:
        assert os.path.exists(os.path.join(BENCH, "metrics",
                                           m["name"] + ".py"))


def test_file_names_under_paths():
    ok = re.compile(r"^[A-Za-z0-9_.\-/]+$")
    for dirpath, dirs, files in os.walk(BENCH):
        dirs[:] = [d for d in dirs if d != "__pycache__"]
        for f in files:
            rel = os.path.relpath(os.path.join(dirpath, f), ROOT)
            assert ok.match(rel), rel
