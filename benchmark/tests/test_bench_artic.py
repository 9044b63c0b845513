"""The artic_v3 cell: its generator is deterministic per seed and its
fixed panel is the ancestor's own bases at the configured sites; planted
amplicons are intact in their genomes; the CPU rehearsal is correct with
slices that hold records, and its control fails; the cell's four
per-layer readers read the program's spans and counters, on a synthetic
trace and under a CPU profiler, and nothing where the program has none."""

import json
import os
from types import SimpleNamespace

import pytest
from torch.profiler import ProfilerActivity, profile

import control
import reference
import run
from conftest import BENCH
from traffic import artic_v3

CELL = "artic_v3.genomes1024"
METRICS = ("group_submit_ms", "ctx_ms_per_frag", "output_us_per_record",
           "strip_chunk_share")


def _params():
    with open(os.path.join(BENCH, "configs", "artic_v3.json")) as fh:
        return json.load(fh)["params"]


def _read(path):
    with open(path, "rb") as fh:
        return fh.read()


def test_deterministic_per_seed(tmp_path):
    kw = dict(_params(), genomes=6)
    a = artic_v3.generate(str(tmp_path / "a"), 2**40 + 7, **kw)
    b = artic_v3.generate(str(tmp_path / "b"), 2**40 + 7, **kw)
    c = artic_v3.generate(str(tmp_path / "c"), 2**40 + 8, **kw)
    assert _read(a["db"]) == _read(b["db"]) != _read(c["db"])
    assert a["planted"] == b["planted"]
    # the panel is fixed: every seed searches the same one
    assert _read(a["queries"]["artic"]) == _read(c["queries"]["artic"])
    db = reference.read_fasta(a["db"])
    assert len(db) == 6 and a["bases"] == sum(map(len, db.values()))
    # lineages delete 0-18 bases of the 29,903
    assert all(29903 - 18 <= len(s) <= 29903 for s in db.values())


def test_panel_is_the_ancestors_bases_at_its_sites():
    p = _params()
    anc = artic_v3.ancestor(p["genome_len"], p["gc"], p["ancestor_seed"])
    text = artic_v3._to_str(anc)
    rows = p["panels"]["artic"]
    assert len(rows) == len(p["amplicons"]) == 98
    for (name, pool, ls, ll, re, rl), (label, left, right) in zip(
            p["amplicons"], rows):
        assert name == label
        assert pool == 1 + (int(name.split("_")[1]) + 1) % 2
        assert 22 <= ll <= 30 and 22 <= rl <= 30
        assert text[ls:ls + ll] == left
        assert reference.revcomp(text[re - rl + 1:re + 1]) == right
        assert 380 - 20 <= re - ls + 1 <= 420 + 20
    # tiled: each left primer inside the amplicon before, clear of its
    # right primer
    for a, b in zip(p["amplicons"], p["amplicons"][1:]):
        assert a[2] < b[2] and b[2] + b[3] <= a[4] - a[5] + 1


def test_the_configured_panel_is_the_drawn_one():
    """draw_panel, which checks each primer's perfect-match Tm with
    nucruc, draws what the configuration keeps; its least Tm is at least
    50 C."""
    p = _params()
    amplicons, panels, tm_min = artic_v3.draw_panel(
        p["genome_len"], p["gc"], p["ancestor_seed"])
    assert amplicons == p["amplicons"] and panels == p["panels"]
    assert tm_min >= 50.0


def test_planted_sites_are_intact(tmp_path):
    d = artic_v3.generate(str(tmp_path), 99, **dict(_params(), genomes=12))
    db = reference.read_fasta(d["db"])
    rows = {r[0]: r[1:] for r in _params()["panels"]["artic"]}
    planted = d["planted"]["artic"]
    # most amplicons of most genomes are intact, not all
    assert 12 * 98 * 0.8 <= len(planted) < 12 * 98
    for label, rec, lo, hi in planted:
        left, right = rows[label]
        site = db[rec][lo:hi + 1]
        assert site.startswith(left)
        assert site.endswith(reference.revcomp(right))


def _run(capsys, keep=None, trace=0, seed=2147483659):
    rc = run.main(["--workload", CELL, "--seed", str(seed), "--seconds",
                   "0.01", "--trace", str(trace), "--rehearse"], keep=keep)
    out = capsys.readouterr().out.strip().splitlines()
    assert rc == 0
    return json.loads(out[-1])


@pytest.fixture
def one_batch(monkeypatch):
    # the rehearsal's 4 genomes in one step a group, not a batch of 8
    monkeypatch.setenv("TNTBLAST_TPU_BATCH", "4")


def test_rehearsal_is_correct_and_reads_its_layers(capsys, one_batch):
    keep = {}
    with profile(activities=[ProfilerActivity.CPU]):
        res = _run(capsys, keep=keep, trace=1)
    assert res["correct"] is True and res["failed"] == 0
    assert res["records"] >= 4 * 90
    assert keep["numbers"]["slice_records"] > 0
    assert keep["numbers"]["missing_planted"] == 0
    assert res["checks"]["missing_hits"]["value"] == 0
    m = res["metrics"]
    for name in METRICS:
        assert m[name]["value"] >= 0, name
    assert m["group_submit_ms"]["value"] > 0
    assert m["strip_chunk_share"]["value"] == 100.0
    for name in ("search_setup_ms", "ctx_ms_per_mb", "wait_share",
                 "kept_share", "fallback_frags"):
        assert name in m, name
    assert m["fallback_frags"]["value"] == 0
    # the config5 cell's own readers are not read here
    assert "db_open_ms" not in m


def test_control_fails(capsys, one_batch):
    keep = {"then": control.readings}
    _run(capsys, keep=keep)
    limits = keep["cell"].limits
    assert keep["numbers"]["thermo_gap"] <= limits["thermo_gap"]
    assert keep["numbers"]["slice_records"] > 0
    ctl = keep["then_result"]
    assert ctl["thermo_gap"] > limits["thermo_gap"]
    assert ctl["failed"] >= 1


def _span(name, t0, t1, **attrs):
    return SimpleNamespace(name=name, start=t0, end=t1, attrs=attrs)


def _synthetic(monkeypatch, counters):
    """Two searches of the window: two step.group spans of 2 and 4 ms,
    host.frag_index + host.seed_inject 30 ms over 3 + 5 fragments,
    cli.output 10 ms, and `counters` split across them."""
    import progtrace

    s1 = SimpleNamespace(spans=[
        _span("step.group", 1.0, 1.002, group=0, slots=64),
        _span("host.frag_index", 1.0, 1.01),
        _span("host.seed_inject", 1.0, 1.005),
        _span("cli.output", 1.1, 1.104)], counters=dict(counters[0]))
    s2 = SimpleNamespace(spans=[
        _span("step.group", 2.0, 2.004, group=6, slots=8),
        _span("host.frag_index", 2.0, 2.015),
        _span("cli.output", 2.1, 2.106)], counters=dict(counters[1]))
    monkeypatch.setattr(progtrace, "searches", lambda t: [s1, s2])
    return SimpleNamespace(window=(0.0, 3.0), mb=1.0, searches=[],
                           split=None, device=None)


def test_readers_on_a_synthetic_trace(monkeypatch):
    t = _synthetic(monkeypatch, [
        {"host.fragments": 3, "output.records": 600,
         "screen.chunks.strip": 6, "screen.chunks.reg": 1},
        {"host.fragments": 5, "output.records": 400,
         "screen.chunks.strip": 0, "screen.chunks.reg": 1}])
    got = {m: run.load_module("metrics", m).read(t) for m in METRICS}
    assert got["group_submit_ms"] == pytest.approx(3.0)
    assert got["ctx_ms_per_frag"] == pytest.approx(30.0 / 8)
    assert got["output_us_per_record"] == pytest.approx(10.0)
    assert got["strip_chunk_share"] == pytest.approx(75.0)


def test_readers_read_nothing_without_the_counters(monkeypatch):
    """A program older than the counters gives the counter readers
    nothing, and no reader raises."""
    t = _synthetic(monkeypatch, [{}, {}])
    got = {m: run.load_module("metrics", m).read(t) for m in METRICS}
    assert got["ctx_ms_per_frag"] is None
    assert got["output_us_per_record"] is None
    assert got["strip_chunk_share"] is None
    import progtrace
    monkeypatch.setattr(progtrace, "searches", lambda t: [])
    assert all(run.load_module("metrics", m).read(t) is None
               for m in METRICS)


def test_the_cell_is_declared():
    bench = run.load_json(run.ROOT, "BENCHMARK.json")
    (w,) = [w for w in bench["workloads"] if w["name"] == CELL]
    assert w["config"] == "artic_v3" and w["chips"] == 1
    declared = {m["name"]: m for m in bench["per_layer"]}
    for name in METRICS:
        assert declared[name]["workloads"] == [CELL]
        assert declared[name]["moves"] == "search_mbps"
    cell = run.Cell(CELL)
    assert cell.params["genomes"] == 1024
    assert cell.slices == {"count": 32, "size": 20000}
    assert cell.warmup == {"genomes": 16}
