"""The per-layer readers of the program's own spans (benchmark/progtrace.py
and the metrics that use it) on a CPU rehearsal: each reads a number from
a traced run made under a CPU profiler session (the program traces its
searches while one records), nothing from one made without it; and the
benchmark's own wrapper still finds every function it wraps."""

import contextlib
import io
import json

import pytest
from torch.profiler import ProfilerActivity, profile

import instrument
import run

CELL = "config5.chrom128"
PROGRAM = ("db_open_ms", "record_decode_ms", "panel_build_ms", "drain_ms",
           "output_ms", "frag_index_ms_per_mb", "seed_inject_ms_per_mb")
# read from timing events on a card's stream: never on the CPU
DEVICE = ("step_event_ms",)


def _rehearse(keep=None):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = run.main(["--workload", CELL, "--seed", "2147483659",
                       "--seconds", "0.01", "--trace", "1", "--rehearse"],
                      keep=keep)
    assert rc == 0
    return json.loads(out.getvalue().strip().splitlines()[-1])


@pytest.fixture(scope="module")
def profiled():
    with profile(activities=[ProfilerActivity.CPU]):
        res = _rehearse()
    assert res["correct"] is True
    return res


@pytest.fixture(scope="module")
def plain():
    res = _rehearse()
    assert res["correct"] is True
    return res


def test_every_new_metric_is_declared():
    bench = run.load_json(run.ROOT, "BENCHMARK.json")
    declared = {m["name"]: m for m in bench["per_layer"]}
    for name in PROGRAM + DEVICE:
        m = declared[name]
        assert m["moves"] == "search_mbps" and m["workloads"] == [CELL]
        assert m["source"] == ("program_counter" if name in DEVICE
                               else "program_span")


@pytest.mark.parametrize("name", PROGRAM)
def test_reads_the_programs_spans_under_a_profiler(profiled, name):
    value = profiled["metrics"][name]["value"]
    assert value > 0
    # the existing readers still read theirs
    for old in ("search_setup_ms", "ctx_ms_per_mb", "wait_share",
                "kept_share", "fallback_frags"):
        assert old in profiled["metrics"]


@pytest.mark.parametrize("name", PROGRAM + DEVICE)
def test_reads_nothing_untraced(plain, name):
    assert name not in plain["metrics"]


@pytest.mark.parametrize("name", DEVICE)
def test_no_device_number_from_the_cpu(profiled, name):
    assert name not in profiled["metrics"]


def test_program_and_wrapper_agree_on_the_fragment_context(profiled):
    """host.frag_index + host.seed_inject lie inside the wrapper's
    "fragment context": together they read no more than it."""
    ctx = profiled["metrics"]["ctx_ms_per_mb"]["value"]
    parts = sum(profiled["metrics"][n]["value"]
                for n in ("frag_index_ms_per_mb", "seed_inject_ms_per_mb"))
    assert 0 < parts <= ctx


def test_the_wrapper_still_wraps_every_function(monkeypatch):
    """The benchmark's WallSplit finds every function it names in the
    program: no span of its list is empty in a traced rehearsal (one
    fragment a step, so that a panel's second step is a "step"; the
    resolve's sync needs a card)."""
    monkeypatch.setenv("TNTBLAST_TPU_BATCH", "1")
    made = []
    real = instrument.WallSplit.__init__

    def init(self):
        real(self)
        made.append(self)

    monkeypatch.setattr(instrument.WallSplit, "__init__", init)
    _rehearse()
    (split,) = made
    for name in ("manager build", "panel build", "first step", "step",
                 "search", "resolve", "handle wait", "fragment context",
                 "host search"):
        assert split.spans.get(name, [0.0, 0])[1] >= 1, name
    assert split.managers and split.steps
