"""The device timeline's arithmetic and the per-layer readers on a
synthetic trace."""

import types

import devtrace
import run


def _trace():
    dev = types.SimpleNamespace(intervals=[
        ("k1", "kernel", 1.0, 1.5), ("Memcpy DtoH", "copy", 1.4, 1.6),
        ("k2", "kernel", 3.0, 3.25), ("k1", "kernel", 9.0, 9.5)])
    split = types.SimpleNamespace(
        spans={"handle wait": [2.0, 4], "fragment context": [5.0, 3],
               "host search": [3.0, 3]},
        intervals=[("search", 1, 0.0, 10.0), ("fragment context", 2, 1.6,
                                              2.9),
                   ("handle wait", 3, 3.3, 8.0)],
        steps=[{"slot_len": [20], "conds": [1], "eval_on": False,
                "flank": 4, "counts": [[100]], "n_kept": 0,
                "payload_bytes": 0, "table_bytes": 0, "header_bytes": 0}])
    searches = [{"start": 0.0, "end": 5.0, "first_step_end": 0.5,
                 "stats": {"steps": 2, "seeds": 100, "kept": 40,
                           "fallback": 0}},
                {"start": 5.0, "end": 10.0, "first_step_end": 5.25,
                 "stats": {"steps": 2, "seeds": 100, "kept": 60,
                           "fallback": 2}}]
    return run.Trace(split, searches, (0.0, 10.0), dev, 20.0)


def test_busy_union_and_gaps():
    busy, gaps = devtrace.busy_and_gaps(_trace().device.intervals, 0.0, 10.0)
    assert abs(busy - (0.6 + 0.25 + 0.5)) < 1e-12
    assert gaps == [(0.0, 1.0), (1.6, 3.0), (3.25, 9.0), (9.5, 10.0)]


def test_gaps_are_labelled_by_the_innermost_host_span():
    t = _trace()
    assert devtrace.label_gap((1.6, 3.0), t.split.intervals) == \
        "fragment context"
    assert devtrace.label_gap((3.25, 9.0), t.split.intervals) == \
        "handle wait"
    assert devtrace.label_gap((0.0, 1.0), t.split.intervals) == "search"
    assert devtrace.label_gap((11.0, 12.0), t.split.intervals) == "no span"
    # an inner span over a small part of a gap does not name it
    assert devtrace.label_gap((0.0, 2.0), t.split.intervals) == "search"


def test_readers():
    bench = run.load_json(run.ROOT, "BENCHMARK.json")
    t = _trace()
    got = {m["name"]: run.load_module("metrics", m["name"]).read(t)
           for m in bench["per_layer"]}
    assert abs(got["device_idle_share"] - 100 * (1 - 1.35 / 10)) < 1e-9
    # device time summed over activities (a copy beside a kernel counts)
    assert abs(got["step_device_ms"] - 1e3 * 1.45 / 4) < 1e-9
    assert abs(got["kept_share"] - 50.0) < 1e-12
    assert got["fallback_frags"] == 1.0
    assert abs(got["wait_share"] - 20.0) < 1e-12
    assert abs(got["ctx_ms_per_mb"] - 250.0) < 1e-12
    assert abs(got["search_setup_ms"] - 375.0) < 1e-9
    least = 100 * 20 * 28 * 13 / (64 * 132 * 1980e6)
    assert abs(got["step_roofline"] - 100 * least / 1.25) < 1e-9
