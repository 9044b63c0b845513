"""Window accounting: the rate is every search's bases over the time from
the first start to the last end, so a stall inside the window lowers it."""

import time

import run


def _loop(n, stall_at=None, stall=0.05):
    out, t = [], time.perf_counter()
    for i in range(n):
        start = time.perf_counter()
        time.sleep(0.01)
        end = time.perf_counter()
        out.append({"start": start, "end": end})
        if i == stall_at:
            time.sleep(stall)
    assert out[0]["start"] >= t
    return out


def test_a_stall_inside_the_window_lowers_the_rate():
    bases = 1_000_000
    calm = run.window_rate(_loop(5), lambda s: bases)
    stalled = run.window_rate(_loop(5, stall_at=2), lambda s: bases)
    assert stalled < calm * 0.8


def test_rate_counts_every_search_over_the_whole_span():
    searches = [{"start": 10.0, "end": 11.0}, {"start": 11.0, "end": 12.5},
                {"start": 12.5, "end": 14.0}]
    assert run.window_rate(searches, lambda s: 2_000_000) == 6.0 / 4.0


def test_window_covers_every_panel(monkeypatch, tmp_path):
    cell = run.Cell("config5.chrom128", rehearse=True)
    cell.data = {"db": "db.fna", "queries": {"pcr": "p", "padlock": "q"}}
    monkeypatch.setattr(run, "run_search", lambda argv, device: (0, None))
    w = run.Window(cell, str(tmp_path), "cpu", lambda: None)
    w.run(0.0)
    assert [s["search"] for s in w.searches] == ["pcr", "padlock"]
