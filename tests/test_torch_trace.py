"""The port's tracer (tntblast_tpu_torch/trace.py) on the CPU: a search is
traced where TNTBLAST_TPU_PROFILE is set or a torch.profiler session
records, and nowhere else; its spans nest, name their search, their parent
and the step they wait for; the device path's layers each leave their
spans and the host path none of the device's; the output is the golden's
either way."""

import io
import pathlib
import sys
import threading
import timeit

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from tntblast_tpu_torch import cli, trace
from tntblast_tpu_torch import engine as eng
from tntblast_tpu_torch.parallel import panel as port_panel

HERE = pathlib.Path(__file__).resolve().parent
DATA = HERE / "data"
GOLD = HERE / "golden" / "e2e"

DEVICE = ["--tpu-screen", "T"]


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    monkeypatch.chdir(DATA)
    monkeypatch.setenv("TNTBLAST_TPU_THREADS", "2")
    monkeypatch.delenv("TNTBLAST_TPU_PROFILE", raising=False)
    yield
    torch.set_num_threads(prev)


def _search(name, tmp_path, flags):
    args = (GOLD / f"{name}.cmd").read_text().split()
    out = tmp_path / f"{name}.out"
    rc = cli.local_main(args + ["-o", str(out), "-v", "F"] + flags,
                        stdout=io.StringIO(), device="cpu")
    assert rc == 0
    assert out.read_text() == (GOLD / f"{name}.out").read_text()


def _new(before):
    """The searches recorded since `before` (trace.searches() then)."""
    ids = {s.id for s in before}
    return [s for s in trace.searches() if s.id not in ids]


def _names(s):
    return [x.name for x in s.spans]


def _count_calls(monkeypatch, owner, attr):
    calls = []
    real = getattr(owner, attr)

    def spy(*args, **kw):
        calls.append(1)
        return real(*args, **kw)

    monkeypatch.setattr(owner, attr, spy)
    return calls


def test_off_by_default(tmp_path, monkeypatch):
    """No switch: nothing recorded, no timing event made, the null span
    everywhere, the output the golden's."""
    def no_event(*a, **k):
        raise AssertionError("a timing event with tracing off")

    monkeypatch.setattr(torch.cuda, "Event", no_event)
    before = trace.searches()
    _search("pcr_small", tmp_path, DEVICE)
    _search("pcr_small", tmp_path, [])
    assert _new(before) == []
    assert trace.span("cli.search") is trace.span("io.read") is trace._NULL
    assert trace.current() is trace._NULL

    def fn():
        pass
    assert trace.bind(fn) is fn


@pytest.fixture(params=["env", "profiler"])
def switch(request, monkeypatch):
    """Tracing on by TNTBLAST_TPU_PROFILE, or by a CPU profiler session."""
    if request.param == "env":
        monkeypatch.setenv("TNTBLAST_TPU_PROFILE", "1")
        yield
    else:
        with profile(activities=[ProfilerActivity.CPU]):
            yield


def _assays(name):
    """The assays of a golden's query file."""
    args = (GOLD / f"{name}.cmd").read_text().split()
    path = DATA / args[args.index("-i") + 1]
    return sum(1 for line in path.read_text().splitlines() if line.split())


@pytest.mark.parametrize("name", ["pcr_small", "pcr_frag", "shared_cache"])
def test_device_path_spans(name, tmp_path, monkeypatch, switch):
    submits = _count_calls(monkeypatch, port_panel.FragmentPanelManager,
                           "submit_batch")
    contexts = _count_calls(monkeypatch, eng, "NativeFragContext")
    before = trace.searches()
    _search(name, tmp_path, DEVICE)
    (s,) = _new(before)
    root = s.root
    assert root.name == "cli.search" and root.parent is None
    assert root.id == s.root_id and "assay_format" in root.attrs
    assert _names(s).count("cli.search") == 1
    assert all(x.search == s.id for x in s.spans)
    by_id = {x.id: x for x in s.spans}
    assert len(by_id) == len(s.spans)
    for x in s.spans:
        assert root.start <= x.start <= x.end <= root.end, x
        if x is root:
            continue
        p = by_id[x.parent]
        if p.thread == x.thread:
            assert p.start <= x.start and x.end <= p.end, (p, x)
        else:
            # handed to a worker or resolve thread: under the root
            assert p is root, x
    submit_ids = {x.id for x in s.spans if x.name == "step.submit"}
    causes = [x for x in s.spans if x.cause is not None]
    assert causes and all(x.cause in submit_ids for x in causes)
    assert {x.name for x in causes} == {"host.wait", "step.resolve"}
    assert len(submit_ids) == len(submits) >= 1
    assert _names(s).count("panel.build") == 1
    assert _names(s).count("panel.device_panel") >= 1
    assert len(contexts) >= 1
    for span_name in ("host.frag_index", "host.seed_inject"):
        assert _names(s).count(span_name) >= len(contexts)
    # a panel of several assays: one native call a work item searches them
    if _assays(name) > 1:
        assert _names(s).count("host.panel_search") == len(contexts)
        assert s.counters["host.panel.calls"] == len(contexts)
        assert s.counters["host.panel.assays"] == (
            _assays(name) * len(contexts))
    else:
        assert "host.panel_search" not in _names(s)
        assert "host.panel.calls" not in s.counters
    for span_name in ("cli.options", "io.open", "cli.melt_engine",
                      "engine.plan", "io.read", "io.decode", "step.resolve",
                      "engine.drain", "engine.apply", "host.wait",
                      "host.search", "cli.output"):
        assert span_name in _names(s), span_name
    # no card: no step timing, no capture, no sync
    assert not {"step.sync", "step.capture"} & set(_names(s))
    assert trace.step_device_ms(s) == []
    assert root.attrs["panel"]["steps"] >= len(submits)
    assert root.attrs["captures"] == 0
    assert s.counters["io.bytes_decoded"] > 0
    # the main thread's own layers, the workers' and the resolve threads'
    main = {x.name for x in s.spans if x.thread == root.thread}
    assert {"io.read", "step.submit", "engine.drain"} <= main
    assert not {"host.wait", "host.frag_index", "step.resolve"} & main


def test_host_path_has_no_device_spans(tmp_path, monkeypatch, switch):
    before = trace.searches()
    _search("pcr_small", tmp_path, [])
    (s,) = _new(before)
    names = set(_names(s))
    assert {"cli.search", "io.open", "io.read", "host.frag_index",
            "host.search", "cli.output"} <= names
    assert not {n for n in names if n.startswith(("panel.", "step."))}
    assert "host.seed_inject" not in names and "host.wait" not in names
    assert "panel" not in s.root.attrs


def test_profile_line(tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("TNTBLAST_TPU_PROFILE", "1")
    _search("pcr_small", tmp_path, DEVICE)
    err = capsys.readouterr().err.splitlines()
    (line,) = [x for x in err if x.startswith("[profile] spans")]
    assert line.startswith("[profile] spans (self ms, count): cli.search ")
    for name in ("io.open", "panel.build", "step.submit", "host.frag_index",
                 "host.seed_inject", "cli.output"):
        assert f" {name} " in line, name
    assert "io.bytes_decoded" in line
    s = trace.searches()[-1]
    times = trace.self_times(s)
    assert f"step.submit {1e3 * times['step.submit'][0]:.3f} (" in line


def test_keeps_the_last_searches(monkeypatch):
    monkeypatch.setenv("TNTBLAST_TPU_PROFILE", "1")
    made = []
    for i in range(trace.KEEP + 6):
        with trace.search("cli.search", i=i) as root:
            with trace.span("io.open"):
                trace.count("io.bytes_decoded", i)
        made.append(root.search)
    kept = trace.searches()
    assert len(kept) == trace.KEEP
    assert kept == made[-trace.KEEP:]
    assert [s.root.attrs["i"] for s in kept] == list(range(6, trace.KEEP + 6))
    assert kept[-1].counters == {"io.bytes_decoded": trace.KEEP + 5}


def test_a_span_off_costs_under_a_microsecond():
    def one():
        with trace.span("host.search"):
            pass

    n = 20000
    best = min(timeit.repeat(one, number=n, repeat=5)) / n
    assert best < 1e-6, best


def test_threads_lose_no_span_or_count(monkeypatch):
    """Many threads bound to one search record every span and count."""
    monkeypatch.setenv("TNTBLAST_TPU_PROFILE", "1")
    threads, per = 32, 200
    prev = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with trace.search("cli.search") as root:
            def work():
                for _ in range(per):
                    with trace.span("host.search"):
                        trace.count("io.bytes_decoded")
            ts = [threading.Thread(target=trace.bind(work))
                  for _ in range(threads)]
            for t in ts:
                t.start()
            for t in ts:
                t.join(timeout=60)
            assert not any(t.is_alive() for t in ts)
    finally:
        sys.setswitchinterval(prev)
    s = root.search
    assert _names(s).count("host.search") == threads * per
    assert s.counters["io.bytes_decoded"] == threads * per
    assert {x.parent for x in s.spans if x.name == "host.search"} == {
        s.root_id}
