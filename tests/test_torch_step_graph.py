"""The device step's CUDA graph on the CPU side: the key of its cache
(tntblast_tpu_torch/parallel/step_graph.py, DevicePanel.graph_key), the
launch counts a replay adds, the in-flight contract of the step (several
batches queued before any is resolved, resolved out of order, against each
run alone and against the JAX step), and the wall split of
tntblast_tpu_torch/profile_slice.py, read from the program's spans, on a
small golden search.  The graph
itself needs a card: tests/test_torch_cuda.py."""

import io
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tntblast_tpu import constants as JC
from tntblast_tpu import native as jnative
from tntblast_tpu.parallel import device_search as J
from tntblast_tpu.screen import TpuScreen
from tntblast_tpu.search import seed as jseed
from tntblast_tpu.thermo.santa_lucia import build_tables
from tntblast_tpu_torch import ops
from tntblast_tpu_torch.parallel import device_search as T
from tntblast_tpu_torch.parallel import step_graph

HERE = pathlib.Path(__file__).resolve().parent
GOLD = HERE / "golden" / "e2e"

FWD = "TTGACCTAGATATTCAGCAAC"
REV = "GGGAGAGACTCACCCAAAGATC"


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def jax_panel():
    """A JAX DevicePanel on the word-table path: two screening conditions
    and the eval condition."""
    engine = jnative.MeltEngine(n_threads=1)
    w = 7
    scr = TpuScreen(engine, dangle=False)
    conds = scr.conditions({"min_tm": 40.0, "max_dg": -9.0}, 9e-7)
    dg = np.stack([np.asarray(scr._dg_table(t)) for _, t, _ in conds])
    thr = np.array([[ms] * 4 for _, _, ms in conds], np.int32)
    cfg = J.PanelConfig(word_len=w, num_os=8, max_words=16, wq_max=22,
                        tile_len=16384, cap=1024, num_cond=2)
    panel = []
    for oligo, minus in ((FWD, True), (FWD, False), (REV, True),
                         (REV, False)):
        codes = JC.ASCII_TO_MELT[np.frombuffer(oligo.encode(), np.uint8)]
        panel.append({"words": jseed.oligo_word_list(
            codes, w, complement=not minus), "codes": codes, "minus": minus})
    ev_dg = np.ascontiguousarray(engine.delta_g().astype(np.int32).ravel())
    return J.DevicePanel(panel, cfg, dg, thr, eval_dg=ev_dg,
                         thermo_tables=build_tables())


def _port(jdp, tables=None, config=None, eval_const=None):
    return T.DevicePanel.from_tables(
        config or jdp.config, jdp.slot_meta,
        jdp.eval_const if eval_const is None else eval_const, jdp.s_max,
        jdp.k_max, tables or J._PANEL_TABLES[jdp._tab_digest], "cpu",
        eval_on=jdp.eval_on)


def _batches(count, n, seed_):
    rng = np.random.default_rng(seed_)
    site = JC.ASCII_TO_DB[np.frombuffer(FWD.encode(), np.uint8)]
    out = []
    for j in range(count):
        frags = [rng.integers(0, 4, int(rng.integers(2000, 16000))).astype(
            np.uint8) for _ in range(n)]
        frags[j % n][500 + 31 * j:500 + 31 * j + len(site)] = site
        frags[(j + 1) % n][1000:1300] = JC.DB_N
        out.append(frags)
    return out


def test_config_key_is_the_jax_key(jax_panel):
    cfg = jax_panel.config
    port = T.PanelConfig(cfg.word_len, cfg.num_os, cfg.max_words, cfg.wq_max,
                         cfg.tile_len, cfg.cap, cfg.num_cond)
    assert port.key() == cfg.key()


def test_graph_key_is_the_same_for_the_same_panel(jax_panel):
    """Two panels from the same panel and tables have one key (a fresh
    panel per search replays the graph of the last); a key holds every
    static part of the step, the tables' digest and the card."""
    a, b = _port(jax_panel), _port(jax_panel)
    assert a.graph_key(8, False) == b.graph_key(8, False)
    assert a.table_digest() == b.table_digest()
    assert a.graph_key(8, False, "cuda:0") == b.graph_key(8, False,
                                                          "cuda:0")
    keys = {a.graph_key(8, False), a.graph_key(4, False),
            a.graph_key(8, True), a.graph_key(8, False, "cuda:0"),
            a.graph_key(8, False, "cuda:1")}
    assert len(keys) == 5
    cfg = jax_panel.config
    wider = T.PanelConfig(cfg.word_len, cfg.num_os, cfg.max_words,
                          cfg.wq_max, 2 * cfg.tile_len, cfg.cap,
                          cfg.num_cond)
    assert (_port(jax_panel, config=wider).graph_key(8, False)
            != a.graph_key(8, False))
    assert (_port(jax_panel, eval_const=(1.0, 0.0, 0.0, 0.0))
            .graph_key(8, False) != a.graph_key(8, False))


@pytest.mark.parametrize("table", range(7))
def test_graph_key_follows_each_table(jax_panel, table):
    """A change to any one of the seven host tables gives another key."""
    tables = [np.array(t) for t in J._PANEL_TABLES[jax_panel._tab_digest]]
    flat = tables[table].reshape(-1)
    flat[len(flat) // 2] += 1
    changed = _port(jax_panel, tables=tuple(tables))
    assert changed.table_digest() != _port(jax_panel).table_digest()
    assert changed.graph_key(8, False) != _port(jax_panel).graph_key(
        8, False)


def test_replay_adds_the_launches_its_capture_took_back():
    before = ops.counts()
    ops.add({"seed": 2, "screen_dp": 3})
    got = ops.counts()
    ops.add({"seed": -2, "screen_dp": -3})
    assert got == {k: v + {"seed": 2, "screen_dp": 3}.get(k, 0)
                   for k, v in before.items()}
    assert ops.counts() == before


def test_cpu_step_never_graphs(jax_panel):
    """The CPU step is eager: it neither captures nor replays."""
    stats = dict(step_graph.stats)
    kept = len(step_graph.graphs())
    dp = _port(jax_panel)
    dp.resolve_fragments(dp.submit_fragments(_batches(1, 2, 5)[0]))
    assert step_graph.stats == stats and len(step_graph.graphs()) == kept


def test_eager_step_is_the_step(jax_panel):
    """tools/bench_inputs.eager_step, the tools' eager step, gives the
    outputs of DevicePanel.step (on the CPU both dispatch op by op)."""
    from tntblast_tpu_torch.tools.bench_inputs import eager_step

    dp = _port(jax_panel)
    payload = dp._pack_host(_batches(1, 3, 7)[0])
    for full in (False, True):
        for got, want in zip(eager_step(dp, payload, full),
                             dp.step(payload, full=full)):
            assert torch.equal(got, want)


def _results_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        # a fast resolve's fragment in the JAX panel's layout
        g, w = (r.fields() if isinstance(r, T.FragmentKept) else r
                for r in (g, w))
        assert g.keys() == w.keys()
        for k in w:
            np.testing.assert_array_equal(np.asarray(g[k]), np.asarray(w[k]),
                                          err_msg=k)


@pytest.mark.parametrize("full", [False, True])
def test_steps_in_flight_resolve_in_any_order(jax_panel, full):
    """Four steps queued before any is resolved, resolved last first, each
    equal to the same batch run alone and to the JAX step."""
    dp = _port(jax_panel)
    batches = _batches(4, 3, 11 + full)
    pending = [dp.submit_fragments(b, full=full) for b in batches]
    resolve = "resolve_fragments_full" if full else "resolve_fragments"
    for i in reversed(range(len(batches))):
        got = getattr(dp, resolve)(pending[i])
        alone = _port(jax_panel)
        _results_equal(got, getattr(alone, resolve)(
            alone.submit_fragments(batches[i], full=full)))
        _results_equal(got, getattr(jax_panel, resolve)(
            jax_panel.submit_fragments(batches[i], full=full)))
        # the step's raw outputs against the JAX step's
        payload = dp._pack_host(batches[i])
        want = [np.asarray(x) for x in jax_panel._step(len(batches[i]),
                                                       full)(
            *(jnp.asarray(a) for a in payload), *jax_panel.args)]
        raw = pending[i][1]
        np.testing.assert_array_equal(raw[0].numpy(), want[0])
        m = min(int(want[0][0]), dp.config.batch_kcap(len(batches[i])))
        np.testing.assert_array_equal(raw[1][:, :m].numpy(), want[1][:, :m])


def _search(args, flags, out, monkeypatch):
    """One traced search of pcr_small; its record (trace.py)."""
    from tntblast_tpu_torch import trace
    from tntblast_tpu_torch.cli import local_main

    monkeypatch.setenv("TNTBLAST_TPU_PROFILE", "1")
    n = len(trace.searches())
    rc = local_main(args + ["-o", str(out), "-v", "F"] + flags,
                    stdout=io.StringIO(), device="cpu")
    assert rc == 0
    assert out.read_text() == (GOLD / "pcr_small.out").read_text()
    assert len(trace.searches()) == min(n + 1, trace.KEEP)
    return trace.searches()[-1]


def test_wall_split_of_a_small_search(tmp_path, monkeypatch):
    """The wall split reads the program's spans of the device and host
    paths of pcr_small on the CPU, and tracing changes neither the output
    nor any function of the program."""
    from tntblast_tpu_torch import engine, trace
    from tntblast_tpu_torch.parallel import panel
    from tntblast_tpu_torch.profile_slice import split_lines

    monkeypatch.chdir(HERE / "data")
    args = (GOLD / "pcr_small.cmd").read_text().split()
    saved = (T.DevicePanel.step, T.DevicePanel.resolve_fragments,
             T.DevicePanel.__init__, panel.FragmentPanelManager.__init__,
             engine._BatchHandle.get, engine.search_assay,
             engine.run_search)
    search = _search(args, ["--tpu-screen", "T"], tmp_path / "d.out",
                     monkeypatch)
    spans = trace.self_times(search)
    assert set(spans) <= set(trace.NAMES)
    assert spans["cli.search"][1] == spans["panel.build"][1] == 1
    assert spans["panel.device_panel"][1] >= 1
    steps = spans["step.submit"][1]
    assert steps >= 1
    # one resolve a step, a worker's wait a fragment of a step
    assert spans["step.resolve"][1] == steps
    assert spans["host.wait"][1] >= steps
    assert spans["host.search"][1] >= spans["host.frag_index"][1] >= 1
    assert "step.sync" not in spans and "step.capture" not in spans
    assert search.root.attrs["captures"] == 0
    main = search.root.thread
    serial = sum(x.end - x.start for x in search.spans
                 if x.thread == main and x.parent == search.root_id)
    assert 0 < serial <= search.root.end - search.root.start
    assert all(s >= 0 for s, _ in spans.values())
    wall = search.root.end - search.root.start
    lines = split_lines("device", wall * 2, search)
    assert len(lines) == len(trace.NAMES) + 1

    host = trace.self_times(_search(args, [], tmp_path / "h.out",
                                    monkeypatch))
    assert host["cli.search"][1] == 1 and host["host.search"][1] >= 1
    assert not {"panel.build", "panel.device_panel", "step.submit",
                "step.resolve", "host.wait"} & set(host)
    assert saved == (T.DevicePanel.step, T.DevicePanel.resolve_fragments,
                     T.DevicePanel.__init__,
                     panel.FragmentPanelManager.__init__,
                     engine._BatchHandle.get, engine.search_assay,
                     engine.run_search)
