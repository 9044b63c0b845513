"""The port's step entry point and device microbench
(tntblast_tpu_torch.entry, tntblast_tpu_torch.tools.device_bench) on the
CPU: `entry("cpu")` against __graft_entry__.entry() under jax.jit on the
same seed, every output equal exactly; the multi-device dry run; the
microbench's arithmetic on a CPU step of a small panel."""

import json
import sys

import jax
import numpy as np
import pytest
import torch

import __graft_entry__ as jax_entry
import bench_data
from tntblast_tpu_torch import entry as port_entry
from tntblast_tpu_torch.tools import device_bench


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def test_entry_equals_the_jax_entry():
    """Both steps return (header, kept_block, slot, p, keep, needs_host,
    valid) in this order.  All are compared whole except kept_block, whose
    columns past header[0] = n_kept are out of contract (the resolve reads
    only that prefix); keep and needs_host are the all-zero placeholders of
    a step with full=False in both."""
    fn, args = port_entry.entry("cpu")
    got = [t.numpy() for t in fn(*args)]
    jfn, jargs = jax_entry.entry()
    want = [np.asarray(a) for a in jax.jit(jfn)(*jargs)]
    assert len(got) == len(want) == 7
    names = ("header", "kept_block", "slot", "p", "keep", "needs_host",
             "valid")
    n_kept = int(want[0][0])
    assert n_kept > 0 and n_kept <= want[1].shape[1]
    for name, g, w in zip(names, got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        if name == "kept_block":
            g, w = g[:, :n_kept], w[:, :n_kept]
        np.testing.assert_array_equal(g, w, err_msg=name)
    # the panel's example arrays are the original's
    for g, w in zip(port_entry._example_panel(8, 26, 32, 2, 7,
                                              np.random.default_rng(3)),
                    jax_entry._example_panel(8, 26, 32, 2, 7,
                                             np.random.default_rng(3))):
        np.testing.assert_array_equal(g, w)


def test_dryrun_multichip_on_two_cpu_mesh_entries(monkeypatch):
    import tntblast_tpu_torch.parallel.panel as port_panel

    made = []

    class Spy(port_panel.FragmentPanelManager):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            made.append(self)

    monkeypatch.setattr(port_panel, "FragmentPanelManager", Spy)
    port_entry.dryrun_multichip(2, device="cpu")
    (mgr,) = made
    assert mgr.mesh == [torch.device("cpu")] * 2 and mgr.batch == 2
    assert mgr.stats["fragments"] == 7 and mgr.stats["fallback"] == 0


def test_entry_points_raise_without_a_card():
    """entry(), dryrun_multichip(n) and the module's main run on the card
    by default and raise where there is none."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port_entry.entry()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_entry.dryrun_multichip(1)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port_entry.main()


@pytest.fixture
def small_bench(tmp_path, monkeypatch):
    """The bench generator at a small size: 2 x 20 kb, 2 planted assays."""
    for name, value in (("NSEQ", 2), ("SEQLEN", 20000), ("NASSAY", 2),
                        ("NPLANT", 2), ("PLANTS_PER_SEQ", 2)):
        monkeypatch.setattr(bench_data, name, value)
    monkeypatch.setenv("TNTBLAST_TPU_BATCH", "2")
    return bench_data.build(str(tmp_path / "bench"))


def test_device_bench_on_a_small_cpu_step(small_bench):
    fna, panel = small_bench
    res = device_bench.run(fna, panel, device="cpu", reps=1)
    assert res["device"] == "cpu" and res["n_frags"] == 2
    assert res["candidates"] >= res["kept_seeds"] > 0
    # the header arithmetic: wq_max 24 at most, three conditions
    wq_max = max(len(w) for line in open(panel) for w in line.split()[1:])
    cells = res["candidates"] * wq_max * (wq_max + 8) * 3
    assert res["dp_cells_per_s"] == pytest.approx(
        cells / (res["batch_ms"] / 1e3))
    # two whole 20 kb sequences (each shorter than a fragment)
    assert res["mbases_per_s"] == pytest.approx(
        2 * 20000 / (res["batch_ms"] / 1e3) / 1e6)
    # every stage of the step was timed, the per-chunk ones once a chunk
    assert set(res["stage_ms"]) == set(device_bench.STAGES)
    assert res["stage_spans"]["tnt.seed"] == 1
    assert (res["stage_spans"]["tnt.decode"]
            == res["stage_spans"]["tnt.screen_dp"]
            == res["stage_spans"]["tnt.eval"] >= 1)
    assert all(v >= 0 for v in res["stage_ms"].values())
    assert sum(res["stage_ms"].values()) <= res["staged_step_wall_ms"]
    # the chunks past the pooled candidates are counted and timed apart
    assert 1 <= res["live_chunks"] <= res["chunks"]
    assert res["chunks"] == res["stage_spans"]["tnt.eval"]
    assert set(res["empty_chunk_stage_ms"]) == set(
        device_bench.CHUNK_STAGES)
    for k, v in res["empty_chunk_stage_ms"].items():
        assert 0 <= v <= res["stage_ms"][k]
        assert (v == 0) == (res["live_chunks"] == res["chunks"])
    # CPU tensors take the plain versions: no kernel launch is counted
    assert res["eval_pack_launches_per_step"] == 0
    assert res["screen_dp_launches_per_step"] == 0
    # no device figure from a CPU run
    assert "utilization_pct" not in res and "card" not in res
    json.dumps(res)


def test_device_bench_arithmetic():
    assert device_bench.dp_cells(10, 24, 3) == 10 * 24 * 32 * 3
    res = device_bench.summarize(4_000_000, 0.5, 8, 100, 2000, 5_000_000)
    assert res == {"mbases_per_s": 8.0, "batch_ms": 500.0, "n_frags": 8,
                   "kept_seeds": 100, "candidates": 2000,
                   "dp_cells_per_s": 1e7}
    # 64 lanes x 132 SMs at 1980 MHz over (13 + 13 + 19) / 3 operations
    assert device_bench.cell_ceiling(2, True, 1.98e9) == pytest.approx(
        64 * 132 * 1.98e9 / 15)
    assert device_bench.cell_ceiling(1, False, 1e9) == pytest.approx(
        64 * 132 * 1e9 / 13)


def test_stage_timer_sums_spans_by_name():
    timer = device_bench.StageTimer("cpu")
    for name in ("a", "b", "a"):
        with timer.span(name):
            pass
    totals = timer.totals_ms()
    assert totals["a"][1] == 2 and totals["b"][1] == 1
    assert totals["a"][0] >= 0
    spans = timer.spans_ms()
    assert len(spans["a"]) == 2 and sum(spans["a"]) == totals["a"][0]


def test_device_bench_raises_without_a_card(small_bench, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        device_bench.run(*small_bench)
    monkeypatch.setattr(sys, "argv", ["device_bench"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        device_bench.main([])
