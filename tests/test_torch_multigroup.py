"""A panel of more than 64 slots through the port's device path on the CPU
(the kernels' plain versions): 40 PCR assays of 22-30-nt primers tiled
over a 12 kb genome, 160 slots in three panel groups, two of whose windows
run past screen_dp's widest register width, searched over a FASTA of
short records, some with substitutions under primers.  The JAX package's
device path (the reference), the port's device path and the port's host
path print byte-equal output, both device paths form the same three
groups, no fragment falls back to host seeding, and the trace holds the multi-group spans and counters (step.group,
panel.groups, panel.slots, host.fragments, output.records and
screen.chunks.reg / .strip).  A batch is packed once for its three
group steps, as the JAX package packs each."""

import io

import numpy as np
import pytest
import torch

import tntblast_tpu_torch.parallel.device_search as port_ds
import tntblast_tpu_torch.parallel.panel as port_panel
from tntblast_tpu import cli as jax_cli
from tntblast_tpu.parallel import device_search as jax_ds
from tntblast_tpu.parallel import panel as jax_panel
from tntblast_tpu_torch import cli, trace
from tntblast_tpu_torch import constants as C
from tntblast_tpu_torch.ops.screen_dp import REG_WIDTHS

N_ASSAYS = 40
N_RECORDS = 8
ARGS = ["-A", "PCR", "-e", "40", "-E", "45", "-l", "2000", "-v", "F"]
BASES = np.frombuffer(b"ACGT", np.uint8)


def _text(codes):
    return BASES[codes].tobytes().decode()


def _panel_and_records(rng):
    """40 amplicons of about 380 bases, 300 apart, over one ancestral
    genome; the primers of the first 32 drawn from 22-30 nt, of the last 8
    from 22-24 nt (a group whose windows fit the register path).  Record
    0 is the ancestor, each other one carries substitutions (some under
    primers) and records 3 and 5 a deletion."""
    genome = rng.choice(4, 300 * N_ASSAYS + 200,
                        p=[0.3, 0.2, 0.2, 0.3]).astype(np.uint8)
    rows, sites = [], []
    for a in range(N_ASSAYS):
        top = 30 if a < 32 else 24
        lf, lr = (int(x) for x in rng.integers(22, top + 1, 2))
        lo, hi = 30 + 300 * a, 30 + 300 * a + 380
        rows.append(f"ASY{a:02d}\t{_text(genome[lo:lo + lf])}\t"
                    f"{_text((3 - genome[hi - lr:hi])[::-1])}\n")
        sites += [(lo, lo + lf), (hi - lr, hi)]
    records = []
    for k in range(N_RECORDS):
        g = genome.copy()
        if k:
            under = [int(rng.integers(a, b)) for a, b in (
                sites[int(i)] for i in rng.choice(len(sites), 3, False))]
            pos = np.array(under + list(rng.choice(len(g), 10, False)))
            g[pos] = (g[pos] + rng.integers(1, 4, len(pos))) % 4
        if k in (3, 5):
            d = int(rng.integers(100, len(g) - 100))
            g = np.concatenate([g[:d], g[d + int(rng.integers(3, 10)):]])
        records.append(f">rec{k} synthetic\n{_text(g)}\n")
    return "".join(rows), "".join(records)


@pytest.fixture(scope="module")
def searches(tmp_path_factory):
    """The output of the JAX package's device path, of the port's host
    path and of the port's traced device path; the panel managers of both
    device paths and the port's trace record."""
    tmp = tmp_path_factory.mktemp("multigroup")
    queries, db = _panel_and_records(np.random.default_rng(2023))
    (tmp / "q.txt").write_text(queries)
    (tmp / "db.fna").write_text(db)
    base = ["-i", str(tmp / "q.txt"), "-d", str(tmp / "db.fna")] + ARGS
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    made = {"jax": [], "device": []}
    submits = []
    real_submit = port_ds.DevicePanel.submit_fragments

    def submit(dp, frags, full=False, payload=None):
        submits.append((dp, payload))
        return real_submit(dp, frags, full=full, payload=payload)

    def spy(mod, name):
        class Spy(mod.FragmentPanelManager):
            def __init__(self, *a, **k):
                super().__init__(*a, **k)
                made[name].append(self)
        return Spy

    runs = (("jax", lambda argv: jax_cli.local_main(
                argv + ["--tpu-screen", "T"], stdout=io.StringIO())),
            ("host", lambda argv: cli.local_main(
                argv, stdout=io.StringIO(), device="cpu")),
            ("device", lambda argv: cli.local_main(
                argv + ["--tpu-screen", "T"], stdout=io.StringIO(),
                device="cpu")))
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("TNTBLAST_TPU_THREADS", "2")
        mp.setattr(jax_panel, "FragmentPanelManager", spy(jax_panel, "jax"))
        mp.setattr(port_panel, "FragmentPanelManager",
                   spy(port_panel, "device"))
        mp.setattr(port_ds.DevicePanel, "submit_fragments", submit)
        for name, run in runs:
            if name == "device":
                mp.setenv("TNTBLAST_TPU_PROFILE", "1")
            path = tmp / f"{name}.out"
            assert run(base + ["-o", str(path)]) == 0
            out[name] = path.read_text()
    torch.set_num_threads(prev)
    out["managers"] = made["device"]
    out["jax_managers"] = made["jax"]
    out["trace"] = trace.searches()[-1]
    out["submits"] = submits
    return out


def test_device_path_equals_host_path(searches):
    host = searches["host"]
    assert searches["jax"] == searches["device"] == host
    # a hit list of nearly every amplicon in every record
    assert host.count("\nname = ") >= N_RECORDS * (N_ASSAYS - 4)


def test_three_groups_and_no_fallback(searches):
    (mgr,) = searches["managers"]
    (jax_mgr,) = searches["jax_managers"]
    assert [len(g.keys) for g in mgr.groups] == [64, 64, 32]
    keys = [k for g in mgr.groups for k in g.keys]
    assert len(set(keys)) == len(keys) == 4 * N_ASSAYS
    # the reference forms the same groups of the same slots
    assert [g.keys for g in jax_mgr.groups] == [g.keys for g in mgr.groups]
    assert jax_mgr.stats["fallback"] == 0
    assert jax_mgr.stats["fragments"] == N_RECORDS
    assert mgr.stats["fallback"] == 0
    assert mgr.stats["fragments"] == N_RECORDS
    assert mgr.stats["steps"] == 3 * -(-N_RECORDS // mgr.batch)
    assert mgr.stats["kept"] > 0


def test_group_widths_take_both_screen_routes(searches):
    (mgr,) = searches["managers"]
    routes = []
    for g in mgr.groups:
        (dp,) = g._panels.values()
        chunks, route = dp.screen_chunks(mgr.batch)
        assert chunks >= 1
        assert (route == "strip") == (dp.config.wt > max(REG_WIDTHS))
        routes.append(route)
    assert routes == ["strip", "strip", "reg"]


def test_spans_and_counters(searches):
    s = searches["trace"]
    (mgr,) = searches["managers"]
    c = s.counters
    assert c["panel.groups"] == 3 and c["panel.slots"] == 4 * N_ASSAYS
    assert c["host.fragments"] == N_RECORDS
    assert c["output.records"] == searches["device"].count("\nname = ")
    steps = mgr.stats["steps"]
    assert c["screen.chunks.strip"] == 2 * steps // 3
    assert c["screen.chunks.reg"] == steps // 3
    submits = {x.id: x for x in s.spans if x.name == "step.submit"}
    groups = [x for x in s.spans if x.name == "step.group"]
    assert len(groups) == steps == 3 * len(submits)
    for x in groups:
        p = submits[x.parent]
        assert p.start <= x.start <= x.end <= p.end
        assert x.attrs["slots"] == [64, 64, 32][x.attrs["group"]]
    assert sorted(x.attrs["group"] for x in groups) == sorted(
        list(range(3)) * len(submits))


def test_the_device_timer_is_the_submit_span_under_a_group(monkeypatch):
    """step_graph times a step on the innermost span that asked for device
    timing, so that a step.group span between changes nothing."""
    monkeypatch.setenv("TNTBLAST_TPU_PROFILE", "1")
    with trace.search("cli.search"):
        assert trace.device_timer() is trace._NULL
        with trace.span("step.submit") as sp:
            sp.time_device()
            with trace.span("step.group", group=0, slots=64) as g:
                assert trace.current() is g
                assert trace.device_timer() is sp
    assert trace.device_timer() is trace._NULL


def test_a_batch_is_packed_once_for_every_group(searches):
    """submit_batch packs a batch once and hands every panel group's step
    the same payload, in group order."""
    (mgr,) = searches["managers"]
    calls = searches["submits"]
    assert len(calls) == mgr.stats["steps"] == 3 * -(-N_RECORDS // mgr.batch)
    for k in range(0, len(calls), 3):
        (a, pa), (b, pb), (c, pc) = calls[k:k + 3]
        assert [a, b, c] == [g._panels[a.config.tile_len]
                             for g in mgr.groups]
        assert pa is not None and pb is pa and pc is pa
    assert len({id(p) for _, p in calls}) == len(calls) // 3


def _pack_frags(case, L):
    """A batch at tile `L`: a full tile, short and empty fragments; with
    "sideband" N runs and other codes past T, with "overflow" a fragment
    of more N runs than RUN_CAP and one of more exceptions than EXC_CAP."""
    rng = np.random.default_rng(["plain", "sideband", "overflow"].index(case))
    frags = [rng.integers(0, 4, n).astype(np.uint8)
             for n in (L, 1000, 0, 3001, 17, L - 1)]
    if case != "plain":
        frags[1][10:30] = C.DB_N
        frags[1][500] = C.DB_N
        frags[1][999] = C.DB_N
        frags[3][[0, 7, 3000]] = [C.DB_R, C.DB_I, C.DB_GAP]
        frags[3][100:104] = C.DB_N
        frags[5][-1] = C.DB_UNKNOWN
    if case == "overflow":
        frags[0][0:2 * (port_ds.DevicePanel.RUN_CAP + 1):2] = C.DB_N
        frags[3][rng.choice(3001, port_ds.DevicePanel.EXC_CAP + 1,
                            replace=False)] = C.DB_Y
    return frags


@pytest.mark.parametrize("case", ["plain", "sideband", "overflow"])
def test_batch_pack_equals_the_reference_pack(case):
    """The port's pack of a batch, the payload every panel group's step
    reads, equals the JAX package's pack array for array: base stream,
    lengths, N runs, exceptions and the overflow flags."""
    L = 4096
    assert (port_ds.DevicePanel.RUN_CAP, port_ds.DevicePanel.EXC_CAP) == (
        jax_ds.DevicePanel.RUN_CAP, jax_ds.DevicePanel.EXC_CAP)

    class Shape:
        RUN_CAP = port_ds.DevicePanel.RUN_CAP
        EXC_CAP = port_ds.DevicePanel.EXC_CAP

        class config:
            tile_len = L

    frags = _pack_frags(case, L)
    got = port_ds.DevicePanel._pack_host(Shape, frags)
    want = jax_ds.DevicePanel._pack_host(Shape, frags)
    assert len(got) == len(want) == 7
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)
    assert got[6].any() == (case == "overflow")
    with pytest.raises(ValueError, match="tile_len"):
        port_ds.DevicePanel._pack_host(Shape, frags + [np.zeros(L + 1,
                                                                np.uint8)])

