"""The port's CUDA kernels against their plain PyTorch versions, on the
card.

Every test here needs an NVIDIA GPU and skips elsewhere.  The file imports
neither jax nor the JAX package (the GPU machine need not have jax); run it
there with

    TNTBLAST_TEST_TPU=1 python -m pytest tests/test_torch_cuda.py

(TNTBLAST_TEST_TPU=1 keeps tests/conftest.py from importing jax).
"""

import io
import os
import pathlib
import re
import socket
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

from tntblast_tpu_torch import cli
from tntblast_tpu_torch import constants as C
from tntblast_tpu_torch import native
from tntblast_tpu_torch import ops
from tntblast_tpu_torch.ops.eval_pack import (
    EvalPackPlan, eval_pack, eval_pack_reference)
from tntblast_tpu_torch.ops.kept import KeptPlan, kept, kept_reference
from tntblast_tpu_torch.ops.pool import PoolPlan, pool, pool_reference
from tntblast_tpu_torch.ops.screen_dp import (
    MAX_WT, NEG_I32, ScreenDpPlan, screen_dp, screen_dp_reference)
from tntblast_tpu_torch.ops.screen_probe import (
    screen_probe, screen_probe_reference)
from tntblast_tpu_torch.ops.seed import (
    DenseSeedPlan, SeedPlan, seed as seed_kernel, seed_dense as
    seed_dense_kernel, seed_dense_reference, seed_reference)
from tntblast_tpu_torch.ops.thermo_dp import build_t_canon
from tntblast_tpu_torch.ops.win_decode import (
    WinDecodePlan, win_decode, win_decode_reference)
from tntblast_tpu_torch.parallel.device_search import (
    DevicePanel, FragmentKept, PanelConfig)
from tntblast_tpu_torch.parallel import panel as port_panel
from tntblast_tpu_torch.parallel import step_graph
from tntblast_tpu_torch.parallel.mesh import MeshPanel, make_mesh
from tntblast_tpu_torch.search import seed
from tntblast_tpu_torch.thermo.santa_lucia import build_tables
from tntblast_tpu_torch.tools.bench_inputs import (
    KEPT_ARGS, decode_inputs, eager_step, eval_inputs,
    eval_pack_args, kept_inputs, pool_inputs, seed_dense_inputs, seed_inputs,
    step_decode_inputs, synthetic_eval_panel)

HERE = pathlib.Path(__file__).resolve().parent
GOLD = HERE / "golden" / "e2e"

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.fixture(autouse=True)
def _no_step_graphs():
    """Each test starts with no step graph kept: its first step of a key
    runs panel_step_core (the eager step, then the capture), not a replay
    of a graph that an earlier test captured with the same key."""
    step_graph.clear()
    yield
    step_graph.clear()


def _stream(rng, B, n_real, wq_max, nc_all):
    eng = native.MeltEngine(n_threads=1)
    tcan = np.stack([build_t_canon(eng.delta_g_screen(np.float32(t)).astype(
        np.int32).ravel()) for t in (313.15, 310.15, 303.15)][:nc_all])
    qp = rng.integers(0, 30, (n_real, wq_max)).astype(np.int32)
    ql = rng.integers(wq_max - 6, wq_max + 1, n_real).astype(np.int32)
    slot = rng.integers(0, n_real, B).astype(np.int32)
    slot[rng.random(B) < 0.1] = 64                 # invalid entries
    wt_max = wq_max + 8
    tb5 = rng.integers(0, 5, (B, wt_max)).astype(np.int32)
    pt6 = np.concatenate([np.full((B, 1), 5, np.int32), tb5[:, :-1]], 1)
    q_e = ql[np.clip(slot, 0, n_real - 1)]
    return {"ptb": pt6 * 5 + tb5, "slot": slot, "ql": q_e,
            "wt_e": q_e + 8, "qp": qp, "tcan": tcan}


def _check_screen_dp(case, device, eval_on):
    """screen_dp on `device` against the plain version there: best, mgmax
    and the M rows in contract (valid entries, rows < ql) bit for bit."""
    n_real, wq_max = case["qp"].shape
    dev = {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
           for k, v in case.items()}
    before = screen_dp.launches
    got = screen_dp(*dev.values(), eval_on=eval_on)
    torch.cuda.synchronize(device)
    assert screen_dp.launches == before + 1
    want = screen_dp_reference(*dev.values(), eval_on=eval_on)
    assert torch.equal(got[0], want[0])
    assert torch.equal(got[1], want[1])
    valid = (dev["slot"] >= 0) & (dev["slot"] < n_real)
    assert (got[0][:, ~valid] == -1).all()
    assert (got[1][~valid] == NEG_I32).all()
    if not eval_on:
        assert got[2] is None and want[2] is None
        return got
    rows = torch.arange(wq_max, device=device)[:, None] < dev["ql"][None, :]
    keep = rows & valid[None, :]
    assert torch.equal(got[2][keep], want[2][keep])
    return got


@pytest.mark.parametrize("wq_max", [16, 24, 30, 40, 56, 120, 121, 150, 300,
                                    1024])
@pytest.mark.parametrize("eval_on", [False, True])
def test_screen_dp_kernel_matches_plain(cuda, eval_on, wq_max):
    """wt_max = wq_max + 8 in {24, 32, 38, 48, 64, 128, 129, 158, 308,
    1032}: both widths with the row in registers, and eight on the strip
    path, the first past the registers and the widest the kernel takes
    among them."""
    rng = np.random.default_rng(17 + wq_max)
    B = 4096 if wq_max <= 40 else 1024 if wq_max <= 150 else 256
    case = _stream(rng, B, 12, wq_max, 3 if eval_on else 2)
    _check_screen_dp(case, cuda, eval_on)


def test_screen_dp_kernel_between_register_widths(cuda):
    """wt_max 28 runs on register width 32; the panel's tables passed in
    give what the wrapper's own re-layout gives."""
    from tntblast_tpu_torch.ops.screen_dp import kernel_tables

    rng = np.random.default_rng(23)
    case = _stream(rng, 3000, 12, 20, 3)
    got = _check_screen_dp(case, cuda, True)
    dev = [torch.from_numpy(np.ascontiguousarray(v)).to(cuda)
           for v in case.values()]
    tables = kernel_tables(dev[-1])
    again = screen_dp(*dev, eval_on=True, tables=tables)
    assert torch.equal(again[0], got[0]) and torch.equal(again[1], got[1])
    with pytest.raises(ValueError):
        screen_dp(*dev, eval_on=True, tables=tables[:2])
    with pytest.raises(ValueError):
        screen_dp(*dev, eval_on=True, tables=tables.cpu())


@pytest.mark.parametrize("B", [1, 31, 4099])
@pytest.mark.parametrize("eval_on", [False, True])
def test_screen_dp_kernel_ragged_batch(cuda, eval_on, B):
    """B that is no multiple of a warp or of a block."""
    rng = np.random.default_rng(29 + B)
    case = _stream(rng, B, 12, 24, 3)
    case["slot"][0] = 3                  # at least one valid entry
    case["ql"][0], case["wt_e"][0] = 24, 32
    _check_screen_dp(case, cuda, eval_on)


@pytest.mark.parametrize("wq_max", [24, 56])
def test_screen_dp_kernel_all_invalid(cuda, wq_max):
    """A chunk without one valid entry: every score is the floor."""
    rng = np.random.default_rng(31)
    case = _stream(rng, 700, 12, wq_max, 3)
    case["slot"][:] = 12
    case["slot"][::3] = -1
    best, mgmax, _ = _check_screen_dp(case, cuda, True)
    assert (best == -1).all() and (mgmax == NEG_I32).all()


@pytest.mark.parametrize("wq_max", [24, 56])
def test_screen_dp_kernel_warp_straddles_slots(cuda, wq_max):
    """Slot-major entries whose slot (and ql, wt_e) changes in the middle
    of a warp, ql 0 and ql above wq_max among them, and a valid entry
    between invalid ones."""
    rng = np.random.default_rng(37)
    B, n_real = 333, 5
    case = _stream(rng, B, n_real, wq_max, 3)
    ql_s = np.array([wq_max - 9, wq_max, 0, wq_max + 3, 7], np.int32)
    slot = np.sort(rng.integers(0, n_real, B)).astype(np.int32)
    slot[40:47] = n_real
    slot[300:] = n_real
    slot[320] = 2
    case["slot"] = slot
    case["ql"] = ql_s[np.clip(slot, 0, n_real - 1)]
    case["wt_e"] = case["ql"] + 8
    case["wt_e"][100:110] = wq_max + 20          # wider than wt_max
    case["wt_e"][110:120] = 0
    _check_screen_dp(case, cuda, True)
    _check_screen_dp(case, cuda, False)


@pytest.mark.parametrize("wq_max", [24, 56])
def test_screen_dp_kernel_clamps_ptb(cuda, wq_max):
    """ptb values outside [0, 30) read the nearest table row, as the plain
    version's clamp does."""
    rng = np.random.default_rng(41)
    case = _stream(rng, 500, 12, wq_max, 3)
    case["ptb"][::5, ::3] = 30
    case["ptb"][1::7, 1::2] = -4
    case["ptb"][2::11] = 1 << 20
    _check_screen_dp(case, cuda, True)


def test_screen_dp_kernel_on_second_card(cuda):
    """Tensors on cuda:1 launch there, whatever the current device is."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    rng = np.random.default_rng(43)
    for wq_max in (24, 56):
        case = _stream(rng, 1500, 12, wq_max, 3)
        got = _check_screen_dp(case, torch.device("cuda:1"), True)
        assert got[0].device == torch.device("cuda:1")
        first = _check_screen_dp(case, torch.device("cuda:0"), True)
        assert torch.equal(got[0].cpu(), first[0].cpu())


def _check_eval_pack(rng, B, wq_max, device, invalid=0.1, slot_major=True,
                     all_invalid=False):
    """The stage as the step runs it, on `device`: the screen_dp kernel
    writes the M rows (rows >= ql, columns > wt_e and invalid entries stay
    unwritten), then eval_pack against the plain version on the same
    tensors: all five words of every entry, bit for bit."""
    pan = synthetic_eval_panel(rng, 12, wq_max, device)
    dp_args, tb5, needs_host, ent_valid = eval_inputs(
        rng, B, pan["qp"], pan["qc"], pan["ql_slot"], pan["tcan"], device,
        invalid=invalid, slot_major=slot_major)
    if all_invalid:
        dp_args[1].fill_(12)
        ent_valid.fill_(False)
    _, mgmax, M_rows = screen_dp(*dp_args, eval_on=True)
    args = eval_pack_args(dp_args, M_rows, mgmax, tb5, needs_host, ent_valid,
                          pan["qc"], pan["ev_tabs"], pan["ev_loop"])
    before = eval_pack.launches
    got = eval_pack(*args, pan["eval_const"])
    torch.cuda.synchronize(device)
    assert eval_pack.launches == before + 1
    want = eval_pack_reference(*args, pan["eval_const"])
    assert got.shape == (B, 5) and got.dtype == torch.int32
    assert got.device == want.device == M_rows.device
    bad = (got != want).any(dim=1).nonzero()
    assert len(bad) == 0, (len(bad), got[bad[0, 0]].tolist(),
                           want[bad[0, 0]].tolist())
    assert (got[~ent_valid] == 0).all()
    return got, ent_valid


@pytest.mark.parametrize("wq_max", [16, 24, 30, 56, 120])
@pytest.mark.parametrize("slot_major", [True, False])
def test_eval_pack_kernel_matches_plain(cuda, slot_major, wq_max):
    """One general path takes every width; a chunk holds trusted entries
    with a Tm to compute, with mismatches, and entries for the host."""
    rng = np.random.default_rng(71 + wq_max)
    B = 4096 if wq_max <= 30 else 1024
    got, ent_valid = _check_eval_pack(rng, B, wq_max, cuda,
                                      slot_major=slot_major)
    w0 = got[ent_valid][:, 0]
    assert int((w0 & 1).sum()) > B // 8                   # trusted
    assert int(((w0 & 3) == 1).sum()) > B // 16          # and tm not zero
    assert int((((w0 >> 10) & 63) > 0).sum()) > B // 16  # mismatches


@pytest.mark.parametrize("wq_max", [150, 300, 1024])
def test_eval_pack_kernel_matches_plain_on_wide_windows(cuda, wq_max):
    """Past a window of 128 columns the kernel stages pieces of each row
    and reads the window codes in place, and the pair bits take 32 words:
    a chunk behind the screen_dp kernel, every word of every entry equal
    to the plain version's."""
    rng = np.random.default_rng(71 + wq_max)
    B = 1024 if wq_max <= 300 else 192
    got, ent_valid = _check_eval_pack(rng, B, wq_max, cuda)
    assert int(ent_valid.sum()) > B // 2


@pytest.mark.parametrize("B", [1, 31, 4099])
def test_eval_pack_kernel_ragged_batch(cuda, B):
    """B that is no multiple of a warp or of a block."""
    _check_eval_pack(np.random.default_rng(73 + B), B, 24, cuda,
                     invalid=0.0 if B == 1 else 0.1)


@pytest.mark.parametrize("wq_max", [24, 56])
def test_eval_pack_kernel_all_invalid(cuda, wq_max):
    """A chunk past the pool: every word zero, no M row read."""
    got, _ = _check_eval_pack(np.random.default_rng(79), 700, wq_max, cuda,
                              all_invalid=True)
    assert (got == 0).all()


def test_eval_pack_kernel_refuses_what_it_does_not_take(cuda):
    rng = np.random.default_rng(83)
    pan = synthetic_eval_panel(rng, 12, 24, cuda)
    dp_args, tb5, needs_host, ent_valid = eval_inputs(
        rng, 64, pan["qp"], pan["qc"], pan["ql_slot"], pan["tcan"], cuda)
    _, mgmax, M_rows = screen_dp(*dp_args, eval_on=True)
    args = list(eval_pack_args(dp_args, M_rows, mgmax, tb5, needs_host,
                               ent_valid, pan["qc"], pan["ev_tabs"],
                               pan["ev_loop"]))
    for i, bad in ((3, args[3].long()), (6, args[6].to(torch.int32)),
                   (2, args[2][:, :-1]), (1, args[1].cpu()),
                   (9, args[9].double())):
        with pytest.raises(ValueError):
            eval_pack(*args[:i], bad, *args[i + 1:], pan["eval_const"])


def _eval_chunk(rng, B, wq_max, device):
    """A panel's tables and one chunk's arguments behind the screen_dp
    kernel, as the step hands them to the evaluator."""
    pan = synthetic_eval_panel(rng, 12, wq_max, device)
    dp_args, tb5, needs_host, ent_valid = eval_inputs(
        rng, B, pan["qp"], pan["qc"], pan["ql_slot"], pan["tcan"], device)
    _, mgmax, M_rows = screen_dp(*dp_args, eval_on=True)
    args = eval_pack_args(dp_args, M_rows, mgmax, tb5, needs_host, ent_valid,
                          pan["qc"], pan["ev_tabs"], pan["ev_loop"])
    return pan, args


@pytest.mark.parametrize("wq_max,B", [(16, 4099), (24, 32768), (56, 31)])
def test_eval_pack_lean_call_equals_checked(cuda, wq_max, B):
    """The device step's lean call (EvalPackPlan) gives the checked call's
    words, counts its launch in eval_pack.launches, and refuses CPU
    tensors and M rows whose shape does not fit its tables."""
    pan, args = _eval_chunk(np.random.default_rng(97 + B), B, wq_max, cuda)
    plan = EvalPackPlan(pan["qc"], pan["ev_tabs"], pan["ev_loop"],
                        pan["eval_const"])
    before = eval_pack.launches
    got = plan(*args[:8])
    torch.cuda.synchronize()
    assert eval_pack.launches == before + 1
    assert torch.equal(got, eval_pack(*args, pan["eval_const"]))
    assert torch.equal(got, eval_pack_reference(*args, pan["eval_const"]))
    with pytest.raises(ValueError):
        plan(*(a.cpu() for a in args[:8]))
    with pytest.raises(ValueError):         # M rows of another wq_max
        plan(args[0][:-1], *args[1:8])
    assert eval_pack.launches == before + 2        # the checked call alone


def test_eval_pack_plan_checks_its_tables_once(cuda):
    """The tables are checked when the plan is made: a mismatched table
    raises there, and a plan is not made for CPU tables."""
    pan, args = _eval_chunk(np.random.default_rng(101), 64, 24, cuda)
    tabs = (pan["qc"], pan["ev_tabs"], pan["ev_loop"])
    for i, bad in ((0, pan["qc"][:, :-1]), (1, pan["ev_tabs"].double()),
                   (1, pan["ev_tabs"][:, :-1]),
                   (2, pan["ev_loop"][:, :-1].contiguous()),
                   (2, pan["ev_loop"].cpu())):
        with pytest.raises(ValueError):
            EvalPackPlan(*tabs[:i], bad, *tabs[i + 1:], pan["eval_const"])
    with pytest.raises(ValueError):
        EvalPackPlan(*(t.cpu() for t in tabs), pan["eval_const"])


def test_device_panel_evaluates_through_its_plan(cuda):
    """A panel on the card builds its plan with its tables, and the step's
    chunks go through it: one launch a chunk, as many as screen_dp's."""
    dp = _panel(cuda)
    assert isinstance(dp.tabs.get("eval_plan"), EvalPackPlan)
    assert "eval_plan" not in _panel("cpu").tabs
    rng = np.random.default_rng(5)
    frags = [rng.integers(0, 4, 30000).astype(np.uint8) for _ in range(2)]
    calls = []
    plan = dp.tabs["eval_plan"]
    dp.tabs["eval_plan"] = lambda *a: calls.append(1) or plan(*a)
    before = screen_dp.launches, eval_pack.launches
    # the eager step: a replay of the step's graph calls no plan
    dp.resolve_fragments((2, eager_step(dp, dp._pack_host(frags))))
    n = screen_dp.launches - before[0]
    assert n > 0 and len(calls) == n == eval_pack.launches - before[1]


def test_eval_pack_kernel_on_second_card(cuda):
    """Tensors on cuda:1 launch there, whatever the current device is."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    for wq_max in (24, 56):
        got, _ = _check_eval_pack(np.random.default_rng(89), 1500, wq_max,
                                  torch.device("cuda:1"))
        first, _ = _check_eval_pack(np.random.default_rng(89), 1500, wq_max,
                                    torch.device("cuda:0"))
        assert got.device == torch.device("cuda:1")
        assert torch.equal(got.cpu(), first.cpu())


def test_eval_pack_lean_call_on_second_card(cuda):
    """A plan made for cuda:1 launches there while cuda:0 is current, and
    leaves cuda:0 current."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    dev = torch.device("cuda:1")
    pan, args = _eval_chunk(np.random.default_rng(103), 1500, 24, dev)
    plan = EvalPackPlan(pan["qc"], pan["ev_tabs"], pan["ev_loop"],
                        pan["eval_const"])
    with torch.cuda.device(0):
        got = plan(*args[:8])
        assert torch.cuda.current_device() == 0
    assert got.device == dev
    assert torch.equal(got, eval_pack_reference(*args, pan["eval_const"]))


@pytest.mark.parametrize("wt_max", [32, 27, 72])
@pytest.mark.parametrize("n_sel", [0, 5, 30])
def test_screen_probe_kernel_matches_plain(cuda, n_sel, wt_max):
    """ql and wt_e vary per block, a block has ql 0, and ptb carries values
    outside [0, 30) (zero energies); wt_max 32 fills a register width, 27
    lies between two, 72 keeps its rows in shared memory."""
    rng = np.random.default_rng(23 + n_sel)
    n_blocks, BB, wq_max, nc_all = 6, 512, 24, 3
    meta = np.zeros((n_blocks, 4), np.int32)
    meta[:, 1] = (22, 24, 0, 9, 17, 24)
    meta[:, 2] = (30, wt_max, 12, 17, 25, 5)
    ptb = rng.integers(0, 30, (n_blocks, wt_max, BB)).astype(np.int32)
    ptb[1, :, ::7] = 31
    ptb[4, ::3, :] = -2
    meta_d = torch.from_numpy(meta).to(cuda)
    ptb_d = torch.from_numpy(ptb).to(cuda)
    before = screen_probe.launches
    got = screen_probe(meta_d, ptb_d, n_sel, wq_max=wq_max, nc_all=nc_all)
    torch.cuda.synchronize()
    assert screen_probe.launches == before + 1
    want = screen_probe_reference(meta_d, ptb_d, n_sel, wq_max=wq_max,
                                  nc_all=nc_all)
    assert got.shape == (n_blocks, nc_all, BB)
    assert torch.equal(got, want)
    assert (got[2] == -1).all()                    # ql 0: nothing scored
    cpu = screen_probe(torch.from_numpy(meta), torch.from_numpy(ptb), n_sel,
                       wq_max=wq_max, nc_all=nc_all)
    assert torch.equal(got.cpu(), cpu)
    assert screen_probe.launches == before + 1     # CPU tensors: no launch


@pytest.mark.parametrize("flag", ["--tpu-screen", "--mesh"])
def test_port_golden_on_cuda(cuda, tmp_path, monkeypatch, flag):
    args = (GOLD / "pcr_small.cmd").read_text().split()
    out = tmp_path / "o.out"
    monkeypatch.chdir(HERE / "data")
    before = screen_dp.launches, eval_pack.launches
    assert cli.local_main(args + ["-o", str(out), "-v", "F", flag, "T"],
                          stdout=io.StringIO(), device=cuda) == 0
    assert screen_dp.launches > before[0]
    assert eval_pack.launches - before[1] == screen_dp.launches - before[0]
    assert out.read_text() == (GOLD / "pcr_small.out").read_text()


def _panel(device, mesh=None):
    eng = native.MeltEngine(n_threads=1)
    w = 7
    panel = []
    for oligo in ("TTGACCTAGATATTCAGCAAC", "GGGAGAGACTCACCCAAAGATC"):
        codes = C.ASCII_TO_MELT[np.frombuffer(oligo.encode(), np.uint8)]
        for minus in (True, False):
            panel.append({"words": seed.oligo_word_list(
                codes, w, complement=not minus), "codes": codes,
                "minus": minus})
    cfg = PanelConfig(word_len=w, num_os=8, max_words=16, wq_max=22,
                      tile_len=32768, cap=2048, num_cond=1)
    dg = eng.delta_g_screen(np.float32(313.15)).astype(np.int32)
    args = (panel, cfg, dg.reshape(1, -1), np.full((1, 4), 100000, np.int32))
    kw = dict(eval_dg=eng.delta_g().astype(np.int32).ravel(),
              thermo_tables=build_tables())
    if mesh is not None:
        return MeshPanel(*args, mesh=mesh, **kw)
    return DevicePanel(*args, device=device, **kw)


@pytest.mark.parametrize("mesh", [False, True])
def test_submit_is_asynchronous_and_matches_cpu(cuda, mesh):
    """Queueing a step issues no host sync (the resolve does), and the
    CUDA step's kept seeds and eval words equal the CPU step's; the same
    for a mesh over every visible card (twice each, so a batch of four is
    split whatever the count)."""
    rng = np.random.default_rng(5)
    frags = [rng.integers(0, 4, 30000).astype(np.uint8) for _ in range(4)]
    frags[1][7000:7400] = C.DB_N
    site = C.ASCII_TO_DB[np.frombuffer(b"TTGACCTAGATATTCAGCAAC", np.uint8)]
    frags[0][1000:1000 + len(site)] = site
    cuda_panel = _panel(cuda, mesh=make_mesh() * 2 if mesh else None)
    cuda_panel.submit_fragments(frags)           # warm-up: the capture
    torch.cuda.synchronize()
    replays = step_graph.stats["replays"]
    torch.cuda.set_sync_debug_mode("error")
    try:
        pending = [cuda_panel.submit_fragments(frags) for _ in range(2)]
    finally:
        torch.cuda.set_sync_debug_mode("default")
    # each step replayed its graph (one a mesh device)
    assert (step_graph.stats["replays"] - replays
            == 2 * (len(cuda_panel.mesh) if mesh else 1))
    got = cuda_panel.resolve_fragments(pending[-1])
    cpu_panel = _panel("cpu")
    want = cpu_panel.resolve_fragments(cpu_panel.submit_fragments(frags))
    assert sum(r["n_kept"] for r in want) > 0
    for g, w in zip(got, want):
        # a mesh device's kept block is its own: compare the fragment's part
        g, w = g.fields(), w.fields()
        assert g.keys() == w.keys()
        for k in g:
            np.testing.assert_array_equal(np.asarray(g[k]),
                                          np.asarray(w[k]), err_msg=k)


def test_two_ranks_on_one_card(cuda, tmp_path):
    """Two ranks of the multi-process runtime, each on its default device
    (its card, here the same one for both; the gather runs over gloo):
    pcr_frag byte-identical, the screen kernel launched on every rank and
    nothing fell back."""
    args = (GOLD / "pcr_frag.cmd").read_text().split()
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    out = tmp_path / "out.txt"
    env = dict(os.environ, PYTHONPATH=str(HERE.parent),
               TNTBLAST_TPU_THREADS="1", TNTBLAST_TPU_PROFILE="1")
    # each rank's output goes to a file: a pipe that fills would block the
    # rank while the other waits for it in the gather
    logs = [tmp_path / f"rank{i}.log" for i in range(2)]
    procs = []
    for i, log in enumerate(logs):
        with open(log, "w") as fh:
            procs.append(subprocess.Popen(
                [sys.executable, "-m",
                 "tntblast_tpu_torch.parallel.multiproc",
                 "--coordinator", f"127.0.0.1:{port}", "--num-procs", "2",
                 "--proc-id", str(i), "--", *args, "--tpu-screen", "T", "-o",
                 str(out) if i == 0 else str(out) + f".rank{i}.ignore"],
                cwd=HERE / "data", env=env, stdout=fh,
                stderr=subprocess.STDOUT))
    try:
        for p in procs:
            p.wait(timeout=600)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)
    errs = [log.read_text() for log in logs]
    for rank, (p, err) in enumerate(zip(procs, errs)):
        assert p.returncode == 0, err[-2000:]
        (line,) = [ln for ln in err.splitlines()
                   if ln.startswith(f"rank {rank}:")]
        assert "device cuda:" in line and "'fallback': 0" in line
        assert int(line.split("screen_dp.launches ")[1].split()[0]) > 0
        assert int(line.split("eval_pack.launches ")[1].split()[0]) > 0
        assert int(line.split("seed.launches ")[1].split()[0]) > 0
        assert line.endswith("outside 0")
    assert out.read_text() == (GOLD / "pcr_frag.out").read_text()


@pytest.mark.parametrize("n_letters", [5, 18])
def test_dp_max_score_on_cuda(cuda, n_letters):
    """dp_max_score on the card equals its CPU run; on plain codes both
    equal dp_scores_canon, the screen_dp kernel."""
    from tntblast_tpu_torch.ops.thermo_dp import (
        build_qpair_rows, dp_max_score, dp_scores_canon)

    rng = np.random.default_rng(61 + n_letters)
    B, wq = 512, 24
    wt = wq + 8
    eng = native.MeltEngine(n_threads=1)
    dg = eng.delta_g_screen(np.float32(313.15)).astype(np.int32).ravel()
    qc = rng.integers(0, n_letters, (B, wq)).astype(np.int32)
    tc = rng.integers(0, n_letters, (B, wt)).astype(np.int32)
    ql = rng.integers(1, wq + 1, B).astype(np.int32)
    tl = rng.integers(0, wt + 1, B).astype(np.int32)
    arrays = [torch.from_numpy(a) for a in (qc, ql, tc, tl, dg)]
    want = dp_max_score(*arrays, wq=wq, wt=wt)
    got = dp_max_score(*(a.to(cuda) for a in arrays), wq=wq, wt=wt)
    assert got.dtype == torch.int32 and torch.equal(got.cpu(), want)
    if n_letters == 5:
        qp = np.stack([build_qpair_rows([qc[i]], [ql[i]], wq=wq)[0]
                       for i in range(B)])
        before = screen_dp.launches
        canon = dp_scores_canon(
            *(torch.from_numpy(a).to(cuda) for a in (qp, ql, tc, tl)),
            torch.from_numpy(build_t_canon(dg)).to(cuda))
        assert screen_dp.launches == before + 1
        assert torch.equal(canon.cpu(), want)


def test_window_screen_on_cuda(cuda, monkeypatch):
    """screen_windows behind search/bind.py with its DP on the card: the
    hit list of the Python search layer is the one without a screen, the
    plain-code batches went through the kernel, and every batch's scores
    equal dp_max_score on the card and on the CPU (chip_smoke's checked
    screen raises otherwise)."""
    import chip_smoke

    monkeypatch.chdir(HERE / "data")
    before = screen_dp.launches
    res = chip_smoke.window_screen_run(
        torch, (GOLD / "pcr_small.cmd").read_text().split(), cuda)
    assert res["hits"] > 0 and res["screened"] > 0
    assert res["canon"] > 0 and res["rows_compared"] > 0
    assert screen_dp.launches > before


def test_entry_on_cuda_equals_cpu(cuda):
    from tntblast_tpu_torch.entry import dryrun_multichip, entry

    fn, args = entry(cuda)
    before = screen_dp.launches
    got = fn(*args)
    torch.cuda.synchronize()
    assert screen_dp.launches > before
    cfn, cargs = entry("cpu")
    want = cfn(*cargs)
    n_kept = int(want[0][0])
    assert n_kept > 0
    for i, (g, w) in enumerate(zip(got, want)):
        g = g.cpu()
        if i == 1:
            g, w = g[:, :n_kept], w[:, :n_kept]
        assert torch.equal(g, w), i
    dryrun_multichip(torch.cuda.device_count())


def test_device_bench_on_cuda(cuda):
    import bench_data
    from tntblast_tpu_torch.tools import device_bench

    fna, panel = bench_data.build(str(HERE.parent / "bench_work"))
    res = device_bench.run(fna, panel, reps=2)
    assert res["n_frags"] == 8 and res["candidates"] > res["kept_seeds"] > 0
    assert res["batch_ms"] > 0 and res["batch_wall_ms"] > 0
    assert res["win_decode_launches_per_step"] == 1
    assert res["seed_launches_per_step"] == 1
    assert res["pool_launches_per_step"] == res["kept_launches_per_step"] == 1
    assert res["chunks"] == res["live_chunks"] == 1
    assert (res["eval_pack_launches_per_step"]
            == res["screen_dp_launches_per_step"] == 1)
    assert set(res["stage_ms"]) == set(device_bench.STAGES)
    assert all(v > 0 for v in res["stage_ms"].values())
    assert 0 < res["utilization_pct"] < 100


# ---- the window decode ----------------------------------------------------

def _check_win_decode(args, kw):
    """win_decode on the tensors' card against the plain version there:
    all six outputs equal, one launch."""
    before = win_decode.launches
    got = win_decode(*args, **kw)
    torch.cuda.synchronize(args[0].device)
    assert win_decode.launches == before + 1
    want = win_decode_reference(*args, **kw)
    for g, w in zip(got, want):
        assert g.device == w.device == args[0].device
        assert torch.equal(g, w)
    return got


@pytest.mark.parametrize("wq_max", [16, 24, 56, 120, 121, 300, 1024])
@pytest.mark.parametrize("B", [1, 31, 4099, 40000])
def test_win_decode_kernel_matches_plain(cuda, B, wq_max):
    rng = np.random.default_rng(B + wq_max)
    for word_len in (6, 7, 8):
        args, kw = decode_inputs(rng, B, wq_max, cuda, word_len=word_len,
                                 invalid=0.0 if B == 1 else 0.25)
        got = _check_win_decode(args, kw)
        if B > 1000:
            assert 0 < int(got[0].sum()) < int(got[5].sum()) < B


def test_win_decode_kernel_past_the_pool(cuda):
    """A stream without a valid entry: zeros everywhere."""
    args, kw = decode_inputs(np.random.default_rng(3), 4099, 24, cuda,
                             invalid=1.0)
    for g in _check_win_decode(args, kw):
        assert not g.any()


def test_win_decode_kernel_on_a_step_stream(cuda):
    """The pooled stream of a device step, as the step decodes it."""
    dp = _panel(cuda)
    rng = np.random.default_rng(21)
    frags = [rng.integers(0, 4, 30000).astype(np.uint8) for _ in range(3)]
    frags[1][7000:7400] = C.DB_N
    args, kw = step_decode_inputs(dp, frags)
    got = _check_win_decode(args, kw)
    assert int(got[5].sum()) > 0


def test_win_decode_refuses_what_it_does_not_take(cuda):
    args, kw = decode_inputs(np.random.default_rng(5), 64, 24, cuda, n=2,
                             L=2048)
    bad_args = [(0, args[0].long()), (1, args[1].cpu()),
                (4, args[4][::2]), (5, args[5].to(torch.int32)),
                (6, args[6][:-1]), (2, torch.stack([args[2]] * 2, 1)[:, 0])]
    for i, bad in bad_args:
        with pytest.raises(ValueError):
            win_decode(*args[:i], bad, *args[i + 1:], **kw)
    for field, value in (("wt_max", MAX_WT + 1), ("wt_max", 0),
                         ("word_len", 16)):
        with pytest.raises(ValueError):
            win_decode(*args, **dict(kw, **{field: value}))


def test_win_decode_on_second_card(cuda):
    """Tensors on cuda:1 decode there, whatever the current device is."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    args, kw = decode_inputs(np.random.default_rng(7), 4099, 24, "cuda:1")
    with torch.cuda.device(0):
        got = _check_win_decode(args, kw)
        assert torch.cuda.current_device() == 0
    assert got[1].device == torch.device("cuda:1")


def _decode_plan(args, kw):
    return WinDecodePlan(args[6], args[7], **{
        k: kw[k] for k in ("L", "wt_max", "word_len", "nw_pos", "num_os")})


@pytest.mark.parametrize("wq_max,B", [(16, 4099), (17, 129), (24, 40000),
                                      (120, 257)])
def test_win_decode_lean_call_equals_checked(cuda, wq_max, B):
    """The step's lean call (WinDecodePlan) gives the checked call's six
    outputs, which are the plain version's, counts its launch, and refuses
    CPU tensors."""
    args, kw = decode_inputs(np.random.default_rng(59 + B), B, wq_max, cuda)
    plan = _decode_plan(args, kw)
    before = win_decode.launches
    got = plan(*args[:6])
    torch.cuda.synchronize()
    assert win_decode.launches == before + 1
    checked = _check_win_decode(args, kw)
    for g, c, w in zip(got, checked, win_decode_reference(*args, **kw)):
        assert torch.equal(g, c) and torch.equal(g, w)
    with pytest.raises(ValueError):
        plan(*(a.cpu() for a in args[:6]))
    assert win_decode.launches == before + 2        # the checked call alone


def test_win_decode_plan_checks_its_tables_once(cuda):
    """The slot tables and shapes are checked when the plan is made: a
    wrong table or shape raises there, and a plan is not made for CPU
    tables."""
    args, kw = decode_inputs(np.random.default_rng(61), 64, 24, cuda)
    for ql, minus in ((args[6][:-1], args[7]), (args[6].long(), args[7]),
                      (args[6], args[7].to(torch.int32)),
                      (args[6], args[7].cpu()),
                      (args[6].cpu(), args[7].cpu()),
                      (torch.stack([args[6]] * 2, 1)[:, 0], args[7])):
        with pytest.raises(ValueError):
            WinDecodePlan(ql, minus, **{k: kw[k] for k in (
                "L", "wt_max", "word_len", "nw_pos", "num_os")})
    for field, value in (("wt_max", MAX_WT + 1), ("wt_max", 0),
                         ("word_len", 16), ("nw_pos", 0)):
        with pytest.raises(ValueError):
            _decode_plan(args, dict(kw, **{field: value}))


def test_win_decode_lean_call_on_second_card(cuda):
    """A plan made for cuda:1 launches there while cuda:0 is current."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    args, kw = decode_inputs(np.random.default_rng(67), 4099, 24, "cuda:1")
    plan = _decode_plan(args, kw)
    with torch.cuda.device(0):
        got = plan(*args[:6])
        assert torch.cuda.current_device() == 0
    for g, w in zip(got, win_decode_reference(*args, **kw)):
        assert g.device == args[0].device and torch.equal(g, w)


def test_step_launches_each_kernel_once(cuda, monkeypatch):
    """A step whose pooled stream fits one chunk seeds, decodes, screens
    and evaluates it in one call of each kernel, through the panel's lean
    calls: the checked decode and the tensor code of the seeding stage
    (and with them the plain versions) are never reached."""
    from tntblast_tpu_torch.parallel import device_search

    def refuse(*args, **kw):
        raise AssertionError("the step called a plain version")

    for name in ("win_decode", "seed_fragments", "unpack_fragments"):
        monkeypatch.setattr(device_search, name, refuse)
    dp = _panel(cuda)
    assert isinstance(dp.tabs.get("seed_plan"), SeedPlan)
    assert isinstance(dp.tabs.get("screen_plan"), ScreenDpPlan)
    assert isinstance(dp.tabs.get("decode_plan"), WinDecodePlan)
    assert "screen_plan" not in _panel("cpu").tabs
    assert "seed_plan" not in _panel("cpu").tabs
    rng = np.random.default_rng(9)
    frags = [rng.integers(0, 4, 30000).astype(np.uint8) for _ in range(4)]
    kernels = (seed_kernel, win_decode, screen_dp, eval_pack)
    captures = step_graph.stats["captures"]
    # the capture: the eager step and the captured step both run here
    before = [k.launches for k in kernels]
    dp.resolve_fragments(dp.submit_fragments(frags))
    assert step_graph.stats["captures"] - captures == 1
    assert [k.launches - b for k, b in zip(kernels, before)] == [1, 1, 1, 1]
    # a replay adds what the capture recorded
    before = [k.launches for k in kernels]
    dp.resolve_fragments(dp.submit_fragments(frags))
    assert step_graph.stats["captures"] - captures == 1
    assert [k.launches - b for k, b in zip(kernels, before)] == [1, 1, 1, 1]


def _screen_chunk(rng, device, B=3000, wq_max=24):
    case = _stream(rng, B, 12, wq_max, 3)
    return [torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for v in case.values()]


def test_screen_dp_lean_call_equals_checked(cuda):
    """The step's lean call (ScreenDpPlan) gives the checked call's
    outputs, counts its launch, refuses CPU tensors, and checks its tables
    once, when it is made."""
    dev = _screen_chunk(np.random.default_rng(47), cuda)
    plan = ScreenDpPlan(dev[4], dev[5], eval_on=True)
    before = screen_dp.launches
    got = plan(*dev[:4])
    torch.cuda.synchronize()
    assert screen_dp.launches == before + 1
    want = screen_dp(*dev, eval_on=True)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    rows = (torch.arange(24, device=cuda)[:, None] < dev[2][None, :]) & (
        dev[1] < 12)[None, :]
    assert torch.equal(got[2][rows], want[2][rows])
    with pytest.raises(ValueError):
        plan(*(a.cpu() for a in dev[:4]))
    for bad in ((dev[4].cpu(), dev[5]), (dev[4], dev[5][:, :-1]),
                (dev[4].long(), dev[5])):
        with pytest.raises(ValueError):
            ScreenDpPlan(*bad, eval_on=True)
    with pytest.raises(ValueError):
        ScreenDpPlan(dev[4], dev[5], eval_on=True, tables=dev[5])


def test_screen_dp_lean_call_on_second_card(cuda):
    """A plan made for cuda:1 launches there while cuda:0 is current."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    dev = _screen_chunk(np.random.default_rng(53), torch.device("cuda:1"))
    plan = ScreenDpPlan(dev[4], dev[5], eval_on=False)
    with torch.cuda.device(0):
        got = plan(*dev[:4])
        assert torch.cuda.current_device() == 0
    want = screen_dp_reference(*dev, eval_on=False)
    assert torch.equal(got[0], want[0]) and got[0].device == dev[0].device


# ---- the seeding stage ------------------------------------------------------

SEED_NAMES = ("slot", "p", "n_cand", "counts", "overflow", "word",
              "word_valid")


def _check_seed(args, kw):
    """seed on the tensors' card against the plain version there: all
    seven outputs equal, one counted call."""
    before = seed_kernel.launches
    got = seed_kernel(*args, **kw)
    torch.cuda.synchronize(args[0].device)
    assert seed_kernel.launches == before + 1
    want = seed_reference(*args, **kw)
    for name, g, w in zip(SEED_NAMES, got, want):
        assert g.device == w.device == args[0].device, name
        assert torch.equal(g, w), name
    return got


def _seed_plan(args, kw):
    return SeedPlan.from_table(
        args[6].cpu().numpy(), args[0].device, L=kw["tile_len"],
        **{k: v for k, v in kw.items() if k != "tile_len"})


@pytest.mark.parametrize("shape", [
    dict(n=8, L=65536, word_len=7, num_os=40, max_words=18, cap=8192),
    dict(n=2, L=8192, word_len=3, num_os=8, max_words=1, cap=512),
    dict(n=4, L=32768, word_len=8, num_os=64, max_words=31, cap=4096,
         share=10, repeat=10),
    dict(n=8, L=4100, word_len=7, num_os=8, max_words=18, cap=64, share=6,
         repeat=8),
    dict(n=1, L=8, word_len=4, num_os=8, max_words=2, cap=16)],
    ids=["bench-widths", "w3-overflow", "w8-64slots", "past-a-block",
         "tile-of-8"])
def test_seed_kernel_matches_plain(cuda, shape):
    args, kw = seed_inputs(np.random.default_rng(len(str(shape))), cuda,
                           **shape)
    _check_seed(args, kw)


def test_seed_lean_call_equals_checked(cuda):
    """The step's lean call (SeedPlan) gives the checked call's seven
    outputs, counts its call, and refuses CPU tensors."""
    args, kw = seed_inputs(np.random.default_rng(71), cuda, n=4, L=16384)
    plan = _seed_plan(args, kw)
    before = seed_kernel.launches
    got = plan(*args[:6])
    torch.cuda.synchronize()
    assert seed_kernel.launches == before + 1
    checked = _check_seed(args, kw)
    for g, c, w in zip(got, checked, seed_reference(*args, **kw)):
        assert torch.equal(g, c) and torch.equal(g, w)
    with pytest.raises(ValueError):
        plan(*(a.cpu() for a in args[:6]))
    assert seed_kernel.launches == before + 2


def test_seed_on_scratch_of_garbage(cuda):
    """The lean call's launch with outputs and scratch set to 0xFF before
    it (every status word then reads as inclusive, the tile counter as
    huge): launch 1 resets what launch 2 reads, every output is written,
    and the outputs equal the plain version's."""
    from tntblast_tpu_torch.ops import seed as S

    args, kw = seed_inputs(np.random.default_rng(89), cuda, n=4, L=65536,
                           cap=4096)
    plan = _seed_plan(args, kw)
    n = args[0].shape[0]
    out = S.empty_outputs(n, *plan.shape, plan.device)
    scratch = torch.empty(n * plan._scratch, dtype=torch.int32, device=cuda)
    for t in (*out, scratch):
        t.view(torch.uint8).fill_(0xFF)
    rc = S._library().seed_launch_plan(
        *S.launch_args(plan._plan, args[:6], out, scratch),
        torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    assert rc == 0
    for name, g, w in zip(SEED_NAMES, out, seed_reference(*args, **kw)):
        assert torch.equal(g, w), name


def test_seed_graph_replays(cuda):
    """A CUDA graph of the lean call replayed 20 times, each replay on the
    scratch the last one left and on outputs set to 0xFF before it: every
    replay equals the plain version (the call keeps no state on the host
    and needs no memset)."""
    args, kw = seed_inputs(np.random.default_rng(97), cuda, n=8, L=65536,
                           cap=8192)
    plan = _seed_plan(args, kw)
    want = seed_reference(*args, **kw)
    plan(*args[:6])
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got = plan(*args[:6])
    for _ in range(20):
        for t in got:
            t.view(torch.uint8).fill_(0xFF)
        graph.replay()
        torch.cuda.synchronize()
        for name, g, w in zip(SEED_NAMES, got, want):
            assert torch.equal(g, w), name


def test_seed_refuses_what_it_does_not_take(cuda):
    """The checked call raises on a wrong type, shape, device or layout and
    on shapes the kernel does not take; the plan on tables it cannot
    read."""
    args, kw = seed_inputs(np.random.default_rng(73), cuda, n=2, L=4096)
    bad_args = [(0, args[0].to(torch.int32)), (1, args[1].cpu()),
                (2, args[2][:, :-1]), (4, args[4].long()),
                (5, args[5].to(torch.int32)), (6, args[6][:-1]),
                (0, torch.stack([args[0]] * 2, 2)[:, :, 0])]
    for i, bad in bad_args:
        with pytest.raises(ValueError):
            seed_kernel(*args[:i], bad, *args[i + 1:], **kw)
    for field, value in (("tile_len", 4094), ("max_words", 32),
                         ("num_os", 65), ("cap", 0)):
        with pytest.raises(ValueError):
            seed_kernel(*args, **dict(kw, **{field: value}))
    plan_args = _seed_plan(args, kw)._tables
    for ks, vf in ((plan_args[0][:-1], plan_args[1]),
                   (plan_args[0].to(torch.int32), plan_args[1]),
                   (plan_args[0], plan_args[1].cpu())):
        with pytest.raises(ValueError):
            SeedPlan(ks, vf, L=kw["tile_len"], word_len=kw["word_len"],
                     num_os=kw["num_os"], max_words=kw["max_words"],
                     cap=kw["cap"])


def test_seed_on_second_card(cuda):
    """Tensors on cuda:1 seed there, whatever the current device is."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    args, kw = seed_inputs(np.random.default_rng(79), "cuda:1", n=2,
                           L=16384)
    with torch.cuda.device(0):
        got = _check_seed(args, kw)
        assert torch.cuda.current_device() == 0
    assert got[0].device == torch.device("cuda:1")


def _dense_panel(device, rng, n_oligos=1, mesh=None):
    """A panel of n_oligos random 40-mers on both strands (more than 31
    words: the dense seeding path) and the oligos."""
    oligos = ["".join(rng.choice(list("ACGT"), 40)) for _ in range(n_oligos)]
    panel = []
    for oligo in oligos:
        codes = C.ASCII_TO_MELT[np.frombuffer(oligo.encode(), np.uint8)]
        panel += [{"words": seed.oligo_word_list(codes, 7, complement=not m),
                   "codes": codes, "minus": m} for m in (True, False)]
    max_words = max(len(p["words"]) for p in panel)
    assert max_words > 31
    cfg = PanelConfig(word_len=7, num_os=-(-len(panel) // 8) * 8,
                      max_words=max_words, wq_max=40, tile_len=16384,
                      cap=256, num_cond=1)
    eng = native.MeltEngine(n_threads=1)
    dg = eng.delta_g().astype(np.int32).reshape(1, -1)
    thr = np.full((1, len(panel)), 120000, dtype=np.int32)
    if mesh is not None:
        return MeshPanel(panel, cfg, dg, thr, mesh=mesh), oligos
    return DevicePanel(panel, cfg, dg, thr, device=device), oligos


def _dense_frags(rng, oligos, count=2, shift=0):
    frags = [rng.integers(0, 4, 16000).astype(np.uint8)
             for _ in range(count)]
    for i, oligo in enumerate(oligos):
        site = C.ASCII_TO_DB[np.frombuffer(oligo.encode(), np.uint8)]
        x = 2000 + 700 * i + shift
        frags[(i + shift) % count][x:x + 40] = site
    return frags


def test_dense_panel_seeds_without_the_kernel(cuda):
    """A panel on the dense seeding path (more slots a word than the table
    path takes) has no seed plan but a dense one; its step on the card
    equals the CPU step, launches no seed kernel (the table path's) and
    launches the seed_dense kernel once."""
    rng = np.random.default_rng(83)
    dps = [_dense_panel(d, np.random.default_rng(83))[0]
           for d in (cuda, "cpu")]
    oligos = _dense_panel("cpu", np.random.default_rng(83))[1]
    assert "seed_plan" not in dps[0].tabs
    assert isinstance(dps[0].tabs.get("seed_dense_plan"), DenseSeedPlan)
    assert "seed_dense_plan" not in dps[1].tabs
    frag = _dense_frags(rng, oligos, count=1)[0]
    before = seed_kernel.launches, seed_dense_kernel.launches
    got, want = (dp.resolve_fragments_full(dp.submit_fragments(
        [frag], full=True)) for dp in dps)
    assert seed_kernel.launches == before[0]
    assert seed_dense_kernel.launches > before[1]
    for g, w in zip(got, want):
        for k in w:
            np.testing.assert_array_equal(np.asarray(g[k]),
                                          np.asarray(w[k]), err_msg=k)


@pytest.mark.parametrize("shape", [
    dict(n=8, L=1 << 19, num_os=64, max_words=54, cap=131072),
    dict(n=2, L=16384, word_len=4, num_os=40, max_words=32, cap=3000),
    dict(n=2, L=16384, word_len=4, num_os=40, max_words=32, cap=60000),
    dict(n=4, L=65536, num_os=64, max_words=113, cap=8192, share=10,
         repeat=10, empty=0),
    dict(n=2, L=8192, word_len=3, num_os=40, max_words=32, cap=2048),
    dict(n=1, L=8, word_len=4, num_os=8, max_words=2, cap=16),
    dict(n=4, L=65536, num_os=64, max_words=300, cap=65536, share=10,
         repeat=10),
    dict(n=2, L=65536, num_os=64, max_words=1018, cap=131072)],
    ids=["long-probe-widths", "more-diagonals-than-cap",
         "more-pairs-than-cap", "113-words-slot-63", "w3", "tile-of-8",
         "300-words", "1018-words-wide-tiles"])
def test_seed_dense_kernel_matches_plain(cuda, shape):
    """seed_dense on the card through the checked call and a plan equals
    seed_dense_reference on all seven outputs; each call one launch."""
    args, kw = seed_dense_inputs(np.random.default_rng(len(str(shape))),
                                 cuda, **shape)
    before = seed_dense_kernel.launches
    got = seed_dense_kernel(*args, **kw)
    lean = DenseSeedPlan(args[6], L=kw["tile_len"],
                         **{k: v for k, v in kw.items()
                            if k != "tile_len"})(*args[:6])
    torch.cuda.synchronize()
    assert seed_dense_kernel.launches == before + 2
    want = seed_dense_reference(*args, **kw)
    for out in (got, lean):
        for name, g, w in zip(SEED_NAMES, out, want):
            assert torch.equal(g, w), name


def test_seed_dense_graph_replays_and_garbage(cuda):
    """A CUDA graph of the lean call replayed 20 times on outputs set to
    0xFF before each, and a launch on scratch of 0xFF: each equals the
    plain version (the head launch resets the look-back every call)."""
    from tntblast_tpu_torch.ops import seed as S

    args, kw = seed_dense_inputs(np.random.default_rng(101), cuda, n=8,
                                 L=65536, cap=8192)
    plan = DenseSeedPlan(args[6], L=kw["tile_len"],
                         **{k: v for k, v in kw.items() if k != "tile_len"})
    want = seed_dense_reference(*args, **kw)
    n = args[0].shape[0]
    out = S.empty_outputs(n, *plan.shape, plan.device)
    scratch = torch.empty(n * plan._scratch, dtype=torch.int32,
                          device=cuda)
    for t in (*out, scratch):
        t.view(torch.uint8).fill_(0xFF)
    assert S._dense_library().seed_dense_launch_plan(
        *S.launch_args(plan._plan, args[:6], out, scratch),
        torch.cuda.current_stream().cuda_stream) == 0
    torch.cuda.synchronize()
    for name, g, w in zip(SEED_NAMES, out, want):
        assert torch.equal(g, w), name
    plan(*args[:6])
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got = plan(*args[:6])
    for _ in range(20):
        for t in got:
            t.view(torch.uint8).fill_(0xFF)
        graph.replay()
        torch.cuda.synchronize()
        for name, g, w in zip(SEED_NAMES, got, want):
            assert torch.equal(g, w), name
    with pytest.raises(ValueError):
        plan(*(a.cpu() for a in args[:6]))


def test_dense_graph_step_equals_eager(cuda):
    """On a dense panel the graph's steps equal the eager steps and the
    CPU steps bit for bit, with full outputs, and each step launches
    seed_dense once and the table path's seed never."""
    rng = np.random.default_rng(103)
    dp, oligos = _dense_panel(cuda, np.random.default_rng(7), n_oligos=3)
    cpu = _dense_panel("cpu", np.random.default_rng(7), n_oligos=3)[0]
    payloads = [dp._pack_host(_dense_frags(rng, oligos, 3, j))
                for j in range(3)]
    want = [cpu.step(p, full=True) for p in payloads]
    eager = [eager_step(dp, p, True) for p in payloads]
    before = seed_kernel.launches, seed_dense_kernel.launches
    graphed = [dp.step(p, full=True) for p in payloads * 2]
    assert seed_kernel.launches == before[0]
    assert seed_dense_kernel.launches == before[1] + 6
    for i in (3, 0, 5, 1, 4, 2):
        _same_step(graphed[i], want[i % 3], 3, dp.config, True)
        _same_step(eager[i % 3], want[i % 3], 3, dp.config, True)


def _wide_probe_panel(device, length):
    """A panel of one random probe of `length` nt on both strands, with the
    evaluator (windows of length + 8 columns: past the register widths;
    10-base words, so that random sequence seeds few diagonals), the probe
    and two 6000-nt fragments with its site planted once on each strand,
    two mismatches in each."""
    rng = np.random.default_rng(length)
    probe = "".join(rng.choice(list("ACGT"), length))
    codes = C.ASCII_TO_MELT[np.frombuffer(probe.encode(), np.uint8)]
    panel = [{"words": seed.oligo_word_list(codes, 10, complement=not m),
              "codes": codes, "minus": m} for m in (True, False)]
    cfg = PanelConfig(word_len=10, num_os=8,
                      max_words=max(len(p["words"]) for p in panel),
                      wq_max=length, tile_len=8192, cap=256, num_cond=1)
    eng = native.MeltEngine(n_threads=1)
    dg = eng.delta_g_screen(np.float32(313.15)).astype(np.int32)
    dp = DevicePanel(panel, cfg, dg.reshape(1, -1),
                     np.full((1, 2), 100000, np.int32),
                     eval_dg=eng.delta_g().astype(np.int32).ravel(),
                     thermo_tables=build_tables(), device=device)
    site = C.ASCII_TO_DB[np.frombuffer(probe.encode(), np.uint8)]
    rc = np.array([3, 2, 1, 0, 4], np.uint8)[np.minimum(site, 4)][::-1]
    frags = [rng.integers(0, 4, 6000).astype(np.uint8) for _ in range(2)]
    for f, s_ in zip(frags, (site.copy(), rc.copy())):
        s_[[length // 3, 2 * length // 3]] ^= 1
        f[300:300 + length] = s_
    return dp, frags


@pytest.mark.parametrize("length", [121, 300, 1024])
def test_wide_probe_step_graphed_and_eager_equal_cpu(cuda, length):
    """Oligos past 120 nt, to MAX_SEQUENCE_LENGTH: a DevicePanel of one
    probe takes the card (no width is refused, no plain version runs),
    and one step graphed and one eager equal the CPU step bit for bit,
    full outputs, with windows kept."""
    dp, frags = _wide_probe_panel(cuda, length)
    cpu = _wide_probe_panel("cpu", length)[0]
    assert dp.config.wq_max + 8 <= MAX_WT
    assert {"seed_dense_plan", "decode_plan", "screen_plan", "eval_plan",
            "kept_plan"} <= set(dp.tabs)
    payload = dp._pack_host(frags)
    want = cpu.step(payload, full=True)
    before = screen_dp.launches
    eager = eager_step(dp, payload, True)
    graphed = dp.step(payload, full=True)
    assert screen_dp.launches > before
    _same_step(eager, want, 2, dp.config, True)
    _same_step(graphed, want, 2, dp.config, True)


def test_dense_mesh_panel_launches_on_each_device(cuda):
    """A MeshPanel on the dense path holds a dense plan on every device
    (DevicePanel._tables_on) and launches seed_dense once a device a
    step; its results equal the CPU panel's."""
    rng = np.random.default_rng(107)
    mesh = make_mesh() * 2
    mp, oligos = _dense_panel(cuda, np.random.default_rng(9), n_oligos=2,
                              mesh=mesh)
    cpu = _dense_panel("cpu", np.random.default_rng(9), n_oligos=2)[0]
    frags = _dense_frags(rng, oligos, 2 * len(mesh))
    before = seed_dense_kernel.launches
    got = mp.resolve_fragments(mp.submit_fragments(frags))
    assert mp._replicas is not None and len(mp._replicas) == len(mesh)
    for tabs, device in zip(mp._replicas, mesh):
        plan = tabs["seed_dense_plan"]
        assert isinstance(plan, DenseSeedPlan) and plan.device == device
    assert seed_dense_kernel.launches == before + len(mesh)
    _same_results(got, cpu.resolve_fragments(cpu.submit_fragments(frags)))


# ---- the pool and the kept compaction ---------------------------------------

def _check_pool(args, num_os):
    """pool on the card through the checked call and a plan against the
    plain version there, on all five outputs; each call one launch."""
    before = pool.launches
    got = pool(*args, num_os=num_os)
    lean = PoolPlan(args[0].device, num_os=num_os,
                    cap=args[0].shape[1])(*args)
    assert pool.launches == before + 2
    want = pool_reference(*args, num_os=num_os)
    for out in (got, lean):
        for g, w in zip(out, want):
            assert torch.equal(g, w)


@pytest.mark.parametrize("num_os, cap, n_cand", [
    (40, 45056, [9000, 45073, 0, 12000, 11000, 15000, 45056, 1]),
    (64, 2049, [2049, 1024, 0, 5000]), (8, 1, [1, 0, 2]),
    (16, 3000, [0, 0, 0])])
def test_pool_kernel_matches_plain(cuda, num_os, cap, n_cand):
    """Overflowing and empty fragments, every entry invalid, the bench
    step's shapes."""
    rng = np.random.default_rng(cap)
    args = [torch.from_numpy(a).to(cuda)
            for a in pool_inputs(rng, len(n_cand), cap, num_os, n_cand)]
    _check_pool(args, num_os)


def test_pool_kernel_one_slot_for_every_entry(cuda):
    rng = np.random.default_rng(5)
    args = [torch.from_numpy(a).to(cuda) for a in pool_inputs(
        rng, 3, 5000, 16, [5000, 4999, 100], one_slot=True)]
    _check_pool(args, 16)


def test_pool_refuses_what_it_does_not_take(cuda):
    rng = np.random.default_rng(6)
    args = [torch.from_numpy(a).to(cuda)
            for a in pool_inputs(rng, 2, 100, 8, [50, 60])]
    for i, bad in ((0, args[0].long()), (1, args[1][:, :-1]),
                   (2, args[2].cpu())):
        with pytest.raises(ValueError):
            pool(*args[:i], bad, *args[i + 1:], num_os=8)
    with pytest.raises(ValueError):
        pool(*args, num_os=65)
    with pytest.raises(ValueError):
        PoolPlan(cuda, num_os=8, cap=100)(*(a.cpu() for a in args))


def _kept_case(seed_, device, **kw):
    case = kept_inputs(np.random.default_rng(seed_), **kw)
    t = {k: (torch.from_numpy(np.ascontiguousarray(case[k])).to(device)
             if case[k] is not None else None) for k in KEPT_ARGS}
    return case, t


def _kept_lean(case, t):
    """The plan's lean call and its arguments."""
    plan = KeptPlan(t["ow"], t["thr"], nw_pos=case["nw_pos"])
    return plan, (*(t[k] for k in KEPT_ARGS[:10]),
                  *(t[k] for k in KEPT_ARGS[12:]))


@pytest.mark.parametrize("num_cond, eval_on, bkcap", [
    (2, True, 30000), (1, False, 1000), (2, True, 9000), (1, True, 12000)])
def test_kept_kernel_matches_plain(cuda, num_cond, eval_on, bkcap):
    """One and two conditions, the evaluator on and off, n_kept above and
    below bkcap; checked call and lean call, each one launch."""
    case, t = _kept_case(num_cond + 7, cuda, n=8, cap=5000,
                         num_cond=num_cond, eval_on=eval_on)
    kw = dict(num_cond=num_cond, num_os=case["num_os"],
              max_words=case["max_words"], nw_pos=case["nw_pos"],
              bkcap=bkcap)
    args = [t[k] for k in KEPT_ARGS]
    want = kept_reference(*args, **kw)
    plan, largs = _kept_lean(case, t)
    before = kept.launches
    outs = [kept(*args, **kw), plan(*largs, bkcap=bkcap)]
    assert kept.launches == before + 2
    for out in outs:
        for g, w in zip(out, want):
            assert torch.equal(g, w)


def test_kept_kernel_every_entry_invalid(cuda):
    case, t = _kept_case(3, cuda, n=2, cap=4100, valid_share=0.0)
    plan, largs = _kept_lean(case, t)
    header, block = plan(*largs, bkcap=5000)
    assert int(header[0]) == 0 and not block.any()


def test_kept_graph_replays(cuda):
    """A CUDA graph of the lean call replayed 25 times, each replay on the
    scratch the last one left (its tickets spent, its status words final)
    and on outputs set to 0xFF before it: every replay equals the plain
    version (the head launch resets the look-back in the graph)."""
    case, t = _kept_case(11, cuda, n=8, cap=45056, num_os=40)
    Bp = 8 * 45056
    bkcap = Bp * 3 // 4
    want = kept_reference(*(t[k] for k in KEPT_ARGS), num_cond=2,
                          num_os=40, max_words=case["max_words"],
                          nw_pos=case["nw_pos"], bkcap=bkcap)
    plan, largs = _kept_lean(case, t)
    plan(*largs, bkcap=bkcap)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got = plan(*largs, bkcap=bkcap)
    for _ in range(25):
        for x in got:
            x.view(torch.uint8).fill_(0xFF)
        graph.replay()
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            assert torch.equal(g, w)


def test_kept_refuses_what_it_does_not_take(cuda):
    case, t = _kept_case(12, cuda, n=2, cap=300)
    args = [t[k] for k in KEPT_ARGS]
    kw = dict(num_cond=2, num_os=16, max_words=case["max_words"],
              nw_pos=case["nw_pos"], bkcap=400)
    for i in (0, 2, 5, 10, 11, 14):
        bad = args[i].cpu()
        with pytest.raises(ValueError):
            kept(*args[:i], bad, *args[i + 1:], **kw)
    for field, value in (("bkcap", 601), ("bkcap", 0), ("num_os", 65)):
        with pytest.raises(ValueError):
            kept(*args, **dict(kw, **{field: value}))
    with pytest.raises(ValueError):
        KeptPlan(t["ow"].cpu(), t["thr"].cpu(), nw_pos=100)


# ---- the device step's CUDA graph (parallel/step_graph.py) ----------------

def _payloads(n_frags, seed_, count=3):
    """`count` batches of `n_frags` random fragments, each with a primer
    site and an N run somewhere."""
    rng = np.random.default_rng(seed_)
    site = C.ASCII_TO_DB[np.frombuffer(b"TTGACCTAGATATTCAGCAAC", np.uint8)]
    out = []
    for j in range(count):
        frags = [rng.integers(0, 4, int(rng.integers(5000, 30000))).astype(
            np.uint8) for _ in range(n_frags)]
        frags[j % n_frags][1000 + 97 * j:1000 + 97 * j + len(site)] = site
        frags[(j + 1) % n_frags][4000:4400] = C.DB_N
        out.append(frags)
    return out


def _same_step(got, want, n, cfg, full):
    header = want[0].cpu()
    assert torch.equal(got[0].cpu(), header)
    m = min(int(header[0]), cfg.batch_kcap(n))
    assert m > 0
    assert torch.equal(got[1][:, :m].cpu(), want[1][:, :m].cpu())
    if full:
        for name, g, w in zip(("slot", "p", "keep", "needs_host", "valid"),
                              got[2:], want[2:]):
            assert torch.equal(g.cpu(), w.cpu()), name


def _same_results(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if isinstance(g, FragmentKept):
            # a mesh device's kept block is its own: compare the fragment's
            g, w = g.fields(), w.fields()
        assert g.keys() == w.keys()
        for k in w:
            np.testing.assert_array_equal(np.asarray(g[k]), np.asarray(w[k]),
                                          err_msg=k)


@pytest.mark.parametrize("full", [False, True])
def test_graph_step_equals_eager_and_cpu(cuda, full):
    """Over three payloads the graph's steps, the eager steps and the CPU
    steps are equal bit for bit: six graph steps in flight (the key's
    first its capture, the rest replays) resolved out of order."""
    dp, cpu = _panel(cuda), _panel("cpu")
    payloads = [dp._pack_host(f) for f in _payloads(4, 21)]
    want = [cpu.step(p, full=full) for p in payloads]
    eager = [eager_step(dp, p, full) for p in payloads]
    replays = step_graph.stats["replays"]
    graphed = [dp.step(p, full=full) for p in payloads * 2]
    assert step_graph.stats["replays"] - replays >= 5
    if not full:
        assert all(o is None for g in graphed[1:] for o in g[2:])
    for i in (3, 0, 5, 1, 4, 2):
        _same_step(graphed[i], want[i % 3], 4, dp.config, full)
        _same_step(eager[i % 3], want[i % 3], 4, dp.config, full)


@pytest.mark.parametrize("chunk, full", [(40, False), (3000, True)])
def test_graph_step_in_chunks_equals_eager_and_cpu(cuda, monkeypatch,
                                                    chunk, full):
    """A step whose screen and evaluator run in chunks of `chunk` entries
    (the last one short), as a panel of long oligos runs them: on the card
    screen_dp and eval_pack launch once a chunk, pool and kept once a step,
    kept reads the chunks' scores and words concatenated, and the graph's
    steps and the eager steps equal the CPU step, which runs the stream in
    one chunk, bit for bit (header, the used kept block and, with full,
    every output)."""
    from tntblast_tpu_torch.parallel import device_search

    dp, cpu = _panel(cuda), _panel("cpu")
    payloads = [dp._pack_host(f) for f in _payloads(4, 23)]
    want = [cpu.step(p, full=full) for p in payloads]
    monkeypatch.setattr(device_search, "SCREEN_CHUNK", chunk)
    # one chunk's M rows exactly: chunks of SCREEN_CHUNK entries (a budget
    # below that gives chunks of whole KERNEL_BLOCKs)
    wq = dp.config.wq_max
    monkeypatch.setattr(device_search, "M_ROWS_BYTES",
                        chunk * wq * (wq + 9) * 4)
    assert device_search.chunk_entries(4 * dp.config.cap, wq, wq + 8) \
        == chunk
    n_chunks = -(-4 * dp.config.cap // chunk)
    assert n_chunks > 2
    counters = (screen_dp, eval_pack, pool, kept)
    before = [f.launches for f in counters]
    eager = [eager_step(dp, p, full) for p in payloads]
    assert ([f.launches - b for f, b in zip(counters, before)]
            == [3 * n_chunks, 3 * n_chunks, 3, 3])
    replays = step_graph.stats["replays"]
    graphed = [dp.step(p, full=full) for p in payloads * 2]
    assert step_graph.stats["replays"] - replays >= 5
    for i in (3, 0, 5, 1, 4, 2):
        _same_step(graphed[i], want[i % 3], 4, dp.config, full)
        _same_step(eager[i % 3], want[i % 3], 4, dp.config, full)
    # kept entries in two chunks at least
    assert max(int(w[0][0]) for w in want) > chunk or chunk > 1000


@pytest.mark.parametrize("full", [False, True])
def test_graph_step_on_a_mesh(cuda, full):
    """The same on a mesh over every visible card, twice each (one graph a
    device, the replicas of a card replay one graph): six submissions in
    flight, resolved out of order, equal the CPU panel's."""
    mp, cpu = _panel(cuda, mesh=make_mesh() * 2), _panel("cpu")
    batches = _payloads(4, 22)
    resolve = "resolve_fragments_full" if full else "resolve_fragments"
    replays = step_graph.stats["replays"]
    pending = [mp.submit_fragments(b, full=full) for b in batches * 2]
    assert step_graph.stats["replays"] - replays >= 5 * len(mp.mesh)
    for i in (5, 2, 0, 4, 1, 3):
        _same_results(getattr(mp, resolve)(pending[i]),
                      getattr(cpu, resolve)(cpu.submit_fragments(
                          batches[i % 3], full=full)))


@pytest.mark.parametrize("full", [False, True])
def test_graph_nodes_are_the_launches_its_capture_recorded(cuda, full,
                                                           monkeypatch,
                                                           tmp_path):
    """The kernel nodes of a step graph, by their mangled names in the
    graph's dump, are the launches its capture recorded, which every
    replay adds to the counts: a seed launch is its two kernels, a pool
    launch its three, a kept launch its two, a screen_dp launch one kernel
    of the screening conditions (Lb0E) and one of the eval condition
    (Lb1E); no node sorts."""
    plain = torch.cuda.CUDAGraph

    class KeptGraph(plain):
        """Keeps its template (its nodes) to dump; instantiated at the end
        of the capture, as without it."""

        def __new__(cls):
            return super().__new__(cls, True)

        def __init__(self):
            super().__init__(True)     # keep_graph

        def capture_end(self):
            super().capture_end()
            self.instantiate()

    monkeypatch.setattr(torch.cuda, "CUDAGraph", KeptGraph)
    dp = _panel(cuda)
    assert dp.eval_on
    dp.submit_fragments(_payloads(4, 25, count=1)[0], full=full)
    monkeypatch.setattr(torch.cuda, "CUDAGraph", plain)
    (entry,) = step_graph.graphs().values()
    path = tmp_path / "step.dot"
    entry.graph.debug_dump(str(path))
    names = re.findall(r"\| (_Z\w+)\\<\\<\\<", path.read_text())

    def ran(name, flag=""):
        return sum(1 for k in names if name in k and flag in k)

    assert entry.launches == dict(dict.fromkeys(ops.STEP_KERNELS, 1),
                                  seed_dense=0)
    assert ran("seed_words_kernel") == ran("seed_keys_kernel") == 1
    assert ran("seed_dense") == 0
    assert ran("pool_count_kernel") == ran("pool_scatter_kernel") == 1
    assert ran("win_decode_kernel") == ran("eval_pack_kernel") == 1
    assert ran("screen_dp_", "Lb0E") == ran("screen_dp_", "Lb1E") == 1
    assert ran("kept_head_kernel") == ran("kept_kernel") == 1
    # no sort anywhere in the step's graph (the pool is a counting sort)
    assert not [k for k in names if "sort" in k.lower()
                or "radix" in k.lower()]
    # and the graph still replays after its dump
    dp.resolve_fragments(dp.submit_fragments(_payloads(4, 25, count=1)[0],
                                             full=full))


def test_step_on_a_second_stream_raises(cuda):
    """The graphs of a card share one pool, which is safe only while every
    step of the card is queued on one stream: a step from another raises."""
    dp = _panel(cuda)
    frags = _payloads(4, 26, count=1)[0]
    dp.resolve_fragments(dp.submit_fragments(frags))
    with torch.cuda.stream(torch.cuda.Stream()):
        with pytest.raises(RuntimeError, match="queued on"):
            dp.submit_fragments(frags)
    dp.resolve_fragments(dp.submit_fragments(frags))


def _same_slots(got, want):
    """Panel-manager results: per fragment, slot key -> (q, t, n_screened,
    eval words)."""
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g, w = dict(g.items()), dict(w.items())
        assert g.keys() == w.keys()
        for key in w:
            for a, b in zip(g[key], w[key]):
                np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def _small_search(monkeypatch):
    from tntblast_tpu_torch.engine import make_melt_engine
    from tntblast_tpu_torch.model import (
        expand_degenerate_signatures, read_input_file)
    from tntblast_tpu_torch.options import Options

    monkeypatch.chdir(HERE / "data")
    opt = Options()
    opt.parse(["-i", "assay_pcr.txt", "-d", "small_db.fna", "-e", "40",
               "-E", "40"])
    opt.sig_list = expand_degenerate_signatures(
        read_input_file(opt.input_filename, opt.ignore_probe, False),
        opt.degen_rescale_ct)
    return opt, make_melt_engine(opt, n_threads=1)


def test_step_core_runs_only_at_capture(cuda, monkeypatch):
    """panel_step_core runs at a key's first step (the eager step, then
    the capture) and never again: not on later steps and not from a fresh
    panel manager on the same panel, whose steps replay the graphs."""
    from tntblast_tpu_torch.parallel import device_search

    opt, melt = _small_search(monkeypatch)
    calls = []
    real = device_search.panel_step_core
    monkeypatch.setattr(device_search, "panel_step_core",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    step_graph.clear()
    batches = _payloads(2, 23)
    captures = step_graph.stats["captures"]
    first = port_panel.FragmentPanelManager(opt, melt, cuda)
    got = [first.resolve_batch(first.submit_batch(b)) for b in batches]
    # a key a tile length and group: two calls each, then none
    keys = step_graph.stats["captures"] - captures
    assert keys >= len(first.groups) and len(calls) == 2 * keys
    for _ in range(2):
        mgr = port_panel.FragmentPanelManager(opt, melt, cuda)
        for b, g in zip(batches * 2, got * 2):
            _same_slots(mgr.resolve_batch(mgr.submit_batch(b)), g)
    assert len(calls) == 2 * keys
    assert step_graph.stats["captures"] - captures == keys
    cpu = port_panel.FragmentPanelManager(opt, melt, "cpu")
    for b, g in zip(batches, got):
        _same_slots(cpu.resolve_batch(cpu.submit_batch(b)), g)


def _multigroup_search(tmp_path, n_assays=40):
    """Options, melt engine and genome of a PCR search of `n_assays`
    assays of 22-30-nt primers drawn from one random genome, 300 bases
    apart: 4 slots an assay, three panel groups at 40."""
    from tntblast_tpu_torch.engine import make_melt_engine
    from tntblast_tpu_torch.model import (
        expand_degenerate_signatures, read_input_file)
    from tntblast_tpu_torch.options import Options

    acgt = np.frombuffer(b"ACGT", np.uint8)
    rng = np.random.default_rng(2024)
    genome = rng.integers(0, 4, 300 * n_assays + 200).astype(np.uint8)
    rows = []
    for a in range(n_assays):
        lf, lr = (int(x) for x in rng.integers(22, 31, 2))
        lo, hi = 30 + 300 * a, 410 + 300 * a
        rows.append(f"A{a:02d}\t{acgt[genome[lo:lo + lf]].tobytes().decode()}"
                    f"\t{acgt[(3 - genome[hi - lr:hi])[::-1]].tobytes().decode()}"
                    "\n")
    (tmp_path / "q.txt").write_text("".join(rows))
    (tmp_path / "db.fna").write_text(
        f">g\n{acgt[genome].tobytes().decode()}\n")
    opt = Options()
    opt.parse(["-i", str(tmp_path / "q.txt"), "-d", str(tmp_path / "db.fna"),
               "-A", "PCR", "-e", "40", "-E", "45", "-l", "2000"])
    opt.sig_list = expand_degenerate_signatures(
        read_input_file(opt.input_filename, opt.ignore_probe, False),
        opt.degen_rescale_ct)
    return opt, make_melt_engine(opt, n_threads=1), genome


def test_a_batch_is_packed_once_for_its_panel_groups(cuda, monkeypatch,
                                                     tmp_path):
    """A panel of three groups through the panel manager on the card:
    each batch is packed once for its three group steps, which all replay
    their graphs on that payload; three batches in flight resolve out of
    order, and every fragment's seeds equal the CPU manager's."""
    opt, melt, genome = _multigroup_search(tmp_path)
    rng = np.random.default_rng(2025)
    batches = []
    for n in (8, 8, 5):
        frags = []
        for _ in range(n):
            g = genome.copy()
            pos = rng.choice(len(g), 20, replace=False)
            g[pos] = (g[pos] + rng.integers(1, 4, 20)) % 4
            frags.append(g[:int(rng.integers(len(g) - 3000, len(g) + 1))])
        batches.append(frags)
    mgr = port_panel.FragmentPanelManager(opt, melt, cuda)
    cpu = port_panel.FragmentPanelManager(opt, melt, "cpu")
    assert [len(g.keys) for g in mgr.groups] == [64, 64, 32]
    want = [cpu.resolve_batch(cpu.submit_batch(b)) for b in batches]
    mgr.resolve_batch(mgr.submit_batch(batches[0]))     # the captures
    packs = []
    real = DevicePanel._pack_host
    monkeypatch.setattr(DevicePanel, "_pack_host",
                        lambda dp, f: packs.append(1) or real(dp, f))
    replays = step_graph.stats["replays"]
    pending = [mgr.submit_batch(b) for b in batches]
    assert len(packs) == len(batches)
    assert step_graph.stats["replays"] - replays == 3 * len(batches)
    for i in (2, 0, 1):
        _same_slots(mgr.resolve_batch(pending[i]), want[i])
    assert mgr.stats["fallback"] == 0


def test_capture_beside_a_resolving_thread(cuda):
    """A capture taken while another thread copies earlier outputs to the
    host (as a new tile length's panel captures beside the resolve
    threads) is not broken by it, and every output stays right."""
    dp, cpu = _panel(cuda), _panel("cpu")
    batches = _payloads(4, 24)
    pending = [dp.submit_fragments(b) for b in batches]
    want = [cpu.resolve_fragments(cpu.submit_fragments(b)) for b in batches]
    step_graph.clear()
    errors, resolved = [], []
    stop = threading.Event()

    def resolver():
        try:
            while not stop.is_set():
                resolved.append([dp.resolve_fragments(p) for p in pending])
        except BaseException as e:   # noqa: BLE001 — asserted below
            errors.append(e)

    thread = threading.Thread(target=resolver)
    thread.start()
    captures = step_graph.stats["captures"]
    try:
        while not resolved:
            pass
        new = [(n, dp.submit_fragments(b[:n])) for n in (3, 2, 1)
               for b in batches]
    finally:
        stop.set()
        thread.join()
    assert not errors
    assert step_graph.stats["captures"] - captures == 3
    for got in resolved:
        for g, w in zip(got, want):
            _same_results(g, w)
    for (n, p), b in zip(new, batches * 3):
        _same_results(dp.resolve_fragments(p),
                      cpu.resolve_fragments(cpu.submit_fragments(b[:n])))


def test_graph_step_on_the_dense_path(cuda):
    """The dense seeding path (a dense seed plan, no seed plan) replays its
    graph too, with no host sync, equal to the CPU step."""
    rng = np.random.default_rng(84)
    dp, oligos = _dense_panel(cuda, np.random.default_rng(84))
    cpu = _dense_panel("cpu", np.random.default_rng(84))[0]
    assert "seed_plan" not in dp.tabs and "seed_dense_plan" in dp.tabs
    oligo = oligos[0]
    site = C.ASCII_TO_DB[np.frombuffer(oligo.encode(), np.uint8)]
    batches = []
    for j in range(3):
        frags = [rng.integers(0, 4, 16000).astype(np.uint8)
                 for _ in range(2)]
        frags[j % 2][2000 + j:2040 + j] = site
        batches.append(frags)
    dp.submit_fragments(batches[0], full=True)      # the capture
    torch.cuda.synchronize()
    replays = step_graph.stats["replays"]
    torch.cuda.set_sync_debug_mode("error")
    try:
        pending = [dp.submit_fragments(b, full=True) for b in batches]
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert step_graph.stats["replays"] - replays == 3
    for i in (2, 0, 1):
        _same_results(dp.resolve_fragments_full(pending[i]),
                      cpu.resolve_fragments_full(cpu.submit_fragments(
                          batches[i], full=True)))
