"""The window decode of the port's device step (ops/win_decode.py).

On the CPU: the CUDA kernel's own source (csrc/win_decode.cu), built for
the host with g++ behind tests/cuda_host_shim/cuda_runtime.h, against
`win_decode_reference` (the plain PyTorch version, the kernel's spec) on
all six outputs, exactly: random streams over every window width up to
wq_max 120 and word lengths 6-8, both strands, diagonals below
NUM_FLANK_BASE and windows past a fragment's end, words with N and pure
ACGT, slots past the pool and out of range, B around a warp and a block;
output rows at every offset from a 16-byte boundary (the kernel's 16-byte
stores); the real pooled stream of a device step; and the shapes the entry
point refuses.  Around the kernel's block of 128 entries, whose rows it
stores as two spans four words a thread: B ending just before, at and
past a block at odd widths (a thread's words cross entries) and at wt_max
128, the pool ending mid-block, minus-strand entries at every span's
start, every word length at wt_max 128, rows inside guard words the kernel
must not touch, and the lean call's C entry points (win_decode_plan,
win_decode_launch_plan).  The reference itself is held against the JAX
step through the whole step (tests/test_torch_device_search.py).
`chunk_entries`, the step's chunk rule, is checked here too.  The kernel's
launch on the card is held by chip_smoke.py and tests/test_torch_cuda.py.
"""

import ctypes
import os
import pathlib
import subprocess

import numpy as np
import pytest
import torch

from tntblast_tpu_torch import _kernels
from tntblast_tpu_torch import constants as C
from tntblast_tpu_torch.ops import win_decode as W
from tntblast_tpu_torch.ops.screen_dp import MAX_WT
from tntblast_tpu_torch.parallel import device_search as T
from tntblast_tpu_torch.tools.bench_inputs import (
    decode_inputs, step_decode_inputs)

HERE = pathlib.Path(__file__).resolve().parent
NAMES = ("needs_host", "tb5", "ptb", "ql", "wt_e", "ent_valid")


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def host_kernel(tmp_path_factory):
    """csrc/win_decode.cu built by g++ with -DWIN_DECODE_HOST (one host
    thread plays each block's threads, phase by phase)."""
    lib = tmp_path_factory.mktemp("win_decode_host") / "libwin_decode.so"
    subprocess.run(
        ["g++", "-x", "c++", "-std=c++17", "-O2", "-DWIN_DECODE_HOST",
         f"-I{HERE / 'cuda_host_shim'}", "-shared", "-fPIC",
         os.path.join(_kernels.CSRC, "win_decode.cu"), "-o", str(lib)],
        check=True)
    return W.bind(ctypes.CDLL(str(lib)))


def _offset_rows(B, wt_max, offset):
    """A (B, wt_max) int32 tensor whose first word lies `offset` words past
    a 16-byte boundary."""
    flat = torch.full((B * wt_max + 8,), -7, dtype=torch.int32)
    base = (-flat.data_ptr() // 4) % 4 + offset
    rows = flat[base:base + B * wt_max].view(B, wt_max)
    assert rows.is_contiguous() and rows.data_ptr() % 16 == 4 * offset
    return rows


def _run_host(lib, args, kw, offsets=(0, 0)):
    """The host build on (args, kw), its tb5 and ptb rows starting the
    given numbers of words past a 16-byte boundary; (rc, outputs)."""
    B = args[0].shape[0]
    out = list(W.empty_outputs(B, kw["wt_max"], "cpu"))
    out[1] = _offset_rows(B, kw["wt_max"], offsets[0])
    out[2] = _offset_rows(B, kw["wt_max"], offsets[1])
    rc = lib.win_decode_launch(*W.launch_args(*args, out, **kw), 0, None)
    return rc, out


def _assert_equal(got, want):
    for name, g, w in zip(NAMES, got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        bad = (g != w).reshape(len(g), -1).any(dim=1).nonzero()
        assert len(bad) == 0, (
            f"{name}: {len(bad)} entries differ, first {int(bad[0])}: "
            f"kernel {g[bad[0]].tolist()} plain {w[bad[0]].tolist()}")


def _fuzz_args(rng, B, wq_max, word_len):
    """decode_inputs with the corners mixed in: fragment indices and slots
    out of range, the default slot num_os, diagonals at the clamps."""
    args, kw = decode_inputs(rng, B, wq_max, "cpu", word_len=word_len, n=3,
                             L=int(rng.choice([512, 2048])), num_os=8)
    slot, p, frag = (a.clone() for a in args[:3])
    k = max(1, B // 16)
    idx = torch.from_numpy(rng.integers(0, B, k))
    slot[idx] = torch.from_numpy(rng.integers(-2, 11, k).astype(np.int32))
    frag[torch.from_numpy(rng.integers(0, B, k))] = torch.from_numpy(
        rng.integers(-2, 5, k).astype(np.int32))
    p[torch.from_numpy(rng.integers(0, B, k))] = torch.from_numpy(
        rng.choice([-50, 0, 3, 4, kw["L"] - 1, kw["L"], 10 ** 6], k).astype(
            np.int32))
    return (slot, p, frag, *args[3:]), kw


@pytest.mark.parametrize("B", [1, 31, 33, 4099])
@pytest.mark.parametrize("word_len", [6, 7, 8])
def test_kernel_source_matches_reference(host_kernel, word_len, B):
    rng = np.random.default_rng(1000 * word_len + B)
    seen = {"minus": 0, "plus": 0, "host": 0, "device": 0, "past_pool": 0,
            "cut": 0}
    for wq_max in sorted(set(rng.integers(1, 121, 6).tolist()) | {1, 120}):
        args, kw = _fuzz_args(rng, B, wq_max, word_len)
        want = W.win_decode_reference(*args, **kw)
        rc, got = _run_host(host_kernel, args, kw)
        assert rc == 0
        _assert_equal(got, want)
        nh, _, _, _, wt_e, ev = want
        s = args[0].clamp(0, kw["num_os"]).long()
        minus = args[7][s] & ev
        start = args[1] - C.NUM_FLANK_BASE
        flen = args[3][args[2].clamp(0, kw["n"] - 1).long()]
        seen["minus"] += int(minus.sum())
        seen["plus"] += int((ev & ~minus).sum())
        seen["host"] += int(nh.sum())
        seen["device"] += int((ev & ~nh).sum())
        seen["past_pool"] += int((~ev).sum())
        seen["cut"] += int((ev & ((start < 0) | (start + wt_e > flen))).sum())
    if B > 1000:
        assert min(seen.values()) > 50, seen


@pytest.mark.parametrize("offsets", [(0, 0), (1, 1), (2, 2), (3, 3), (0, 1),
                                     (3, 2)])
@pytest.mark.parametrize("wq_max", [16, 21, 22, 23])
def test_kernel_source_row_alignment(host_kernel, wq_max, offsets):
    """Rows of wt_max = wq_max + 8 words start 16-byte aligned only where
    wt_max % 4 == 0: head, 16-byte body and tail at every offset, word by
    word where the two rows lie on different 16-byte grids; a 16-byte
    store off 16 bytes would fail the launch (716)."""
    rng = np.random.default_rng(7 * wq_max + offsets[0] + 4 * offsets[1])
    args, kw = decode_inputs(rng, 257, wq_max, "cpu", n=2, L=1024, num_os=8)
    rc, got = _run_host(host_kernel, args, kw, offsets)
    assert rc == 0
    _assert_equal(got, W.win_decode_reference(*args, **kw))


def test_kernel_source_on_an_all_invalid_stream(host_kernel):
    """A stream past the pool: zeros in all six outputs."""
    args, kw = decode_inputs(np.random.default_rng(5), 700, 24, "cpu",
                             invalid=1.0)
    rc, got = _run_host(host_kernel, args, kw, (1, 1))
    assert rc == 0
    for g in got:
        assert not g.any()
    _assert_equal(got, W.win_decode_reference(*args, **kw))


def _step_panel():
    """A small port panel on the CPU: two oligos on both strands, the
    evaluator on."""
    from tntblast_tpu_torch import native
    from tntblast_tpu_torch.search import seed
    from tntblast_tpu_torch.thermo.santa_lucia import build_tables

    eng = native.MeltEngine(n_threads=1)
    w = 7
    panel = []
    for oligo in ("TTGACCTAGATATTCAGCAAC", "GGGAGAGACTCACCCAAAGATC"):
        codes = C.ASCII_TO_MELT[np.frombuffer(oligo.encode(), np.uint8)]
        for minus in (True, False):
            panel.append({"words": seed.oligo_word_list(
                codes, w, complement=not minus), "codes": codes,
                "minus": minus})
    cfg = T.PanelConfig(word_len=w, num_os=8, max_words=16, wq_max=22,
                        tile_len=16384, cap=2048, num_cond=1)
    dg = eng.delta_g_screen(np.float32(313.15)).astype(np.int32)
    return T.DevicePanel(
        panel, cfg, dg.reshape(1, -1), np.full((1, 4), 100000, np.int32),
        eval_dg=eng.delta_g().astype(np.int32).ravel(),
        thermo_tables=build_tables(), device="cpu")


def test_kernel_source_on_a_step_stream(host_kernel):
    """The pooled stream a device step decodes (bench_inputs'
    step_decode_inputs): sites planted on both strands, one cut by each
    end of its fragment, an N run and degenerate bases next to sites."""
    dp = _step_panel()
    rng = np.random.default_rng(13)
    site = C.ASCII_TO_DB[np.frombuffer(b"TTGACCTAGATATTCAGCAAC", np.uint8)]
    rc_site = 3 - C.ASCII_TO_DB[np.frombuffer(
        b"GGGAGAGACTCACCCAAAGATC", np.uint8)][::-1]
    frags = [rng.integers(0, 4, 16000).astype(np.uint8) for _ in range(3)]
    frags[0][:len(site)] = site                       # cut by the start
    frags[0][-len(rc_site):] = rc_site                # cut by the end
    frags[1][3000:3000 + len(site)] = site
    frags[1][2990:3000] = C.DB_N
    frags[2][5000:5000 + len(rc_site)] = rc_site
    frags[2][5005] = 9                                # a degenerate base
    args, kw = step_decode_inputs(dp, frags)
    assert args[0].shape == (3 * dp.config.cap,)
    want = W.win_decode_reference(*args, **kw)
    rc, got = _run_host(host_kernel, args, kw, (1, 1))
    assert rc == 0
    _assert_equal(got, want)
    nh, ev = want[0], want[5]
    assert 0 < int(nh.sum()) < int(ev.sum()) < len(ev)
    # the wrapper on CPU tensors is the plain version and launches nothing
    before = W.win_decode.launches
    for g, w in zip(W.win_decode(*args, **kw), want):
        assert torch.equal(g, w)
    assert W.win_decode.launches == before


@pytest.mark.parametrize("field,value", [
    ("wt_max", 0),
    # one past MAX_WT (1032); the case keeps the name it had at 128
    pytest.param("wt_max", MAX_WT + 1, id="wt_max-129"),
    ("word_len", 0), ("word_len", 16),
    ("n", 0), ("nw_pos", 0), ("num_os", -1)])
def test_entry_point_refuses_what_the_kernel_does_not_take(host_kernel,
                                                           field, value):
    """cudaErrorInvalidValue (1) for a shape the kernel does not take, and
    nothing written; every width up to MAX_WT is taken."""
    args, kw = decode_inputs(np.random.default_rng(3), 40, 24, "cpu", n=2,
                             L=1024)
    bad = dict(kw, **{field: value})
    out = W.empty_outputs(40, max(kw["wt_max"], 1), "cpu")
    for t in out:
        t.fill_(1)
    rc = host_kernel.win_decode_launch(*W.launch_args(*args, out, **bad), 0,
                                       None)
    assert rc == 1
    assert all(bool((t == 1).all()) for t in out)
    for wt_max in (1, 24, 33, 128, 129, MAX_WT):
        ok = dict(kw, wt_max=wt_max)
        rc, got = _run_host(host_kernel, args, ok)
        assert rc == 0
        _assert_equal(got, W.win_decode_reference(*args, **ok))


# ---- the block's spans ------------------------------------------------------
# A block owns DECODE_ENTRIES (128) consecutive entries and stores their
# rows as one span each of tb5 and ptb, four words a thread.

ENTRIES = 128


def _guarded_rows(B, wt_max, offset, guard=8):
    """(rows, flat): a (B, wt_max) int32 view `offset` words past a
    16-byte boundary inside `flat`, with `guard` words of -7 on each side
    that the kernel must leave as they are."""
    flat = torch.full((B * wt_max + 2 * guard + 4,), -7, dtype=torch.int32)
    base = (-flat.data_ptr() // 4) % 4 + guard + offset - guard % 4
    rows = flat[base:base + B * wt_max].view(B, wt_max)
    assert rows.data_ptr() % 16 == 4 * offset and base >= guard
    return rows, flat, base


def _run_guarded(lib, args, kw, offsets=(0, 0)):
    """The host build with its rows inside guard words; the guards checked
    untouched.  Returns the six outputs."""
    B, wt = args[0].shape[0], kw["wt_max"]
    out = list(W.empty_outputs(B, wt, "cpu"))
    guarded = [_guarded_rows(B, wt, o) for o in offsets]
    out[1], out[2] = guarded[0][0], guarded[1][0]
    rc = lib.win_decode_launch(*W.launch_args(*args, out, **kw), 0, None)
    assert rc == 0
    for name, (_, flat, base) in zip(("tb5", "ptb"), guarded):
        outside = torch.cat([flat[:base], flat[base + B * wt:]])
        assert bool((outside == -7).all()), f"{name}: written past its rows"
    return out


@pytest.mark.parametrize("wq_max", [17, 19, 24, 120])
@pytest.mark.parametrize("B", [127, 128, 129, 257])
def test_kernel_source_across_block_ends(host_kernel, B, wq_max):
    """B ending just before, at and just past a block's 128 entries, and
    mid-warp in a third block; odd widths (wt_max 25, 27), at which a
    thread's four words cross from one entry into the next, and wt_max 128.
    Nothing is written past the rows."""
    rng = np.random.default_rng(31 * B + wq_max)
    args, kw = decode_inputs(rng, B, wq_max, "cpu", n=3, L=1024, num_os=8)
    for offsets in ((0, 0), (3, 1)):
        got = _run_guarded(host_kernel, args, kw, offsets)
        _assert_equal(got, W.win_decode_reference(*args, **kw))


@pytest.mark.parametrize("n_valid", [1, 77, ENTRIES + 45, 2 * ENTRIES - 1])
def test_kernel_source_valid_entries_end_mid_block(host_kernel, n_valid):
    """The pool ends inside a block (mid-warp, or one entry short of its
    end): the block's valid entries are decoded, the rest are zeros."""
    B = 3 * ENTRIES
    args, kw = decode_inputs(np.random.default_rng(n_valid), B, 21, "cpu",
                             n=3, L=1024, num_os=8,
                             invalid=(B - n_valid) / B)
    got = _run_guarded(host_kernel, args, kw)
    want = W.win_decode_reference(*args, **kw)
    assert int(want[5].sum()) == n_valid
    _assert_equal(got, want)
    for g in got:
        assert not g[n_valid:].any()


@pytest.mark.parametrize("wq_max", [17, 24, 56])
def test_kernel_source_minus_strand_at_span_starts(host_kernel, wq_max):
    """Every block's first entry on the minus strand after a plus-strand
    entry: its column 0 reads the reversal's far end, and its ptb at
    column 0 takes the code 5 before it, never the previous entry's last
    code."""
    B = 4 * ENTRIES + 9
    rng = np.random.default_rng(wq_max)
    args, kw = decode_inputs(rng, B, wq_max, "cpu", n=3, L=1024, num_os=8,
                             invalid=0.0)
    slot = args[0].clone()
    slot[ENTRIES - 1::ENTRIES] = 1                    # plus strand
    slot[::ENTRIES] = 0                               # minus strand
    p = args[1].clone()
    p[::ENTRIES] = torch.from_numpy(rng.integers(
        C.NUM_FLANK_BASE, 900, len(p[::ENTRIES])).astype(np.int32))
    args = (slot, p, *args[2:])
    assert bool(args[7][0]) and not bool(args[7][1])
    want = W.win_decode_reference(*args, **kw)
    assert bool(want[5][::ENTRIES].all())
    assert bool((want[2][::ENTRIES, 0] // 5 == 5).all())
    got = _run_guarded(host_kernel, args, kw, (1, 1))
    _assert_equal(got, want)


@pytest.mark.parametrize("word_len", range(1, W.MAX_WORD_LEN + 1))
def test_kernel_source_every_word_length_at_wt_max_128(host_kernel,
                                                       word_len):
    """Column r's word is (r * word_inv) >> 16, r / word_len for every
    column of the widest window and every word length the kernel takes."""
    rng = np.random.default_rng(400 + word_len)
    args, kw = decode_inputs(rng, 300, 120, "cpu", word_len=word_len, n=3,
                             L=1024, num_os=8)
    got = _run_guarded(host_kernel, args, kw)
    _assert_equal(got, W.win_decode_reference(*args, **kw))


def test_plan_entry_points_match_the_one_call(host_kernel):
    """win_decode_plan + win_decode_launch_plan, the lean call's pair,
    decode as win_decode_launch does; the plan refuses the shapes the
    kernel does not take, and the launch refuses n < 1, writing
    nothing."""
    args, kw = decode_inputs(np.random.default_rng(17), 700, 24, "cpu", n=4,
                             L=2048, num_os=8)
    lib = host_kernel
    plan = (ctypes.c_uint64 * -(-lib.win_decode_plan_bytes() // 8))()
    statics = (kw["L"], kw["wt_max"], kw["word_len"], kw["nw_pos"],
               kw["num_os"], 0)
    assert lib.win_decode_plan(plan, args[6].data_ptr(), args[7].data_ptr(),
                               *statics) == 0
    out = W.empty_outputs(700, kw["wt_max"], "cpu")

    def launch(n):
        return lib.win_decode_launch_plan(
            plan, *(t.data_ptr() for t in args[:6]),
            *(t.data_ptr() for t in out), 700, n, None)

    assert launch(kw["n"]) == 0
    _assert_equal(out, W.win_decode_reference(*args, **kw))
    for t in out:
        t.fill_(1)
    assert launch(0) == 1
    assert all(bool((t == 1).all()) for t in out)
    for i, bad in ((1, MAX_WT + 1), (2, 0), (2, 16), (3, 0), (4, -1)):
        wrong = list(statics)
        wrong[i] = bad
        assert lib.win_decode_plan(plan, args[6].data_ptr(),
                                   args[7].data_ptr(), *wrong) == 1


def test_plan_serves_a_card_only():
    """WinDecodePlan refuses CPU tables, and a CPU panel has no plan: its
    step calls win_decode, which runs the plain version."""
    args, kw = decode_inputs(np.random.default_rng(19), 40, 24, "cpu")
    with pytest.raises(ValueError):
        W.WinDecodePlan(args[6], args[7], L=kw["L"], wt_max=kw["wt_max"],
                        word_len=kw["word_len"], nw_pos=kw["nw_pos"],
                        num_os=kw["num_os"])
    assert "decode_plan" not in _step_panel().tabs


# ---- the step's chunk rule -----------------------------------------------

def test_chunk_entries_at_the_step_shapes():
    """One chunk a bench step (wq_max 24: 3168 B of M rows an entry, the
    8 x 45056 pooled entries in 1.14 GB); SCREEN_CHUNK at wq_max 120."""
    bench = 8 * 45056
    assert T.chunk_entries(bench, 24, 32) == bench
    assert T.chunk_entries(bench, 120, 128) == T.SCREEN_CHUNK
    assert T.chunk_entries(100, 24, 32) == 100
    assert T.M_ROWS_BYTES == 2 << 30


def test_chunk_entries_rule():
    rng = np.random.default_rng(9)
    for _ in range(2000):
        wq_max = int(rng.integers(1, 121))
        Bp = int(rng.integers(1, 1 << 22))
        ch = T.chunk_entries(Bp, wq_max, wq_max + 8)
        assert 1 <= ch <= Bp
        assert ch == Bp or ch % T.SCREEN_CHUNK == 0
        if ch < Bp:     # a full chunk's M rows stay within the budget
            assert ch * wq_max * (wq_max + 9) * 4 <= max(
                T.M_ROWS_BYTES, T.SCREEN_CHUNK * wq_max * (wq_max + 9) * 4)


def test_chunk_entries_past_one_screen_chunk():
    """Where one SCREEN_CHUNK of M rows is over M_ROWS_BYTES (oligos of
    more than 120 nt: 138 GB at wq_max 1024) a chunk is whole blocks of
    KERNEL_BLOCK entries within the budget, at least one block; below that
    width the rule gives what it gave before."""
    assert T.chunk_entries(8 * 131072, 60, 68) == 3 * T.SCREEN_CHUNK
    assert T.chunk_entries(10 ** 6, 121, 129) == T.SCREEN_CHUNK
    assert T.chunk_entries(10 ** 6, 150, 158) == 22400
    assert T.chunk_entries(10 ** 6, 1024, 1032) == 384
    assert T.chunk_entries(100, 1024, 1032) == 100
    rng = np.random.default_rng(10)
    for _ in range(2000):
        wq_max = int(rng.integers(121, 1025))
        Bp = int(rng.integers(1, 1 << 22))
        ch = T.chunk_entries(Bp, wq_max, wq_max + 8)
        per = wq_max * (wq_max + 9) * 4
        assert 1 <= ch <= Bp
        assert ch == Bp or ch % T.KERNEL_BLOCK == 0
        assert ch * per <= T.M_ROWS_BYTES
        if ch < Bp and T.SCREEN_CHUNK * per > T.M_ROWS_BYTES:
            assert (ch + T.KERNEL_BLOCK) * per > T.M_ROWS_BYTES


# ---- windows past 128 columns -------------------------------------------

@pytest.mark.parametrize("wt_max", [129, 148, 308, 1032])
@pytest.mark.parametrize("word_len", [7, 10])
def test_kernel_source_on_wide_windows(host_kernel, wt_max, word_len):
    """Oligos of 121 to 1024 nt: the host build against the plain version
    on all six outputs, B around a block, a pool ending mid-block, rows off
    16 bytes."""
    rng = np.random.default_rng(wt_max * 16 + word_len)
    for B, offsets in ((129, (0, 0)), (300, (1, 3))):
        args, kw = _fuzz_args(rng, B, wt_max - 8, word_len)
        slot = args[0].clone()
        slot[B - 40:] = kw["num_os"]                # the tail of the pool
        args = (slot, *args[1:])
        want = W.win_decode_reference(*args, **kw)
        rc, got = _run_host(host_kernel, args, kw, offsets)
        assert rc == 0
        _assert_equal(got, want)
        assert int(want[5].sum()) > B // 2


def test_source_has_a_plain_c_entry_and_one_host_switch():
    """Built by nvcc like the other kernels, with no flags of its own (no
    float arithmetic); the host build is the source's only #if."""
    import re

    with open(os.path.join(_kernels.CSRC, "win_decode.cu")) as fh:
        src = fh.read()
    assert 'extern "C" int win_decode_launch(' in src and "<<<" in src
    assert re.findall(r"#\s*if(?:n?def)?\s+(\w+)", src) == [
        "WIN_DECODE_HOST"]
    includes = [ln for ln in src.splitlines() if ln.startswith("#include")]
    assert includes == ["#include <cuda_runtime.h>", "#include <stdint.h>"]
    assert "win_decode" in _kernels.KERNELS
    assert "win_decode" not in _kernels.KERNEL_FLAGS
    for name in _kernels.KERNELS:
        assert os.path.exists(os.path.join(_kernels.CSRC, f"{name}.cu"))
