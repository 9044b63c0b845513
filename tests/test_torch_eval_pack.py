"""The evaluation stage of the port's device step (ops/eval_pack.py).

On the CPU: `eval_pack_reference` (the plain PyTorch version, the kernel's
spec) against the JAX eval_flat + pack_eval word for word, tolerance zero;
and the CUDA kernel's own source (csrc/eval_pack.cu), built for the host
with g++ behind tests/cuda_host_shim/cuda_runtime.h, against the plain
version on every entry.  The host build plays a warp's 32 lanes phase by
phase, so it runs the kernel's staging of the M rows too: the layout's
pitch, the head, 16-byte body and tail of a span that starts off 16 bytes
(the shim refuses a misaligned 16-byte copy), the per-warp row bound and the
warps without a valid entry; through the checked entry point and through a
plan (the lean call's).  The kernel's launch on the card is held by
chip_smoke.py and tests/test_torch_cuda.py.
"""

import ctypes
import os
import pathlib
import subprocess

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tntblast_tpu import native
from tntblast_tpu.ops import eval_gapless_jax as J
from tntblast_tpu.thermo.santa_lucia import build_tables
from tntblast_tpu_torch import _kernels
from tntblast_tpu_torch.ops import eval_pack as P
from tntblast_tpu_torch.ops.screen_dp import MAX_WT, screen_dp_reference
from tntblast_tpu_torch.tools.bench_inputs import (
    eval_inputs, eval_pack_args, synthetic_eval_panel)

from test_torch_eval_gapless import _flat_pool

HERE = pathlib.Path(__file__).resolve().parent


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def engine():
    return native.MeltEngine(n_threads=1)


@pytest.fixture(scope="module")
def tables():
    return build_tables()


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _jax_words(flat, ev_tabs, ev_loop, eval_const, needs_host, ent_valid):
    """JAX eval_flat + the packing of the JAX step's pack_eval (a closure of
    tntblast_tpu/parallel/device_search.py:584-610, restated here)."""
    n_slots = ev_tabs.shape[0]
    oh = (flat["sl"][:, None] == np.arange(n_slots)[None, :]).astype(
        np.float32)
    ev = J.eval_flat(flat["M"], flat["mg"], flat["t"], flat["q"],
                     flat["ql"], flat["wt"], oh, ev_tabs, ev_loop,
                     eval_const)
    trusted = ev["trusted"] & ~needs_host & ent_valid
    w0 = (trusted.astype(jnp.int32)
          | (ev["tm_zero"].astype(jnp.int32) << 1)
          | (jnp.clip(ev["num_base"], 0, 255) << 2)
          | (jnp.clip(ev["mm"], 0, 63) << 10)
          | (jnp.clip(ev["align_len"], 0, 63) << 16))
    w1 = ((ev["fm_q"] & 0xFF) | ((ev["fm_t"] & 0xFF) << 8)
          | ((ev["lm_q"] & 0xFF) << 16) | ((ev["lm_t"] & 0xFF) << 24))
    w2 = (ev["anchor5"] & 0xFF) | ((ev["anchor3"] & 0xFF) << 8)
    return np.asarray(jnp.stack(
        [w0, w1, w2, ev["dH"].view(jnp.int32), ev["dS"].view(jnp.int32)],
        axis=1))


def _pool_case(engine, tables, seed, qls, degenerate):
    """The mixed-slot pool of test_torch_eval_gapless (planted and mutated
    sites, junk in the M rows and columns out of contract) as eval_pack's
    arguments, with some entries needing the host, some invalid (their M
    rows all junk, as screen_dp leaves them) and, with `degenerate`, window
    codes 4 and 5 among the targets."""
    flat, ev_tabs, ev_loop, eval_const = _flat_pool(engine, tables, seed,
                                                    qls)
    rng = np.random.default_rng(seed + 1000)
    B = len(flat["ql"])
    n_slots, wq_max = ev_tabs.shape[:2]
    if degenerate:
        hit = rng.random(flat["t"].shape) < 0.04
        flat["t"] = np.where(hit, rng.integers(4, 6, flat["t"].shape),
                             flat["t"]).astype(np.int32)
    needs_host = rng.random(B) < 0.15
    ent_valid = rng.random(B) >= 0.1
    flat["M"][:, ~ent_valid] = rng.integers(
        -(1 << 31), 1 << 31, (wq_max, int((~ent_valid).sum()),
                              flat["M"].shape[2])).astype(np.int32)
    qc = np.zeros((n_slots + 1, wq_max), np.int32)
    for s in range(n_slots):
        qc[s] = flat["q"][np.flatnonzero(flat["sl"] == s)[0]]
    slot = np.where(ent_valid, flat["sl"], n_slots).astype(np.int32)
    args = [_t(flat["M"]), _t(flat["mg"]), _t(flat["t"]), _t(slot),
            _t(flat["ql"]), _t(flat["wt"]), _t(needs_host), _t(ent_valid),
            _t(qc), _t(ev_tabs), _t(ev_loop)]
    return flat, args, eval_const, needs_host, ent_valid


POOLS = [(23, (15, 19, 24), False), (31, (18, 21, 22, 25), False),
         (47, (9, 16, 30), True), (53, (12, 13, 20, 24), True)]


@pytest.mark.parametrize("seed,qls,degenerate", POOLS)
def test_reference_matches_jax_words(engine, tables, seed, qls, degenerate):
    flat, args, eval_const, needs_host, ent_valid = _pool_case(
        engine, tables, seed, qls, degenerate)
    got = P.eval_pack_reference(*args, eval_const).numpy()
    want = _jax_words(flat, args[9].numpy(), args[10].numpy(), eval_const,
                      needs_host, ent_valid)
    assert got.dtype == np.int32 and got.shape == want.shape
    np.testing.assert_array_equal(got[ent_valid], want[ent_valid])
    assert (got[~ent_valid] == 0).all() and (~ent_valid).sum() > 5
    trusted = got[:, 0] & 1
    assert trusted.sum() > 0.3 * len(trusted)
    assert not trusted[needs_host].any()
    # eval_pack on CPU tensors is the plain version, and launches nothing
    before = P.eval_pack.launches
    again = P.eval_pack(*args, eval_const)
    assert torch.equal(again, torch.from_numpy(got))
    assert P.eval_pack.launches == before


@pytest.mark.parametrize("wq_max", [140, 300])
def test_reference_matches_jax_words_on_wide_windows(wq_max):
    """At wt_max 148 and 308 (oligos past 120 nt): the plain version against
    the JAX eval_flat and pack_eval on a stream with planted sites, junk
    out of contract and random tables (the JAX package builds no evaluator
    tables past 256 nt), every word of every valid entry."""
    rng = np.random.default_rng(wq_max)
    args, eval_const = _staging_case(rng, 64, wq_max)
    slot = args[3].numpy()
    sl = np.clip(slot, 0, args[9].shape[0] - 1)
    flat = {"M": args[0].numpy().copy(), "mg": args[1].numpy(),
            "t": args[2].numpy(), "q": args[8].numpy()[sl],
            "ql": args[4].numpy(), "wt": args[5].numpy(), "sl": sl}
    want = _jax_words(flat, args[9].numpy(), args[10].numpy(), eval_const,
                      args[6].numpy(), args[7].numpy())
    got = P.eval_pack_reference(*args, eval_const).numpy()
    valid = args[7].numpy()
    np.testing.assert_array_equal(got[valid], want[valid])
    assert (got[valid][:, 0] & 1).sum() > 0


# ---- the kernel's source on the host -------------------------------------

def _host_build(lib):
    """csrc/eval_pack.cu built by g++ with -DEVAL_PACK_HOST (the source then
    plays each warp's lanes itself); no contraction of the f32 sums, as
    -fmad=false asks of nvcc."""
    subprocess.run(
        ["g++", "-x", "c++", "-std=c++17", "-O2", "-ffp-contract=off",
         "-DEVAL_PACK_HOST", f"-I{HERE / 'cuda_host_shim'}", "-shared",
         "-fPIC", os.path.join(_kernels.CSRC, "eval_pack.cu"), "-o",
         str(lib)], check=True)
    return HostKernel(P.bind(ctypes.CDLL(str(lib))))


@pytest.fixture(scope="module")
def host_kernel(tmp_path_factory):
    return _host_build(tmp_path_factory.mktemp("eval_pack_host")
                       / "libeval_pack_host.so")


class HostKernel:
    """The host build's entry points on CPU tensors: `plan` fills a plan
    for a panel's tables and window width (its return code beside it),
    `run` launches a chunk through a plan as the lean call does, `layout`
    is the staging layout at a window width."""

    def __init__(self, lib):
        self.lib = lib

    def layout(self, wt_max, blocks=2):
        return P.layout(wt_max, blocks, self.lib)

    def plan(self, qc, ev_tabs, ev_loop, eval_const, wt_max,
             wq_max=None):
        plan = (ctypes.c_uint64 * (self.lib.eval_pack_plan_bytes() // 8 + 1))()
        rc = self.lib.eval_pack_plan(
            plan, qc.data_ptr(), ev_tabs.data_ptr(), ev_loop.data_ptr(),
            qc.shape[1] if wq_max is None else wq_max, wt_max, qc.shape[0],
            ev_tabs.shape[0], *eval_const, 0)
        return plan, rc

    def run(self, args, eval_const):
        wq_max, B, w1 = args[0].shape
        plan, rc = self.plan(*args[8:11], eval_const, w1 - 1)
        assert rc == 0, f"host plan: error {rc}"
        out = torch.full((B, 5), 7, dtype=torch.int32)
        rc = self.lib.eval_pack_launch_plan(
            plan, *(a.data_ptr() for a in args[:8]), out.data_ptr(), B, None)
        assert rc == 0, f"host launch through a plan: error {rc}"
        return out

    def __call__(self, args, eval_const):
        return self.run(args, eval_const)


def _assert_words_equal(got, want):
    bad = np.argwhere(got.numpy() != want.numpy())
    assert len(bad) == 0, (
        f"{len(bad)} words differ, first (entry, word) {bad[0].tolist()}: "
        f"kernel {got[bad[0][0]].tolist()} plain {want[bad[0][0]].tolist()}")


@pytest.mark.parametrize("seed,qls,degenerate", POOLS)
def test_kernel_source_matches_reference_on_pool(host_kernel, engine, tables,
                                                 seed, qls, degenerate):
    _, args, eval_const, _, ent_valid = _pool_case(engine, tables, seed, qls,
                                                   degenerate)
    want = P.eval_pack_reference(*args, eval_const)
    _assert_words_equal(host_kernel(args, eval_const), want)
    # every entry invalid: zeros, whatever the M rows hold
    args[7] = torch.zeros_like(args[7])
    got = host_kernel(args, eval_const)
    assert (got == 0).all()
    assert torch.equal(got, P.eval_pack_reference(*args, eval_const))


def _fuzz_case(rng, trial):
    """Random entries the pipeline would never make, to reach the corners:
    ql 0, windows narrower and wider than wt_max, M blocks without one
    non-negative cell, ties, diagonals that leave the block, zero and
    negative values on the diagonal, mismatched sites (loops)."""
    W = int(rng.integers(3, 30))
    wt_max = W + 8
    S = int(rng.integers(1, 6))
    B = int(rng.integers(1, 300))
    ql_s = rng.integers(max(1, W - 6), W + 1, S).astype(np.int32)
    if trial % 5 == 0:
        ql_s[0] = 0
    slot = rng.integers(0, S + 1, B).astype(np.int32)
    ent_valid = slot < S
    sc = np.clip(slot, 0, S - 1)
    ql = ql_s[sc].copy()
    wt_e = (ql + 8).astype(np.int32)
    if trial % 4 == 1:
        wt_e = rng.integers(0, wt_max + 3, B).astype(np.int32)
    top = int(rng.choice([3, 50, 100000]))
    M = rng.integers(-5, top, (W, B, wt_max + 1)).astype(np.int32)
    M[:, :, 0] = -1
    if trial % 3 == 0:
        M[:, ::2] = np.minimum(M[:, ::2], -1)
    mg = rng.integers(-5, top, B).astype(np.int32)
    tb5 = rng.integers(0, 6 if trial % 2 else 4, (B, wt_max)).astype(np.int32)
    qc = np.zeros((S + 1, W), np.int32)
    for s in range(S):
        qc[s, :ql_s[s]] = rng.integers(0, 5, ql_s[s])
    for b in range(0, B, 2):
        L = ql_s[sc[b]]
        if L == 0:
            continue
        off = int(rng.integers(0, 9))
        site = (3 - qc[sc[b], :L][::-1]) % 4
        for _ in range(int(rng.integers(0, 4))):
            site[int(rng.integers(0, L))] = rng.integers(0, 4)
        tb5[b, off:off + L] = site
        for r in range(L):
            if off + r + 1 <= wt_max:
                M[r, b, off + r + 1] = (10 + 5 * r if rng.random() > 0.05
                                        else int(rng.integers(-3, 2)))
    args = [_t(M), _t(mg), _t(tb5), _t(slot), _t(ql), _t(wt_e),
            _t(rng.random(B) < 0.2), _t(ent_valid), _t(qc),
            _t(rng.normal(size=(S, W, 25, 4)).astype(np.float32)),
            _t(rng.normal(size=(S, W + 2)).astype(np.float32))]
    return args, tuple(float(np.float32(x)) for x in rng.normal(size=4))


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_kernel_source_matches_reference_on_corners(host_kernel, seed):
    rng = np.random.default_rng(seed)
    n_trusted = n_closing = 0
    for trial in range(25):
        args, eval_const = _fuzz_case(rng, trial)
        want = P.eval_pack_reference(*args, eval_const)
        _assert_words_equal(host_kernel(args, eval_const), want)
        n_trusted += int((want[:, 0] & 1).sum())
        n_closing += int((((want[:, 0] >> 10) & 63) > 0).sum())
    assert n_trusted > 100 and n_closing > 100


@pytest.mark.parametrize("wq_max", [16, 24, 56])
def test_kernel_source_matches_reference_behind_screen_dp(host_kernel,
                                                          wq_max):
    """The stage as the step runs it, on the inputs the card tests and
    chip_smoke.py use (tools/bench_inputs.py): M rows and mgmax from
    screen_dp's plain version on slot-major windows with planted sites, the
    cells out of contract overwritten with junk, real thermodynamic
    tables."""
    rng = np.random.default_rng(100 + wq_max)
    B = 400
    pan = synthetic_eval_panel(rng, 6, wq_max, "cpu")
    dp_args, tb5, needs_host, ent_valid = eval_inputs(
        rng, B, pan["qp"], pan["qc"], pan["ql_slot"], pan["tcan"], "cpu",
        invalid=0.1, slot_major=True)
    _, slot, ql, wt_e = dp_args[:4]
    _, mgmax, M_rows = screen_dp_reference(*dp_args, eval_on=True)
    junk = torch.from_numpy(rng.integers(
        -9, 1 << 20, tuple(M_rows.shape)).astype(np.int32))
    rows = torch.arange(wq_max)[:, None, None]
    cols = torch.arange(wq_max + 9)[None, None, :]
    live = ((rows < ql[None, :, None]) & (cols <= wt_e[None, :, None])
            & ent_valid[None, :, None])
    M_rows = torch.where(live, M_rows, junk).contiguous()
    args = eval_pack_args(dp_args, M_rows, mgmax, tb5, needs_host, ent_valid,
                          pan["qc"], pan["ev_tabs"], pan["ev_loop"])
    want = P.eval_pack_reference(*args, pan["eval_const"])
    _assert_words_equal(host_kernel(args, pan["eval_const"]), want)
    w0 = want[:, 0]
    assert int((w0 & 1).sum()) > B // 4                # trusted
    assert int(((w0 & 3) == 1).sum()) > B // 8         # with a Tm to compute
    assert int((((w0 >> 10) & 63) > 0).sum()) > 20     # with mismatches


# ---- the staged layout of the redesigned kernel --------------------------

def _staging_case(rng, B, wq_max, *, mixed_ql=False, invalid_warps=False,
                  offset=0):
    """Entries in the order of the step's slot-major stream (a warp mostly
    shares its slot, so its ql), with planted sites, junk in every cell out
    of contract (rows past ql, columns past wt_e, invalid entries: a scan
    that reads one changes the words) and the tail of the stream invalid.
    `mixed_ql`: every other lane from a slot of another length, so a warp
    mixes two ql and its row bound is its longest lane's.  `invalid_warps`:
    whole warps without a valid entry between valid ones.  `offset`: the M
    rows start `offset` words past a 16-byte boundary."""
    S = 5
    wt_max = wq_max + 8
    w1 = wt_max + 1
    ql_s = np.array([wq_max, wq_max - 1, wq_max - 3, wq_max - 4, wq_max - 2],
                    np.int32)
    slot = np.sort(rng.integers(0, S, B)).astype(np.int32)
    if mixed_ql:
        slot[1::2] = (slot[1::2] + 2) % S
    ent_valid = np.ones(B, bool)
    ent_valid[B - B // 8:] = False                 # the tail of the pool
    ent_valid[rng.random(B) < 0.03] = False
    if invalid_warps:
        for w in range(1, -(-B // 32), 3):
            ent_valid[32 * w:32 * w + 32] = False
    slot = np.where(ent_valid, slot, S).astype(np.int32)
    sc = np.clip(slot, 0, S - 1)
    ql = ql_s[sc].astype(np.int32)
    wt_e = (ql + 8).astype(np.int32)
    qc = np.zeros((S + 1, wq_max), np.int32)
    for s_ in range(S):
        qc[s_, :ql_s[s_]] = rng.integers(0, 4, ql_s[s_])
    tb5 = rng.integers(0, 4, (B, wt_max)).astype(np.int32)
    M = rng.integers(-3, 40, (wq_max, B, w1)).astype(np.int32)
    M[:, :, 0] = -1
    for b in np.flatnonzero(ent_valid):
        L = ql[b]
        off = int(rng.integers(0, 9))
        site = (3 - qc[sc[b], :L][::-1]) % 4
        for _ in range(int(rng.integers(0, 3))):
            site[int(rng.integers(0, L))] = rng.integers(0, 4)
        tb5[b, off:off + L] = site
        for r in range(L):
            M[r, b, off + r + 1] = 50 + 5 * r
    rows = np.arange(wq_max)[:, None, None]
    cols = np.arange(w1)[None, None, :]
    live = (rows < ql[None, :, None]) & (cols <= wt_e[None, :, None]) & (
        ent_valid[None, :, None])
    junk = rng.integers(1000, 1 << 20, M.shape).astype(np.int32)
    M = np.where(live, M, junk)
    flat = torch.zeros(M.size + 8, dtype=torch.int32)
    base = (-flat.data_ptr() // 4) % 4 + offset    # 16-byte aligned + offset
    M_t = flat[base:base + M.size].view(M.shape)
    M_t.copy_(torch.from_numpy(M))
    assert M_t.is_contiguous() and M_t.data_ptr() % 16 == 4 * offset
    args = [M_t, _t(rng.integers(-3, 120, B).astype(np.int32)), _t(tb5),
            _t(slot), _t(ql), _t(wt_e), _t(rng.random(B) < 0.1),
            _t(ent_valid), _t(qc),
            _t(rng.normal(size=(S, wq_max, 25, 4)).astype(np.float32)),
            _t(rng.normal(size=(S, wq_max + 2)).astype(np.float32))]
    return args, tuple(float(np.float32(x)) for x in rng.normal(size=4))


# (B, wq_max, options): B around a warp and a block, w1 = wq_max + 9 odd
# (the span copied as its image, 16 bytes a lane) and even (word by word
# into the padded pitch)
STAGING = [(B, wq, {}) for B in (1, 31, 33, 4099) for wq in (24, 23)] + [
    (256, 24, {"mixed_ql": True}), (256, 19, {"mixed_ql": True}),
    (700, 24, {"invalid_warps": True}), (700, 21, {"invalid_warps": True}),
    (1000, 24, {"offset": 1}), (1000, 24, {"offset": 2}),
    (1000, 24, {"offset": 3}), (1000, 23, {"offset": 3})]


@pytest.mark.parametrize(
    "B,wq_max,opts", STAGING,
    ids=[f"B{B}-wq{wq}-" + ("-".join(f"{k}{'' if v is True else v}"
                                      for k, v in o.items()) or "plain")
         for B, wq, o in STAGING])
def test_kernel_source_staging_matches_reference(host_kernel, B, wq_max,
                                                 opts):
    rng = np.random.default_rng(B * 131 + wq_max + 7 * len(opts))
    args, eval_const = _staging_case(rng, B, wq_max, **opts)
    want = P.eval_pack_reference(*args, eval_const)
    _assert_words_equal(host_kernel.run(args, eval_const), want)
    valid = args[7].numpy()
    w0 = want[:, 0].numpy()
    assert (want[~args[7]] == 0).all()
    if valid.sum() > 30:
        assert (w0[valid] & 1).sum() > valid.sum() // 20     # trusted
    if opts.get("mixed_ql"):
        ql = args[4].numpy()
        assert all(len(set(ql[w:w + 32][valid[w:w + 32]])) >= 2
                   for w in range(0, B, 32) if valid[w:w + 32].sum() > 8)


@pytest.mark.parametrize("wq_max", [16, 19, 23, 24, 56, 101, 120])
def test_staging_layout_is_conflict_free_and_fits(host_kernel, wq_max):
    """The pitch of a lane's row in shared memory is odd (the 32 lanes'
    column j fall on 32 banks), holds the row, and leaves room for a span's
    misalignment; the ring fits in a block's shared memory at every width
    the step uses."""
    wt_max = wq_max + 8
    w1 = wt_max + 1
    lay = host_kernel.layout(wt_max)
    assert lay["pitch"] % 2 == 1 and w1 <= lay["pitch"] <= w1 + 1
    for j in (0, w1 // 2, w1 - 1):
        assert len({(lane * lay["pitch"] + j) % 32 for lane in range(32)}) \
            == 32
    assert lay["stage"] % 4 == 0 and lay["stage"] >= 32 * lay["pitch"] + 3
    assert lay["tpitch"] % 2 == 1 and wt_max <= lay["tpitch"] <= wt_max + 1
    assert lay["tb5"] % 4 == 0 and lay["tb5"] >= 32 * lay["tpitch"]
    assert lay["slots"] >= 2 and 1 <= lay["warps"] <= 4
    assert lay["smem"] == lay["warps"] * (
        lay["slots"] * lay["stage"] + lay["tb5"]) * 4
    assert lay["smem"] <= 227 * 1024
    # shared memory for the blocks that share an SM (and the SM's 1 KB a
    # block), no more: the rest is L1
    for blocks in (1, 2, 3, 8):
        pct = host_kernel.layout(wt_max, blocks)["carveout"]
        need = blocks * (lay["smem"] + 1024)
        assert 0 < pct <= 100
        assert pct == 100 or (pct - 1) * 228 * 1024 < 100 * need \
            <= pct * 228 * 1024
    if w1 % 2:                  # the image: no padding
        assert lay["pitch"] == w1


def _tables(rng, S, wq_max):
    return (_t(rng.integers(0, 4, (S + 1, wq_max)).astype(np.int32)),
            _t(rng.normal(size=(S, wq_max, 25, 4)).astype(np.float32)),
            _t(rng.normal(size=(S, wq_max + 2)).astype(np.float32)))


# the cases keep the names they had when the kernel took wq_max 128 and
# refused a window whose whole-row staging did not fit (600 columns): the
# bad values are now one past MAX_SEQUENCE_LENGTH's
@pytest.mark.parametrize("case", ["wq_max_0", "wq_max_129", "wt_max_0",
                                  "ev_tabs_off_16", "too_wide"])
def test_plan_refuses_what_the_kernel_does_not_take(host_kernel, case):
    """The plan, the kernel's one way in, refuses shapes the kernel does
    not take (EvalPackPlan raises on its return code): no wq_max beyond
    the pair bits' 1024, no empty shape, no ev_tabs off 16 bytes (read as
    float4), no window wider than MAX_WT (1032); the widths the step uses
    are taken, the widest among them."""
    rng = np.random.default_rng(11)
    qc, ev_tabs, ev_loop = _tables(rng, 3, 24)
    wq_max, wt_max = None, 32
    if case == "wq_max_0":
        wq_max = 0
    elif case == "wq_max_129":
        wq_max = 1025
    elif case == "wt_max_0":
        wt_max = 0
    elif case == "ev_tabs_off_16":
        flat = torch.zeros(ev_tabs.numel() + 4)
        off = (-flat.data_ptr() // 4) % 4 + 1
        ev_tabs = flat[off:off + ev_tabs.numel()].view(ev_tabs.shape)
    else:
        wt_max = MAX_WT + 1
        assert host_kernel.layout(wt_max)["warps"] == 0
    assert host_kernel.plan(qc, ev_tabs, ev_loop, (0.0,) * 4, wt_max,
                            wq_max)[1] == 1          # cudaErrorInvalidValue
    for wq, wt in ((16, 24), (24, 32), (56, 64), (120, 128), (121, 129),
                   (600, 608), (1024, MAX_WT)):
        qc, ev_tabs, ev_loop = _tables(rng, 3, wq)
        assert host_kernel.plan(qc, ev_tabs, ev_loop, (0.0,) * 4, wt)[1] == 0
        assert host_kernel.layout(wt)["warps"] >= 1


# ---- windows past 128 columns: the piece layout --------------------------

# (B, wq_max, options) past the whole-row layout: the scan stages pieces of
# 32 columns of the lanes' rows and reads the window codes in place, the
# pair bits take 32 words
WIDE = [(70, 121, {}), (70, 140, {}), (100, 140, {"mixed_ql": True}),
        (64, 300, {"offset": 1}), (64, 300, {"mixed_ql": True}),
        (96, 300, {"invalid_warps": True}), (33, 1024, {})]


@pytest.mark.parametrize(
    "B,wq_max,opts", WIDE,
    ids=[f"B{B}-wq{wq}-" + ("-".join(f"{k}{'' if v is True else v}"
                                      for k, v in o.items()) or "plain")
         for B, wq, o in WIDE])
def test_kernel_source_on_wide_windows_matches_reference(host_kernel, B,
                                                         wq_max, opts):
    rng = np.random.default_rng(B * 7 + wq_max + len(opts))
    args, eval_const = _staging_case(rng, B, wq_max, **opts)
    lay = host_kernel.layout(wq_max + 8)
    assert lay["piece"] == 32 and lay["tb5"] == 0 and lay["warps"] == 4
    assert lay["pitch"] % 2 == 1 and lay["stage"] >= 32 * lay["pitch"]
    assert lay["bits"] == 32 * 33
    assert lay["smem"] == 4 * lay["warps"] * (
        lay["slots"] * lay["stage"] + lay["bits"])
    want = P.eval_pack_reference(*args, eval_const)
    _assert_words_equal(host_kernel.run(args, eval_const), want)
    valid = args[7].numpy()
    assert (want[~args[7]] == 0).all()
    assert (want[:, 0].numpy()[valid] & 1).sum() > 0          # trusted


@pytest.mark.parametrize("run", [200, 256, 257, 300])
def test_loops_past_the_entropy_table_are_not_trusted(host_kernel, run):
    """A 320-nt oligo whose site holds a run of `run` mismatches inside its
    trimmed alignment: up to LOOP_MAX_MM (256) the loop's entropy is the
    table's and the entry is trusted; past it the loop would read beyond
    the table, so the entry goes to the host (not trusted).  Kernel ==
    plain version either way."""
    from tntblast_tpu_torch.ops.eval_gapless import LOOP_MAX_MM

    rng = np.random.default_rng(run)
    wq_max = 320
    args, eval_const = _staging_case(rng, 32, wq_max)
    qc, tb5, ql, ent_valid = args[8], args[2], args[4], args[7]
    slot = args[3]
    b = int(np.flatnonzero(ent_valid.numpy())[0])
    L = int(ql[b])
    q = qc[int(slot[b]), :L].numpy()
    # the site of the whole oligo on the diagonal of the planted M cells
    # (offset 0: the best cell's diagonal runs through column r + 1 of row
    # r), complementary but for `run` positions in its middle
    site = (3 - q[::-1]) % 4
    mid = L // 2 - run // 2
    site[mid:mid + run] = q[::-1][mid:mid + run]
    tb5[b, :] = 0
    tb5[b, :L] = torch.from_numpy(site.astype(np.int32))
    M = args[0]
    for r in range(L):
        M[r, b, 1:] = -1
        M[r, b, r + 1] = 50 + 5 * r
    args[1][b] = -5                                     # no gapped tie
    args[6][b] = False                                  # not for the host
    want = P.eval_pack_reference(*args, eval_const)
    _assert_words_equal(host_kernel.run(args, eval_const), want)
    w0 = int(want[b, 0])
    assert ((w0 >> 10) & 63) == min(run, 63)            # the mismatches
    assert (w0 & 1) == (1 if run <= LOOP_MAX_MM else 0)
